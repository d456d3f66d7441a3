"""Build and feature flags (counterpart of singa_tpu/config.py).

The reference exports its CMake flags to Python through the SWIG config
module (`singa_wrap.USE_CUDA`, `USE_DIST`, ...), and its tests key off
them. The port has no compile step of its own for the framework (its
kernels build at first use), so each flag states what the port does
today, and where the value comes from:

- `USE_CUDA` is True: the port runs on CUDA (`device`), its kernels are
  CUDA C++ for sm_90a (`ops/attention.py`, `csrc/`).
- `USE_OPENCL` and `USE_DNNL` are False: neither backend exists here.
- `USE_DIST` is False until the port's data-parallel slice (NCCL, with
  gloo for CPU tests; ROADMAP.md Queue 1 item 4) sets it.
- `USE_ONNX` is True: `sonnx` carries its own protobuf codec.
- `CUDNN_VERSION` is `torch.backends.cudnn.version()` (0 where this
  torch has no cuDNN, as a CPU build), read when first asked for: on a
  CUDA build the query initializes CUDA, and a process that imports the
  port and then forks workers that use the card must not have done so.
- `use_tpu()` is False: the port never runs on a TPU.
"""

import torch

USE_CUDA = True
USE_OPENCL = False
USE_DNNL = False
USE_DIST = False
USE_ONNX = True


def use_tpu() -> bool:
    return False


def __getattr__(name):
    if name == "CUDNN_VERSION":
        return torch.backends.cudnn.version() or 0
    if name == "USE_TPU":
        return use_tpu()
    raise AttributeError(
        f"module 'singa_tpu_torch.config' has no attribute {name!r}")
