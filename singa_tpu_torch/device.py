"""Device resolution (counterpart of singa_tpu/device.py).

The port runs on CUDA. The CPU is used only when a caller asks for it by
name (the CPU parity tests do), never as a silent fallback.
"""

from __future__ import annotations

import torch


def best_device() -> torch.device:
    """The first CUDA device, or a RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "singa_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device=\"cpu\" to run the plain PyTorch versions of the "
            "kernels on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device=None) -> torch.device:
    """`device=` argument -> torch.device: None means best_device()."""
    if device is None:
        return best_device()
    return torch.device(device)


__all__ = ["best_device", "resolve"]
