"""Parallelism (counterpart of singa_tpu/parallel): device meshes over the
ranks of a `torch.distributed` process group (`mesh`), the axis
collectives over NCCL or gloo (`communicator`), and the single-device
mixture-of-experts FFN (`moe`). The tensor-, sequence- and
pipeline-parallel helpers and the expert-parallel `moe_ffn_ep` come with
model parallelism (ROADMAP.md Queue 1 item 5)."""

from .communicator import Communicator  # noqa: F401
from .mesh import (  # noqa: F401
    data_parallel_mesh, factor_mesh, local_device_count, make_mesh,
)
from .moe import moe_ffn, top1_gating, topk_gating  # noqa: F401
