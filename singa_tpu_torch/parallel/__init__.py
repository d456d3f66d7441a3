"""Parallelism (counterpart of singa_tpu/parallel): device meshes over the
ranks of a `torch.distributed` process group and their bound axes
(`mesh`), the axis collectives over NCCL or gloo (`communicator`),
tensor parallelism (`tp`), and the single-device mixture-of-experts FFN
(`moe`). The sequence- and pipeline-parallel helpers and the
expert-parallel `moe_ffn_ep` come with ROADMAP.md Queue 1 items 5b and
5c."""

from .communicator import Communicator  # noqa: F401
from .mesh import (  # noqa: F401
    data_parallel_mesh, factor_mesh, local_device_count, make_mesh,
)
from .tp import (  # noqa: F401
    Placement, column_parallel, megatron_f, megatron_g, row_parallel,
    shard_columns, shard_rows, tp_mlp, vocab_parallel_ce,
)
from .moe import moe_ffn, top1_gating, topk_gating  # noqa: F401
