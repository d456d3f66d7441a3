"""Parallelism (counterpart of singa_tpu/parallel): device meshes over the
ranks of a `torch.distributed` process group and their bound axes
(`mesh`), the axis collectives over NCCL or gloo (`communicator`),
tensor parallelism (`tp`), pipeline parallelism (`pipeline`: gpipe, its
interleaved form and 1F1B), and the mixture-of-experts FFN on one device
or expert-parallel over an axis (`moe`). Sequence parallelism is
`ops.attention.ring_attention`."""

from .communicator import Communicator  # noqa: F401
from .mesh import (  # noqa: F401
    data_parallel_mesh, factor_mesh, local_device_count, make_mesh,
)
from .tp import (  # noqa: F401
    Placement, column_parallel, megatron_f, megatron_g, row_parallel,
    shard_columns, shard_rows, tp_mlp, vocab_parallel_ce,
)
from .moe import (  # noqa: F401
    moe_ffn, moe_ffn_ep, top1_gating, topk_gating,
)
from .pipeline import gpipe, last_stage_value  # noqa: F401
