"""Parallelism (counterpart of singa_tpu/parallel). This slice carries the
single-device mixture-of-experts FFN (`moe`); meshes, collectives, the
tensor-, sequence- and pipeline-parallel helpers and the expert-parallel
`moe_ffn_ep` come with the distribution slice."""

from .moe import moe_ffn, top1_gating, topk_gating  # noqa: F401
