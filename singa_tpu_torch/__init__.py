"""singa_tpu_torch: the PyTorch/CUDA port of singa_tpu, for NVIDIA Hopper.

The JAX package `singa_tpu` stays the reference; this package keeps its
module names so each counterpart is easy to find. It imports `torch` and
never `jax` or `singa_tpu`.

What is ported so far is the serving path of the GPT:

    models.transformer.GPT.generate -> serving.build_decode
        -> serving._DecodeCore.prefill / token_step
    engine.ServingEngine.submit/start/stop
        -> serving._DecodeCore.prefill_parts / paged_token_step

carried by three hand-written CUDA kernels in `csrc/` (flash-attention
forward, flash-decode, paged decode attention), bound in `ops.attention`.
Entry points run on CUDA unless the caller passes `device="cpu"`, where
every kernel wrapper runs its plain PyTorch version instead.
"""

from . import device  # noqa: F401

__all__ = ["device"]
