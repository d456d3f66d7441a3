"""singa_tpu_torch: the PyTorch/CUDA port of singa_tpu, for NVIDIA Hopper.

The JAX package `singa_tpu` stays the reference; this package keeps its
module names so each counterpart is easy to find. It imports `torch` and
never `jax` or `singa_tpu`.

What is ported so far is the GPT's serving and training:

    models.transformer.GPT.generate -> serving.build_decode
        (build_spec_decode with a draft model) -> serving._DecodeCore
        .prefill / token_step / verify_step, in fp32, bf16 or int8
        weights and fp, int8 or int4 KV caches
    models.transformer.GPT.generate_beam -> serving.build_beam_decode
    engine.ServingEngine.submit/start/stop
        -> serving._DecodeCore.prefill_parts / paged_token_step /
        paged_verify_step
    model.Model.compile / __call__ -> GPT.train_one_batch, opt

carried by six hand-written CUDA kernels in `csrc/` (flash-attention
forward, its fused and split backward, flash-decode and paged decode
attention over fp, int8 and int4 caches with the speculative verify
ladder), bound in `ops.attention`. Entry points run on CUDA unless the
caller passes `device="cpu"`, where every kernel wrapper runs its plain
PyTorch version instead.
"""

from . import device  # noqa: F401

__all__ = ["device"]
