"""Tensor functions of the ported paths (counterpart of a part of
singa_tpu/autograd.py): the train/eval switch, the mixed-precision policy,
the fused softmax cross-entropy with its hand backward, attention through
the flash kernels, `backward` as a generator of (param, grad), rotary
embeddings and the GELU.

Where the JAX package records a define-by-run tape of its own operators,
the port records PyTorch's autograd graph: parameters are
`nn.Parameter`s that require grad, and each of the JAX package's hand
backward rules (the flash attention VJP, the softmax cross-entropy, the
compute cast) is a `torch.autograd.Function`. The ~100 tape operators and
the `Tensor` facade come with a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops.attention import flash_attention

#: global train/eval switch (singa_tpu/autograd.py `training`); set by
#: Model.train()/eval()
training = False

#: the mixed-precision compute dtype ("bfloat16") or None; set by Model
#: around each call under `compile(amp=...)`. Parameters stay fp32 (the
#: master weights); layers cast at their matmul boundaries through
#: compute_cast, normalizations and the loss upcast internally.
compute_dtype = None


def compute_cast(*xs):
    """Cast floating tensors to the active compute dtype; a no-op when the
    policy is off, for None, and for tensors already in it. The cast is
    differentiable: its gradient is cast back to the input's dtype, so a
    master weight's grad arrives fp32 (JAX's ComputeCast)."""
    if compute_dtype is None:
        return xs if len(xs) > 1 else xs[0]
    tgt = getattr(torch, compute_dtype)
    out = tuple(x.to(tgt) if x is not None and x.is_floating_point()
                and x.dtype != tgt else x for x in xs)
    return out if len(out) > 1 else out[0]


def softmax_cross_entropy_fwd(logits, targets):
    """Per-row -log softmax(logits)[target]; targets are class indices
    (one dim fewer, or integer) or one-hot/soft rows (singa_tpu/tensor.py
    softmax_cross_entropy_fwd)."""
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    if targets.dim() == logits.dim() - 1 or not targets.is_floating_point():
        return -logp.gather(-1, targets.long()[..., None])[..., 0]
    return -(targets * logp).sum(-1)


def softmax_cross_entropy_bwd(logits, targets):
    """d(CE)/d(logits) = softmax(logits) - onehot(targets)."""
    p = torch.softmax(logits, dim=-1)
    if targets.dim() == logits.dim() - 1 or not targets.is_floating_point():
        onehot = F.one_hot(targets.long(), logits.shape[-1]).to(logits.dtype)
    else:
        onehot = targets
    return p - onehot


class SoftMaxCrossEntropy(torch.autograd.Function):
    """Fused stable softmax cross-entropy, the mean over every leading
    dim, with the JAX package's hand backward: an fp32 island under the
    bf16 policy; dx = (softmax - onehot) * dy / n in the input's dtype."""

    @staticmethod
    def forward(ctx, x, t):
        x32 = x.float()
        ctx.save_for_backward(x32, t)
        ctx.in_dtype = x.dtype
        return softmax_cross_entropy_fwd(x32, t).mean()

    @staticmethod
    def backward(ctx, dy):
        x32, t = ctx.saved_tensors
        n = x32[..., 0].numel() if x32.dim() > 1 else 1
        dx = softmax_cross_entropy_bwd(x32, t) * (dy / n)
        return dx.to(ctx.in_dtype), None


def softmax_cross_entropy(x, t):
    return SoftMaxCrossEntropy.apply(x, t)


def attention(q, k, v, causal=False):
    """Fused attention (B, H, S, D) through the flash kernels; its
    backward is the K2 kernels (ops.attention.FlashAttention)."""
    return flash_attention(q, k, v, causal)


def backward(loss, dy=None):
    """Reverse pass from `loss`; a GENERATOR of (param, grad) for every
    leaf that requires grad and was reached (singa_tpu/autograd.py
    backward), so a distributed optimizer can start reducing as grads
    arrive. Here the grads come from one torch.autograd.grad call over
    the leaves of the graph, then are yielded in the leaves' order."""
    if loss.grad_fn is None:
        raise RuntimeError("backward needs a loss computed in training "
                           "mode from parameters that require grad")
    leaves, seen, stack = [], set(), [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            leaves.append(var)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    if dy is None:
        dy = torch.ones_like(loss)
    grads = torch.autograd.grad(loss, leaves, dy, allow_unused=True)
    for p, g in zip(leaves, grads):
        if g is not None:
            yield p, g


def rope_tables(positions, dim, theta=10000.0):
    """(cos, sin) tables for NeoX-style rotary embeddings: positions (S,)
    -> (S, dim) fp32 with the two half-blocks duplicated (cos = [c | c])."""
    half = dim // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=positions.device) / half)
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], dim=-1)
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], dim=-1)
    return cos, sin


def apply_rope(x, cos, sin):
    """Rotate (..., S, D) by per-position tables (S, D), NeoX halves:
    out = x*cos + rotate_half(x)*sin, rotate_half = [-x2 | x1]; fp32 math,
    result in x's dtype."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


def gelu(x):
    """GELU with the tanh approximation, jax.nn.gelu's default."""
    return F.gelu(x, approximate="tanh")


__all__ = ["apply_rope", "attention", "backward", "compute_cast",
           "compute_dtype", "gelu", "rope_tables",
           "softmax_cross_entropy", "softmax_cross_entropy_bwd",
           "softmax_cross_entropy_fwd", "training"]
