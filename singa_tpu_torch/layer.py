"""Transformer layers as `nn.Module`s (counterpart of the transformer stack
in singa_tpu/layer.py): LayerNorm, Linear, Embedding, MultiHeadAttention,
TransformerBlock and the SoftMaxCrossEntropy loss.

Parameters are trainable `nn.Parameter`s (fp32 master weights). Under the
bf16 policy (`autograd.compute_dtype`) each layer casts where the JAX
layer does: Linear its input, weight and bias; Embedding the looked-up
rows; MultiHeadAttention its input, the four projections and each bias.
LayerNorm and the loss are fp32 islands.

Parameters keep the JAX package's names and layouts, so its
`get_params()` dict maps onto these modules one to one: a Linear's `W` is
(in, out) and `y = x @ W + b`. Widths are given at construction (the JAX
layers infer them at the first call). Initialisation follows the JAX
initializers' formulas from a `torch.Generator`; the draws differ, so
parity checks carry weights over (models.transformer.load_singa_params).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import autograd


def _uniform(shape, limit, gen):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def he_uniform(fan_in, fan_out, gen):
    return _uniform((fan_in, fan_out), math.sqrt(6.0 / fan_in), gen)


def glorot_uniform(fan_in, fan_out, gen):
    return _uniform((fan_in, fan_out),
                    math.sqrt(6.0 / (fan_in + fan_out)), gen)


class LayerNorm(nn.Module):
    """LayerNorm as an fp32 island (biased variance), output in the input
    dtype: variance in bf16 is lossy."""

    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layernorm(x, self.gamma, self.beta, self.eps)


def layernorm(x, g, b, eps=1e-5):
    x32 = x.float()
    m = x32.mean(dim=-1, keepdim=True)
    v = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - m) * torch.rsqrt(v + eps) * g.float() + b.float()
    return y.to(x.dtype)


class _MatmulF32(torch.autograd.Function):
    """x @ W accumulated and returned in fp32 whatever the inputs' dtype
    (the JAX package's `preferred_element_type=float32` on the loss
    head): on CUDA through `torch.mm(out_dtype=float32)`, on the CPU by
    upcasting both operands; both give the fp32 product of the same
    values. The gradients go back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, W):
        ctx.save_for_backward(x, W)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype != torch.float32:
            y = torch.mm(x2, W, out_dtype=torch.float32)
        else:
            y = x2.float() @ W.float()
        return y.reshape(*x.shape[:-1], W.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, W = ctx.saved_tensors
        g = dy.to(x.dtype).reshape(-1, dy.shape[-1])
        dx = (g @ W.t()).reshape(x.shape)
        dW = x.reshape(-1, x.shape[-1]).t() @ g
        return dx, dW


class Linear(nn.Module):
    """y = x W + b with W (in, out); `out_dtype="float32"` returns the
    product accumulated in fp32 whatever the input dtype (the GPT head
    under the bf16 policy)."""

    def __init__(self, in_features, out_features, bias=True, out_dtype=None,
                 generator=None):
        super().__init__()
        self.W = nn.Parameter(he_uniform(in_features, out_features,
                                         generator))
        self.b = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.out_dtype = out_dtype

    def forward(self, x):
        x, W, b = autograd.compute_cast(x, self.W, self.b)
        y = _MatmulF32.apply(x, W) if self.out_dtype == "float32" \
            else x @ W
        return y + b if b is not None else y


class Embedding(nn.Module):
    """Token id -> row of a (V, E) table; under the bf16 policy the
    looked-up rows are cast, not the table."""

    def __init__(self, num, dim, generator=None):
        super().__init__()
        self.W = nn.Parameter(glorot_uniform(num, dim, generator))

    def forward(self, ids):
        return autograd.compute_cast(self.W[ids])


class MultiHeadAttention(nn.Module):
    """Self-attention over (B, S, E) through the flash-attention kernel;
    `num_kv_heads` < num_heads is GQA (each kv head serves num_heads /
    num_kv_heads consecutive query heads), `rope` rotates q and k."""

    def __init__(self, dim, num_heads, causal=True, bias=False,
                 num_kv_heads=None, rope=False, rope_theta=10000.0,
                 generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads or dim % num_heads:
            raise ValueError(f"dim {dim}, {num_heads} heads, "
                             f"{self.num_kv_heads} kv heads do not divide")
        self.causal = causal
        self.rope = bool(rope)
        self.rope_theta = float(rope_theta)
        self.use_bias = bias
        kv_e = self.num_kv_heads * (dim // num_heads)
        for attr in ("Wq", "Wk", "Wv", "Wo"):
            out_e = kv_e if attr in ("Wk", "Wv") else dim
            setattr(self, attr, nn.Parameter(
                glorot_uniform(dim, out_e, generator)))
            if bias:
                setattr(self, "b" + attr[1].lower(), nn.Parameter(
                    torch.zeros(out_e)))

    def forward(self, x):
        B, S, E = x.shape
        x, Wq, Wk, Wv, Wo = autograd.compute_cast(
            x, self.Wq, self.Wk, self.Wv, self.Wo)
        bq, bk, bv, bo = (self.bq, self.bk, self.bv, self.bo) \
            if self.use_bias else (None,) * 4

        def proj(W, b, heads):
            y = x @ W
            if b is not None:
                y = y + autograd.compute_cast(b)
            return y.reshape(B, S, heads, -1).transpose(1, 2)  # (B,H,S,D)

        q = proj(Wq, bq, self.num_heads)
        k = proj(Wk, bk, self.num_kv_heads)
        v = proj(Wv, bv, self.num_kv_heads)
        if self.rope:
            # rotate before the kv-head repeat, as the JAX layer does
            cos, sin = autograd.rope_tables(
                torch.arange(S, device=x.device), q.shape[-1],
                self.rope_theta)
            q, k = autograd.apply_rope(q, cos, sin), \
                autograd.apply_rope(k, cos, sin)
        grp = self.num_heads // self.num_kv_heads
        if grp > 1:
            # GQA: each kv head serves `grp` consecutive query heads; the
            # repeat's gradient sums over the group
            k = k.repeat_interleave(grp, dim=1)
            v = v.repeat_interleave(grp, dim=1)
        o = autograd.attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=self.causal)
        y = o.transpose(1, 2).reshape(B, S, E) @ Wo
        if bo is not None:
            y = y + autograd.compute_cast(bo)
        return y


class TransformerBlock(nn.Module):
    """Pre-LN causal block: x + MHA(LN(x)); x + MLP(LN(x)), tanh-GELU
    MLP."""

    def __init__(self, dim, num_heads, mlp_ratio=4, attn_bias=False,
                 num_kv_heads=None, rope=False, rope_theta=10000.0,
                 generator=None):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(
            dim, num_heads, causal=True, bias=attn_bias,
            num_kv_heads=num_kv_heads, rope=rope, rope_theta=rope_theta,
            generator=generator)
        self.ln2 = LayerNorm(dim)
        self.fc1 = Linear(dim, dim * mlp_ratio, generator=generator)
        self.fc2 = Linear(dim * mlp_ratio, dim, generator=generator)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(autograd.gelu(self.fc1(self.ln2(x))))


class SoftMaxCrossEntropy(nn.Module):
    """Mean softmax cross-entropy of logits (..., V) against integer
    targets (...), fp32 inside (autograd.softmax_cross_entropy)."""

    def forward(self, x, t):
        return autograd.softmax_cross_entropy(x, t)


__all__ = ["Embedding", "LayerNorm", "Linear", "MultiHeadAttention",
           "SoftMaxCrossEntropy", "TransformerBlock", "layernorm"]
