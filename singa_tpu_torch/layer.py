"""Transformer layers as `nn.Module`s (counterpart of the transformer stack
in singa_tpu/layer.py): LayerNorm, Linear, Embedding, MultiHeadAttention
and TransformerBlock, inference forward only.

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
from .ops.attention import flash_attention


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
        self.gamma = nn.Parameter(torch.ones(dim), requires_grad=False)
        self.beta = nn.Parameter(torch.zeros(dim), requires_grad=False)

    def forward(self, x):
        return layernorm(x, self.gamma, self.beta, self.eps)


def layernorm(x, g, b, eps=1e-5):
    x32 = x.float()
    m = x32.mean(dim=-1, keepdim=True)
    v = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - m) * torch.rsqrt(v + eps) * g.float() + b.float()
    return y.to(x.dtype)


class Linear(nn.Module):
    """y = x W + b with W (in, out); `out_dtype="float32"` returns fp32
    whatever the input dtype (the GPT head)."""

    def __init__(self, in_features, out_features, bias=True, out_dtype=None,
                 generator=None):
        super().__init__()
        self.W = nn.Parameter(he_uniform(in_features, out_features,
                                         generator), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(out_features),
                              requires_grad=False) if bias else None
        self.out_dtype = out_dtype

    def forward(self, x):
        y = x @ self.W.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y.float() if self.out_dtype == "float32" else y


class Embedding(nn.Module):
    """Token id -> row of a (V, E) table."""

    def __init__(self, num, dim, generator=None):
        super().__init__()
        self.W = nn.Parameter(glorot_uniform(num, dim, generator),
                              requires_grad=False)

    def forward(self, ids):
        return self.W[ids]


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
                glorot_uniform(dim, out_e, generator), requires_grad=False))
            if bias:
                setattr(self, "b" + attr[1].lower(), nn.Parameter(
                    torch.zeros(out_e), requires_grad=False))

    def forward(self, x):
        B, S, E = x.shape
        ab = self.use_bias

        def proj(W, b, heads):
            y = x @ W.to(x.dtype)
            if b is not None:
                y = y + b.to(x.dtype)
            return y.reshape(B, S, heads, -1).transpose(1, 2)  # (B,H,S,D)

        q = proj(self.Wq, self.bq if ab else None, self.num_heads)
        k = proj(self.Wk, self.bk if ab else None, self.num_kv_heads)
        v = proj(self.Wv, self.bv if ab else None, self.num_kv_heads)
        if self.rope:
            cos, sin = autograd.rope_tables(
                torch.arange(S, device=x.device), q.shape[-1],
                self.rope_theta)
            q, k = autograd.apply_rope(q, cos, sin), \
                autograd.apply_rope(k, cos, sin)
        grp = self.num_heads // self.num_kv_heads
        if grp > 1:
            k = k.repeat_interleave(grp, dim=1)
            v = v.repeat_interleave(grp, dim=1)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=self.causal)
        y = o.transpose(1, 2).reshape(B, S, E) @ self.Wo.to(x.dtype)
        if ab:
            y = y + self.bo.to(x.dtype)
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


__all__ = ["Embedding", "LayerNorm", "Linear", "MultiHeadAttention",
           "TransformerBlock", "layernorm"]
