"""Tensor functions of the serving path (counterpart of a part of
singa_tpu/autograd.py): rotary embeddings and the GELU. The define-by-run
tape comes with the training slice of the port."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


__all__ = ["apply_rope", "gelu", "rope_tables"]
