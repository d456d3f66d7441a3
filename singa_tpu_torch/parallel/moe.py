"""Mixture-of-experts FFN on one device (counterpart of
singa_tpu/parallel/moe.py): top-k routing with capacity, a Switch
load-balance loss and the ST-MoE router z-loss.

Each token picks its k experts by gate probability (ties to the lower
expert index, as `lax.top_k` orders them) and the k gates are
renormalized. An expert accepts at most `capacity` routes, queued in
token order with every kept first choice ahead of every second choice;
a route past its expert's capacity is dropped (zero output for that
choice), and `overflow` is the dropped fraction.

The JAX package dispatches and combines with dense einsums over a
(T, E, C) one-hot. The port computes the same function by index:
routing yields one flat slot per (token, choice), `e * C + position`,
or the spare slot `E * C` when dropped; `index_copy` fills an
(E * C + 1, D) buffer, the experts run as two batched matmuls over
(E, C, ·), and each token gathers its k output rows times its gates.
Slots are unique apart from the spare one, which nothing reads, so the
backward is deterministic, and every shape is static: no host sync, so a
CUDA graph captures the step. Queue positions are exact integers; the
JAX package counts them in the activation dtype, where bf16 stops
counting at 256 (ROADMAP.md, Queue 3)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# tanh-GELU (jax.nn.gelu's default); top-k with ties to the lower index
from ..autograd import _gelu, _top_k


def topk_gating(x, Wg, capacity: int, k: int = 1):
    """x (T, D) tokens, Wg (D, E). Returns (slots, gates, aux, z_loss,
    overflow):
      slots    — (T, k) int64: choice j of token t is row slots[t, j] of
                 the flattened (E * capacity + 1) expert buffer, e * C +
                 queue position when kept, E * C (the spare row) when
                 dropped
      gates    — (T, k): the renormalized gate of each kept choice, 0 for
                 a dropped one (the JAX package's combine weights)
      aux      — Switch load balance, E * sum(first-choice token fraction
                 * mean probability), first choices taken before capacity
      z_loss   — mean(logsumexp(fp32 logits)^2)
      overflow — fraction of the T * k routes dropped, fp32
    """
    T = x.shape[0]
    dt = torch.promote_types(x.dtype, Wg.dtype)
    logits = x.to(dt) @ Wg.to(dt)                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    E = probs.shape[-1]
    z = torch.logsumexp(logits.float(), dim=-1)
    z_loss = torch.mean(z * z)

    topv, topi = _top_k(probs, k)                          # (T, k)
    renorm = topv / topv.sum(dim=-1, keepdim=True)
    experts = torch.arange(E, device=x.device)[:, None]
    fill = torch.zeros(E, dtype=torch.long, device=x.device)
    slots, keeps = [], []
    for j in range(k):
        e = topi[:, j]
        mask = experts == e[None, :]                       # (E, T)
        # queue position: routes kept by earlier choices (fill) + this
        # choice's running count in token order (a scan along the
        # contiguous token axis)
        count = torch.cumsum(mask, dim=1, dtype=torch.int32)
        pos = count.gather(0, e[None, :])[0].long() - 1 + fill[e]
        keep = pos < capacity
        slots.append(torch.where(keep, e * capacity + pos,
                                 E * capacity))
        keeps.append(keep)
        fill = fill + (mask & keep[None, :]).sum(dim=1)
    slots = torch.stack(slots, dim=1)
    keep = torch.stack(keeps, dim=1)
    gates = renorm * keep.to(renorm.dtype)

    frac_tokens = F.one_hot(topi[:, 0], E).to(probs.dtype).mean(dim=0)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    overflow = 1.0 - keep.sum().float() / (T * k)
    return slots, gates, aux, z_loss, overflow


def top1_gating(x, Wg, capacity: int):
    """Switch (k = 1) gating: (slots, gates, aux)."""
    slots, gates, aux, _, _ = topk_gating(x, Wg, capacity, k=1)
    return slots, gates, aux


def _expert_ffn(blocks, W1, b1, W2, b2, act):
    """blocks (E, C, D); each expert's two-layer FFN, batched over E."""
    h = act(torch.bmm(blocks, W1) + b1[:, None, :])
    return torch.bmm(h, W2) + b2[:, None, :]


def moe_ffn(x, Wg, W1, b1, W2, b2, capacity_factor=1.25, act=None, k=1):
    """Single-device MoE: x (T, D); W1 (E, D, H); W2 (E, H, D). Returns
    (y (T, D), aux, (z_loss, overflow)). The capacity is batch-global,
    max(1, int(T * k * capacity_factor / E)) over every row of x. The
    experts run in the promoted dtype of x and their weights (fp32
    experts under the bf16 policy, as in the JAX package)."""
    act = act or _gelu
    T, D = x.shape
    E = W1.shape[0]
    capacity = max(1, int(T * k * capacity_factor / E))
    slots, gates, aux, z_loss, overflow = topk_gating(x, Wg, capacity, k)
    dt = torch.promote_types(x.dtype, W1.dtype)
    flat = slots.reshape(-1)                               # (T * k,)
    src = x.to(dt).repeat_interleave(k, dim=0)             # row t*k + j
    buf = x.new_zeros((E * capacity + 1, D), dtype=dt).index_copy(
        0, flat, src)
    out = _expert_ffn(buf[:-1].reshape(E, capacity, D), W1.to(dt),
                      b1.to(dt), W2.to(dt), b2.to(dt), act)
    out = torch.cat([out.reshape(E * capacity, D),
                     out.new_zeros((1, D))])                # spare row: 0
    rows = out.index_select(0, flat).reshape(T, k, D)
    y = (gates[..., None] * rows).sum(dim=1)
    return y, aux, (z_loss, overflow)


__all__ = ["moe_ffn", "top1_gating", "topk_gating"]
