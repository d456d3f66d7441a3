"""Mixture-of-experts FFN (counterpart of singa_tpu/parallel/moe.py):
top-k routing with capacity, a Switch load-balance loss and the ST-MoE
router z-loss, on one device (`moe_ffn`) or expert-parallel over a mesh
axis (`moe_ffn_ep`).

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
counting at 256 (ROADMAP.md, Queue 3).

Expert parallelism: each rank of the axis owns E / n experts; the
(E, C, D) blocks of its tokens go to their experts' ranks and come back
by two all-to-alls (`_A2A`, over `parallel.communicator`'s primitive;
its backward is the mirrored all-to-all, as the JAX package writes it)."""

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


class _A2A(torch.autograd.Function):
    """`lax.all_to_all(x, axis, split, concat)` over a bound axis: x's
    dimension `split` (of the axis's size) is scattered over the ranks
    and what arrives is stacked on a new dimension `concat`; the
    backward is the mirrored all-to-all (JAX's `_a2a`)."""

    @staticmethod
    def forward(ctx, x, ax, split, concat):
        ctx.ax, ctx.split, ctx.concat = ax, split, concat
        return _all_to_all(x, ax, split, concat)

    @staticmethod
    def backward(ctx, dy):
        return (_all_to_all(dy, ctx.ax, ctx.concat, ctx.split), None, None,
                None)


def _all_to_all(x, ax, split, concat):
    """The all-to-all itself: the split dimension moved first, exchanged
    block by block (`_exchanged`; nothing without a process group), and
    the arrivals' dimension moved to `concat`."""
    from .communicator import _exchanged
    if x.shape[split] != ax.size:
        raise ValueError(f"all_to_all: dimension {split} of "
                         f"{tuple(x.shape)} is not the axis size {ax.size}")
    x = x.movedim(split, 0)
    if ax.group is not None:
        x = _exchanged(x, ax.group)
    return x.movedim(0, concat)


class _PMean(torch.autograd.Function):
    """`lax.pmean` as the JAX package differentiates it inside its
    shard_map (check_vma off, psum transposing to psum): the mean over
    the axis forward, the mean of the cotangents backward."""

    @staticmethod
    def forward(ctx, x, ax):
        from .tp import _psum
        ctx.ax = ax
        return _psum(x, ax) / ax.size

    @staticmethod
    def backward(ctx, dy):
        from .tp import _psum
        return _psum(dy, ctx.ax) / ctx.ax.size, None


def moe_ffn_ep(x, Wg, W1, b1, W2, b2, axis_name, capacity_factor=1.25,
               act=None, k=1):
    """Expert-parallel MoE over the bound mesh axis `axis_name`: x (T, D)
    this rank's tokens, Wg (D, E) replicated, W1 (E / n, D, H), b1, W2,
    b2 this rank's experts only. The capacity is `moe_ffn`'s formula on
    the local T, max(1, int(T * k * capacity_factor / E)). Routing is by
    index, as in `moe_ffn`; the (E, C, D) blocks, grouped (n, E / n, C,
    D) by owner, are all-to-all'd, run through the local experts as
    (E / n, n C, D) and all-to-all'd back. Returns (y (T, D), aux,
    (z_loss, overflow)), the three averaged over the axis."""
    from .tp import _axis
    act = act or _gelu
    ax = _axis(axis_name)
    n = ax.size
    T, D = x.shape
    E = Wg.shape[1]
    e_local = E // n
    if e_local * n != E or W1.shape[0] != e_local:
        raise ValueError(f"{E} experts over {n} ranks: each rank holds "
                         f"E / n of them, got W1 {tuple(W1.shape)}")
    capacity = max(1, int(T * k * capacity_factor / E))
    slots, gates, aux, z_loss, overflow = topk_gating(x, Wg, capacity, k)
    dt = torch.promote_types(x.dtype, W1.dtype)
    flat = slots.reshape(-1)
    src = x.to(dt).repeat_interleave(k, dim=0)
    buf = x.new_zeros((E * capacity + 1, D), dtype=dt).index_copy(
        0, flat, src)
    grouped = buf[:-1].reshape(n, e_local, capacity, D)
    received = _A2A.apply(grouped, ax, 0, 1)         # (e_local, n, C, D)
    out = _expert_ffn(received.reshape(e_local, n * capacity, D),
                      W1.to(dt), b1.to(dt), W2.to(dt), b2.to(dt), act)
    returned = _A2A.apply(out.reshape(e_local, n, capacity, D), ax, 1, 0)
    out = torch.cat([returned.reshape(E * capacity, D),
                     out.new_zeros((1, D))])           # spare row: 0
    rows = out.index_select(0, flat).reshape(T, k, D)
    y = (gates[..., None] * rows).sum(dim=1)
    aux, z_loss, overflow = (_PMean.apply(t, ax)
                             for t in (aux, z_loss, overflow))
    return y, aux, (z_loss, overflow)


__all__ = ["moe_ffn", "moe_ffn_ep", "top1_gating", "topk_gating"]
