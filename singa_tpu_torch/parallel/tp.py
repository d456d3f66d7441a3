"""Tensor parallelism (counterpart of singa_tpu/parallel/tp.py): Megatron
column- and row-parallel matmuls over a mesh axis, its `f` and `g`
operators, and the vocab-parallel cross-entropy.

The JAX functions run inside a shard_map body, where the weights arrive
sharded and the axis names are bound. Here each rank is a process: the
axis must be bound (`Mesh.bind()`, or the graph-mode step of a model
whose DistOpt's mesh carries it; `parallel.mesh`), the weights are this
rank's shards, and every collective is one of `parallel.communicator`'s
primitives over the axis's process group (NCCL on the card, gloo on the
CPU; the identity over a mesh of one rank that has no process group).
Each operator finds the group at its forward and keeps it for its
backward.

`shard_columns`/`shard_rows` return a `Placement`, the port's form of a
NamedSharding: a mesh and a spec that can cut a full array into this
rank's block and gather the blocks back.

Known difference: `row_parallel`'s reduction is Megatron's `g`, whose
backward is the identity; JAX's raw `psum` would transpose to a second
psum when differentiated inside a shard_map with check_vma off. The
forwards are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from .communicator import _reduced, _shifted, _stacked
from .mesh import bound_mesh


class _Axis(NamedTuple):
    """A bound axis as an operator keeps it: its process group (None: the
    identity), size and this rank's index along it."""
    group: object
    size: int
    index: int


def _mesh_axis(mesh, name) -> _Axis:
    return _Axis(mesh.group(name), int(mesh.shape[name]),
                 mesh.coordinate(name))


def _axis(axis) -> _Axis:
    """The bound axis `axis` (a name, or an `_Axis` already found)."""
    if isinstance(axis, _Axis):
        return axis
    mesh = bound_mesh(axis)
    if mesh is None:
        raise NameError(f"unbound axis name: {axis}")
    return _mesh_axis(mesh, axis)


def _psum(x, ax: _Axis, op=None):
    """The sum (or `op`) of x over the axis, in a new tensor."""
    return x if ax.group is None else _reduced(x, ax.group, op)


def _stack(x, ax: _Axis):
    """Every rank's x stacked on a new leading axis, in axis order."""
    return x.unsqueeze(0) if ax.group is None \
        else _stacked(x, ax.group, ax.size)


def _shift(x, ax: _Axis):
    """x one step along the axis's ring (`lax.ppermute` with the pairs
    (i, i + 1 mod size)): the previous rank's x; x itself at size 1."""
    return _shifted(x, ax.group, ax.size, ax.index)


def _gather_dim(x, ax: _Axis, dim: int):
    """The axis's blocks of x concatenated along `dim` (tiled)."""
    return torch.cat(list(_stack(x, ax).unbind(0)), dim=dim)


# ---- placements ---------------------------------------------------------

class Placement:
    """A mesh and a spec: entry d of `spec` names the mesh axis that
    splits dimension d (None, or a missing entry, keeps it whole).
    `shard(full)` is this rank's contiguous block of a full array;
    `gather(local)` assembles the full array from every rank's block (a
    collective over the spec's axes: every rank of the mesh calls it)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return f"Placement({self.mesh!r}, {self.spec})"

    def _split(self):
        return [(d, a) for d, a in enumerate(self.spec) if a is not None]

    def local_shape(self, shape) -> tuple:
        shape = list(shape)
        for d, a in self._split():
            n = int(self.mesh.shape[a])
            if shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does "
                                 f"not split over axis '{a}' of size {n}")
            shape[d] //= n
        return tuple(shape)

    def shard(self, full):
        """This rank's block of `full` (a view when `full` is a tensor)."""
        t = torch.as_tensor(full)
        local = self.local_shape(t.shape)
        for d, a in self._split():
            i = self.mesh.coordinate(a)
            t = t.narrow(d, i * local[d], local[d])
        return t

    def gather(self, local):
        t = local
        for d, a in self._split():
            t = _gather_dim(t, _mesh_axis(self.mesh, a), d)
        return t


def sanitize(spec, mesh):
    """`spec` with the axes `mesh` lacks dropped, or None when nothing is
    left (the JAX Model's `sanitize`: a model built with tp_axis="tp"
    but trained on a mesh without it keeps those parameters whole)."""
    if not spec:
        return None
    out = tuple(a if a is not None and a in mesh.shape else None
                for a in spec)
    return out if any(a is not None for a in out) else None


def shard_columns(mesh, axis_name) -> Placement:
    """The placement of an (in, out) weight split on the output dim."""
    return Placement(mesh, (None, axis_name))


def shard_rows(mesh, axis_name) -> Placement:
    """The placement of an (in, out) weight split on the input dim."""
    return Placement(mesh, (axis_name, None))


# ---- Megatron's f and g ---------------------------------------------------

class _F(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _psum(dy, ctx.ax), None


class _G(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, ax):
        return _psum(x, ax)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def megatron_f(x, axis_name):
    """Megatron's `f`: marks where a replicated activation enters
    column-parallel compute (dL/dx sums every shard's part)."""
    return _F.apply(x, _axis(axis_name))


def megatron_g(x, axis_name):
    """Megatron's `g`: reduces a row-parallel partial output."""
    return _G.apply(x, _axis(axis_name))


def column_parallel(x, W, axis_name, b=None):
    """x replicated, W column-sharded: y_shard = x @ W_shard (+ b_shard),
    sharded on the feature dim (feed it to row_parallel)."""
    y = x @ W
    return y + b if b is not None else y


def row_parallel(x_shard, W, axis_name, b=None):
    """x feature-sharded, W row-sharded: the full y, all-reduced over the
    axis; the bias is added once, after the reduction."""
    y = megatron_g(x_shard @ W, axis_name)
    return y + b if b is not None else y


# ---- vocab-parallel cross-entropy ----------------------------------------

def vp_ce_forward(x, t, axis_name, valid_vocab=None):
    """The forward math of Megatron's vocab-parallel cross-entropy: x
    (..., V/tp) this rank's logits slice, t global target ids. Returns
    (token-mean loss, residuals); the single source of truth of the tape
    operator (`autograd._VocabParallelSCE`) and `vocab_parallel_ce`.
    Three collectives of one value a row: the max, the sum of
    exponentials and the target's logit."""
    ax = _axis(axis_name)
    xf = x.float().reshape(-1, x.shape[-1])
    tf = t.reshape(-1).long()
    vp = xf.shape[-1]
    off = ax.index * vp
    if valid_vocab is not None:
        gcol = off + torch.arange(vp, device=xf.device)
        xf = torch.where(gcol[None, :] < valid_vocab, xf,
                         torch.full_like(xf, -float("inf")))
    m = _psum(xf.max(dim=-1).values, ax, dist.ReduceOp.MAX)
    z = torch.exp(xf - m[:, None])
    s = _psum(z.sum(dim=-1), ax)
    local = tf - off
    ok = (local >= 0) & (local < vp)
    safe = local.clamp(0, vp - 1)
    tl = torch.where(ok, xf.gather(1, safe[:, None])[:, 0],
                     torch.zeros((), dtype=xf.dtype, device=xf.device))
    tl = _psum(tl, ax)
    loss = torch.mean(torch.log(s) + m - tl)
    return loss, (z, s, safe, ok)


def vp_ce_backward(res, dy):
    """The backward: (softmax - onehot) * dy / N in fp32, flat (N,
    V/tp), this rank's columns only; no collective."""
    z, s, safe, ok = res
    n = z.shape[0]
    p = z / s[:, None]
    onehot = (torch.arange(z.shape[-1], device=z.device)[None, :]
              == safe[:, None]) & ok[:, None]
    return (p - onehot.to(p.dtype)) * (dy / n)


class _VocabParallelCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, t, ax, valid_vocab):
        loss, res = vp_ce_forward(x, t, ax, valid_vocab)
        ctx.save_for_backward(*res)
        ctx.in_shape, ctx.in_dtype = tuple(x.shape), x.dtype
        return loss

    @staticmethod
    def backward(ctx, dy):
        dx = vp_ce_backward(ctx.saved_tensors, dy)
        return (dx.to(ctx.in_dtype).reshape(ctx.in_shape), None, None,
                None)


def vocab_parallel_ce(logits_local, targets, axis_name, valid_vocab=None):
    """Token-mean softmax cross-entropy over vocab-sharded logits, with
    the hand backward of `vp_ce_backward`."""
    return _VocabParallelCE.apply(logits_local, targets, _axis(axis_name),
                                  valid_vocab)


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def tp_mlp(x, W1, b1, W2, b2, axis_name, act=None):
    """Two-layer MLP with exactly one collective: column-parallel W1, the
    activation (tanh GELU, jax.nn.gelu's default), row-parallel W2."""
    h = column_parallel(x, W1, axis_name, b1)
    h = (act or _gelu)(h)
    return row_parallel(h, W2, axis_name, b2)


__all__ = ["Placement", "column_parallel", "megatron_f", "megatron_g",
           "row_parallel", "sanitize", "shard_columns", "shard_rows",
           "tp_mlp", "vocab_parallel_ce", "vp_ce_backward", "vp_ce_forward"]
