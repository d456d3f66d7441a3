"""Mesh-axis collectives (counterpart of singa_tpu/parallel/communicator.py).

The reference's `Communicator` (include/singa/io/communicator.h) runs
synch / fusedSynch / synchHalf / sparsification over NCCL; the JAX
package's is a set of `lax` collectives over a bound mesh axis. Here each
verb is a `torch.distributed` collective over the axis's process group
(`Mesh.group`): NCCL on the card, gloo on the CPU. A verb takes and
returns tensors on the rank's device and leaves its input untouched. The
calls are synchronous for the caller's stream (`async_op=False`), so a
collective issued inside a CUDA-graph capture is recorded in the graph
and replays with it; `wait` has nothing left to do.

At world size 1 a communicator WITH a process group still issues every
collective through it (NCCL or gloo over one rank returns its input, so
the results are those of JAX's identity path; `all_reduce_half` rounds to
bf16 and back, where JAX's identity returns the input). Without a process
group (no mesh, or a mesh of one rank in a process that never joined a
group) every verb is the identity, as in the JAX package.

Every verb books `observe.record_comm(op, payload bytes, world_size)`
with the JAX package's payload formulas and runs inside `_comm_stamp`:
the watchdog's `collective` guard, the fault point "comm.collective"
(ctx: op) and `observe.record_comm_host`. Those hooks run once per host
run of the calling code: at every eager step, and for a CUDA-graph step
at its warm-up and its capture, never at a replay.

Known differences: `broadcast` is `dist.broadcast` from the root's global
rank (JAX's is a ppermute tree); `global_rank` and `local_rank` are the
process's real rank and device index (JAX holds 0); the sparse verbs'
scatter-add is `index_add_`, whose summation order on the card is that of
its atomics.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch
import torch.distributed as dist

from .. import distributed, observe


@contextmanager
def _comm_stamp(op: str):
    """Per-call-site stamp around one collective: the watchdog's
    `collective` deadline armed over it, the fault point
    "comm.collective" (a FaultPlan delay there simulates one slow rank,
    inside the stamped interval), and the host wall time into
    `singa_comm_host_seconds{op=...}`."""
    from .. import resilience, watchdog
    with watchdog.guard("collective", comm_op=op):
        t0 = time.perf_counter()
        resilience.fault_point("comm.collective", op=op)
        try:
            yield
        finally:
            observe.record_comm_host(op, t0, time.perf_counter() - t0)


# ---- the collective primitives ------------------------------------------
# Every torch.distributed collective of the data-, tensor-, sequence-,
# expert- and pipeline-parallel steps goes through these (the
# communicator's verbs, `parallel.tp`'s operators, the rank groups'
# transfers below (the ring's shifts, the pipeline's slots), the experts'
# all-to-all, the model's first-build sync), so a rule of the backend is
# kept in one place: NCCL takes contiguous tensors only (a tied head's
# gradient is a transposed view). None of them books anything.

def _reduce_(x, group, op=None):
    """x summed (or reduced by `op`, a `dist.ReduceOp`) over `group`'s
    ranks, in place; x must be contiguous."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return x


def _reduced(x, group, op=None):
    """x summed (or reduced by `op`) over `group`'s ranks, in a new
    contiguous tensor."""
    return _reduce_(x.detach().clone(memory_format=torch.contiguous_format),
                    group, op)


def _stacked(x, group, size: int):
    """Every rank's x stacked on a new leading axis of `size`, in group
    order."""
    x = x.detach().contiguous()
    out = torch.empty((size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(out.unbind(0)), x, group=group)
    return out


@torch.no_grad()
def _bcast_(x, group, root: int = 0):
    """The x of `group`'s rank `root` written into every member's x, in
    place; x must be contiguous."""
    dist.broadcast(x, src=dist.get_global_rank(group, int(root)),
                   group=group)
    return x


def _p2p(sends, recvs, group):
    """One batch of point-to-point transfers over `group`: `sends` is a
    list of (tensor, group rank) and `recvs` of (template, group rank);
    returns the received tensors, in `recvs`' order, each new and shaped
    like its template. Every op goes into one `batch_isend_irecv`, so a
    rank that sends to and receives from both of its neighbours in one
    step cannot deadlock against them; an empty batch makes no call."""
    ops = [dist.P2POp(dist.isend, x.detach().contiguous(),
                      dist.get_global_rank(group, int(r)), group)
           for x, r in sends]
    outs = [torch.empty(tuple(t.shape), dtype=t.dtype, device=t.device)
            for t, _ in recvs]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, int(r)),
                       group) for out, (_, r) in zip(outs, recvs)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


def _exchanged(x, group):
    """`dist.all_to_all_single` of x over `group`: block i of x's first
    dimension goes to the group's rank i, and block i of the result came
    from it, in a new contiguous tensor."""
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


# ---- rank groups ------------------------------------------------------------
# The ring attention's hops and the pipeline's slots run the ranks of a
# mesh axis in lock step over one of two groups: `_AxisRanks`, one rank a
# process, whose transfers are P2P over the axis's process group, or
# `_Loopback`, every rank of an n-rank group in this process, whose
# transfers hand a rank its neighbour's tensor: a check of a schedule on
# one device, not an API. `local` are the ranks this process runs and
# `current` the one a stage function runs for (`pipeline.stage_index`).

class _Ranks:
    """What the two groups share: `shift` over their own `exchange`."""

    def shift(self, xs):
        """`lax.ppermute` with the pairs (i, i + 1 mod n) of the local
        ranks' tensors (a list in `local` order): each rank gets the
        tensor of the rank before it. At n == 1 xs itself, and no
        call."""
        if self.n == 1:
            return list(xs)
        got, _ = self.exchange(dict(zip(self.local, xs)), {}, self.local,
                               (), xs[0])
        return [got[r] for r in self.local]


class _AxisRanks(_Ranks):
    """The ranks of a bound mesh axis (`parallel.tp._Axis`), one a
    process: this process runs the rank at its index."""

    def __init__(self, ax):
        self.ax = ax
        self.n = ax.size
        self.local = (ax.index,)
        self.current = ax.index

    def exchange(self, fwd, bwd, recv_fwd, recv_bwd, like):
        """One step's transfers: `fwd` {rank: tensor} goes to rank + 1
        and `bwd` to rank - 1 (mod n); the ranks in `recv_fwd` take rank
        - 1's tensor and those in `recv_bwd` rank + 1's, each shaped like
        `like`. Returns ({rank: from rank - 1}, {rank: from rank + 1});
        the four directions in one `_p2p` batch (none at all when nothing
        moves: torch refuses a send to one's own rank)."""
        i, n = self.ax.index, self.n
        sends = [(t, (i + 1) % n) for t in fwd.values()]
        sends += [(t, (i - 1) % n) for t in bwd.values()]
        recvs = [(like, (i - 1) % n) for _ in recv_fwd]
        recvs += [(like, (i + 1) % n) for _ in recv_bwd]
        got = _p2p(sends, recvs, self.ax.group)
        k = len(recv_fwd)
        return dict(zip(recv_fwd, got[:k])), dict(zip(recv_bwd, got[k:]))

    def psum(self, x):
        """x summed over the axis, in a new tensor (x itself at n == 1)."""
        return x if self.n == 1 else _reduced(x, self.ax.group)


class _Loopback(_Ranks):
    """Every rank of an n-rank group in this process: a transfer hands
    rank r the tensor of rank r - 1 (forward) or r + 1 (backward), as
    the axis's P2P does."""

    def __init__(self, n: int):
        self.n = int(n)
        self.local = tuple(range(self.n))
        self.current = 0

    def exchange(self, fwd, bwd, recv_fwd, recv_bwd, like):
        n = self.n
        return ({r: fwd[(r - 1) % n] for r in recv_fwd},
                {r: bwd[(r + 1) % n] for r in recv_bwd})


def _payload_bytes(x) -> int:
    return int(x.numel()) * x.element_size()


class Communicator:
    """`axis` is one mesh axis name or a TUPLE of names (the collective
    runs over their product group, e.g. ("data", "ep")). `world_size` is
    the product of the axes' sizes; `group` the process group (None:
    every verb is the identity)."""

    def __init__(self, axis="data", mesh=None):
        self.axis = axis
        self.mesh = mesh
        axes = axis if isinstance(axis, tuple) else (axis,)
        self.world_size = 1
        if mesh is not None:
            for a in axes:
                self.world_size *= int(mesh.shape[a])
        self.group = mesh.group(axis) if mesh is not None else None
        if self.group is None and self.world_size > 1:
            raise ValueError(
                f"a mesh of {self.world_size} ranks over {axis!r} needs a "
                "process group: call distributed.init() first")
        # parity attributes (communicator.h): this process's real ranks
        self.global_rank = distributed.process_index()
        self.local_rank = torch.cuda.current_device() \
            if distributed.device_type() == "cuda" else self.global_rank

    @property
    def device(self) -> torch.device:
        return self.mesh.device if self.mesh is not None \
            else torch.device("cpu")

    def rank(self):
        """This rank's index over the axis (row-major over tuple axes), a
        0-d int32 tensor on the rank's device."""
        return torch.tensor(self._rank_index(), dtype=torch.int32,
                            device=self.device)

    def _rank_index(self) -> int:
        idx = 0
        if self.group is not None:
            for a in (self.axis if isinstance(self.axis, tuple)
                      else (self.axis,)):
                idx = idx * int(self.mesh.shape[a]) \
                    + self.mesh.coordinate(a)
        return idx

    # -- unbooked helpers of the data-parallel step (the JAX package's
    # pmean / all_gather / device_put there are not communicator calls)
    def _sum(self, x):
        """The sum of x over the ranks, in a new tensor."""
        return _reduced(x, self.group)

    def _mean(self, x):
        """The mean of x over the ranks (JAX's pmean)."""
        return self._sum(x) / self.world_size

    @torch.no_grad()
    def _mean_(self, x):
        """x averaged over the ranks, in place."""
        _reduce_(x, self.group)
        x.div_(self.world_size)

    def _broadcast_(self, x, root=0):
        """The root's x written into every rank's x, in place."""
        return _bcast_(x, self.group, root)

    # -- synch / fusedSynch (communicator.cc:212-327) ----------------------
    def all_reduce(self, x):
        """Sum over the axis (reference `synch`)."""
        observe.record_comm("all_reduce", _payload_bytes(x),
                            self.world_size)
        with _comm_stamp("all_reduce"):
            if self.group is None:
                return x
            return self._sum(x)

    # -- synchHalf (communicator.cc:330-467) -------------------------------
    def all_reduce_half(self, x):
        """Halved-width all-reduce: bf16 on the wire (fp16 in the
        reference), the sum back in x's dtype."""
        observe.record_comm("all_reduce_half", 2 * int(x.numel()),
                            self.world_size)
        with _comm_stamp("all_reduce_half"):
            if self.group is None:
                return x
            y = x.detach().to(torch.bfloat16, copy=True,
                              memory_format=torch.contiguous_format)
            return _reduce_(y, self.group).to(x.dtype)

    def all_gather(self, x, tiled=True):
        """Every rank's x stacked on a new leading axis, or (tiled)
        concatenated along axis 0."""
        observe.record_comm("all_gather", _payload_bytes(x),
                            self.world_size)
        with _comm_stamp("all_gather"):
            if self.group is None:
                return x
            return self._gather(x, tiled)

    def _gather(self, x, tiled=False):
        out = _stacked(x, self.group, self.world_size)
        if tiled and x.dim() > 0:
            return out.reshape((-1,) + tuple(x.shape[1:]))
        return out

    def broadcast(self, x, root=0):
        """The root's x on every rank (`dist.broadcast` from the root's
        global rank; only the root's value is read)."""
        observe.record_comm("broadcast", _payload_bytes(x),
                            self.world_size)
        with _comm_stamp("broadcast"):
            if self.group is None:
                return x
            if isinstance(self.axis, tuple):
                raise ValueError("broadcast over a tuple axis is "
                                 "ambiguous; pick one axis")
            return self._broadcast_(
                x.detach().clone(memory_format=torch.contiguous_format), root)

    def reduce_scatter(self, x):
        """The sum over the axis, scattered along axis 0 (tiled): rank r
        gets rows [r n / world, (r + 1) n / world) of the sum."""
        observe.record_comm("reduce_scatter", _payload_bytes(x),
                            self.world_size)
        with _comm_stamp("reduce_scatter"):
            if self.group is None:
                return x
            if x.shape[0] % self.world_size:
                raise ValueError(
                    f"reduce_scatter: axis 0 of {tuple(x.shape)} does not "
                    f"split over {self.world_size} ranks")
            parts = [p.contiguous() for p in
                     x.detach().chunk(self.world_size, dim=0)]
            out = torch.empty_like(parts[0])
            dist.reduce_scatter(out, parts, group=self.group)
            return out

    def all_reduce_max(self, x):
        """Max over the axis (the health layer's non-finite counts: a sum
        would inflate a replicated count world_size-fold)."""
        observe.record_comm("all_reduce_max", _payload_bytes(x),
                            self.world_size)
        with _comm_stamp("all_reduce_max"):
            if self.group is None:
                return x
            return _reduced(x, self.group, dist.ReduceOp.MAX)

    def agree_any(self, flag):
        """Cross-rank OR of a predicate (a sum of its 0/1 int32 value), a
        0-d bool tensor that is the same on every rank: a health policy
        fires on all of them in the same step. 4 bytes on the wire."""
        observe.record_comm("agree_any", 4, self.world_size)
        with _comm_stamp("agree_any"):
            dev = flag.device if torch.is_tensor(flag) else self.device
            f = torch.as_tensor(flag, device=dev).to(torch.int32, copy=True)
            if self.group is not None:
                _reduce_(f, self.group)
            return f > 0

    def wait(self):
        """Stream fence (communicator.cc:169-186): nothing to do, every
        verb is ordered on the caller's stream when it returns."""

    # -- sparsification (communicator.cc:619-807) --------------------------
    def sparse_all_reduce_topk(self, x, frac: float):
        """Top-K sparsified all-reduce: each rank sends its k = n * frac
        largest-magnitude entries as (int32 index, value) pairs (an
        all-gather of 2 k world elements instead of n), then one
        scatter-add. Returns (summed dense, residual for error
        feedback)."""
        flat = x.reshape(-1)
        n = flat.numel()
        k = max(1, int(n * float(frac)))
        observe.record_comm("sparse_all_reduce_topk",
                            k * (4 + x.element_size()), self.world_size)
        with _comm_stamp("sparse_all_reduce_topk"):
            idx = torch.topk(flat.abs(), k).indices
            vals = flat[idx]
            residual = flat.index_fill(0, idx, 0.0).reshape(x.shape)
            if self.group is None:
                out = torch.zeros_like(flat).index_add_(0, idx, vals)
                return out.reshape(x.shape), residual
            gidx = self._gather(idx.to(torch.int32))   # (world, k)
            gvals = self._gather(vals)                 # (world, k)
            out = torch.zeros_like(flat).index_add_(0, gidx.reshape(-1),
                                                    gvals.reshape(-1))
            return out.reshape(x.shape), residual

    def sparse_all_reduce_threshold(self, x, threshold: float,
                                    capacity_frac: float = 0.1):
        """Threshold-sparsified all-reduce with a static capacity
        (`valSparsAllReduce`, communicator.cc:619-719): each rank packs up
        to cap = n * capacity_frac of its largest entries at or above the
        threshold, all-gathers 2 cap elements and scatter-adds; entries
        past the capacity stay in the residual, as sub-threshold ones do.
        Returns (summed dense, residual for error feedback)."""
        flat = x.reshape(-1)
        n = flat.numel()
        cap = max(1, min(n, int(n * float(capacity_frac))))
        observe.record_comm("sparse_all_reduce_threshold",
                            cap * (4 + x.element_size()), self.world_size)
        with _comm_stamp("sparse_all_reduce_threshold"):
            absx = flat.abs()
            score = torch.where(absx >= threshold, absx,
                                torch.full_like(absx, -float("inf")))
            idx = torch.topk(score, cap).indices
            taken = score[idx] > -float("inf")
            vals = torch.where(taken, flat[idx], torch.zeros_like(flat[idx]))
            idx_safe = torch.where(taken, idx, torch.zeros_like(idx))
            sent = torch.zeros_like(flat).index_add_(0, idx_safe, vals)
            residual = (flat - sent).reshape(x.shape)
            if self.group is None:
                return sent.reshape(x.shape), residual
            gidx = self._gather(idx_safe.to(torch.int32))   # (world, cap)
            gvals = self._gather(vals)                      # (world, cap)
            out = torch.zeros_like(flat).index_add_(0, gidx.reshape(-1),
                                                    gvals.reshape(-1))
            return out.reshape(x.shape), residual


__all__ = ["Communicator"]
