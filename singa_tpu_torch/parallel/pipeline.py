"""Pipeline parallelism (counterpart of singa_tpu/parallel/pipeline.py):
GPipe, its interleaved form and 1F1B over the stages of a mesh axis.

The JAX functions run inside a shard_map body: every device holds one
stage's parameters, a schedule is one `lax.scan` over slots whose
activations ride a `lax.ppermute` ring, and `jax.grad` differentiates the
scan. Here each stage is a process (the axis bound by `Mesh.bind()`, or
by the graph-mode step of a model whose DistOpt's mesh carries it), a
schedule is a Python loop over the same slots, and the ring is point to
point over the axis's process group (`_AxisRanks.exchange`, one
`batch_isend_irecv` a slot). A stage runs only the slots where it has
work, and sends and receives only what a neighbour consumes.

GPipe and the interleaved schedule are differentiable: torch's autograd
runs through the loop, and the shift that carries the activations is a
`torch.autograd.Function` (`_Shift`) whose backward is the shift the
other way, what `lax.ppermute` transposes to. Autograd sees only this
process's graph, so a stage's shifts are chained by an empty token into
its outputs (`_Token`, `_Tie`): every shift's backward runs, in reverse
slot order, on every stage, and meets its neighbours' transfers. Every
stage must therefore backpropagate through the outputs (`bcast_from_last`
gives the stages that are not last a zero cotangent). 1F1B computes its
gradients inside the schedule, as JAX's does, by `torch.autograd.grad`
of each slot's rematerialized stage.

Stage groups are `parallel.communicator`'s rank groups, as the ring
attention's: `axis_name` is a mesh axis name (`_AxisRanks`: one stage a
process), or a `_Loopback(n)`, every stage of an n-stage pipeline in this
process, whose transfers hand stage s the tensor of stage s - 1 (or
s + 1): a check of the schedules on one device, not an API. With a
loopback group `stage_params` is the list of the stages' parameters, and
a result that is per stage (outputs, stage gradients, dx) is the list of
the stages'.
A stage function reads its stage with `stage_index(axis_name)` (JAX's
`lax.axis_index`).

Known differences: the warm-up and drain slots are skipped (JAX computes
them and masks the results), and so is 1F1B's `last_fn` on every stage
but the last (JAX runs it in every slot on every stage and gates the
result); `pipeline_bubble_fraction`, `schedule_compute_overhead` and
`schedule_table` keep JAX's formulas, which count the slots JAX runs. At
an axis of size 1 no transfer or reduction is issued (each is the
identity there).
"""

from __future__ import annotations

import torch

from .communicator import _AxisRanks, _Loopback


def _group(axis_name):
    """(stage group, is a loopback) of `axis_name`."""
    if isinstance(axis_name, _Loopback):
        return axis_name, True
    from .tp import _axis
    return _AxisRanks(_axis(axis_name)), False


def stage_index(axis_name) -> int:
    """The stage a stage function runs for: the bound axis's index
    (`lax.axis_index`), or a loopback group's current stage."""
    if isinstance(axis_name, (_AxisRanks, _Loopback)):
        return axis_name.current
    from .mesh import axis_index
    return axis_index(axis_name)


def _per_stage(stages, loop, value):
    """{stage: value}: a loopback's list by stage, else this process's."""
    if loop:
        if len(value) != stages.n:
            raise ValueError(f"a loopback of {stages.n} stages takes "
                             f"{stages.n} stage parameter sets, got "
                             f"{len(value)}")
        return dict(enumerate(value))
    return {stages.local[0]: value}


def _result(stages, loop, by_stage):
    """A per-stage result as the caller takes it: the loopback's list,
    else this process's value."""
    return [by_stage[s] for s in stages.local] if loop \
        else by_stage[stages.local[0]]


def _leaves(tree) -> list:
    """The tensors of a (nested) list or tuple of tensors, in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _leaves(item)]
    return []


def _rebuild(tree, it):
    """`tree` with each tensor replaced by the next of iterator `it`."""
    if torch.is_tensor(tree):
        return next(it)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(item, it) for item in tree)
    return tree


# ---- the differentiable shift -----------------------------------------------

class _Token(torch.autograd.Function):
    """An empty tensor on the tape made from `anchors`, every input of the
    schedule that requires grad: the head of a stage's chain of shifts.
    The chain leads to each of them, so a backward that asks for the
    gradient of any one (`torch.autograd.grad(..., inputs)` runs only the
    nodes on the way to its inputs) runs every shift."""

    @staticmethod
    def forward(ctx, *anchors):
        ctx.n = len(anchors)
        return anchors[0].new_zeros(0)

    @staticmethod
    def backward(ctx, d):
        return (None,) * ctx.n


class _Tie(torch.autograd.Function):
    """x, with the chain's token as a second input: backpropagating
    through x runs the backward of every shift of the chain."""

    @staticmethod
    def forward(ctx, x, token):
        return x.clone()

    @staticmethod
    def backward(ctx, dx):
        return dx, dx.new_zeros(0)


class _Shift(torch.autograd.Function):
    """One slot's forward transfer of an axis stage (`_AxisRanks`) on the
    tape: `y` to stage + 1 (when `send`), stage - 1's tensor received
    (when `recv`, else an empty tensor). The backward is the transfer the
    other way: the received tensor's cotangent back to stage - 1, y's
    from stage + 1. The token in and out orders the shifts."""

    @staticmethod
    def forward(ctx, token, y, stages, send, recv, like):
        ctx.stages, ctx.send, ctx.recv, ctx.like = stages, send, recv, like
        i = stages.local[0]
        got, _ = stages.exchange({i: y} if send else {}, {},
                                 (i,) if recv else (), (), like)
        return token.new_zeros(0), got[i] if recv else token.new_zeros(0)

    @staticmethod
    def backward(ctx, dtoken, dbuf):
        i = ctx.stages.local[0]
        _, got = ctx.stages.exchange({}, {i: dbuf} if ctx.recv else {}, (),
                                     (i,) if ctx.send else (), ctx.like)
        return dtoken, got.get(i), None, None, None, None


def _chain_head(stages, loop, x_micro, params):
    """The token that chains an axis stage's shifts on the tape, or None
    (a loopback's shifts are in this process's graph already; nothing
    requires grad; grad mode is off)."""
    if loop or not torch.is_grad_enabled():
        return None
    anchors = [t for t in [x_micro, *_leaves(list(params.values()))]
               if t.requires_grad]
    return _Token.apply(*anchors) if anchors else None


# ---- GPipe and the interleaved schedule -------------------------------------

def _takes(plan, s, t) -> bool:
    """Whether stage s consumes its neighbour's activation at slot t."""
    job = plan(s, t)
    return job is not None and not job[2]


def _gpipe_loop(stages, loop, fn, params, x_micro, n_slots, plan,
                with_aux):
    """The slots of a GPipe-style schedule. `plan(s, t)` is None (stage s
    idles at slot t) or (microbatch, chunk, takes the input, final);
    `fn(params, x, chunk)` runs a stage. Returns ({stage: outputs},
    {stage: aux sum}); a stage that writes no output holds zeros."""
    n, M = stages.n, x_micro.shape[0]
    like = x_micro[0]
    token = _chain_head(stages, loop, x_micro, params)
    outs = {s: [None] * M for s in stages.local}
    aux = {s: None for s in stages.local}
    buf = {}
    for t in range(n_slots):
        ys = {}
        for s in stages.local:
            job = plan(s, t)
            if job is None:
                continue
            m, c, first, final = job
            inp = x_micro[m] if first else buf.pop(s)
            stages.current = s
            r = fn(params[s], inp, c)
            y, a = r if with_aux else (r, None)
            y = y.to(like.dtype)
            if with_aux:
                aux[s] = a if aux[s] is None else aux[s] + a
            if final:
                outs[s][m] = y
            ys[s] = y
        recv = [s for s in stages.local if _takes(plan, s, t + 1)]
        send = {s: y for s, y in ys.items()
                if _takes(plan, (s + 1) % n, t + 1)}
        if token is None:
            buf = stages.exchange(send, {}, recv, (), like)[0]
        else:
            i = stages.local[0]
            token, got = _Shift.apply(token, send.get(i), stages,
                                      i in send, bool(recv), like)
            buf = {i: got} if recv else {}
    res = {}
    for s in stages.local:
        o = torch.stack(outs[s]) if outs[s][0] is not None \
            else torch.zeros_like(x_micro)
        res[s] = o if token is None else _Tie.apply(o, token)
    return res, aux


def gpipe(stage_fn, stage_params, x_micro, axis_name, with_aux=False):
    """Run the pipeline.

    stage_fn(params, x) -> y: one stage's computation; the activation
    shape is the same for every stage (the classic GPipe constraint).
    With `with_aux` it returns (y, aux), aux a fixed-shape tensor of
    per-stage scalars (the MoE router losses), summed over this stage's
    working slots only.
    stage_params: this stage's parameters (a list of loopback stages'
    parameter lists for a `_Loopback`).
    x_micro: (n_micro, mb, ...) microbatches, the same value on every
    stage (only stage 0 reads them).
    Returns the (n_micro, mb, ...) outputs, valid on the LAST stage and
    zeros elsewhere (`last_stage_value` / `bcast_from_last` on the
    caller's side); with `with_aux`, (outputs, this stage's aux sum)."""
    stages, loop = _group(axis_name)
    n, M = stages.n, x_micro.shape[0]

    def plan(s, t):
        m = t - s
        return (m, 0, s == 0, s == n - 1) if 0 <= m < M else None

    outs, aux = _gpipe_loop(stages, loop, lambda p, x, c: stage_fn(p, x),
                            _per_stage(stages, loop, stage_params), x_micro,
                            M + n - 1, plan, with_aux)
    outs = _result(stages, loop, outs)
    return (outs, _result(stages, loop, aux)) if with_aux else outs


def gpipe_interleaved(chunk_fn, stage_params, x_micro, axis_name,
                      n_chunks):
    """Interleaved (virtual-stage) GPipe: each stage holds `n_chunks`
    model chunks assigned round-robin (stage d owns the global stages
    {c n + d : c < n_chunks}), so the activations make n_chunks passes
    around the same d -> d + 1 ring, and each warm-up or drain slot costs
    1 / n_chunks of a stage's model.

    The closed-form schedule: microbatch m = q n + r runs chunk c on
    stage d at slot t = (q V + c) n + r + d; every hop, the wrap from
    stage n - 1 to chunk c + 1 on stage 0 included, lands at t + 1.

    chunk_fn(params, x, c) -> y applies this stage's chunk c. Returns the
    (n_micro, mb, ...) outputs, valid on the last stage (the holder of
    the final chunk's final stage)."""
    stages, loop = _group(axis_name)
    n, M, V = stages.n, x_micro.shape[0], n_chunks
    Q = -(-M // n)
    T = ((Q - 1) * V + (V - 1)) * n + 2 * (n - 1) + 1

    def plan(d, t):
        u = t - d
        if u < 0:
            return None
        j, r = divmod(u, n)
        q, c = divmod(j, V)
        m = q * n + r
        if m >= M:
            return None
        return m, c, c * n + d == 0, c == V - 1 and d == n - 1

    outs, _ = _gpipe_loop(stages, loop, chunk_fn,
                          _per_stage(stages, loop, stage_params), x_micro,
                          T, plan, False)
    return _result(stages, loop, outs)


# ---- 1F1B -------------------------------------------------------------------

def _grad_leaves(tree):
    """`tree` with each tensor a new leaf of the same values that
    requires grad, and the flat list of those leaves."""
    flat = [t.detach().requires_grad_(t.is_floating_point())
            for t in _leaves(tree)]
    return _rebuild(tree, iter(flat)), flat


def _accumulate(acc, grads, flat):
    """acc (a list, or None) plus grads (None: zero) of the tensors of
    `flat`."""
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, flat)]
    if acc is None:
        return grads
    return [a + g for a, g in zip(acc, grads)]


def one_f_one_b(stage_fn, last_fn, stage_params, last_params, x_micro,
                tgt_micro, axis_name):
    """The 1F1B schedule, forward and backward in one pass over the slots
    (Megatron's memory-bounded pipeline):

        t_fwd(stage s, microbatch m) = s + m
        t_bwd(stage s, microbatch m) = 2n - 1 - s + m

    so in steady state every slot does one forward and one backward, the
    cotangents travel against the activations, and a stage holds at most
    2(n - s) - 1 <= 2n - 1 saved stage inputs, whatever n_micro. Only the
    stage INPUT is saved; the stage is recomputed when the cotangent
    arrives (its forward half runs without a graph).

    The loss lives inside the schedule: the last stage applies
    `last_fn(last_params, y, tgt)` (final LN, head and CE for a GPT) and
    seeds the cotangent with 1 / n_micro.

    Returns (loss_mean, outs, d_stage_params, d_last_params, dx_micro):
      loss_mean      the mean over the microbatches, on every stage
      outs           (n_micro, mb, ...) last-stage activations (the
                     caller-facing logits path), valid on the last stage
      d_stage_params this stage's parameter cotangents, as stage_params
      d_last_params  last_fn's parameter cotangents, summed over the
                     axis (so replicated parameters see replicated grads)
      dx_micro       the cotangent of x_micro, nonzero on stage 0 (the
                     model's tp_copy on the pipeline input sums it)
    None of them carries a graph."""
    stages, loop = _group(axis_name)
    n, M = stages.n, x_micro.shape[0]
    T = M + 2 * n - 2
    last = n - 1
    like = x_micro[0]
    params = _per_stage(stages, loop, stage_params)
    leaves = {s: _grad_leaves(p) for s, p in params.items()}
    lp, lp_flat = _grad_leaves(last_params)
    d_stage = {s: None for s in stages.local}
    d_last = None
    loss_acc = torch.zeros((), dtype=torch.float32, device=x_micro.device)
    outs = {s: torch.zeros_like(x_micro) for s in stages.local}
    dx = {s: torch.zeros_like(x_micro) for s in stages.local}
    saved = {s: {} for s in stages.local}
    fwd_buf, bwd_buf = {}, {}
    scale = 1.0 / M
    for t in range(T + 1):
        f_send, b_send = {}, {}
        for s in stages.local:
            # the saved input of the backward's microbatch is taken before
            # the forward half stores its own
            m_b = t - (2 * n - 1 - s)
            x_saved = saved[s].pop(m_b) if 0 <= m_b < M else None
            m_f = t - s
            stages.current = s
            sp, flat = leaves[s]
            if 0 <= m_f < M:
                x_in = x_micro[m_f] if s == 0 else fwd_buf.pop(s)
                with torch.no_grad():
                    y = stage_fn(sp, x_in).to(like.dtype)
                saved[s][m_f] = x_in
                if s == last:
                    outs[s][m_f] = y
                else:
                    f_send[s] = y
            if x_saved is None:
                continue
            with torch.enable_grad():
                xl = x_saved.detach().requires_grad_()
                y_b = stage_fn(sp, xl)
                if s == last:
                    yl = y_b.detach().requires_grad_()
                    loss_m = last_fn(lp, yl, tgt_micro[m_b])
                    g = torch.autograd.grad(
                        loss_m, [yl] + lp_flat,
                        torch.full_like(loss_m, scale), allow_unused=True)
                    dy = g[0]
                    d_last = _accumulate(d_last, g[1:], lp_flat)
                    loss_acc = loss_acc + loss_m.detach().float() * scale
                else:
                    dy = bwd_buf.pop(s)
                g = torch.autograd.grad(y_b, [xl] + flat, dy.to(y_b.dtype),
                                        allow_unused=True)
            d_stage[s] = _accumulate(d_stage[s], g[1:], flat)
            dx_m = torch.zeros_like(xl) if g[0] is None else g[0]
            if s == 0:
                dx[s][m_b] = dx_m.to(like.dtype)
            else:
                b_send[s] = dx_m.to(like.dtype)
        recv_f = [s for s in stages.local if s > 0 and 0 <= t + 1 - s < M]
        recv_b = [s for s in stages.local
                  if s < last and 0 <= t + 1 - (2 * n - 1 - s) < M]
        got_f, got_b = stages.exchange(f_send, b_send, recv_f, recv_b, like)
        fwd_buf.update(got_f)
        bwd_buf.update(got_b)
    if d_last is None:
        d_last = [torch.zeros_like(p) for p in lp_flat]
    if loop:
        loss_mean = loss_acc
    else:
        loss_mean = stages.psum(loss_acc)   # zero but on the last stage
        d_last = [stages.psum(g) for g in d_last]
    d_stage = {s: _rebuild(params[s], iter(
        g if g is not None else [torch.zeros_like(p) for p in leaves[s][1]]))
        for s, g in d_stage.items()}
    return (loss_mean, _result(stages, loop, outs),
            _result(stages, loop, d_stage),
            _rebuild(last_params, iter(d_last)), _result(stages, loop, dx))


# ---- the schedules' accounting (JAX's formulas) -----------------------------

def pipeline_bubble_fraction(n_stages: int, n_micro: int,
                             schedule: str = "gpipe",
                             n_chunks: int = 2) -> float:
    """Idle fraction of the pipeline schedule, as JAX's scan runs it.

    gpipe: (n-1) warm-up and (n-1) drain slots around n_micro useful
    slots -> (n-1)/(n_micro+n-1).
    1f1b: n_micro + 2n - 1 slots, n_micro of them useful ->
    (2n-1)/(n_micro+2n-1): worse than gpipe at equal n_micro; 1f1b's win
    is the O(n) bound on in-flight activations.
    interleaved: V*n_micro useful chunk-slots out of
    T = ((ceil(M/n)-1)*V + V-1)*n + 2(n-1) + 1."""
    n, M, V = n_stages, n_micro, n_chunks
    if n <= 1 or M <= 0:
        return 0.0
    if schedule == "1f1b":
        return (2 * n - 1) / (M + 2 * n - 1)
    if schedule == "interleaved":
        Q = -(-M // n)
        T = ((Q - 1) * V + (V - 1)) * n + 2 * (n - 1) + 1
        return 1.0 - (V * M) / T
    return (n - 1) / (M + n - 1)


def schedule_compute_overhead(schedule: str) -> float:
    """Per-microbatch compute relative to gpipe's forward and backward
    (1 forward + 2 backward = 3 units): 1f1b recomputes the stage forward
    from the saved stage input, 4/3; gpipe and interleaved 1.0."""
    return 4.0 / 3.0 if schedule == "1f1b" else 1.0


def schedule_table(n_stages: int, n_micro: int, n_chunks: int = 2):
    """Rows of (schedule, bubble_fraction, compute_overhead,
    inflight_activation_sets)."""
    n, M = n_stages, n_micro
    return [
        ("gpipe", pipeline_bubble_fraction(n, M, "gpipe"), 1.0,
         f"O(M)={M}"),
        ("1f1b", pipeline_bubble_fraction(n, M, "1f1b"),
         schedule_compute_overhead("1f1b"), f"O(n)={min(2 * n, M)}"),
        (f"interleaved x{n_chunks}",
         pipeline_bubble_fraction(n, M, "interleaved", n_chunks), 1.0,
         f"O(M)={M}"),
    ]


# ---- the last stage's value on every stage ----------------------------------

class _LastValue(torch.autograd.Function):
    """psum(x * mask) over the axis, mask = (stage == n - 1). `own`
    selects the backward: JAX's psum transpose (psum(dy) * mask), or
    `bcast_from_last`'s per-stage rule (dy * mask)."""

    @staticmethod
    def forward(ctx, x, stages, own):
        ctx.stages, ctx.own = stages, own
        ctx.is_last = stages.local[0] == stages.n - 1
        return stages.psum(x if ctx.is_last else torch.zeros_like(x))

    @staticmethod
    def backward(ctx, dy):
        if not ctx.own:
            dy = ctx.stages.psum(dy)
        return (dy if ctx.is_last else torch.zeros_like(dy)), None, None


def last_stage_value(x, axis_name):
    """The last stage's value on every stage: the psum of a one-hot mask
    (cheap for a loss or small outputs). A loopback group takes and
    returns the stages' list."""
    stages, loop = _group(axis_name)
    if loop:
        return [x[-1]] * stages.n
    return _LastValue.apply(x, stages, False)


def bcast_from_last(axis_name, x):
    """last_stage_value with the per-stage backward of a tape operator
    differentiated inside the step: dy * mask (only the last stage's
    input made the value), where psum's transpose would scale the
    cotangent by the axis size."""
    stages, loop = _group(axis_name)
    if loop:
        n = stages.n
        return [x[-1] if s == n - 1 else x[-1].detach() for s in range(n)]
    return _LastValue.apply(x, stages, True)


__all__ = ["bcast_from_last", "gpipe", "gpipe_interleaved",
           "last_stage_value", "one_f_one_b", "pipeline_bubble_fraction",
           "schedule_compute_overhead", "schedule_table", "stage_index"]
