"""Port parity, the pipeline schedules (`parallel.pipeline`) on gloo ranks
and on the loopback group against JAX (`torch_dist_worker.job_pp_fn`,
one job a world size): JAX runs the same functions in this process on 2
and 4 of its virtual CPU devices.

- tests/test_parallel_extra.py:666-718's tanh stage (d 16, n_micro 8,
  mb 4; W scaled by 0.3, b by 0.1), one stage a rank over {pp 2} and
  {pp 4}: `gpipe` and `gpipe_interleaved` (two chunks a stage, the same
  stage function on the chunk's weights) through `bcast_from_last`, with
  the gradients of the outputs' sum of squares (JAX's taken through
  `last_stage_value` outside its shard_map, as :691 does); `one_f_one_b`
  with last_fn mean((y @ w - t)^2): the loss, the last stage's outputs,
  each stage's parameter gradients, w's gradient on every rank and dx on
  stage 0. Outputs rtol and atol 2e-4, gradients 2e-3.
- Dryrun step 3's `gpipe` then `last_stage_value` (`__graft_entry__.py:
  407-427`: D 16, n_micro 4, mb 2, W scaled by 0.3, b zero) on 2 and 4
  ranks, outputs rtol and atol 2e-4.
- The same three schedules on `communicator._Loopback(2)` and `(4)`: every
  stage in this process, against JAX's, at the same tolerances.
- `pipeline_bubble_fraction`, `schedule_compute_overhead` and
  `schedule_table` equal JAX's exactly.
"""

import concurrent.futures
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from singa_tpu.parallel import make_mesh as jmake_mesh
from singa_tpu.parallel import pipeline as jpp
from torch_dist_worker import (pp_square_loss, pp_tanh_chunk, pp_tanh_stage,
                               run_job)

torch.set_num_threads(2)

N_MICRO, MB, D, V = 8, 4, 16, 2
FWD, BWD = 2e-4, 2e-3
#: the CPU cores a job's ranks share (run_job's `cpus`)
JOB_CPUS = 2


def _inputs(n):
    rng = np.random.default_rng(1)
    f = np.float32
    out = dict(Ws=rng.standard_normal((n, D, D)).astype(f) * 0.3,
               bs=rng.standard_normal((n, D)).astype(f) * 0.1,
               x=rng.standard_normal((N_MICRO, MB, D)).astype(f),
               Wi=rng.standard_normal((V, n, D, D)).astype(f) * 0.3,
               bi=rng.standard_normal((V, n, D)).astype(f) * 0.1,
               wl=rng.standard_normal((D,)).astype(f),
               tgt=rng.standard_normal((N_MICRO, MB)).astype(f))
    rng = np.random.RandomState(0)
    out.update(dry_Ws=rng.standard_normal((n, D, D)).astype(f) * 0.3,
               dry_bs=np.zeros((n, D), f),
               dry_x=rng.standard_normal((4, 2, D)).astype(f))
    return out


def _jax_stage(p, h):
    return jnp.tanh(h @ p[0] + p[1])


def _jax(n, inp):
    """JAX's results over {pp: n}: {name: per-stage (n, ...) array, or a
    global one}."""
    mesh = jmake_mesh({"pp": n})
    pp, rep = P("pp"), P()
    J = {k: jnp.asarray(v) for k, v in inp.items()}
    out = {}

    def run(body, in_specs, out_specs):
        return jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    def gp(W, b, x):
        y = jpp.last_stage_value(jpp.gpipe(_jax_stage, (W[0], b[0]), x,
                                           "pp"), "pp")
        return jnp.sum(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(
        run(gp, (pp, pp, rep), (rep, rep)), argnums=(0, 1, 2),
        has_aux=True))(J["Ws"], J["bs"], J["x"])
    out.update({"gpipe/out": y, "gpipe/dW": g[0], "gpipe/db": g[1],
                "gpipe/dx": g[2]})

    def il(W, b, x):
        fn = lambda p, h, c: jnp.tanh(h @ jnp.take(p[0], c, axis=0)[0]
                                      + jnp.take(p[1], c, axis=0)[0])
        y = jpp.last_stage_value(jpp.gpipe_interleaved(fn, (W, b), x, "pp",
                                                       V), "pp")
        return jnp.sum(y ** 2), y

    cut = P(None, "pp")
    (_, y), g = jax.jit(jax.value_and_grad(
        run(il, (cut, cut, rep), (rep, rep)), argnums=(0, 1, 2),
        has_aux=True))(J["Wi"], J["bi"], J["x"])
    out.update({"il/out": y, "il/dW": g[0], "il/db": g[1], "il/dx": g[2]})

    def fb(W, b, wl, x, t):
        lf = lambda lp, y, tt: jnp.mean((y @ lp[0] - tt) ** 2)
        loss, outs, ds, dl, dx = jpp.one_f_one_b(
            _jax_stage, lf, (W[0], b[0]), (wl,), x, t, "pp")
        return (loss[None], outs[None], ds[0][None], ds[1][None],
                dl[0][None], dx[None])

    res = jax.jit(run(fb, (pp, pp, rep, rep, rep), (pp,) * 6))(
        J["Ws"], J["bs"], J["wl"], J["x"], J["tgt"])
    out.update(dict(zip(("1f1b/loss", "1f1b/outs", "1f1b/dW", "1f1b/db",
                         "1f1b/dwl", "1f1b/dx"), res)))

    def dry(W, b, x):
        return jpp.last_stage_value(jpp.gpipe(_jax_stage, (W[0], b[0]), x,
                                              "pp"), "pp")

    out["dry3/out"] = jax.jit(run(dry, (pp, pp, rep), rep))(
        J["dry_Ws"], J["dry_bs"], J["dry_x"])
    return {k: np.asarray(v) for k, v in out.items()}


def _loopback(n, inp):
    """The port's schedules on `_Loopback(n)`, in the layout of
    the worker's results: a list of per-stage {name: array}."""
    from singa_tpu_torch.parallel import pipeline as tpp
    from singa_tpu_torch.parallel.communicator import _Loopback
    g = _Loopback(n)
    T = torch.as_tensor
    res = [{} for _ in range(n)]

    def put(name, vals):
        for r, v in zip(res, vals):
            r[name] = v.detach().numpy()

    def grads(ys, xs):
        loss = sum((y ** 2).sum() for y in ys)
        return torch.autograd.grad(loss, xs)

    for case, fn in (("gpipe", None), ("il", pp_tanh_chunk)):
        W = T(inp["Ws" if fn is None else "Wi"]).requires_grad_(True)
        b = T(inp["bs" if fn is None else "bi"]).requires_grad_(True)
        x = T(inp["x"]).requires_grad_(True)
        if fn is None:
            outs = tpp.gpipe(pp_tanh_stage, [(W[s], b[s]) for s in range(n)],
                             x, g)
        else:
            outs = tpp.gpipe_interleaved(
                fn, [(W[:, s], b[:, s]) for s in range(n)], x, g, V)
        ys = tpp.bcast_from_last(g, outs)
        put(f"{case}/out", ys)
        dW, db, dx = grads(ys, [W, b, x])
        put(f"{case}/dW", dW.unbind(0 if fn is None else 1))
        put(f"{case}/db", db.unbind(0 if fn is None else 1))
        put(f"{case}/dx", [dx] + [torch.zeros_like(dx)] * (n - 1))
    loss, outs, ds, dl, dx = tpp.one_f_one_b(
        pp_tanh_stage, pp_square_loss,
        [(T(inp["Ws"][s]), T(inp["bs"][s])) for s in range(n)],
        (T(inp["wl"]),), T(inp["x"]), T(inp["tgt"]), g)
    put("1f1b/loss", [loss] * n)
    put("1f1b/outs", outs)
    put("1f1b/dW", [d[0] for d in ds])
    put("1f1b/db", [d[1] for d in ds])
    put("1f1b/dwl", [dl[0]] * n)
    put("1f1b/dx", dx)
    put("dry3/out", tpp.last_stage_value(tpp.gpipe(
        pp_tanh_stage, [(T(inp["dry_Ws"][s]), T(inp["dry_bs"][s]))
                        for s in range(n)], T(inp["dry_x"]), g), g))
    return res


@functools.lru_cache(maxsize=None)
def _runs(world, root):
    """(JAX's results, the port's per-rank results, the loopback's) at
    `world` stages; the port's job runs while JAX computes its side."""
    inp = _inputs(world)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(run_job, "pp_fn", world, f"{root}/pp{world}", inp,
                           cpus=JOB_CPUS, forked=True)
        want = _jax(world, inp)
        loop = _loopback(world, inp)
        return want, port.result(), loop


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pp_fn"))
    return lambda world: _runs(world, root)


def _check(want, got, n, names):
    """Each name of `names` in every rank's results `got` against JAX's:
    a per-stage JAX result (leading n, or an (V, n, ...) chunk stack) by
    the rank's index, a global one whole; gpipe's dx is stage 0's, zero
    elsewhere."""
    for name in names:
        tol = FWD if name.endswith(("out", "loss", "outs")) else BWD
        ref = want[name]
        for r, res in enumerate(got):
            if name.startswith("il/d") and name != "il/dx":
                exp = ref[:, r]
            elif name.startswith("gpipe/d") and name != "gpipe/dx":
                exp = ref[r]
            elif name in ("gpipe/dx", "il/dx"):
                exp = ref if r == 0 else np.zeros_like(ref)
            elif name.startswith("1f1b/"):
                exp = ref[r]
            else:
                exp = ref
            np.testing.assert_allclose(res[name], exp, rtol=tol, atol=tol,
                                       err_msg=f"{name} stage {r}")


SCHEDULES = {
    "gpipe": ("gpipe/out", "gpipe/dW", "gpipe/db", "gpipe/dx"),
    "interleaved": ("il/out", "il/dW", "il/db", "il/dx"),
    "1f1b": ("1f1b/loss", "1f1b/outs", "1f1b/dW", "1f1b/db", "1f1b/dwl",
             "1f1b/dx"),
    "dryrun_step3": ("dry3/out",),
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("world", [2, 4])
def test_schedule_on_gloo_ranks_matches_jax(runs, world, schedule):
    want, port, _ = runs(world)
    _check(want, port, world, SCHEDULES[schedule])


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("world", [2, 4])
def test_schedule_on_the_loopback_matches_jax(runs, world, schedule):
    want, _, loop = runs(world)
    _check(want, loop, world, SCHEDULES[schedule])


def test_schedule_tables_equal_jax():
    from singa_tpu_torch.parallel import pipeline as tpp
    for n in (1, 2, 4, 8):
        for M in (0, 1, 2, 4, 7, 32):
            for V in (1, 2, 3):
                for s in ("gpipe", "1f1b", "interleaved"):
                    assert tpp.pipeline_bubble_fraction(n, M, s, V) == \
                        jpp.pipeline_bubble_fraction(n, M, s, V)
            assert tpp.schedule_table(n, M, 2) == jpp.schedule_table(n, M, 2)
    for s in ("gpipe", "1f1b", "interleaved"):
        assert tpp.schedule_compute_overhead(s) == \
            jpp.schedule_compute_overhead(s)
