"""Port parity, sequence parallelism on gloo ranks against JAX
(`torch_dist_worker.job_sp`, one job a world size, a module fixture):
the port's ranks hold their blocks of the sequence; JAX runs the same
functions in this process on 2 and 4 of its virtual CPU devices.

- `ring_attention` over {sp 2} and {sp 4} (tests/test_attention.py:60-95's
  (1, 2, 64, 16) inputs, causal and not): each rank's output block and
  the gradients of sum(o^2) against JAX's `ring_attention_sharded` over
  {sp 4} and the gradients of sum(o^2) through it, rtol and atol 2e-4
  forward and 2e-3 for the gradients; `ring_attention_sharded` on the global
  arrays, its output and the gradients of its global inputs, alike.
- The sequence-sharded GPT forward (tests/test_attention.py:234-300:
  learned positions, RoPE, GQA; one layer, dim 32, S 32) from JAX's
  weights against JAX's serial forward, rtol and atol 2e-3 as JAX's own
  tests hold its sharded forward. JAX's GPTs run their attention through
  its plain reference (`jax_plain_attention`).
- Dryrun step 2 (`__graft_entry__.py:187-244`) on {data 1, sp 2}, {data
  1, sp 4} and {data 2, sp 2}: under the bound mesh each rank takes its
  (data, sp) block of ids and targets, runs the forward on the tape and
  `autograd.gradients`, averages gradients and loss over data, then sp,
  and takes an SGD(0.05) step. The GPT has max_seq 32 on every mesh
  (the dryrun's is S; the rows past S are not read), so one set of
  JAX's initial weights serves the three. The loss rtol 1e-5, the
  parameters atol 1e-5, every rank alike.
"""

import concurrent.futures
import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import models as jmodels
from singa_tpu import tensor as jt
from singa_tpu.ops import attention as jatt
from singa_tpu.parallel import make_mesh as jmake_mesh
from torch_dist_worker import (SP_DRY_GPT, SP_GPT, run_job, sp_dry_data,
                               sp_dry_meshes)

torch.set_num_threads(2)


@contextlib.contextmanager
def jax_plain_attention():
    """JAX's attention through its plain reference (its dispatch with
    Pallas off), as its tests may run it on the CPU: the GPTs' runs here
    spend most of their time in the Pallas kernels' interpret mode
    otherwise. The rings are held against JAX's own ring."""
    prev = jatt._HAS_PALLAS
    jatt._HAS_PALLAS = False
    try:
        yield
    finally:
        jatt._HAS_PALLAS = prev


@contextlib.contextmanager
def jax_rng_kept():
    """JAX's default device's random key as it was before the block: the
    models built here draw from it, and a later test in the same worker
    process may depend on where it stands."""
    dev = jdevice.get_default_device()
    key = dev.rng_state
    try:
        yield
    finally:
        dev.rng_state = key


def ring_inputs():
    """tests/test_attention.py:66's (1, 2, 64, 16) q, k, v."""
    rng = np.random.default_rng(3)
    return [rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
            for _ in range(3)]


@functools.lru_cache(maxsize=None)
def jax_ring(causal):
    """JAX's global `ring_attention_sharded` output over {sp 4} on
    `ring_inputs()` and the gradients of sum(o^2) through it
    (tests/test_attention.py:60-95), in one jitted call: (out, [dq, dk,
    dv])."""
    mesh = jmake_mesh({"sp": 4})

    @jax.jit
    def run(q, k, v):
        o, vjp = jax.vjp(lambda *a: jatt.ring_attention_sharded(
            *a, mesh, "sp", causal), q, k, v)
        return o, vjp(2 * o)

    out, grads = run(*(jnp.asarray(t) for t in ring_inputs()))
    return np.asarray(out), [np.asarray(g) for g in grads]


GPT_IDS = np.random.RandomState(3).randint(0, 50, (2, 32)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_gpt(case):
    """JAX's GPT of SP_GPT[case] on GPT_IDS, built (seq axis unbound: the
    serial path): (model, ids Tensor, initial weights)."""
    dev = jdevice.get_default_device()
    m = jmodels.create_model("gpt", **SP_GPT[case])
    tx = jt.from_numpy(GPT_IDS, dev)
    m.compile([tx], is_train=False, use_graph=False)
    m.eval()
    return m, tx, {k: jt.to_numpy(v).copy()
                   for k, v in m.get_params().items()}


@functools.lru_cache(maxsize=None)
def _jax_logits(case):
    m, tx, _ = _jax_gpt(case)
    return m.forward(tx).numpy()


@functools.lru_cache(maxsize=None)
def _jax_dry_gpt():
    """Dryrun step 2's GPT in JAX (SP_DRY_GPT), initialized on GPT_IDS
    (shapes this process's JAX has run already): (model, initial
    weights by name)."""
    dev = jdevice.get_default_device()
    g = jmodels.create_model("gpt", **SP_DRY_GPT)
    prev = jag.training
    jag.training = False
    try:
        g.forward(jt.from_numpy(GPT_IDS, device=dev))
    finally:
        jag.training = prev
    return g, {k: jt.to_numpy(v).copy() for k, v in g.get_params().items()}


def _jax_dry2(shape, ids, tgt):
    """Dryrun step 2 in JAX (`__graft_entry__.py:198-240`) on `shape`,
    from `_jax_dry_gpt`'s initial weights: (loss, stepped parameters by
    name)."""
    dev = jdevice.get_default_device()
    V = SP_DRY_GPT["vocab_size"]
    mesh = jmake_mesh(shape)
    g, w = _jax_dry_gpt()
    named = g.get_params()
    params = list(named.values())
    w0 = [jnp.asarray(w[k]) for k in named]

    def step(p_arrs, ids_a, tgt_a):
        for p, a in zip(params, p_arrs):
            p.data = a
        jag.training = True
        try:
            logits = g.forward(jt.Tensor(data=ids_a, device=dev,
                                         requires_grad=False))
            loss = jag.softmax_cross_entropy(
                jag.reshape(logits, (-1, V)),
                jag.reshape(jt.Tensor(data=tgt_a, device=dev,
                                      requires_grad=False), (-1,)))
            grads = jag.gradients(loss)
        finally:
            jag.training = False
        new_p = [a - 0.05 * jax.lax.pmean(jax.lax.pmean(
            grads[p].data, "data"), "sp") for p, a in zip(params, p_arrs)]
        return new_p, jax.lax.pmean(jax.lax.pmean(loss.data, "data"), "sp")

    spec = P("data", "sp")
    stepped = jax.shard_map(step, mesh=mesh, in_specs=(P(), spec, spec),
                            out_specs=(P(), P()), check_vma=False)
    rep, shard = NamedSharding(mesh, P()), NamedSharding(mesh, spec)
    new_p, loss = jax.jit(stepped)(
        [jax.device_put(a, rep) for a in w0],
        jax.device_put(jnp.asarray(ids), shard),
        jax.device_put(jnp.asarray(tgt), shard))
    return float(loss), {k: np.asarray(a) for k, a in zip(named, new_p)}


@pytest.fixture(scope="module", params=[2, 4])
def runs(request, tmp_path_factory):
    with jax_rng_kept():
        return _runs(request.param, tmp_path_factory)


def _runs(world, tmp_path_factory):
    """(world, JAX's results, the port's rank results). The port's job
    runs while JAX computes its side from the same initial weights."""
    inputs = {f"ring_{c}": t for c, t in zip("qkv", ring_inputs())}
    inputs["gpt_ids"] = GPT_IDS
    todo = {}
    with jax_plain_attention():
        for case in SP_GPT:
            inputs.update({f"{case}_w0/{k}": v
                           for k, v in _jax_gpt(case)[2].items()})
            todo[f"gpt/{case}"] = functools.partial(_jax_logits, case)
        inputs.update({f"dry_w0/{k}": v
                       for k, v in _jax_dry_gpt()[1].items()})
    for shape in sp_dry_meshes(world):
        key = "dry/{data}x{sp}".format(**shape)
        rng = np.random.RandomState(5 + shape["data"] * 10 + shape["sp"])
        d_ids = rng.randint(0, 50, sp_dry_data(shape)).astype(np.int32)
        d_tgt = np.roll(d_ids, -1, axis=1).astype(np.int32)
        todo[key] = functools.partial(_jax_dry2, shape, d_ids, d_tgt)
        inputs.update({f"{key}_ids": d_ids, f"{key}_tgt": d_tgt})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(run_job, "sp", world,
                           tmp_path_factory.mktemp(f"sp{world}"), inputs,
                           timeout=240)
        with jax_plain_attention():
            want = {k: fn() for k, fn in todo.items()}
        want["ring"] = {c: jax_ring(c) for c in (False, True)}
        return world, want, port.result()


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(runs, causal):
    world, want, port = runs
    out, grads = want["ring"][causal]
    got = np.concatenate([r[f"ring/{causal}/out"] for r in port], axis=2)
    np.testing.assert_allclose(got, out, rtol=2e-4, atol=2e-4)
    for name, g in zip("qkv", grads):
        got = np.concatenate([r[f"ring/{causal}/d{name}"] for r in port],
                             axis=2)
        np.testing.assert_allclose(got, g, rtol=2e-3, atol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_sharded_matches_jax(runs, causal):
    world, want, port = runs
    out, grads = want["ring"][causal]
    for r in port:
        np.testing.assert_allclose(r[f"sharded/{causal}/out"], out,
                                   rtol=2e-4, atol=2e-4)
        for name, g in zip("qkv", grads):
            np.testing.assert_allclose(r[f"sharded/{causal}/d{name}"], g,
                                       rtol=2e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("case", list(SP_GPT))
def test_sequence_sharded_gpt_matches_serial_jax(runs, case):
    world, want, port = runs
    got = np.concatenate([r[f"gpt/{case}"] for r in port], axis=1)
    np.testing.assert_allclose(got, want[f"gpt/{case}"], rtol=2e-3,
                               atol=2e-3)


def test_dryrun_step2_matches_jax(runs):
    world, want, port = runs
    for key in ("dry/{data}x{sp}".format(**s) for s in sp_dry_meshes(world)):
        _check_dry(want, port, key)


def _check_dry(want, port, key):
    loss, params = want[key]
    for r in port:
        np.testing.assert_allclose(float(r[f"{key}/loss"]), loss, rtol=1e-5)
        got = {k[len(key) + 3:]: v for k, v in r.items()
               if k.startswith(f"{key}/p/")}
        assert sorted(got) == sorted(params)
        for k, v in params.items():
            np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)
