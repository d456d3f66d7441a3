"""Port parity, expert parallelism on gloo ranks against JAX
(`torch_dist_worker.job_ep`, one job a world size, a module fixture):
JAX runs the same functions and models in this process on 2 and 4 of
its virtual CPU devices.

- `moe_ffn_ep` over {ep 2} and {ep 4} (tests/test_moe.py:57 and :162:
  D 16, H 32, E 4, T 32 tokens split over the ranks; top-2 at capacity
  factor E, top-1 at 1.0, where routes drop), each rank its tokens and
  its E / n experts: y rtol 1e-5 (atol 1e-6), aux and
  z_loss rtol 1e-5, overflow equal; the rank's gradients of sum(y^2) +
  aux / 2 + z_loss / 10 (taken inside JAX's shard_map body, as its
  Model step takes them) rtol 1e-4, atol 1e-5.
- The MoE-GPT through Model/DistOpt(SGD(0.05), axis=("data", "ep")):
  tests/test_moe.py:85's config on {data 2, ep 2} (4 ranks), three
  steps, and dryrun step 2b's (`__graft_entry__.py:378-395`: ep 4 at 4
  ranks, 2 at 2, the router losses on), one step; from JAX's initial
  weights, losses rtol 1e-5 and parameters atol 1e-5, every rank alike.
  JAX's GPTs run their attention through its plain reference.
- A DistOpt that reduces over "data" only, on a {data, ep 2} mesh with
  an expert-parallel MoE-GPT (dryrun 2b's at 2 ranks), is refused at
  the first step with JAX's message; JAX raises it too, on {data 1, ep
  2} (tests/test_moe.py:139's check).
"""

import concurrent.futures
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from singa_tpu import device as jdevice
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu.parallel import make_mesh as jmake_mesh
from singa_tpu.parallel.moe import moe_ffn_ep as jmoe_ffn_ep
from test_torch_sp import jax_plain_attention, jax_rng_kept
from torch_dist_worker import (EP_FFN, EP_REFUSED, ep_gpt_cases,
                               ep_gpt_config, ep_mesh_shape, run_job)

torch.set_num_threads(2)

FFN_ARGS = ("x", "Wg", "W1", "b1", "W2", "b2")


def _ffn_inputs():
    rng = np.random.default_rng(3)
    Wg = rng.standard_normal((16, 4)).astype(np.float32)
    W1 = rng.standard_normal((4, 16, 32)).astype(np.float32) * 0.2
    b1 = rng.standard_normal((4, 32)).astype(np.float32) * 0.1
    W2 = rng.standard_normal((4, 32, 16)).astype(np.float32) * 0.2
    b2 = rng.standard_normal((4, 16)).astype(np.float32) * 0.1
    x = rng.standard_normal((32, 16)).astype(np.float32)
    return dict(x=x, Wg=Wg, W1=W1, b1=b1, W2=W2, b2=b2)


def _jax_ffn(inp, n, k, cf):
    """JAX's moe_ffn_ep over {ep: n}: global y, per-rank stats (n, 3) and
    the per-rank gradients, the sharded ones concatenated, Wg's stacked
    (n, D, E)."""
    mesh = jmake_mesh({"ep": n})
    ep = P("ep")

    def body(*a):
        def f(*a):
            y, aux, (z, ovf) = jmoe_ffn_ep(*a, "ep", capacity_factor=cf, k=k)
            return (jnp.sum(y ** 2) + 0.5 * aux + 0.1 * z,
                    (y, jnp.stack([aux, z, ovf])))
        grads, (y, st) = jax.grad(f, argnums=tuple(range(6)),
                                  has_aux=True)(*a)
        return (y, st[None]) + tuple(g[None] if i == 1 else g
                                     for i, g in enumerate(grads))

    run = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(ep, P(), ep, ep, ep, ep),
        out_specs=(ep,) * 8, check_vma=False))
    out = run(*(jnp.asarray(inp[a]) for a in FFN_ARGS))
    return [np.asarray(t) for t in out]


def _jax_gpt(case, world, ids, tgt):
    """JAX's MoE-GPT of `case` under DistOpt(SGD(0.05), axis=("data",
    "ep")) on its mesh, compiled: (initial weights, a function that
    trains its steps and returns (losses, parameters))."""
    dev = jdevice.get_default_device()
    cfg, steps = ep_gpt_config(case, world)
    m = jmodels.create_model("gpt", **cfg)
    m.set_optimizer(jopt.DistOpt(jopt.SGD(lr=0.05), axis=("data", "ep"),
                                 mesh=jmake_mesh(ep_mesh_shape(case, world))))
    tx, ty = jt.from_numpy(ids, dev), jt.from_numpy(tgt, dev)
    m.compile([tx], is_train=True, use_graph=True)

    def run():
        losses = [float(jt.to_numpy(m(tx, ty)[1])) for _ in range(steps)]
        return np.asarray(losses), {k: jt.to_numpy(v)
                                    for k, v in m.get_params().items()}

    return {k: jt.to_numpy(v).copy() for k, v in m.get_params().items()}, run


def _gpt_data(case, world):
    if case == "dry2b":
        rng, B = np.random.RandomState(13), 2 * world
        ids = rng.randint(0, 50, (B, 8))
    else:
        ids = np.random.RandomState(21).randint(0, 40, (8, 8))
    return ids.astype(np.int32), np.roll(ids, -1, axis=1).astype(np.int32)


@pytest.fixture(scope="module", params=[2, 4])
def runs(request, tmp_path_factory):
    with jax_rng_kept():
        return _runs(request.param, tmp_path_factory)


def _runs(world, tmp_path_factory):
    """(world, JAX's results, the port's rank results). The port's job
    runs while JAX computes its side from the same initial weights."""
    ffn = _ffn_inputs()
    inputs = {f"ffn_{k}": v for k, v in ffn.items()}
    todo = {case: functools.partial(_jax_ffn, ffn, world, k, cf)
            for case, (k, cf) in EP_FFN.items()}
    inputs["refused_ids"] = REFUSED_IDS
    with jax_plain_attention():
        for case in ep_gpt_cases(world):
            ids, tgt = _gpt_data(case, world)
            w0, todo[case] = _jax_gpt(case, world, ids, tgt)
            inputs.update({f"{case}_ids": ids, f"{case}_tgt": tgt})
            inputs.update({f"{case}_w0/{k}": v for k, v in w0.items()})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(run_job, "ep", world,
                           tmp_path_factory.mktemp(f"ep{world}"), inputs,
                           timeout=240)
        with jax_plain_attention():
            want = {k: fn() for k, fn in todo.items()}
        return world, want, port.result()


@pytest.mark.parametrize("case", list(EP_FFN))
def test_moe_ffn_ep_matches_jax(runs, case):
    world, want, port = runs
    y, stats, *grads = want[case]
    np.testing.assert_allclose(
        np.concatenate([r[f"ffn/{case}/y"] for r in port]), y, rtol=1e-5,
        atol=1e-6)
    for i, r in enumerate(port):
        got = r[f"ffn/{case}/stats"]
        np.testing.assert_allclose(got[:2], stats[i, :2], rtol=1e-5)
        assert got[2] == stats[i, 2]
    if case == "top1":
        assert stats[:, 2].max() > 0, "no route dropped"
    for name, g in zip(FFN_ARGS, grads):
        parts = [r[f"ffn/{case}/d{name}"] for r in port]
        got = np.stack(parts) if name == "Wg" else np.concatenate(parts)
        np.testing.assert_allclose(got, g, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_moe_gpt_under_distopt_matches_jax(runs):
    world, want, port = runs
    for case in ep_gpt_cases(world):
        _check_gpt(want, port, case)


def _check_gpt(want, port, case):
    losses, params = want[case]
    for r in port:
        np.testing.assert_allclose(r[f"{case}/losses"], losses, rtol=1e-5)
        got = {k[len(case) + 3:]: v for k, v in r.items()
               if k.startswith(f"{case}/p/")}
        assert sorted(got) == sorted(params)
        for k, v in params.items():
            np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)


REFUSED_IDS = _gpt_data("dry2b", 2)[0]


@functools.lru_cache(maxsize=None)
def _jax_refusal():
    """JAX's error for EP_REFUSED under DistOpt(axis="data") on {data 1,
    ep 2}."""
    dev = jdevice.get_default_device()
    m = jmodels.create_model("gpt", **EP_REFUSED)
    m.set_optimizer(jopt.DistOpt(jopt.SGD(lr=0.05), axis="data",
                                 mesh=jmake_mesh({"data": 1, "ep": 2})))
    tx = jt.from_numpy(REFUSED_IDS, dev)
    with jax_rng_kept(), jax_plain_attention(), \
            pytest.raises(ValueError, match="diverge") as e:
        m.compile([tx], is_train=True, use_graph=True)
        m(tx, jt.from_numpy(np.roll(REFUSED_IDS, -1, 1), dev))
    return str(e.value)


def test_data_only_reduction_is_refused_as_in_jax(runs):
    world, _, port = runs
    for r in port:
        assert str(r["refused"]) == _jax_refusal()
