"""Port parity, the tensor-parallel GPT on gloo ranks against JAX's,
through the Model API (`torch_dist_worker.job_tp_gpt`, one job a world
size, a module fixture; the vocab-parallel cases are in
test_torch_tp_vocab.py, on the same helpers). JAX runs the same models in
this process over the same mesh on its virtual CPU devices; both start
from JAX's initial weights, given to the port as global arrays. Meshes:
{data 1, tp 2} at 2 ranks and {data 2, tp 2} at 4. Losses within rtol
1e-5, parameters (the port's gathered from the shards) within atol 1e-5,
every rank alike.

- The TP GPT (tests/test_parallel_extra.py:93: vocab 50, dim 32, 4
  heads, 2 layers), DistOpt(SGD(0.05)) on "data", 3 steps, and its GQA
  form (:721: 8 heads, 4 kv heads): each rank holds num_heads / tp query
  heads' columns of Wq.
- The MoE-GPT with tp_axis (2 experts, top-1, 1 layer, 2 steps): the
  attention head-parallel and the experts whole, as in the JAX block.
- JAX's initial weights loaded into the trained, sharded TP GPT
  (`load_singa_params`): each rank keeps its blocks and the run repeats
  JAX's losses.
"""

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu.parallel import make_mesh as jmake_mesh
from torch_dist_worker import TP_GPT, run_job, tp_gpt_mesh_shape

torch.set_num_threads(2)

#: the data of each case: (seed, batch, sequence)
DATA = {"gpt": (4, 4, 16), "gqa": (31, 4, 16), "vocab": (7, 4, 16),
        "preds": (9, 4, 8), "ckpt": (3, 4, 8), "moe": (11, 4, 16)}
CASES = ("gpt", "gqa", "moe")


def _data(case, world):
    if case == "dry2b":
        # the dryrun's batch: 2 rows a data rank
        seed, B, S = 5, 2 * tp_gpt_mesh_shape(case, world)["data"], 8
    else:
        seed, B, S = DATA[case]
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TP_GPT[case][0]["vocab_size"], (B, S)) \
        .astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _jax_run(case, world, w0=None, save=None, **over):
    """(initial weights, losses, last output, final parameters), from
    `w0` when given; `save`: a path for the initial states' zip."""
    dev = jdevice.get_default_device()
    cfg, _, lr, steps = TP_GPT[case]
    m = jmodels.create_model("gpt", **dict(cfg, **over))
    m.set_optimizer(jopt.DistOpt(jopt.SGD(lr=lr), axis="data",
                                 mesh=jmake_mesh(tp_gpt_mesh_shape(case,
                                                                   world))))
    ids, tgt = _data(case, world)
    tx, ty = jt.from_numpy(ids, dev), jt.from_numpy(tgt, dev)
    m.compile([tx], is_train=True, use_graph=True)
    if w0 is not None:
        m.set_params(w0)
    w0 = {k: jt.to_numpy(v).copy() for k, v in m.get_params().items()}
    if save is not None:
        m.save_states(save)
    losses = []
    for _ in range(steps):
        out, loss = m(tx, ty)
        losses.append(float(jt.to_numpy(loss)))
    return w0, np.asarray(losses), jt.to_numpy(out), {
        k: jt.to_numpy(v) for k, v in m.get_params().items()}


def run_cases(world, cases, tmp_path_factory):
    """JAX's runs of `cases` and the port's job over `world` ranks:
    (world, {case: {losses, out, params}}, [rank results])."""
    work = tmp_path_factory.mktemp(f"tp_gpt{world}")
    jax_res = {}
    inputs = {"cases": np.array(cases),
              "vocab_zip": np.array(str(work / "vocab.zip")),
              "ckpt": np.array(str(work / "ck"))}
    for case in cases:
        w0, losses, out, params = _jax_run(
            case, world, save=str(work / "vocab.zip") if case == "vocab"
            else None)
        jax_res[case] = {"losses": losses, "out": out, "params": params}
        ids, tgt = _data(case, world)
        inputs.update({f"{case}_ids": ids, f"{case}_tgt": tgt})
        inputs.update({f"{case}_w0/{k}": v for k, v in w0.items()})
    if "preds" in cases:
        # the same weights, argmax predictions only
        jax_res["preds/pred"] = _jax_run(
            "preds", world, {k[len("preds_w0/"):]: v
                             for k, v in inputs.items()
                             if k.startswith("preds_w0/")},
            vocab_tp_return_logits=False)[2]
    port = run_job("tp_gpt", world, work, inputs, timeout=240)
    return world, jax_res, port


def check_matches_jax(runs, case):
    world, jax_res, port = runs
    want = jax_res[case]
    for r in port:
        np.testing.assert_allclose(r[f"{case}/losses"], want["losses"],
                                   rtol=1e-5)
        got = {k[len(case) + 3:]: v for k, v in r.items()
               if k.startswith(f"{case}/p/")}
        assert sorted(got) == sorted(want["params"])
        for k, v in want["params"].items():
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)


def check_shards(runs, case):
    world, _, port = runs
    tp = tp_gpt_mesh_shape(case, world)["tp"]
    cfg = TP_GPT[case][0]
    rows = 56 // tp if cfg.get("vocab_tp") else cfg["vocab_size"]
    for r in port:
        assert int(r[f"{case}/local_rows"]) == rows
        assert int(r[f"{case}/wq_cols"]) == cfg["dim"] // tp


def check_bridge(runs, case):
    world, jax_res, port = runs
    for r in port:
        np.testing.assert_allclose(r[f"{case}/bridge_losses"],
                                   jax_res[case]["losses"], rtol=1e-5)


@pytest.fixture(scope="module", params=[2, 4])
def runs(request, tmp_path_factory):
    return run_cases(request.param, CASES, tmp_path_factory)


@pytest.mark.parametrize("case", CASES)
def test_tp_gpt_matches_jax(runs, case):
    check_matches_jax(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_shards(runs, case):
    check_shards(runs, case)


def test_jax_weights_load_into_the_sharded_model(runs):
    check_bridge(runs, "gpt")
