"""Port parity, the data-parallel acceptance: step 1 of
`__graft_entry__.dryrun_multichip` on 4 gloo ranks against JAX's
shard_mapped step on 4 of the virtual CPU devices, the mesh cases of
tests/test_health.py, the kill-and-resume onto a smaller mesh of
tests/test_resilience.py, and the resilience CLI across processes.

- Dryrun step 1: ResNet-18 (3 channels), batch 2 N = 8,
  DistOpt(SGD(0.05, momentum 0.9)), one step from the dryrun's own
  initial states (JAX's device seeded 0, as a fresh process has it),
  every rank's results equal. At 64x64 (the batch upsampled): the loss
  within rtol 1e-4, the parameters and the running statistics (averaged
  over the ranks in both packages) within atol 1e-4. At the dryrun's
  32x32 the loss within rtol 1e-2: there a rank's two rows reach the
  last stage at 1x1, and one process of each package on the same two
  rows parts by ~1e-3 already (`LOSS_RTOL`). One step only: several are
  chaotic at 32x32 in JAX itself.
- The 32x32 gap is fp32 rounding: on one rank's two rows the port in
  fp32 parts from the port in fp64 (the same function, rounded ~1e-16)
  by more than 1e-4 in the states and by as much as from the JAX
  package in fp32 in the loss. (The JAX package cannot run this model
  in fp64: its batch norm computes in fp32.)
- Dryrun step 1b: the sparse MLP (top-K 0.25) all-reduces no dense
  non-scalar tensor (`utils.dense_allreduce_types` over its op listing),
  and the loss's mean is there, so the check is not vacuous.
- Health (tests/test_health.py:370-432): an inf in rank 1's rows only
  makes skip_step fire on every rank at the same step, every rank's
  parameters, slots and step counter bitwise as they were; the
  non-finite count of a NaN batch equals one process's count (the
  counts are max-reduced, not summed).
- Kill and resume (tests/test_resilience.py:587-634): a 4-rank run dies
  at step 7 (saves at 3 and 6, step 6's manifest still pending); a
  corrupt step_99 is planted; a fresh 2-rank job resumes at step 3,
  skipping both, replays steps 3..7, and its losses are within rtol
  1e-4 and atol 1e-5 of the uninterrupted 4-rank run.
- `python -m singa_tpu_torch.resilience --ab --device cpu --devices-a 4
  --devices-b 2`: the A/B as worker processes, 4 ranks killed by
  SIGTERM, resumed on 2.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu.parallel import data_parallel_mesh as jmesh
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import health, layer, model, opt, tensor
from singa_tpu_torch import models as model_zoo
from torch_dist_worker import ROOT, STRATEGIES, _data, _mlp, run_job

WORLD = 4
torch.set_num_threads(2)


def _jax_step1(x, y):
    """JAX's dryrun step 1 over 4 devices: (initial states, loss, states
    after the step)."""
    dev = jdevice.best_device()
    # the dryrun's states: a fresh process's device key (seed 0), not
    # one that earlier tests in this process have advanced
    dev.SetRandSeed(0)
    m = jmodels.create_model("resnet18", num_channels=3)
    m.set_optimizer(jopt.DistOpt(jopt.SGD(lr=0.05, momentum=0.9),
                                 axis="data", mesh=jmesh(WORLD)))
    tx = jt.Tensor(data=x, device=dev)
    ty = jt.from_numpy(y, device=dev)
    m.compile([tx], is_train=True, use_graph=True)
    s0 = {k: jt.to_numpy(v).copy() for k, v in m.get_states().items()}
    _, loss = m(tx, ty)
    return s0, float(jt.to_numpy(loss)), {
        k: jt.to_numpy(v) for k, v in m.get_states().items()}


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """JAX's dryrun step 1 over 4 devices and the port's over 4 ranks,
    from the same states and batch, at the dryrun's 32x32 and at 64x64
    (the batch upsampled)."""
    rng = np.random.RandomState(0)
    x32 = rng.standard_normal((2 * WORLD, 3, 32, 32)).astype(np.float32)
    y = rng.randint(0, 10, 2 * WORLD).astype(np.int32)
    xs = {32: x32, 64: np.repeat(np.repeat(x32, 2, 2), 2, 3)}
    jax_res, inputs = {}, {"y": y}
    for hw, x in xs.items():
        s0, loss, states = _jax_step1(x, y)
        jax_res[hw] = {"loss": loss, "states": states}
        inputs[f"x{hw}"] = x
        inputs.update({f"s{hw}/{k}": v for k, v in s0.items()})
    srng = np.random.RandomState(1)
    inputs.update(sx=srng.randn(2 * WORLD, 10).astype(np.float32),
                  sy=srng.randint(0, 4, 2 * WORLD).astype(np.int32))
    port = run_job("dryrun", WORLD, tmp_path_factory.mktemp("dryrun"),
                   inputs)
    return jax_res, port


#: loss rtol by input size. At 32x32 (the dryrun's size) a rank's batch
#: of two reaches the last stage at 1x1, where batch norm normalizes two
#: values a channel: one process of each package on the same two rows
#: already parts by up to ~1e-3 there (2.6e-3 absolute on a loss of
#: ~3.3, measured), with no collective involved, and by ~2e-7 at 64x64.
#: So 64x64 holds the step to 1e-4; 32x32 runs the dryrun's own shapes
#: to 1e-2.
LOSS_RTOL = {32: 1e-2, 64: 1e-4}


@pytest.mark.parametrize("hw", [32, 64])
def test_dryrun_step1_loss(dryrun, hw):
    jax_res, port = dryrun
    for r in range(1, WORLD):
        assert port[r][f"{hw}/loss"] == port[0][f"{hw}/loss"]
    got = float(port[0][f"{hw}/loss"])
    want = jax_res[hw]["loss"]
    print(f"dryrun step 1 at {hw}x{hw}: loss JAX {want!r} port {got!r}, "
          f"relative difference {abs(got - want) / abs(want):.3e}")
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL[hw])
    assert list(port[0][f"{hw}/out_shape"]) == [2 * WORLD, 10]


def test_dryrun_step1_states(dryrun):
    """Parameters and the running statistics (averaged over the ranks in
    both packages) after the step at 64x64, within atol 1e-4, equal on
    every rank."""
    jax_res, port = dryrun
    want = jax_res[64]["states"]
    err = {k: float(np.abs(port[0][f"64/s/{k}"] - v).max())
           for k, v in want.items()}
    worst = max(err, key=err.get)
    print(f"dryrun step 1 at 64x64: worst state difference "
          f"{err[worst]:.3e} ({worst}) over {len(err)} states")
    assert err[worst] <= 1e-4
    assert any(k.endswith(("running_mean", "running_var")) for k in err)
    for r in range(1, WORLD):
        for hw in (32, 64):
            for k in want:
                np.testing.assert_array_equal(port[r][f"{hw}/s/{k}"],
                                              port[0][f"{hw}/s/{k}"])


def _port_step1(s0, x, y, dtype):
    """One process of the port: ResNet-18, one SGD(0.05, 0.9) step from
    `s0` in `dtype`; (loss, states as float64)."""
    dev = tdevice.create_cpu_device()
    m = model_zoo.create_model("resnet18", num_channels=3)
    m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9))
    m.compile([tensor.from_numpy(x, dev)], is_train=True, use_graph=True)
    if dtype == np.float64:
        m.double()
    m.set_states({k: v.astype(dtype) if v.dtype == np.float32 else v
                  for k, v in s0.items()})
    _, loss = m(tensor.from_numpy(x.astype(dtype), dev, dtype=dtype),
                tensor.from_numpy(y, dev))
    return loss.item(), {k: v.detach().numpy().astype(np.float64)
                         for k, v in m._raw_states().items()}


def test_dryrun_32_gap_is_fp32_rounding():
    """On rank 0's two rows at 32x32, one process each, from the same
    states: rounding alone (the port in fp32 against the port in fp64)
    moves a state after the step by more than the 1e-4 that 64x64 holds,
    and the cross-package loss gap in fp32 is at most 10x the rounding
    gap. Prints the readings."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2 * WORLD, 3, 32, 32)).astype(np.float32)[:2]
    y = rng.randint(0, 10, 2 * WORLD).astype(np.int32)[:2]
    dev = jdevice.best_device()
    dev.SetRandSeed(0)
    m = jmodels.create_model("resnet18", num_channels=3)
    m.set_optimizer(jopt.SGD(lr=0.05, momentum=0.9))
    tx = jt.Tensor(data=x, device=dev)
    m.compile([tx], is_train=True, use_graph=True)
    s0 = {k: jt.to_numpy(v).copy() for k, v in m.get_states().items()}
    _, jloss = m(tx, jt.from_numpy(y, device=dev))
    jax32 = (float(jt.to_numpy(jloss)),
             {k: jt.to_numpy(v).astype(np.float64)
              for k, v in m.get_states().items()})
    port32 = _port_step1(s0, x, y, np.float32)
    port64 = _port_step1(s0, x, y, np.float64)

    def gap(a, b):
        return (abs(a[0] - b[0]) / abs(b[0]),
                max(float(np.abs(a[1][k] - b[1][k]).max()) for k in b[1]))

    cross, rounding = gap(jax32, port32), gap(port32, port64)
    print(f"32x32, two rows: loss relative gap JAX fp32 vs port fp32 "
          f"{cross[0]:.3e}, port fp32 vs port fp64 {rounding[0]:.3e}, "
          f"JAX fp32 vs port fp64 {gap(jax32, port64)[0]:.3e}; worst "
          f"state gap {cross[1]:.3e}, {rounding[1]:.3e}, "
          f"{gap(jax32, port64)[1]:.3e}")
    assert rounding[1] > 1e-4
    assert cross[0] <= 10 * rounding[0]


def test_dryrun_step1b_sparse_wire(dryrun):
    port = dryrun[1]
    assert str(port[0]["sparse_dense"]) == ""
    assert int(port[0]["sparse_allreduces"]) >= 1   # the loss's mean
    assert np.isfinite(float(port[0]["sparse_loss"]))


# ---- health over the ranks --------------------------------------------------

@pytest.fixture(scope="module")
def mesh_health(tmp_path_factory):
    X, Y = _data()
    w0 = {k: v for k, v in _w0().items()}
    port = run_job("health", WORLD, tmp_path_factory.mktemp("health"),
                   {f"w0/{k}": v for k, v in w0.items()})
    return X, Y, w0, port


def _w0():
    """Fixed initial MLP weights (10 -> 16 -> 4) from a seed."""
    rng = np.random.RandomState(5)
    return {"l1.W": (rng.randn(10, 16) * 0.3).astype(np.float32),
            "l1.b": np.zeros(16, np.float32),
            "l2.W": (rng.randn(16, 4) * 0.3).astype(np.float32),
            "l2.b": np.zeros(4, np.float32)}


def test_mesh_policy_fires_on_all_shards_same_step(mesh_health):
    port = mesh_health[-1]
    for r in range(WORLD):
        assert str(port[r]["skip/action"]) == "skip", r
        assert bool(port[r]["skip/kept"]), r
        assert port[r]["skip/anomaly_steps"].tolist() == [3], r
        assert str(port[r]["skip/next_action"]) == "ok", r
        assert np.isfinite(port[r]["skip/next_loss"])
        assert port[r]["skip/next_loss"] == port[0]["skip/next_loss"]


def test_mesh_nonfinite_count_not_inflated(mesh_health, tmp_path):
    """The count over 4 ranks equals one process's on the whole batch."""
    X, Y, w0, port = mesh_health
    dev = tdevice.create_cpu_device()
    mon = health.HealthMonitor(policy="warn", out_dir=str(tmp_path))
    m = _mlp(model, layer, STRATEGIES["plain"])
    m.set_optimizer(opt.SGD(lr=0.2, momentum=0.9))
    m.compile([tensor.from_numpy(X, dev)], is_train=True, use_graph=True,
              health=mon)
    m.set_params(w0)
    ty = tensor.from_numpy(Y, dev)
    m(tensor.from_numpy(X, dev), ty)
    Xn = X.copy()
    Xn[0, 0] = np.nan
    m(tensor.from_numpy(Xn, dev), ty)
    single = [s["nonfinite_grads"] for s in mon.recorder.ring
              if s["anomaly_kinds"]][0]
    assert single > 0
    for r in range(WORLD):
        assert int(port[r]["count/nonfinite"]) == single, r
    health.set_active_monitor(None)


# ---- kill and resume onto a smaller mesh ------------------------------------

def test_kill_and_resume_onto_smaller_mesh(tmp_path):
    ck = tmp_path / "ck"
    ck.mkdir()
    killed = run_job("kill", WORLD, tmp_path / "jobs",
                     {"ckpt": np.array(str(ck))})
    for r in range(WORLD):
        assert "injected fault" in str(killed[r]["raised"]), r
    ref = killed[0]["ref"]
    assert (ck / "step_3").is_dir() and (ck / "step_6").is_dir()
    assert not os.path.exists(str(ck / "step_6") + ".manifest.json")
    bad = ck / "step_99"
    bad.mkdir()
    with open(str(bad) + ".manifest.json", "w") as f:
        f.write("{broken")
    got = run_job("resume_small", 2, tmp_path / "jobs2",
                  {"ckpt": np.array(str(ck))})
    rep = got[0]
    assert str(rep["status"]) == "completed"
    assert int(rep["resumed_step"]) == 3 and int(rep["final_step"]) == 8
    assert float(rep["corrupt"]) >= 2
    assert float(rep["resumed_gauge"]) == 3
    assert not bool(rep["step99"])
    assert rep["hist_steps"].tolist() == [3, 4, 5, 6, 7]
    np.testing.assert_allclose(rep["hist_losses"], ref[3:], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(got[1]["hist_losses"], rep["hist_losses"])
    # the resumed run's own step-6 save, manifested with its mesh
    assert bool(rep["step6"])
    assert json.loads(str(rep["mesh"])) == {
        "axes": {"data": 2}, "n_devices": 2, "n_processes": 2,
        "process_index": 0}


def test_resilience_cli_across_processes(tmp_path):
    out = tmp_path / "ab.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.resilience", "--ab",
         "--device", "cpu", "--devices-a", "4", "--devices-b", "2",
         "--steps", "12", "--save-every", "3", "--timeout", "100",
         "--out", str(out)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["n_devices_a"] == 4 and rec["n_devices_b"] == 2
    assert rec["killed_status"] == "preempted"
    assert rec["resumed_status"] == "completed" and rec["resumed_step"] > 0
    assert rec["compared_steps"] > 0
