"""Port parity, tensor parallelism through the Model API: the TP MLP of
tests/test_parallel_extra.py:40 and the sparse strategy over its TP
parameters (tests/test_dist.py:221), on gloo ranks against JAX.

The port's ranks run in fresh interpreters (`torch_dist_worker.run_job`,
job "tp_model", one job a world size, a module fixture); JAX runs the
same models in this process over the same mesh on its virtual CPU
devices: {data 1, tp 2} at 2 ranks and {data 2, tp 2} at 4
(`torch_dist_worker.tp_mesh_shape`). Both start from JAX's initial
weights, given to the port as global arrays (`set_params`, before the
first step shards them).

- The TP MLP (10 -> 32 -> 4, fc1 column, fc2 row), DistOpt(SGD(0.1,
  0.9)) on "data", 5 steps: losses within rtol 1e-5, the global
  parameters (`get_params()`, gathered from the shards) within atol
  1e-5, equal on every rank; each rank holds its blocks (fc1.W (10,
  32/tp), fc2.W (32/tp, 4)), and the memory ledger's bytes and the
  counted step flops are the rank's.
- The sparse strategy (top-K 0.25, error feedback) over the TP MLP (10
  -> 16 -> 4) with `sparse_residuals=True`, DistOpt(SGD(0.2, 0.9)), 25
  steps: every loss within rtol 1e-5 and atol 1e-7 and the parameters
  after 25 within atol 1e-5 of JAX's; the loss falls below 0.7 of its
  start (JAX's own check); the residuals exist for the replicated parameters only (the
  sharded ones take the dense reduction), and `state_specs` shard the
  slots like their parameters, as JAX's.
"""

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import layer as jl
from singa_tpu import model as jmodel
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu.parallel import make_mesh as jmake_mesh
from torch_dist_worker import run_job, tp_mesh_shape

torch.set_num_threads(2)

STEPS = {"mlp": 5, "sparse": 25}


def _data(case):
    if case == "mlp":
        rng = np.random.RandomState(3)
        X = rng.randn(16, 10).astype(np.float32)
        return X, rng.randint(0, 4, 16).astype(np.int32)
    rng = np.random.RandomState(0)
    X = rng.randn(16, 10).astype(np.float32)
    Y = np.argmax(X @ rng.randn(10, 4).astype(np.float32), 1) \
        .astype(np.int32)
    return X, Y


def _jax_model(sparse):
    class TPMLP(jmodel.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = jl.Linear(16 if sparse else 32, tp_axis="tp",
                                 tp_mode="column")
            self.relu = jl.ReLU()
            self.fc2 = jl.Linear(4, tp_axis="tp", tp_mode="row")
            self.loss_fn = jl.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            if sparse:
                self._optimizer.backward_and_sparse_update(
                    loss, spars=0.25, topK=True)
                return loss
            self._optimizer(loss)
            return out, loss

    return TPMLP()


def _jax_run(case, world):
    dev = jdevice.get_default_device()
    sparse = case == "sparse"
    X, Y = _data(case)
    m = _jax_model(sparse)
    m.set_optimizer(jopt.DistOpt(
        jopt.SGD(lr=0.2 if sparse else 0.1, momentum=0.9), axis="data",
        mesh=jmake_mesh(tp_mesh_shape(world)), sparse_residuals=sparse))
    tx, ty = jt.from_numpy(X, dev), jt.from_numpy(Y, dev)
    m.compile([tx], is_train=True, use_graph=True)
    w0 = {k: jt.to_numpy(v).copy() for k, v in m.get_params().items()}
    losses = []
    for _ in range(STEPS[case]):
        o = m(tx, ty)
        losses.append(float(jt.to_numpy(o if sparse else o[1])))
    params = {k: jt.to_numpy(v) for k, v in m.get_params().items()}
    params["state_specs"] = [repr(tuple(s))
                             for s in m._optimizer.state_specs()]
    return X, Y, w0, np.asarray(losses), params


@pytest.fixture(scope="module", params=[2, 4])
def runs(request, tmp_path_factory):
    world = request.param
    jax_res, inputs = {}, {}
    for case in STEPS:
        X, Y, w0, losses, params = _jax_run(case, world)
        jax_res[case] = (losses, params)
        inputs.update({f"{case}_X": X, f"{case}_Y": Y})
        inputs.update({f"{case}_w0/{k}": v for k, v in w0.items()})
    port = run_job("tp_model", world,
                   tmp_path_factory.mktemp(f"tp_model{world}"), inputs)
    return world, jax_res, port


@pytest.mark.parametrize("case", sorted(STEPS))
def test_losses_match_jax(runs, case):
    """Every step's loss within rtol 1e-5, with an atol of 1e-7 for the
    sparse run's falling loss (a few 1e-3 past step 10, where its gap to
    JAX's reads a few fp32 ulps, 3e-8 absolute)."""
    world, jax_res, port = runs
    for r in port:
        np.testing.assert_allclose(r[f"{case}/losses"], jax_res[case][0],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", sorted(STEPS))
def test_global_params_match_jax(runs, case):
    world, jax_res, port = runs
    want = {k: v for k, v in jax_res[case][1].items() if k != "state_specs"}
    for r in port:
        got = {k[len(case) + 3:]: v for k, v in r.items()
               if k.startswith(f"{case}/p/")}
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)


def test_each_rank_holds_its_blocks(runs):
    """The rank's blocks; the memory ledger's parameter and slot bytes
    and introspect's counted step flops are the rank's (the serial MLP's
    step counts 32,768 flops, tests/test_torch_introspect.py)."""
    world, _, port = runs
    shape = tp_mesh_shape(world)
    tp = shape["tp"]
    local = 4 * (10 * 32 // tp + 32 // tp + 32 // tp * 4 + 4)
    for r in port:
        assert list(r["mlp/local_W"]) == [10, 32 // tp, 32 // tp, 4]
        assert list(r["sparse/local_W"]) == [10, 16 // tp, 16 // tp, 4]
        assert int(r["mlp/params_bytes"]) == local
        assert int(r["mlp/opt_bytes"]) == local + 4   # momentum, counter
        assert float(r["mlp/flops"]) == 32768 / world


def test_sharded_params_refuse_another_optimizer(runs):
    """After the TP MLP's sharded steps, plain SGD or a DistOpt with no
    process group, in graph or eager mode, raises: without the mesh bound
    the layers would run the serial math on the rank's shards."""
    world, _, port = runs
    for r in port:
        msgs = {k: str(r[k]) for k in r if k.startswith("mlp/other_opt/")}
        assert len(msgs) == 4
        for k, msg in msgs.items():
            assert "sharded over" in msg and "DistOpt" in msg, (k, msg)


def test_sparse_over_tp_converges_with_replicated_residuals(runs):
    world, jax_res, port = runs
    r = port[0]
    losses = r["sparse/losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.7
    # fc2.b alone is replicated (fc1's bias is column-sharded); JAX
    # residuals follow the same rule
    assert list(r["sparse/residual_specs"]) == ["None"]
    assert list(r["sparse/state_specs"]) == [
        "()", "(None, 'tp')", "('tp',)", "('tp', None)", "()", "()"]
    assert list(r["sparse/state_specs"]) == \
        jax_res["sparse"][1]["state_specs"]
