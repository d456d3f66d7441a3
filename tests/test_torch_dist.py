"""Port parity, data parallelism (tests/test_dist.py without the TP test):
`parallel.Communicator` and `opt.DistOpt` against the JAX package's.

The port runs one process per rank: each job below is 4 gloo ranks in
fresh interpreters (`torch_dist_worker.run_job`, importing the port
only), one job per module fixture, its results parametrized over. The
JAX side runs in this process over `data_parallel_mesh(4)`, four of the
eight virtual CPU devices of tests/conftest.py. No process group is ever
initialized in this process: a group is process-global and would leak
into the next test the xdist worker runs.

- Every verb at world size 1 with no process group is the identity, as
  in JAX (topk's out + residual reconstructs x).
- Every verb over 4 ranks against JAX's shard_map of the same verb on the
  same per-shard inputs: fp32 within 1e-6 (relative, with an absolute
  floor of 1e-6 for sums that cancel), the bf16 all-reduce of both
  packages within one bf16 step of the exact sum of the bf16 terms (the
  step at the sum of their magnitudes, the largest partial sum either
  summation order can reach), gathers and broadcasts exact; the
  `singa_comm_bytes_total` series by op equal to JAX's.
- The five strategies (plain, half, partial over 2 partitions, top-K
  0.25, threshold 0.05) on JAX's MLP, 5 steps of SGD(0.2, 0.9) from
  JAX's initial weights: plain, topk and threshold within rtol 1e-5
  (losses) and atol 1e-5 (parameters); half within rtol 1e-3 (losses)
  and atol 2e-3 (parameters: the bf16 sums' order; the error is
  printed); partial as rank 0's parameters against what JAX's `numpy()`
  reads (device 0's copy: both packages leave the unreduced partitions
  differing across ranks). Every rank returns the same losses.
- 4 ranks of DistOpt(SGD) against one process of SGD on the whole batch
  (atol 1e-5); 40 steps of each of JAX's converging strategies; one
  step build per tag of the partial strategy (2 and 4 partitions, the
  tag sequence over 8 steps equal to JAX's); the sparse step's op listing
  with no dense all-reduce and the packed (index, value) all-gathers,
  the plain one's with one all-reduce per parameter; the Classifier's
  dist_options (an unknown one raises); a multi-rank DistOpt in eager
  mode raises; bf16 amp under DistOpt trains; a checkpoint with the
  sparse residuals resumes bitwise in a fresh 4-rank job, and raises on
  2 ranks; every rank loads a checkpoint in the job that saved it, and a
  save that rank 0 refuses raises on every rank.
- Dropout draws from a stream of each rank's own (JAX's
  `fold_in(rng, rank)`): the masks differ across the ranks and from
  step to step, the losses are equal on every rank, and the same seed
  repeats the run.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from singa_tpu import device as jdevice
from singa_tpu import layer as jl
from singa_tpu import model as jmodel
from singa_tpu import observe as jobserve
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu.parallel import data_parallel_mesh as jmesh
from singa_tpu.parallel.communicator import Communicator as JComm
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer, model, opt, tensor
from singa_tpu_torch.parallel import Communicator, data_parallel_mesh
from torch_dist_worker import ALL_STRATEGIES, STRATEGIES, _data, _mlp, run_job

WORLD = 4
torch.set_num_threads(2)


# ---- world size 1, no process group: the identity ---------------------------

def _x():
    return torch.as_tensor(np.random.RandomState(0).randn(8)
                           .astype(np.float32))


@pytest.mark.parametrize("verb", [
    "all_reduce", "all_reduce_half", "all_gather", "broadcast",
    "reduce_scatter", "all_reduce_max"])
def test_world1_verbs_are_identity(verb):
    comm = Communicator(mesh=data_parallel_mesh())
    assert comm.world_size == 1 and comm.group is None
    x = _x()
    assert getattr(comm, verb)(x) is x


@pytest.mark.parametrize("verb", ["topk", "threshold"])
def test_world1_sparse_out_plus_residual_is_x(verb):
    comm = Communicator()
    x = _x()
    if verb == "topk":
        out, res = comm.sparse_all_reduce_topk(x, 0.25)
        assert int((out != 0).sum()) == 2
    else:
        out, res = comm.sparse_all_reduce_threshold(x, 0.5)
    assert torch.equal(out + res, x)


def test_world1_rank_agree_and_distopt():
    comm = Communicator()
    assert int(comm.rank()) == 0 and comm.global_rank == 0
    assert bool(comm.agree_any(True)) and not bool(comm.agree_any(False))
    d = opt.DistOpt(opt.SGD(0.1))
    assert d.world_size == 1 and d.communicator.group is None
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        data_parallel_mesh(4)


# ---- the verbs over 4 ranks -------------------------------------------------

VERBS = ("all_reduce", "all_reduce_half", "all_gather", "broadcast0",
         "broadcast2", "reduce_scatter", "all_reduce_max", "agree1",
         "agree0", "topk_out", "topk_res", "thr_out", "thr_res")


def _comm_series(samples):
    return {labels: float(v) for _, labels, v in samples}


def _jax_verbs(inputs):
    """JAX's Communicator over data_parallel_mesh(4), the same calls in
    the same order inside one shard_map; ({verb: per-shard arrays},
    {series: value})."""
    mesh = jmesh(WORLD)
    comm = JComm(mesh=mesh)
    jobserve.enable(True)
    jobserve.get_registry().reset()

    def f(x1, xs, xt):
        r = {"all_reduce": comm.all_reduce(x1),
             "all_reduce_half": comm.all_reduce_half(x1),
             "all_gather": comm.all_gather(x1),
             "broadcast0": comm.broadcast(x1, root=0),
             "broadcast2": comm.broadcast(x1, root=2),
             "reduce_scatter": comm.reduce_scatter(xs),
             "all_reduce_max": comm.all_reduce_max(x1),
             "agree1": comm.agree_any(comm.rank() == 1).reshape(1),
             "agree0": comm.agree_any(False).reshape(1)}
        r["topk_out"], r["topk_res"] = comm.sparse_all_reduce_topk(x1, 0.25)
        r["thr_out"], r["thr_res"] = comm.sparse_all_reduce_threshold(
            xt, 0.8, capacity_frac=0.5)
        return r

    out = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("data"),) * 3, out_specs=P("data"),
        check_vma=False))(inputs["x1"], inputs["xs"], inputs["xt"])
    shards = {k: np.split(np.asarray(v), WORLD) for k, v in out.items()}
    reg = jobserve.get_registry()
    series = {}
    for name in ("singa_comm_bytes_total", "singa_comm_calls_total"):
        for k, v in _comm_series(reg.get(name).samples()).items():
            series[f"{name}|{k}"] = v
    return shards, series


@pytest.fixture(scope="module")
def verbs(tmp_path_factory):
    rng = np.random.RandomState(3)
    inputs = {"x1": rng.randn(WORLD, 16).astype(np.float32),
              "xs": rng.randn(WORLD * 4, 16).astype(np.float32),
              "xt": rng.randn(WORLD, 64).astype(np.float32)}
    port = run_job("verbs", WORLD, tmp_path_factory.mktemp("verbs"), inputs)
    return inputs, port, _jax_verbs(inputs)


def _bf16_step(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("verb", VERBS)
def test_verb_matches_jax_over_4_ranks(verbs, verb):
    inputs, port, (jax_out, _) = verbs
    for r in range(WORLD):
        got, want = port[r][verb], jax_out[verb][r]
        assert got.shape == want.shape, (verb, r, got.shape, want.shape)
        if verb == "all_reduce_half":
            # each package sums in bf16 in its own order: both within one
            # bf16 step of the exact sum of the bf16 terms, the step taken
            # at the largest partial sum any order reaches (sum of |x|)
            xb = torch.as_tensor(inputs["x1"]).bfloat16().double().numpy()
            exact, bound = xb.sum(0), _bf16_step(np.abs(xb).sum(0))
            for what, v in (("port", got), ("JAX", want)):
                err = np.abs(v[0] - exact)
                assert (err <= bound).all(), \
                    f"rank {r}: {what}'s bf16 sum off by {err.max():.3e}"
        elif verb in ("all_gather", "broadcast0", "broadcast2",
                      "all_reduce_max", "agree1", "agree0", "topk_res",
                      "thr_res"):
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"rank {r}")
        np.testing.assert_array_equal(
            port[r]["x1_after"], inputs["x1"][r:r + 1])
    assert port[2]["rank"] == 2


def test_verbs_book_jax_comm_bytes(verbs):
    _, port, (_, series) = verbs
    got = {k: float(v) for k, v in port[0].items()
           if k.startswith("singa_comm_")}
    assert got == series
    assert any("sparse_all_reduce_topk" in k for k in got)


def test_topk_error_feedback_identity(verbs):
    """out + residual reconstructs each rank's input, and the sum over
    the ranks of what each sent is every rank's result."""
    inputs, port, _ = verbs
    sent = [inputs["x1"][r:r + 1] - port[r]["topk_res"]
            for r in range(WORLD)]
    for r in range(WORLD):
        np.testing.assert_allclose(port[r]["topk_out"], sum(sent),
                                   atol=1e-5)


def test_broadcast_tree(verbs):
    """Every rank ends with the root's value, for roots 0 and 2."""
    inputs, port, _ = verbs
    for root in (0, 2):
        for r in range(WORLD):
            np.testing.assert_array_equal(port[r][f"broadcast{root}"],
                                          inputs["x1"][root:root + 1])


# ---- training over 4 ranks --------------------------------------------------

def _jax_mlp(name, steps, w0, X, Y, tags=None):
    """JAX's MLP under DistOpt(SGD(0.2, 0.9)) over 4 devices from w0."""
    dev = jdevice.best_device()
    m = _mlp(jmodel, jl, ALL_STRATEGIES[name])
    d = jopt.DistOpt(jopt.SGD(lr=0.2, momentum=0.9), mesh=jmesh(WORLD))
    if tags is not None:
        step_tag = d.step_tag
        d.step_tag = lambda: tags.append(step_tag()) or tags[-1]
    m.set_optimizer(d)
    tx, ty = jt.from_numpy(X, dev), jt.from_numpy(Y, dev)
    m.compile([tx], is_train=True, use_graph=True)
    m.set_params(w0)
    losses = [float(jt.to_numpy(m(tx, ty)[1])) for _ in range(steps)]
    return np.asarray(losses), {k: jt.to_numpy(v)
                                for k, v in m.get_params().items()}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    X, Y = _data()
    dev = jdevice.best_device()
    m = _mlp(jmodel, jl, STRATEGIES["plain"])
    m.set_optimizer(jopt.SGD(0.1))
    m.compile([jt.from_numpy(X, dev)], is_train=True, use_graph=True)
    w0 = {k: jt.to_numpy(v) for k, v in m.get_params().items()}
    ckpt = tmp_path_factory.mktemp("ckpt")
    inputs = {"X": X, "Y": Y, "ckpt": np.array(str(ckpt)),
              **{f"w0/{k}": v for k, v in w0.items()}}
    port = run_job("train", WORLD, tmp_path_factory.mktemp("train"), inputs,
                   timeout=150)
    return X, Y, w0, ckpt, port


@pytest.fixture(scope="module")
def jax_runs(trained):
    X, Y, w0, _, _ = trained
    runs = {name: _jax_mlp(name, 5, w0, X, Y) for name in STRATEGIES}
    tags = []
    _jax_mlp("partial4", 8, w0, X, Y, tags=tags)
    runs["partial4/tags"] = tags
    return runs


#: (losses rtol, parameters atol) by strategy. half: the packages sum the
#: bf16 gradients in different orders (gloo's and XLA's), one bf16 step
#: apart at most (test_verb_matches_jax_over_4_ranks); over 5 steps of
#: lr 0.2 with momentum that moves a parameter by up to ~1.1e-3
STRATEGY_TOL = {"plain": (1e-5, 1e-5), "topk": (1e-5, 1e-5),
                "threshold": (1e-5, 1e-5), "half": (1e-3, 2e-3),
                "partial": (1e-5, 1e-5)}


@pytest.mark.parametrize("name", list(STRATEGY_TOL))
def test_strategy_matches_jax(trained, jax_runs, name):
    _, _, w0, _, port = trained
    jl_, jp = jax_runs[name]
    rtol, tol = STRATEGY_TOL[name]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(port[r][f"{name}/losses"],
                                      port[0][f"{name}/losses"])
    got = port[0][f"{name}/losses"]
    err = max(float(np.abs(port[0][f"{name}/p/{k}"] - v).max())
              for k, v in jp.items())
    print(f"{name}: losses JAX {jl_.tolist()} port {got.tolist()}; "
          f"largest parameter difference {err:.3e} (tol {tol})")
    np.testing.assert_allclose(got, jl_, rtol=rtol)
    assert err <= tol
    assert list(port[0][f"{name}/out_shape"]) == [32, 4]


def test_dp_matches_single_device(trained):
    """psum-mean grads over 4 ranks == one process on the whole batch."""
    X, Y, w0, _, port = trained
    dev = tdevice.create_cpu_device()
    m = _mlp(model, layer, STRATEGIES["plain"])
    m.set_optimizer(opt.SGD(lr=0.1))
    tx, ty = tensor.from_numpy(X, dev), tensor.from_numpy(Y, dev)
    m.compile([tx], is_train=True, use_graph=True)
    m.set_params(w0)
    losses = [m(tx, ty)[1].item() for _ in range(3)]
    np.testing.assert_allclose(port[0]["single/losses"], losses, atol=1e-5)
    for k, v in m._raw_params().items():
        np.testing.assert_allclose(port[0][f"single/p/{k}"],
                                   v.detach().numpy(), atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["plain", "half", "topk", "partial"])
def test_strategies_converge(trained, name):
    port = trained[-1]
    losses = port[0][f"conv/{name}/losses"]
    assert losses[-1] < 0.4 * losses[0], losses
    assert list(port[0][f"conv/{name}/out_shape"]) == [32, 4]


def test_partial_update_builds_per_tag(trained, jax_runs):
    """One step build per tag (the JAX package's one executable per
    tag), and JAX's tag sequence."""
    port = trained[-1]
    assert int(port[0]["partial/builds"]) == 2
    assert int(port[0]["partial4/builds"]) == 4
    assert port[0]["partial4/tags"].tolist() == jax_runs["partial4/tags"] \
        == [0, 1, 2, 3, 0, 1, 2, 3]


def test_sparse_step_listing_is_packed(trained):
    """The sparse step all-reduces scalars only (the loss's mean) and
    all-gathers capacity-sized (index, value) pairs: k = n / 4 of l1.W
    (40), l2.W (16) and l1.b (4), over 4 ranks; the plain step
    all-reduces every parameter."""
    port = trained[-1]
    assert str(port[0]["wire/topk/dense"]) == ""
    assert int(port[0]["wire/topk/allreduces"]) >= 1
    gathers = str(port[0]["wire/topk/allgathers"])
    for k in (40, 16, 4):
        assert f"int32[{k}], int32[{k}], int32[{k}], int32[{k}]" in gathers
        assert f"float32[{k}], float32[{k}]" in gathers
    assert str(port[0]["wire/plain/dense"]).split("|") == [
        "float32[4]", "float32[16, 4]", "float32[16]", "float32[10, 16]"]


@pytest.mark.parametrize("option", ["plain", "half", "partialUpdate",
                                    "sparseTopK", "sparseThreshold"])
def test_classifier_dist_options(trained, option):
    losses = trained[-1][0][f"cls/{option}"]
    assert losses.dtype.kind == "f" and np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0]


def test_classifier_unknown_option_raises(trained):
    assert "unknown dist_option 'bogus'" in str(trained[-1][0]["cls/bogus"])


def test_eager_distopt_over_ranks_raises(trained):
    assert "compile(use_graph=True)" in str(trained[-1][0]["eager"])


def test_amp_with_distopt(trained):
    losses = trained[-1][0]["amp/losses"]
    assert losses[-1] < losses[0] * 0.8, losses


def test_resume_sparse_residuals_bitwise(trained, tmp_path_factory):
    """A fresh 4-rank job restores the step-3 checkpoint (every rank its
    own residuals) and continues bitwise as the uninterrupted run."""
    ckpt, port = trained[3], trained[4]
    got = run_job("resume", WORLD, tmp_path_factory.mktemp("resume"),
                  {"ckpt": np.array(str(ckpt))})
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r]["losses"],
                                      port[r]["ckpt/ref"][3:])
    # the residuals differ across ranks: each restored its own row
    assert not np.array_equal(got[0]["res0"], got[1]["res0"])
    stacks = np.load(str(ckpt / "step_3" / "res.npz"))
    assert stacks.files and all(stacks[k].shape[0] == WORLD
                               for k in stacks.files)


def test_resume_sparse_residuals_other_world_raises(trained,
                                                    tmp_path_factory):
    got = run_job("resume", 2, tmp_path_factory.mktemp("resume2"),
                  {"ckpt": np.array(str(trained[3]))})
    assert "saved on 4 devices cannot restore on a 2-device" in \
        str(got[0]["error"])


def test_checkpoint_loads_in_the_saving_job(trained):
    """Each rank's load waits for rank 0's async write, and restores the
    states it saved; a refused save raises on every rank."""
    port = trained[-1]
    for r in range(WORLD):
        assert bool(port[r]["same/equal"]), r
        assert "exists and is complete" in str(port[r]["same/refused"]), r


def test_dropout_masks_differ_across_ranks(trained):
    port = trained[-1]
    h = port[0]["drop/h"]                      # (steps, batch, 16)
    masks = (h != 0).reshape(h.shape[0], WORLD, -1)
    assert 0.3 < masks.mean() < 0.7            # dropout is on
    for step in range(h.shape[0]):
        for a in range(WORLD):
            for b in range(a + 1, WORLD):
                assert not np.array_equal(masks[step, a], masks[step, b]), \
                    (step, a, b)
    assert not np.array_equal(masks[0], masks[1])
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r]["drop/losses"],
                                      port[0]["drop/losses"])
        np.testing.assert_array_equal(port[r]["drop/h"], h)
    np.testing.assert_array_equal(port[0]["drop/h_again"], h)
    np.testing.assert_array_equal(port[0]["drop/losses_again"],
                                  port[0]["drop/losses"])
