"""Port parity, tensor parallelism: the operators of `parallel.tp` and the
tape operators of `autograd` against the JAX package's.

- At tp 1, in this process: a mesh of one rank with no process group is
  bound (`Mesh.bind()`), so every collective is the identity, and JAX
  runs the same functions in a shard_map over one virtual device.
- At tp 2 and 4: gloo ranks in fresh interpreters
  (`torch_dist_worker.run_job`, one job per world size, a module
  fixture) against JAX's shard_map over 2 and 4 of the eight virtual CPU
  devices of tests/conftest.py.

Each case holds the forward and the gradient: Megatron's `f` and `g`
(`megatron_f`/`megatron_g` around a column- then row-parallel product,
and `tp_copy`/`tp_reduce` on inputs that differ by rank), the
vocab-parallel embedding (its hand backward: a local scatter-add), the
vocab-parallel cross-entropy over a padded vocab (16 columns, 13 valid),
the tiled gather of the last dim, the vocab-parallel argmax with ties
across and inside the shards and winners in the padding, and `tp_mlp` on
tests/test_parallel_extra.py:16's inputs and dryrun step 3's
(`__graft_entry__.py:397-418`). fp32 within rtol 1e-5 and an atol of
1e-6 of max(1, max|ref|) (the sums' order: dryrun's MLP reaches 57 and
cancels to 1e-2); the argmax exactly. A sharded result is compared
block by block: rank r's block against the r-th block of JAX's global
array.

Also here: `autograd.axis_bound` and the layers' gate on it, outside a
binding and on a mesh without the axis, and `Placement` cutting and
gathering blocks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from singa_tpu import autograd as jag
from singa_tpu.parallel import make_mesh as jmake_mesh
from singa_tpu.parallel import tp as jtp
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import layer as tl
from singa_tpu_torch.parallel import make_mesh, tp_mlp
from singa_tpu_torch.parallel.mesh import Mesh, axis_size
from singa_tpu_torch.parallel.tp import Placement, sanitize
from torch_dist_worker import port_ops, run_job

torch.set_num_threads(2)

#: (in-spec, out-spec, the dim a rank's block splits, or "stack": one
#: result a rank) of each input and result
IN_SPECS = {
    "x": P(), "Wc": P(None, "tp"), "Wr": P("tp", None), "fg_dy": P(),
    "ids": P(), "table": P("tp", None), "emb_dy": P(),
    "logits": P(None, "tp"), "tgt": P(), "g": P(None, None, "tp"),
    "g_dy": P(), "am": P(None, None, "tp"),
    "mlp_x": P(), "mlp_W1": P(None, "tp"), "mlp_b1": P("tp"),
    "mlp_W2": P("tp", None), "mlp_b2": P(),
    "dry_x": P(), "dry_W1": P(None, "tp"), "dry_b1": P("tp"),
    "dry_W2": P("tp", None), "dry_b2": P()}
SPLIT = {"fg/y": None, "fg/dx": None, "fg/dWc": 1, "fg/dWr": 0,
         "copy/y": "stack", "copy/dx": "stack", "reduce/y": "stack",
         "reduce/dx": "stack", "emb/out": None, "emb/dtable": 0,
         "sce/loss": None, "sce/dx": 1, "gather/y": None, "gather/dx": 2,
         "argmax": None, "mlp/y": None, "dry/y": None}


def _out_spec(split, ndim):
    if split is None:
        return P()
    if split == "stack":
        return P("tp")
    return P(*[("tp" if d == split else None) for d in range(ndim)])


def _inputs():
    rng = np.random.RandomState(0)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    am = f(3, 4, 16)
    am[0, 0] = 0.0
    am[0, 0, [2, 9]] = 5.0       # a tie across two shards (tp 2, 4)
    am[0, 1] = 0.0
    am[0, 1, [4, 5]] = 3.0       # a tie inside one shard
    am[1, 2, [12, 14]] = 9.0     # the winner in the padding is masked
    am[2, 3] = -1.0
    return {"x": f(6, 8), "Wc": f(8, 16), "Wr": f(16, 8), "fg_dy": f(6, 8),
            "ids": rng.randint(0, 16, (3, 5)).astype(np.int32),
            "table": f(16, 8), "emb_dy": f(3, 5, 8), "logits": f(10, 16),
            "tgt": rng.randint(0, 13, 10).astype(np.int32),
            "g": f(3, 4, 16), "g_dy": f(3, 4, 16), "am": am,
            "mlp_x": f(8, 16), "mlp_W1": f(16, 32), "mlp_b1": f(32),
            "mlp_W2": f(32, 16), "mlp_b2": f(16),
            "dry_x": f(8, 16), "dry_W1": f(16, 32),
            "dry_b1": np.zeros(32, np.float32), "dry_W2": f(32, 16),
            "dry_b2": np.zeros(16, np.float32)}


def _jax_ops(inp, n):
    """The same cases in JAX's shard_map over `n` devices: {name: global
    array}."""
    mesh = jmake_mesh({"tp": n})
    names = list(IN_SPECS)

    def body(*args):
        a = dict(zip(names, args))
        r = {}

        def fg(x, Wc, Wr):
            return jtp.megatron_g(jtp.megatron_f(x, "tp") @ Wc @ Wr, "tp")

        r["fg/y"], vjp = jax.vjp(fg, a["x"], a["Wc"], a["Wr"])
        r["fg/dx"], r["fg/dWc"], r["fg/dWr"] = vjp(a["fg_dy"])
        c = lax.axis_index("tp").astype(jnp.float32)
        for op, fn in (("copy", jtp.megatron_f), ("reduce", jtp.megatron_g)):
            y, vjp = jax.vjp(lambda x, fn=fn: fn(x * (1.0 + c), "tp"),
                             a["x"])
            r[f"{op}/y"], r[f"{op}/dx"] = y[None], vjp(a["x"])[0][None]
        op = jag._VocabParallelEmbedding("tp")
        r["emb/out"] = op.forward(a["ids"], a["table"])
        r["emb/dtable"] = op.backward(a["emb_dy"])[1]
        op = jag._VocabParallelSCE("tp", valid_vocab=13)
        r["sce/loss"] = op.forward(a["logits"], a["tgt"])
        r["sce/dx"] = op.backward(jnp.float32(1.0))[0]
        op = jag._GatherLastDim("tp")
        r["gather/y"] = op.forward(a["g"])
        r["gather/dx"] = op.backward(a["g_dy"])
        r["argmax"] = jag._VocabParallelArgmax("tp", 13).forward(a["am"])
        for case in ("mlp", "dry"):
            r[f"{case}/y"] = jtp.tp_mlp(
                *(a[f"{case}_{k}"] for k in ("x", "W1", "b1", "W2", "b2")),
                "tp")
        return r

    ndim = {"fg/y": 2, "fg/dx": 2, "fg/dWc": 2, "fg/dWr": 2, "emb/dtable": 2,
            "sce/dx": 2, "gather/dx": 3}
    run = jax.shard_map(
        body, mesh=mesh, in_specs=tuple(IN_SPECS[k] for k in names),
        out_specs={k: _out_spec(v, ndim.get(k, 0)) for k, v in
                   SPLIT.items()}, check_vma=False)
    out = jax.jit(run)(*(jnp.asarray(inp[k]) for k in names))
    return {k: np.asarray(v) for k, v in out.items()}


def _block(ref, split, rank, n):
    """Rank `rank`'s block of JAX's global result."""
    if split is None:
        return ref
    if split == "stack":
        return ref[rank]
    size = ref.shape[split] // n
    return np.take(ref, range(rank * size, (rank + 1) * size), axis=split)


def _check(got, ref, rank, n, name):
    want = _block(ref, SPLIT[name], rank, n)
    if name == "argmax":
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == np.int32
        return
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(want).max())),
        err_msg=f"{name}, rank {rank} of {n}")


# ---- tp 1, in this process --------------------------------------------------

@pytest.fixture(scope="module")
def tp1():
    inp = _inputs()
    return port_ops(inp, Mesh({"tp": 1}, [0])), _jax_ops(inp, 1)


@pytest.mark.parametrize("name", sorted(SPLIT))
def test_tp1_operator_matches_jax(tp1, name):
    got, ref = tp1
    _check(got[name], ref[name], 0, 1, name)


# ---- tp 2 and 4, gloo ranks -------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    n = request.param
    inp = _inputs()
    port = run_job("tp_ops", n, tmp_path_factory.mktemp(f"tp_ops{n}"), inp)
    return n, port, _jax_ops(inp, n)


@pytest.mark.parametrize("name", sorted(SPLIT))
def test_operator_across_ranks_matches_jax(ranks, name):
    n, port, ref = ranks
    for rank in range(n):
        _check(port[rank][name], ref[name], rank, n, name)


def test_argmax_ties_take_the_lowest_index(ranks):
    """The tie across shards goes to column 2 and inside a shard to 4;
    of the 9.0s at columns 12 and 14, 14 lies in the padding (13 valid)
    and is masked: JAX's rule."""
    n, port, ref = ranks
    got = port[0]["argmax"]
    assert got[0, 0] == 2 and got[0, 1] == 4 and got[1, 2] == 12
    np.testing.assert_array_equal(got, ref["argmax"])


@pytest.mark.parametrize("verb", ["all_reduce", "all_reduce_half",
                                  "all_reduce_max", "broadcast"])
def test_communicator_reduces_a_transposed_view(ranks, verb):
    """The communicator's verbs on a transposed view (the tied head's
    gradient under DistOpt) return a contiguous result of the right
    values: NCCL refuses any other layout."""
    n, port, _ = ranks
    t = _inputs()["Wc"].T
    want = {"all_reduce": n * t, "all_reduce_max": t, "broadcast": t,
            "all_reduce_half": n * t.astype(np.float32)}[verb]
    for r in port:
        assert bool(r[f"comm/{verb}/contiguous"])
        if verb == "all_reduce_half":
            np.testing.assert_allclose(r[f"comm/{verb}"], want, rtol=1e-2)
        else:
            np.testing.assert_allclose(r[f"comm/{verb}"], want, rtol=1e-6)


# ---- the bound axis ---------------------------------------------------------

def test_axis_bound_follows_the_binding():
    mesh = Mesh({"data": 1, "tp": 1}, [0])
    assert not tag.axis_bound("tp")
    with mesh.bind():
        assert tag.axis_bound("tp") and tag.axis_bound("data")
        assert not tag.axis_bound("sp")
        assert axis_size("tp") == 1
        with Mesh({"sp": 1}, [0]).bind():
            assert tag.axis_bound("sp") and tag.axis_bound("tp")
        assert not tag.axis_bound("sp")
    assert not tag.axis_bound("tp")
    with pytest.raises(NameError, match="unbound axis name: tp"):
        axis_size("tp")
    x = torch.ones(2, 4)
    with pytest.raises(NameError, match="unbound axis name: tp"):
        tp_mlp(x, torch.ones(4, 4), None, torch.ones(4, 4), None, "tp")


def test_layers_run_the_serial_math_off_the_axis():
    """A tp_axis Linear pair on full weights: unbound, on a mesh without
    the axis, and bound at tp 1, the same output (JAX's gate on
    axis_bound); the specs ride on the parameters."""
    rng = np.random.RandomState(2)
    x = torch.as_tensor(rng.randn(4, 6).astype(np.float32))
    fc1 = tl.Linear(6, 8, tp_axis="tp", tp_mode="column",
                    generator=torch.Generator().manual_seed(0))
    fc2 = tl.Linear(8, 3, tp_axis="tp", tp_mode="row",
                    generator=torch.Generator().manual_seed(1))
    assert fc1.W.spec == (None, "tp") and fc1.b.spec == ("tp",)
    assert fc2.W.spec == ("tp", None) and not hasattr(fc2.b, "spec")
    ref = fc2(fc1(x))
    with Mesh({"data": 1}, [0]).bind():
        np.testing.assert_array_equal(fc2(fc1(x)).detach(), ref.detach())
    with Mesh({"tp": 1}, [0]).bind():
        np.testing.assert_array_equal(fc2(fc1(x)).detach(), ref.detach())
    emb = tl.Embedding(10, 4, None, None, "tp",
                       generator=torch.Generator().manual_seed(2))
    assert emb.W.spec == ("tp", None)


def test_placement_cuts_and_gathers_blocks():
    mesh = Mesh({"data": 1, "tp": 1}, [0])
    full = torch.arange(24.0).reshape(4, 6)
    pl = Placement(mesh, (None, "tp"))
    assert torch.equal(pl.shard(full), full)
    assert torch.equal(pl.gather(pl.shard(full)), full)
    assert pl.local_shape((4, 6)) == (4, 6)
    assert sanitize(("tp", None), mesh) == ("tp", None)
    assert sanitize(("tp", None), Mesh({"data": 1}, [0])) is None
    assert sanitize(None, mesh) is None and sanitize((), mesh) is None
    assert make_mesh({"tp": 1}).shape["tp"] == 1
