"""Port parity, the operators only ONNX reaches: the operators of
`singa_tpu_torch.autograd` from UpSample to LessOrEqual, Rope, the
Reduce*/Arg* families and their functional wrappers against
`singa_tpu.autograd`, forward and gradient, in one parametrised test
(the shape, normalization, convolution and selection cases are in
test_torch_sonnx_ops_nn.py, which shares this file's harness).
Inputs are seeded numpy arrays on `stores_grad` leaf Tensors; the loss is
sum(y * w) over the floating outputs for a seeded cotangent w. Tolerance:
fp32, rtol 1e-4 and atol 1e-5; integer outputs, one-hot outputs of ties
and comparisons exactly, with the JAX package's dtypes (int32 indices).

Also: the tape's record (one src entry per input in order, raw
parameters as leaves that store no gradient, the output index map and
shapes), Mod's float gradient, and the tie rules of TopK, Hardmax and
ArgMax."""

import zlib

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import tensor as jt
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import tensor as tt

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5


# input kinds: f float leaf, p positive, t rounded (ties), n away from 0,
# z half zeros, x with nan/inf, c float constant (no grad), i ints in
# [-1, shape[-1]], s a shape vector (2, 3), k column permutations (for
# scatter: unique rows per column)
def _input(kind, shape, rng):
    if kind == "i":
        return rng.randint(-1, shape[-1] + 1, shape[:-1]).astype(np.int32)
    if kind == "s":
        return np.array([2, 3], np.int32)
    if kind == "k":
        return np.stack([rng.permutation(shape[0])[:shape[1]]
                         for _ in range(shape[2])], 1).astype(np.int64)
    x = rng.randn(*shape).astype(np.float32)
    if kind == "p":
        return np.abs(x) + 0.5
    if kind == "t":
        return np.round(x).astype(np.float32)
    if kind == "n":
        return (np.sign(x) * (np.abs(x) + 0.5)).astype(np.float32)
    if kind == "z":
        return np.where(x > 0, x, 0).astype(np.float32)
    if kind == "x":
        x.flat[::5] = np.nan
        x.flat[1::7] = np.inf
        x.flat[3::7] = -np.inf
        return x
    return x


S4 = (2, 3, 5, 5)
X34 = [("f", (3, 4))]
# name -> (fn(ag, *tensors), [(kind, shape)], differentiable)
CASES = {
    "shape": (lambda g, a: g.shape(a), [("f", (2, 3, 4))], False),
    "size": (lambda g, a: g.Size()(a), [("f", (2, 3, 4))], False),
    "nonzero": (lambda g, a: g.nonzero(a), [("z", (3, 4))], False),
    "onehot": (lambda g, i: g.onehot(5, i, (0.5, 2.0)), [("i", (2, 3, 5))],
               False),
    "onehot_axis0": (lambda g, i: g.onehot(4, i, axis=0), [("i", (3, 4))],
                     False),
    "constant_of_shape": (lambda g, s: g.ConstantOfShape(1.5)(s),
                          [("s", (2,))], False),
    "argmax": (lambda g, a: g.argmax(a, axis=1), [("f", (3, 4, 2))], False),
    "argmin_flat": (lambda g, a: g.argmin(a, axis=0, keepdims=False),
                    [("f", (3, 4))], False),
    "argmax_ties": (lambda g, a: g.ArgMax(1, False)(a), [("t", (6, 5))],
                    False),
    "argmax_ties_last": (lambda g, a: g.ArgMax(1, False, True)(a),
                         [("t", (6, 5))], False),
    "argmin_ties_last": (lambda g, a: g.ArgMin(0, True, True)(a),
                         [("t", (6, 5))], False),
    "reduce_max": (lambda g, a: g.reduce_max(a, axes=(1,)), [("f", (3, 4, 2))]),
    "reduce_min_all": (lambda g, a: g.reduce_min(a, keepdims=False),
                       [("f", (3, 4))]),
    "reduce_prod": (lambda g, a: g.reduce_prod(a, axes=(0, 2)),
                    [("f", (3, 4, 2))]),
    "reduce_prod_flat": (lambda g, a: g.ReduceProd((1, -1), False)(a),
                         [("f", (2, 3, 4))]),
    "reduce_l1": (lambda g, a: g.ReduceL1((1,))(a), [("f", (3, 4))]),
    "reduce_l2": (lambda g, a: g.ReduceL2((0,), False)(a), [("f", (3, 4))]),
    "reduce_logsum": (lambda g, a: g.ReduceLogSum((1,))(a), [("p", (3, 4))]),
    "reduce_logsumexp": (lambda g, a: g.ReduceLogSumExp(None, False)(a),
                         [("f", (3, 4))]),
    "reduce_sumsquare": (lambda g, a: g.ReduceSumSquare((-1,))(a),
                         [("f", (2, 3, 4))]),
    "log_softmax": (lambda g, a: g.log_softmax(a), [("f", (3, 4))]),
    "log_softmax_axis0": (lambda g, a: g.log_softmax(a, axis=0),
                          [("f", (3, 4))]),
    "hardmax_ties": (lambda g, a: g.Hardmax()(a), [("t", (6, 5))], False),
    "hardmax_axis0": (lambda g, a: g.Hardmax(0)(a), [("t", (4, 5))], False),
    "hardswish": (lambda g, a: g.hardswish(a), [("f", (4, 5))]),
    "celu": (lambda g, a: g.celu(a, alpha=0.7), X34),
    "thresholded_relu": (lambda g, a: g.ThresholdedRelu(0.3)(a), X34),
    "shrink": (lambda g, a: g.Shrink(0.1, 0.5)(a), X34),
    "mod_fmod": (lambda g, a, b: g.Mod(1)(a, b), [("f", (3, 4)),
                                                  ("n", (3, 4))]),
    "mod_python": (lambda g, a, b: g.Mod(0)(a, b), [("f", (3, 4)),
                                                    ("n", (3, 4))]),
    "eyelike": (lambda g, a: g.EyeLike(1)(a), [("f", (3, 5))], False),
    "eyelike_int": (lambda g, a: g.EyeLike(-1, "int32")(a),
                    [("f", (4, 3))], False),
    "isnan": (lambda g, a: g.IsNaN()(a), [("x", (3, 7))], False),
    "isinf": (lambda g, a: g.IsInf()(a), [("x", (3, 7))], False),
    "isinf_positive": (lambda g, a: g.IsInf(0, 1)(a), [("x", (3, 7))],
                       False),
    "trilu_upper": (lambda g, a: g.trilu(a, upper=1, k=1), [("f", (4, 5))]),
    "trilu_lower_batched": (lambda g, a: g.trilu(a, upper=0, k=-1),
                            [("f", (2, 4, 4))]),
    "gather_elements": (lambda g, a: g.GatherElements(
        1, [[0, 2, -1], [3, 1, 0], [1, -2, 2]])(a), [("f", (3, 4))]),
    "greater_or_equal": (lambda g, a, b: g.GreaterOrEqual()(a, b),
                         [("t", (4, 5)), ("t", (4, 5))], False),
    "less_or_equal": (lambda g, a, b: g.LessOrEqual()(a, b),
                      [("t", (4, 5)), ("t", (4, 5))], False),
}


def _leaf(tm, a, kind, dev):
    if a.dtype == np.float32 and kind != "c":
        return tm.Tensor(data=a, device=dev, requires_grad=True,
                         stores_grad=True)
    return tm.from_numpy(a, device=dev)


def _run(pkg, cases, name, arrays, kinds, w_seed):
    fn = cases[name][0]
    ag, tm = (jag, jt) if pkg == "jax" else (tag, tt)
    dev = jdevice.best_device() if pkg == "jax" \
        else tdevice.create_cpu_device()
    ins = [_leaf(tm, a, k, dev) for a, k in zip(arrays, kinds)]
    prev = ag.training
    ag.training = True
    try:
        out = fn(ag, *ins)
        outs = list(out) if isinstance(out, tuple) else [out]
        ys = [o.numpy() for o in outs]
        grads = {}
        if len(cases[name]) < 3 or cases[name][2]:
            rng = np.random.RandomState(w_seed)
            loss = None
            for o, y in zip(outs, ys):
                if not np.issubdtype(y.dtype, np.floating):
                    continue
                w = tm.Tensor(data=np.asarray(rng.randn(*y.shape),
                                              np.float32),
                              device=dev, requires_grad=False)
                term = ag.reduce_sum(ag.mul(o, w), None, False)
                loss = term if loss is None else ag.add(loss, term)
            g = ag.gradients(loss)
            grads = {i: g[t].numpy() for i, t in enumerate(ins) if t in g}
    finally:
        ag.training = prev
    return ys, grads


def check_case(cases, name):
    """Run case `name` of `cases` through both packages and compare."""
    spec = cases[name][1]
    rng = np.random.RandomState(zlib.crc32(name.encode()) % 1000)
    arrays = [_input(k, s, rng) for k, s in spec]
    kinds = [k for k, _ in spec]
    jys, jgs = _run("jax", cases, name, arrays, kinds, 1)
    tys, tgs = _run("port", cases, name, arrays, kinds, 1)
    assert len(tys) == len(jys)
    exact = not (len(cases[name]) < 3 or cases[name][2])
    for a, b in zip(tys, jys):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (name, a.shape, b.shape, a.dtype, b.dtype)
        if exact or not np.issubdtype(b.dtype, np.floating):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    assert sorted(tgs) == sorted(jgs), name
    for i in jgs:
        np.testing.assert_allclose(tgs[i], jgs[i], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} input {i}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_matches_jax(name):
    check_case(CASES, name)


def test_tape_record_has_one_entry_per_input():
    """src holds (creator, id, input, stores_grad) per input in order: a
    raw nn.Parameter as a leaf that stores no gradient, a leaf Tensor as
    its Dummy; y_id2idx and _out_shapes describe the outputs; backward's
    pairs are unchanged by the raw leaf."""
    cpu = tdevice.create_cpu_device()
    x = tt.Tensor(data=np.ones((2, 3), np.float32), device=cpu,
                  stores_grad=True)
    w = torch.nn.Parameter(torch.full((3, 4), 0.5))
    prev = tag.training
    tag.training = True
    try:
        y = tag.matmul(x, w)
        v, i = tag.TopK(2)(y)
        pairs = list(tag.backward(tag.reduce_sum(v, None, False)))
    finally:
        tag.training = prev
    op = y.creator
    assert [e[2] is t for e, t in zip(op.src, (x, w))] == [True, True]
    assert op.src[0][0] is x.creator and op.src[0][3] is True
    assert isinstance(op.src[1][0], tag.Dummy) and op.src[1][3] is False
    assert op.src[1][1] == id(w) and op.y_id2idx == {id(y): 0}
    assert op._n_out == 1 and op._out_shapes == [((2, 4), torch.float32)]
    topk = v.creator
    assert topk._n_out == 2 and topk.y_id2idx == {id(v): 0, id(i): 1}
    assert topk._out_shapes[1] == ((2, 2), torch.int32)
    got = {id(p): g for p, g in pairs}
    assert set(got) == {id(x), id(w)}
    assert isinstance(got[id(x)], tt.Tensor) and torch.is_tensor(got[id(w)])
    # every y ties: TopK keeps columns 0 and 1, whose W columns get x's
    # column sums
    np.testing.assert_allclose(got[id(w)].numpy(),
                               np.repeat([[2.0, 2.0, 0.0, 0.0]], 3, 0))


def test_mod_float_gradient():
    """Float fmod carries gradient (d/da = 1 a.e.) in both packages, so
    imported graphs containing Mod keep training."""
    a_np = np.array([5.3, -2.7], np.float32)
    b_np = np.array([2.0, 2.0], np.float32)
    got = {}
    for pkg, ag, tm, dev in (("jax", jag, jt, jdevice.best_device()),
                             ("port", tag, tt, tdevice.create_cpu_device())):
        a = tm.from_numpy(a_np, device=dev)
        a.requires_grad = True
        a.stores_grad = True
        b = tm.from_numpy(b_np, device=dev)
        prev = ag.training
        ag.training = True
        try:
            loss = ag.reduce_sum(ag.Mod(fmod=1)(a, b), None)
            got[pkg] = ag.gradients(loss)[a].numpy()
        finally:
            ag.training = prev
    np.testing.assert_allclose(got["port"], [1.0, 1.0])
    np.testing.assert_array_equal(got["port"], got["jax"])


def test_tie_rules():
    """Equal values: TopK lists them in index order, Hardmax and ArgMax
    take the first, select_last_index the last; indices are int32."""
    cpu = tdevice.create_cpu_device()
    x = tt.from_numpy(np.array([[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32),
                      device=cpu)
    v, i = tag.TopK(3)(x)
    assert i.numpy().tolist() == [[1, 2, 4]] and i.dtype == torch.int32
    _, i = tag.TopK(2, -1, False)(x)
    assert i.numpy().tolist() == [[0, 3]]
    assert tag.Hardmax()(x).numpy().tolist() == [[0, 1, 0, 0, 0]]
    assert tag.ArgMax(1, False)(x).numpy().tolist() == [1]
    assert tag.ArgMax(1, False, True)(x).numpy().tolist() == [4]


@pytest.mark.parametrize("axis,reverse", [(1, 0), (-1, 1), (0, 1)])
def test_cumsum_exclusive_known_difference(axis, reverse):
    """CumSum with exclusive=1 against numpy, forward and gradient. The
    JAX package's CumSum raises TypeError here (its module-level `slice`
    function shadows the builtin inside CumSum.forward), so it is no
    reference for this mode (ROADMAP.md Queue 3)."""
    x = np.random.RandomState(axis + 3 * reverse).randn(2, 3, 4) \
        .astype(np.float32)
    w = np.random.RandomState(9).randn(2, 3, 4).astype(np.float32)
    ax = axis % 3
    xs = np.flip(x, ax) if reverse else x
    ref = np.cumsum(xs, ax) - xs             # exclusive: the sum before
    ref = np.flip(ref, ax) if reverse else ref
    ws = np.flip(w, ax) if reverse else w
    # d/dx_j of sum_i w_i * (exclusive sum)_i = the sum of w after j
    gref = np.flip(np.cumsum(np.flip(ws, ax), ax), ax) - ws
    gref = np.flip(gref, ax) if reverse else gref
    cpu = tdevice.create_cpu_device()
    t = tt.Tensor(data=x, device=cpu, stores_grad=True)
    prev = tag.training
    tag.training = True
    try:
        y = tag.cumsum(t, axis=axis, exclusive=1, reverse=reverse)
        g = tag.gradients(tag.reduce_sum(
            tag.mul(y, tt.from_numpy(w, device=cpu)), None, False))[t]
    finally:
        tag.training = prev
    np.testing.assert_allclose(y.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), gref, rtol=RTOL, atol=ATOL)
    jx = jt.Tensor(data=x, device=jdevice.best_device())
    with pytest.raises(TypeError):
        jag.cumsum(jx, axis=axis, exclusive=1, reverse=reverse)
