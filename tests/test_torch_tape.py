"""Port parity, the tape operators: every operator of
`singa_tpu_torch.autograd` that the layers and the zoo reach (and the
arithmetic, activation, shape and reduction families) against
`singa_tpu.autograd`, forward and gradient, in one parametrised test.
Inputs are seeded numpy arrays on `stores_grad` leaf Tensors; the loss is
sum(y * w) for a seeded cotangent w; `gradients` must hand each leaf its
gradient as a Tensor. Tolerance: fp32, rtol 1e-4 and atol 1e-5.

Conv, batch norm and pooling cover stride, padding, the SAME modes,
group and dilation; `attention` on Tensors goes through the plain
version on the CPU (the JAX package's Pallas kernel in interpret mode).
Also: the raw-tensor path the GPT takes, eval mode recording nothing,
and the backward generator's pairs."""

import zlib
from types import SimpleNamespace

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


def geo(stride=(1, 1), padding=(0, 0), group=1, odd=None, dilation=(1, 1)):
    return SimpleNamespace(stride=stride, padding=padding, group=group,
                           odd_padding=odd, dilation=dilation)


# input kinds: f float leaf, p positive leaf, u in (0.1, 0.9), a > 1,
# i integer labels (no grad), c float constant (no grad)
def _input(kind, shape, rng):
    if kind == "i":
        return rng.randint(0, shape[-1], shape[:-1]).astype(np.int32)
    x = rng.randn(*shape).astype(np.float32)
    if kind == "p":
        return np.abs(x) + 0.5
    if kind == "u":
        return (0.1 + 0.8 * rng.rand(*shape)).astype(np.float32)
    if kind == "a":
        return np.abs(x) + 1.5
    return x


S4 = (2, 3, 6, 6)
# name -> (fn(ag, *tensors), [(kind, shape)], differentiable)
CASES = {
    "add": (lambda g, a, b: g.add(a, b), [("f", (3, 4)), ("f", (3, 4))]),
    "add_broadcast": (lambda g, a, b: g.add(a, b), [("f", (3, 4)),
                                                    ("f", (4,))]),
    "sub": (lambda g, a, b: g.sub(a, b), [("f", (3, 4)), ("f", (3, 4))]),
    "mul": (lambda g, a, b: g.mul(a, b), [("f", (3, 4)), ("f", (3, 4))]),
    "div": (lambda g, a, b: g.div(a, b), [("f", (3, 4)), ("p", (3, 4))]),
    "pow": (lambda g, a, b: g.pow(a, b), [("p", (3, 4)), ("f", (3, 4))]),
    "negative": (lambda g, a: g.negative(a), [("f", (3, 4))]),
    "reciprocal": (lambda g, a: g.reciprocal(a), [("p", (3, 4))]),
    "abs": (lambda g, a: g.abs(a), [("f", (3, 4))]),
    "exp": (lambda g, a: g.exp(a), [("f", (3, 4))]),
    "log": (lambda g, a: g.log(a), [("p", (3, 4))]),
    "sqrt": (lambda g, a: g.sqrt(a), [("p", (3, 4))]),
    "sign": (lambda g, a: g.sign(a), [("f", (3, 4))], False),
    "less": (lambda g, a, b: g.less(a, b), [("f", (3, 4)), ("f", (3, 4))],
             False),
    "greater": (lambda g, a, b: g.greater(a, b), [("f", (3, 4)),
                                                  ("f", (3, 4))], False),
    "equal": (lambda g, a: g.equal(a, a), [("f", (3, 4))], False),
    "and_or_xor_not": (lambda g, a, b: g.add(g.add(g.And()(a, b),
                                                   g.Or()(a, b)),
                                             g.add(g.Xor()(a, b), g.Not()(a))),
                       [("f", (3, 4)), ("f", (3, 4))], False),
    "relu": (lambda g, a: g.relu(a), [("f", (3, 4))]),
    "leakyrelu": (lambda g, a: g.leakyrelu(a, 0.1), [("f", (3, 4))]),
    "elu": (lambda g, a: g.elu(a, 0.7), [("f", (3, 4))]),
    "selu": (lambda g, a: g.selu(a), [("f", (3, 4))]),
    "prelu": (lambda g, a, s: g.prelu(a, s), [("f", (3, 4)), ("f", (4,))]),
    "sigmoid": (lambda g, a: g.sigmoid(a), [("f", (3, 4))]),
    "hardsigmoid": (lambda g, a: g.hardsigmoid(a, 0.3, 0.4),
                    [("f", (3, 4))]),
    "softmax": (lambda g, a: g.softmax(a, 1), [("f", (3, 4))]),
    "softplus": (lambda g, a: g.softplus(a), [("f", (3, 4))]),
    "softsign": (lambda g, a: g.softsign(a), [("f", (3, 4))]),
    "tanh": (lambda g, a: g.tanh(a), [("f", (3, 4))]),
    "trig": (lambda g, a, u, b: g.add(g.add(g.add(g.cos(a), g.sin(a)),
                                            g.add(g.tan(u), g.atan(a))),
                                      g.add(g.add(g.cosh(u), g.sinh(u)),
                                            g.add(g.erf(a), g.asinh(a)))),
             [("f", (3, 4)), ("u", (3, 4)), ("a", (3, 4))]),
    "inverse_trig": (lambda g, u, b: g.add(g.add(g.acos(u), g.asin(u)),
                                           g.add(g.atanh(u), g.acosh(b))),
                     [("u", (3, 4)), ("a", (3, 4))]),
    "reshape": (lambda g, a: g.reshape(a, (4, -1)), [("f", (2, 3, 4))]),
    "flatten": (lambda g, a: g.flatten(a, 2), [("f", (2, 3, 4, 2))]),
    "squeeze": (lambda g, a: g.squeeze(a, 1), [("f", (3, 1, 4))]),
    "unsqueeze": (lambda g, a: g.unsqueeze(a, [0, 2]), [("f", (3, 4))]),
    "flip": (lambda g, a: g.flip(a, 1), [("f", (3, 4))]),
    "transpose": (lambda g, a: g.transpose(a, (2, 0, 1)), [("f", (2, 3, 4))]),
    "transpose_default": (lambda g, a: g.transpose(a), [("f", (2, 3, 4))]),
    "cat": (lambda g, a, b: g.cat([a, b], 1), [("f", (3, 4)), ("f", (3, 2))]),
    "slice": (lambda g, a: g.slice(a, [1, 0], [3, 100], [0, 1], [1, 2]),
              [("f", (4, 5))]),
    "slice_negative_step": (lambda g, a: g.slice(a, [-1], [-6], [1], [-2]),
                            [("f", (3, 6))]),
    "split": (lambda g, a: g.split(a, 1, [1, 3]), [("f", (3, 4))]),
    "gather": (lambda g, a: g.gather(a, 1, [[0, 2], [3, 3]]), [("f", (3, 4))]),
    "tile": (lambda g, a: g.tile(a, (2, 1, 3)), [("f", (2, 3, 2))]),
    "expand": (lambda g, a: g.expand(a, (2, 3, 4)), [("f", (3, 1))]),
    "pad_constant": (lambda g, a: g.pad(a, "constant", [0, 1, 2, 0, 2, 1],
                                        0.5), [("f", (2, 3, 4))]),
    "pad_reflect": (lambda g, a: g.pad(a, "reflect", [0, 0, 1, 2,
                                                      0, 0, 2, 1]),
                    [("f", S4)]),
    "pad_edge": (lambda g, a: g.pad(a, "edge", [0, 0, 2, 1, 0, 0, 1, 2]),
                 [("f", S4)]),
    "clip": (lambda g, a: g.clip(a, -0.5, 0.6), [("f", (3, 4))]),
    "cast": (lambda g, a: g.cast(a, "int32"), [("f", (3, 4))], False),
    "where": (lambda g, a, b: g.where(np.arange(12).reshape(3, 4) % 3 == 0,
                                      a, b), [("f", (3, 4)), ("f", (3, 4))]),
    "identity": (lambda g, a: g.identity(a), [("f", (3, 4))]),
    "ceil_floor_round": (lambda g, a: g.add(g.add(g.ceil(a), g.floor(a)),
                                            g.add(g.round(a), g.rounde(a))),
                         [("f", (3, 4))], False),
    "mean": (lambda g, a, b, c: g.mean(a, b, c), [("f", (3, 4))] * 3),
    "sum": (lambda g, a, b, c: g.sum(a, b, c), [("f", (3, 4))] * 3),
    "min_max": (lambda g, a, b: g.add(g.min(a, b), g.max(a, b)),
                [("f", (3, 4)), ("f", (3, 4))]),
    "reduce_sum": (lambda g, a: g.reduce_sum(a, (0, 2)), [("f", (2, 3, 4))]),
    "reduce_sum_all": (lambda g, a: g.reduce_sum(a, None, False),
                       [("f", (2, 3, 4))]),
    "reduce_mean": (lambda g, a: g.reduce_mean(a, (1,), False),
                    [("f", (2, 3, 4))]),
    "back_broadcast": (lambda g, a: g.back_broadcast((2, 3, 4), (3, 1), a),
                       [("f", (2, 3, 4))]),
    "matmul": (lambda g, a, b: g.matmul(a, b), [("f", (3, 5)),
                                                ("f", (5, 4))]),
    "matmul_batched": (lambda g, a, b: g.matmul(a, b), [("f", (2, 3, 5)),
                                                        ("f", (2, 5, 4))]),
    "matmul_f32_out": (lambda g, a, b: g.matmul(a, b, out_dtype="float32"),
                       [("f", (2, 3, 5)), ("f", (5, 4))]),
    "gemm": (lambda g, a, b, c: g.gemm(a, b, c, 0.5, 2.0, 1, 1),
             [("f", (5, 3)), ("f", (4, 5)), ("f", (3, 4))]),
    "gemm_no_c": (lambda g, a, b: g.gemm(a, b), [("f", (3, 5)),
                                                 ("f", (5, 4))]),
    "add_bias_rows": (lambda g, a, b: g.add_bias(a, b, 0),
                      [("f", (3, 4)), ("f", (4,))]),
    "add_bias_cols": (lambda g, a, b: g.add_bias(a, b, 1),
                      [("f", (3, 4)), ("f", (3,))]),
    "cossim": (lambda g, a, b: g.cossim(a, b), [("f", (3, 4)),
                                                ("f", (3, 4))]),
    "mse_loss": (lambda g, a, b: g.mse_loss(a, b), [("f", (3, 4)),
                                                    ("c", (3, 4))]),
    "cross_entropy": (lambda g, a, b: g.cross_entropy(a, b),
                      [("u", (3, 4)), ("u", (3, 4))]),
    "binary_cross_entropy": (lambda g, a, b: g.binary_cross_entropy(a, b),
                             [("u", (3, 4)), ("u", (3, 4))]),
    "ranking_loss": (lambda g, a, b: g.ranking_loss(a, b, 0.5),
                     [("f", (6,)), ("f", (6,))]),
    "softmax_cross_entropy": (lambda g, a, t: g.softmax_cross_entropy(a, t),
                              [("f", (2, 3, 5)), ("i", (2, 3, 5))]),
    "softmax_cross_entropy_onehot": (
        lambda g, a, t: g.softmax_cross_entropy(a, g.softmax(t, -1)),
        [("f", (4, 5)), ("c", (4, 5))]),
    "conv2d": (lambda g, x, w, b: g.conv2d(geo(), x, w, b),
               [("f", S4), ("f", (4, 3, 3, 3)), ("f", (4,))]),
    "conv2d_stride_pad": (lambda g, x, w: g.conv2d(geo((2, 1), (1, 2)), x, w),
                          [("f", (2, 3, 7, 6)), ("f", (4, 3, 3, 2))]),
    "conv2d_same_upper": (lambda g, x, w: g.conv2d(geo((2, 2), (0, 0), 1,
                                                       (0, 1, 0, 1)), x, w),
                          [("f", S4), ("f", (4, 3, 3, 3))]),
    "conv2d_same_lower_pad": (lambda g, x, w: g.conv2d(
        geo((1, 1), (1, 0), 1, (1, 0, 2, 1)), x, w),
        [("f", S4), ("f", (4, 3, 4, 2))]),
    "conv2d_group": (lambda g, x, w, b: g.conv2d(geo((1, 1), (1, 1), 2),
                                                 x, w, b),
                     [("f", (2, 4, 5, 5)), ("f", (6, 2, 3, 3)),
                      ("f", (6,))]),
    "conv2d_depthwise_dilation": (lambda g, x, w: g.conv2d(
        geo((1, 1), (2, 2), 4, None, (2, 2)), x, w),
        [("f", (2, 4, 7, 7)), ("f", (4, 1, 3, 3))]),
    "batchnorm_train": (lambda g, x, s, b, m, v: g.batchnorm_2d(
        x, s, b, m, v, 0.9, 1e-5, True),
        [("f", S4), ("f", (3,)), ("f", (3,)), ("c", (3,)), ("p", (3,))]),
    "batchnorm_train_2d": (lambda g, x, s, b, m, v: g.batchnorm_2d(
        x, s, b, m, v, 0.8, 1e-3, True),
        [("f", (6, 3)), ("f", (3,)), ("f", (3,)), ("c", (3,)), ("p", (3,))]),
    "batchnorm_eval": (lambda g, x, s, b, m, v: g.batchnorm_2d(
        x, s, b, m, v, 0.9, 1e-5, False),
        [("f", S4), ("f", (3,)), ("f", (3,)), ("c", (3,)), ("p", (3,))]),
    "maxpool": (lambda g, x: g.pooling_2d(x, (2, 2), (2, 2)), [("f", S4)]),
    "maxpool_pad": (lambda g, x: g.pooling_2d(x, (3, 3), (2, 2), (1, 1)),
                    [("f", S4)]),
    "maxpool_same_lower": (lambda g, x: g.pooling_2d(
        x, (3, 2), (2, 2), (0, 0), True, (1, 0, 1, 1)), [("f", S4)]),
    "avgpool": (lambda g, x: g.pooling_2d(x, (3, 3), (1, 1), (0, 0), False),
                [("f", S4)]),
    "avgpool_pad": (lambda g, x: g.pooling_2d(x, (3, 3), (2, 2), (1, 1),
                                              False), [("f", S4)]),
    "avgpool_same_upper": (lambda g, x: g.pooling_2d(
        x, (2, 3), (2, 1), (0, 0), False, (1, 1, 0, 1)), [("f", S4)]),
    "globalaveragepool": (lambda g, x: g.globalaveragepool(x), [("f", S4)]),
    "embedding": (lambda g, i, w: g.embedding(i, w), [("i", (2, 3, 7)),
                                                      ("f", (7, 4))]),
    "layernorm": (lambda g, x, a, b: g.layernorm(x, a, b), [("f", (2, 3, 8)),
                                                            ("f", (8,)),
                                                            ("f", (8,))]),
    "gelu": (lambda g, a: g.gelu(a), [("f", (3, 4))]),
    "attention": (lambda g, q, k, v: g.attention(q, k, v),
                  [("f", (1, 2, 16, 64))] * 3),
    "attention_causal": (lambda g, q, k, v: g.attention(q, k, v, True),
                         [("f", (2, 2, 16, 64))] * 3),
}


def _run(pkg, name, arrays, kinds, w_seed):
    fn = CASES[name][0]
    ag, tm = (jag, jt) if pkg == "jax" else (tag, tt)
    dev = jdevice.best_device() if pkg == "jax" \
        else tdevice.create_cpu_device()
    ins = [tm.Tensor(data=a, device=dev, requires_grad=k not in "ic",
                     stores_grad=k not in "ic")
           if a.dtype == np.float32 else tm.from_numpy(a, device=dev)
           for a, k in zip(arrays, kinds)]
    prev = ag.training
    ag.training = True
    try:
        out = fn(ag, *ins)
        outs = [o for o in (out if isinstance(out, tuple) else (out,))
                if isinstance(o, tm.Tensor)]
        ys = [o.numpy() for o in outs]
        grads = {}
        if len(CASES[name]) < 3 or CASES[name][2]:
            rng = np.random.RandomState(w_seed)
            loss = None
            for o in outs:
                w = tm.Tensor(data=np.asarray(rng.randn(*o.shape),
                                              np.float32),
                              device=dev, requires_grad=False)
                term = ag.reduce_sum(ag.mul(o, w), None, False)
                loss = term if loss is None else ag.add(loss, term)
            g = ag.gradients(loss)
            grads = {i: g[t].numpy() for i, t in enumerate(ins) if t in g}
    finally:
        ag.training = prev
    if name.startswith("batchnorm"):
        # the updated running statistics: JAX returns them, the port
        # updates the buffers in place and returns them
        ys += [np.asarray(out[1]) if pkg == "jax" else out[1].detach().numpy(),
               np.asarray(out[2]) if pkg == "jax" else out[2].detach().numpy()]
    return ys, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_matches_jax(name):
    spec = CASES[name][1]
    rng = np.random.RandomState(zlib.crc32(name.encode()) % 1000)
    arrays = [_input(k, s, rng) for k, s in spec]
    kinds = [k for k, _ in spec]
    jys, jgs = _run("jax", name, arrays, kinds, 1)
    tys, tgs = _run("port", name, arrays, kinds, 1)
    assert len(tys) == len(jys)
    for a, b in zip(tys, jys):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    assert sorted(tgs) == sorted(jgs), name
    for i in jgs:
        np.testing.assert_allclose(tgs[i], jgs[i], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} input {i}")


def test_raw_tensors_pass_through_without_the_tape():
    """The GPT's path: raw tensors in, raw tensors out, torch's grad mode
    untouched whatever `training` says."""
    x = torch.randn(3, 4, requires_grad=True)
    prev = tag.training
    tag.training = False
    try:
        y = tag.relu(tag.matmul(x, torch.ones(4, 2)))
    finally:
        tag.training = prev
    assert type(y) is torch.Tensor and y.grad_fn is not None
    (gx,) = torch.autograd.grad(y.sum(), [x])
    assert gx.shape == x.shape


def test_eval_mode_records_nothing_and_backward_pairs():
    """Out of training an op records no creator and no torch graph; in
    training, backward yields (Tensor, Tensor) for stores_grad leaves
    and for raw parameters (the parameter's Tensor view, as
    `get_params()` returns it), and stops at leaves that do not store
    grads."""
    cpu = tdevice.create_cpu_device()
    x = tt.Tensor(data=np.ones((2, 3), np.float32), device=cpu,
                  stores_grad=True)
    w = torch.nn.Parameter(torch.full((3, 2), 0.5))
    c = tt.Tensor(data=np.ones((2, 3), np.float32), device=cpu)
    prev = tag.training
    try:
        tag.training = False
        y = tag.matmul(tag.mul(x, c), w)
        assert y.creator is None and y.data.grad_fn is None
        tag.training = True
        y = tag.matmul(tag.mul(x, c), w)
        assert isinstance(y.creator, tag.Matmul) and x.is_dummy()
        pairs = list(tag.backward(tag.reduce_sum(y, None, False)))
    finally:
        tag.training = prev
    got = {id(p): g for p, g in pairs}
    assert set(got) == {id(x), id(tt._param_view(w))}
    assert tt._param_view(w).data is w
    got[id(w)] = got.pop(id(tt._param_view(w)))
    assert isinstance(got[id(x)], tt.Tensor) \
        and isinstance(got[id(w)], tt.Tensor)
    np.testing.assert_allclose(got[id(x)].numpy(), np.ones((2, 3)))
    np.testing.assert_allclose(got[id(w)].numpy(), np.full((3, 2), 2.0))
    with pytest.raises(NotImplementedError, match="distribution"):
        tag.attention(x, x, x, seq_axis="sp")


def test_compute_cast_under_the_bf16_policy():
    """compute_cast rounds floating Tensors to bf16 as JAX does, leaves
    integers and None alone, and its gradient comes back in fp32."""
    x = np.random.RandomState(3).randn(4, 5).astype(np.float32)
    cpu = tdevice.create_cpu_device()
    jx = jt.Tensor(data=x, device=jdevice.best_device(), stores_grad=True)
    tx = tt.Tensor(data=x, device=cpu, stores_grad=True)
    ti = tt.from_numpy(np.arange(3, dtype=np.int32), device=cpu)
    prev = (jag.compute_dtype, tag.compute_dtype, jag.training, tag.training)
    jag.compute_dtype = tag.compute_dtype = "bfloat16"
    jag.training = tag.training = True
    try:
        jy, (ty, ti2, none) = jag.compute_cast(jx), tag.compute_cast(tx, ti,
                                                                     None)
        assert ty.dtype == torch.bfloat16 and ti2 is ti and none is None
        np.testing.assert_array_equal(ty.numpy(),
                                      np.asarray(jy.data, np.float32))
        g = tag.gradients(tag.reduce_sum(ty, None, False))
        assert g[tx].dtype == torch.float32
    finally:
        (jag.compute_dtype, tag.compute_dtype, jag.training,
         tag.training) = prev
