"""Port parity, the Tensor API: `singa_tpu_torch.tensor` against
`singa_tpu.tensor` on the same seeded numpy inputs, one parametrised case
per method or module function (exact for data movement, 1e-6 relative
for fp32 arithmetic), plus the dtype names, the host round trip, the
random fills' moments and the device rules (the default device is the
card: without one it raises)."""

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jt
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import tensor as tt

torch.set_num_threads(2)
RTOL = 1e-6


def _a(shape, seed=0, pos=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(x) + 0.5 if pos else x


def _pair(x, **kw):
    return (jt.from_numpy(x, device=jdevice.best_device(), **kw),
            tt.from_numpy(x, device=tdevice.create_cpu_device(), **kw))


def _np(v):
    if isinstance(v, (jt.Tensor, tt.Tensor)):
        return v.numpy()
    return np.asarray(v)


M = _a((3, 4))
P = _a((3, 4), 1, pos=True)
V3, V4 = _a((3,), 2), _a((4,), 3)
SQ = _a((4, 5), 4)

# name -> fn(mod, pair-of-inputs...) run on each package's tensors
CASES = {
    "add": lambda m, a, b: m.add(a, b),
    "sub": lambda m, a, b: m.sub(a, b),
    "eltwise_mult": lambda m, a, b: m.eltwise_mult(a, b),
    "div": lambda m, a, b: m.div(a, b),
    "div_scalar_lhs": lambda m, a, b: m.div(2.0, b),
    "radd_rsub_rmul_rdiv": lambda m, a, b: ((1.0 + a) - 2.0 * b) / (3.0 - b),
    "pow": lambda m, a, b: m.pow(b, 1.5),
    "dunder_pow_neg": lambda m, a, b: -(b ** 2.0),
    "matmul_dunder": lambda m, a, b: a @ m.transpose(b),
    "mult": lambda m, a, b: m.mult(a, m.transpose(b)),
    "axpy": lambda m, a, b: m.axpy(0.5, a, m.Tensor(data=b.data,
                                                    device=b.device)),
    "einsum": lambda m, a, b: m.einsum("ij,kj->ik", a, b),
    "tensordot": lambda m, a, b: m.tensordot(a, b, axes=([1], [1])),
    "lt": lambda m, a, b: m.lt(a, b),
    "le": lambda m, a, b: m.le(a, 0.0),
    "gt": lambda m, a, b: m.gt(a, b),
    "ge": lambda m, a, b: m.ge(a, 0.1),
    "eq": lambda m, a, b: m.eq(a, a),
    "sum_all": lambda m, a, b: m.sum(a),
    "sum_axis": lambda m, a, b: m.sum(a, axis=1),
    "mean_axis": lambda m, a, b: m.mean(a, axis=0),
    "max": lambda m, a, b: m.max(a, axis=1),
    "min": lambda m, a, b: m.min(a),
    "argmax": lambda m, a, b: m.argmax(a, axis=1),
    "softmax": lambda m, a, b: m.softmax(a, axis=-1),
    "clip": lambda m, a, b: m.clip(a, -0.5, 0.5),
    "concatenate": lambda m, a, b: m.concatenate([a, b], axis=1),
    "repeat": lambda m, a, b: m.repeat(a, 2, axis=0),
    "repeat_flat": lambda m, a, b: a.repeat(2),
    "reshape": lambda m, a, b: m.reshape(a, (4, 3)),
    "transpose_T": lambda m, a, b: a.T,
    "getitem": lambda m, a, b: a[1:, ::2],
    "method_sum": lambda m, a, b: a.sum(axis=0),
    "zeros_like_ones_like": lambda m, a, b: m.zeros_like(a) + m.ones_like(b),
    "sum_columns_rows": lambda m, a, b: m.concatenate(
        [m.sum_columns(a), m.sum_rows(m.transpose(b))]),
    "average_axis": lambda m, a, b: m.average(a, axis=1),
    "average_all": lambda m, a, b: m.average(b),
    "l1_l2": lambda m, a, b: np.array([a.l1(), b.l2()], np.float32),
    "clone": lambda m, a, b: a.clone(),
    "contiguous": lambda m, a, b: m.contiguous(a),
    "as_type": lambda m, a, b: a.as_type("int32"),
}
for _name in ("abs", "exp", "sign", "square", "tanh", "sigmoid", "relu",
              "sin", "cos", "ceil", "floor", "round"):
    CASES[_name] = (lambda n: lambda m, a, b: getattr(m, n)(a))(_name)
for _name in ("log", "sqrt"):
    CASES[_name] = (lambda n: lambda m, a, b: getattr(m, n)(b))(_name)
ROWCOL = {"add_column": V3, "sub_column": V3, "mult_column": V3,
          "div_column": V3, "add_row": V4, "sub_row": V4, "mult_row": V4,
          "div_row": V4}


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_function_matches_jax(name):
    ja, ta = _pair(M)
    jb, tb = _pair(P)
    want, got = _np(CASES[name](jt, ja, jb)), _np(CASES[name](tt, ta, tb))
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", sorted(ROWCOL))
def test_row_column_functions_match_jax(name):
    """The 2-D row/column functions, module-level and in place."""
    ja, ta = _pair(M)
    jv, tv = _pair(ROWCOL[name])
    np.testing.assert_allclose(_np(getattr(tt, name)(ta, tv)),
                               _np(getattr(jt, name)(ja, jv)), rtol=RTOL)
    if name.split("_")[0] in ("add", "mult", "div"):
        getattr(ja, name)(jv)
        getattr(ta, name)(tv)
        np.testing.assert_allclose(ta.numpy(), ja.numpy(), rtol=RTOL)


@pytest.mark.parametrize("name", ["iadd", "isub", "imul", "itruediv"])
def test_inplace_operators_match_jax(name):
    ja, ta = _pair(M)
    jb, tb = _pair(P)
    op = getattr(type(ja), f"__{name}__")
    top = getattr(type(ta), f"__{name}__")
    assert top(ta, tb) is ta
    op(ja, jb)
    np.testing.assert_allclose(ta.numpy(), ja.numpy(), rtol=RTOL)


def test_dtypes_shapes_and_flags():
    """Dtype names follow the JAX package's table; int32 labels stay
    int32; float64 input becomes float32; data tensors default to
    requires_grad False and the comparison masks too."""
    cpu = tdevice.create_cpu_device()
    # (int64 is left out: JAX without x64 truncates it to int32)
    for name in ("float16", "float32", "bfloat16", "int8", "int32",
                 "uint8", "float", "int", "char"):
        t = tt.Tensor((2, 3), cpu, name)
        j = jt.Tensor((2, 3), jdevice.best_device(), name)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        assert t.shape == (2, 3) and t.ndim == 2 and t.size() == 6
    assert tt.sizeof("bfloat16") == jt.sizeof("bfloat16") == 2
    lab = tt.from_numpy(np.arange(4, dtype=np.int32), device=cpu)
    assert lab.dtype == tt.int32 and not lab.requires_grad
    assert tt.from_numpy(np.zeros(3), device=cpu).dtype == tt.float32
    assert tt.Tensor(data=np.zeros(3), device=cpu).dtype == tt.float32
    _, ta = _pair(M)
    assert not (ta < 0).requires_grad and (ta + 1).requires_grad
    assert tt.product((2, 3, 4)) == jt.product((2, 3, 4)) == 24
    assert ta.memsize() == 48 and not ta.is_empty() and len(ta) == 3


def test_host_round_trip_and_copies():
    """copy_from_numpy, set_value, copy_data, to_host, copy_data_to_from
    and from_raw_tensor(s) give JAX's values."""
    cpu = tdevice.create_cpu_device()
    jd = jdevice.best_device()
    j, t = jt.Tensor((3, 4), jd), tt.Tensor((3, 4), cpu)
    j.copy_from_numpy(M)
    t.copy_from_numpy(M)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    np.testing.assert_array_equal(tt.to_numpy(t.clone().set_value(2.5)),
                                  jt.to_numpy(j.clone().set_value(2.5)))
    j2, t2 = jt.Tensor((4, 3), jd), tt.Tensor((4, 3), cpu)
    j2.copy_data(j)
    t2.copy_data(t)
    np.testing.assert_array_equal(t2.numpy(), j2.numpy())
    jz, tz = jt.zeros((3, 4), jd), tt.zeros((3, 4), cpu)
    jt.copy_data_to_from(jz, j, size=5)
    tt.copy_data_to_from(tz, t, size=5)
    np.testing.assert_array_equal(tz.numpy(), jz.numpy())
    h = tt.to_host(t)
    assert h.device.is_host() and h.device is cpu
    np.testing.assert_array_equal(h.numpy(), M)
    tt.copy_from_numpy(t2, M.T)
    np.testing.assert_array_equal(t2.numpy(), M.T)
    np.testing.assert_array_equal(tt.ones((2,), cpu).numpy(),
                                  jt.ones((2,), jd).numpy())
    # a raw tensor keeps its placement
    raw = tt.from_raw_tensors([torch.ones(2), torch.zeros(3)])
    assert [r.device for r in raw] == [cpu, cpu]
    assert tt.Tensor(data=np.float32(3.0), device=cpu).item() == 3.0


def test_random_fills_draw_from_the_device_generator():
    """gaussian/uniform/bernoulli (methods and module functions) have
    the requested moments, and reseeding the Device repeats the draws."""
    cpu = tdevice.create_cpu_device()
    cpu.SetRandSeed(7)
    g = tt.gaussian(1.0, 2.0, (200, 100), cpu)
    u = tt.uniform(-1.0, 3.0, (200, 100), cpu)
    b = tt.bernoulli(0.3, (200, 100), cpu)
    r = tt.random((4,), cpu)
    assert abs(g.numpy().mean() - 1.0) < 0.05
    assert abs(g.numpy().std() - 2.0) < 0.05
    assert u.numpy().min() >= -1.0 and u.numpy().max() <= 3.0
    assert abs(u.numpy().mean() - 1.0) < 0.05
    assert set(np.unique(b.numpy())) == {0.0, 1.0}
    assert abs(b.numpy().mean() - 0.3) < 0.02
    cpu.SetRandSeed(7)
    np.testing.assert_array_equal(tt.gaussian(1.0, 2.0, (200, 100),
                                              cpu).numpy(), g.numpy())
    assert r.shape == (4,) and (r.numpy() < 1).all()


def test_devices():
    """Device wraps a torch.device; the default device is the card, so
    without one it raises; resolve takes Devices, torch.devices, strings
    and None."""
    cpu = tdevice.create_cpu_device()
    assert cpu is tdevice.of("cpu") and cpu.is_host()
    assert cpu.platform == "cpu" and cpu.lang == "kCpp"
    assert tdevice.resolve(cpu) == torch.device("cpu")
    assert tdevice.resolve("cpu") == tdevice.resolve(torch.device("cpu"))
    cpu.Sync()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    assert tdevice.get_num_gpus() == 0
    for fn in (tdevice.get_default_device, tdevice.best_device,
               lambda: tdevice.create_cuda_gpu_on(0),
               lambda: tdevice.resolve(None),
               lambda: tdevice.create_cuda_gpus(1),
               lambda: tdevice.get_gpu_mem_size(0),
               lambda: tt.Tensor((2,))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()
