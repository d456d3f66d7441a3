"""Port parity, quantized and verify decode attention: the port's int4
nibble packing and its `flash_decode` / `paged_attention` on CPU tensors
(their plain versions) against singa_tpu.ops.attention's Pallas kernels in
interpret mode, for fp32, int8 and int4 caches x q_tokens 1 and 3 x
groups 1 and 2, at atol = rtol = 2e-5 (the JAX tests' KERNEL_ATOL); and
the verify ladder's row-block identity (tests/test_spec.py's)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singa_tpu.ops import attention as ja
from singa_tpu_torch.ops import attention as ta

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
MODES = ("fp32", "int8", "int4")


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_nibble_pack_unpack_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    q = rng.randint(-8, 8, (3, 5, 16)).astype(np.int8)
    want = np.asarray(ja.nibble_pack(jnp.asarray(q)))
    got = _np(ta.nibble_pack(_t(q)))
    assert got.dtype == np.uint8 and got.shape == (3, 5, 8)
    np.testing.assert_array_equal(got, want)
    for dt, jdt in ((torch.int32, jnp.int32), (torch.float32, jnp.float32)):
        np.testing.assert_array_equal(
            _np(ta.nibble_unpack(_t(want), dt)),
            np.asarray(ja.nibble_unpack(jnp.asarray(want), jdt)))
    np.testing.assert_array_equal(_np(ta.nibble_unpack(_t(got), torch.int32)),
                                  q)


def _blockdiag_q(rng, N, Hp, P, G, D, q_tokens):
    """Packed block-diagonal queries, rows (q_tokens, P, G), as
    _DecodeCore._pack_q builds them."""
    q = np.zeros((N, Hp, q_tokens * P * G, P * D), np.float32)
    for t in range(q_tokens):
        for c in range(P):
            for g in range(G):
                q[:, :, (t * P + c) * G + g, c * D:(c + 1) * D] = \
                    rng.randn(N, Hp, D)
    return q


def _quantize(A, P, D, mode):
    """(…, T, P*D) fp32 -> (rows, scales (…, T, P)) in `mode`, per
    (position, lane block) as the serving cache quantizes."""
    qmax = 7.0 if mode == "int4" else 127.0
    A5 = A.reshape(A.shape[:-1] + (P, D))
    s = np.maximum(np.abs(A5).max(axis=-1), 1e-8) / qmax
    q = np.clip(np.round(A5 / s[..., None]), -qmax, qmax).astype(np.int8)
    rows = q.reshape(A.shape)
    if mode == "int4":
        rows = np.asarray(ja.nibble_pack(jnp.asarray(rows)))
    return rows, s.astype(np.float32)


def _operands(rng, shape, P, D, mode):
    """K, V (and their scales, None for fp32) of `shape` (…, T, P*D)."""
    K = rng.randn(*shape).astype(np.float32)
    V = rng.randn(*shape).astype(np.float32)
    if mode == "fp32":
        return K, V, None, None
    (k8, ks), (v8, vs) = _quantize(K, P, D, mode), _quantize(V, P, D, mode)
    return k8, v8, ks, vs


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("q_tokens", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_flash_decode_matches_jax_kernel(mode, q_tokens, G):
    rng = np.random.RandomState(MODES.index(mode) * 10 + q_tokens * 2 + G)
    N, Hp, P, D, T = 3, 2, 2, 32, 32
    q = _blockdiag_q(rng, N, Hp, P, G, D, q_tokens)
    K, V, ks, vs = _operands(rng, (N, Hp, T, P * D), P, D, mode)
    lens = np.array([5, 17, 32], np.int32)
    jscales = {} if ks is None else dict(k_scales=jnp.asarray(ks),
                                         v_scales=jnp.asarray(vs))
    want = np.asarray(ja.flash_decode(
        *map(jnp.asarray, (q, K, V, lens)), scale=0.2, groups=G,
        use_kernel=True, q_tokens=q_tokens, block_t=8, **jscales))
    tscales = {} if ks is None else dict(k_scales=_t(ks), v_scales=_t(vs))
    got = ta.flash_decode(*map(_t, (q, K, V, lens)), scale=0.2, groups=G,
                          q_tokens=q_tokens, **tscales)
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("q_tokens", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_paged_attention_matches_jax_kernel(mode, q_tokens, G):
    rng = np.random.RandomState(MODES.index(mode) * 10 + q_tokens * 2 + G
                                + 50)
    N, Hp, P, D, ps, M, n_pages = 3, 2, 2, 32, 8, 4, 16
    q = _blockdiag_q(rng, N, Hp, P, G, D, q_tokens)
    K, V, ks, vs = _operands(rng, (n_pages, Hp, ps, P * D), P, D, mode)
    pt = rng.randint(0, n_pages, (N, M)).astype(np.int32)
    lens = np.array([5, 16, 32], np.int32)
    jscales = {} if ks is None else dict(k_scales=jnp.asarray(ks),
                                         v_scales=jnp.asarray(vs))
    want = np.asarray(ja.paged_attention(
        *map(jnp.asarray, (q, K, V, pt, lens)), ps, scale=0.125, groups=G,
        use_kernel=True, q_tokens=q_tokens, **jscales))
    tscales = {} if ks is None else dict(k_scales=_t(ks), v_scales=_t(vs))
    got = ta.paged_attention(*map(_t, (q, K, V, pt, lens)), ps, scale=0.125,
                             groups=G, q_tokens=q_tokens, **tscales)
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_q_tokens_ladder_matches_sequential_limits(mode):
    """Token ti's row block of a q_tokens = kt call equals a q_tokens = 1
    call at length len - (kt - 1 - ti), on both decode ops, every cache
    mode."""
    rng = np.random.RandomState(2)
    N, Hp, P, G, D, ps, M, n_pages, kt = 2, 2, 2, 2, 32, 8, 4, 12, 3
    Q = P * G
    q = _t(_blockdiag_q(rng, N, Hp, P, G, D, kt))
    lens = np.array([7, 24], np.int32)
    Kp, Vp, ks, vs = (None if a is None else _t(a) for a in
                      _operands(rng, (n_pages, Hp, ps, P * D), P, D, mode))
    pt = _t(rng.randint(0, n_pages, (N, M)).astype(np.int32))
    K, V, dks, dvs = (None if a is None else _t(a) for a in
                      _operands(rng, (N, Hp, M * ps, P * D), P, D, mode))
    calls = (
        lambda qq, ln, qt: ta.paged_attention(
            qq, Kp, Vp, pt, _t(ln), ps, 0.2, ks, vs, G, q_tokens=qt),
        lambda qq, ln, qt: ta.flash_decode(
            qq, K, V, _t(ln), 0.2, dks, dvs, G, q_tokens=qt))
    for call in calls:
        r = call(q, lens, kt)
        for ti in range(kt):
            r1 = call(q[:, :, ti * Q:(ti + 1) * Q].contiguous(),
                      (lens - (kt - 1 - ti)).astype(np.int32), 1)
            np.testing.assert_allclose(_np(r[:, :, ti * Q:(ti + 1) * Q]),
                                       _np(r1), atol=1e-5)


def test_paged_factors_match_jax():
    rng = np.random.RandomState(4)
    sc = rng.rand(2, 3, 5, 2).astype(np.float32)
    for groups, rows, qt in ((1, 2, 1), (2, 4, 1), (2, 13, 3), (1, 9, 4)):
        np.testing.assert_array_equal(
            _np(ta._paged_factors(_t(sc), groups, rows, qt)),
            np.asarray(ja._paged_factors(jnp.asarray(sc), groups, rows,
                                         qt)))


def test_cpu_quantized_dispatch_counts_no_launch():
    """Quantized and ladder calls on CPU tensors run the plain versions:
    no launch counted, by kernel or by mode; use_kernel=True raises."""
    ta.reset_launches()
    rng = np.random.RandomState(5)
    q = _t(_blockdiag_q(rng, 2, 1, 2, 1, 32, 2))
    K, V, ks, vs = map(_t, _operands(rng, (2, 1, 16, 64), 2, 32, "int4"))
    lens = torch.tensor([3, 16], dtype=torch.int32)
    ta.flash_decode(q, K, V, lens, 0.2, ks, vs, 1, q_tokens=2)
    assert not any(ta.LAUNCHES.values())
    assert not any(ta.LAUNCHES_BY_MODE.values())
    assert ("flash_decode", "int4", "ladder") in ta.LAUNCHES_BY_MODE
    with pytest.raises(ValueError, match="use_kernel=True"):
        ta.flash_decode(q, K, V, lens, 0.2, ks, vs, 1, use_kernel=True,
                        q_tokens=2)
