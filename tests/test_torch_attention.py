"""Port parity, attention kernels: singa_tpu_torch.ops.attention against
singa_tpu.ops.attention on the CPU, on the same numpy inputs. On CPU
tensors the port's wrappers run their plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode and its references. fp32,
atol = rtol = 2e-5 (the JAX kernel tests' own tolerance)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singa_tpu.ops import attention as ja
from singa_tpu_torch.ops import attention as ta

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [16, 37, 64])
def test_flash_attention_matches_jax(S, causal):
    """S=37 does not tile the TPU kernel, so JAX takes its reference there;
    the port's kernel takes any S (its plain version runs here)."""
    rng = np.random.RandomState(S)
    q, k, v = (rng.randn(1, 2, S, 64).astype(np.float32) for _ in range(3))
    want = np.asarray(ja.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal))
    got = ta.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal)
    np.testing.assert_allclose(_np(got), want, **TOL)
    ref = ta.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal)
    np.testing.assert_allclose(_np(ref), want, **TOL)


@pytest.mark.parametrize("S", [16, 64])
def test_flash_lse_matches_jax_kernel(S):
    """The per-row logsumexp the forward emits for the backward equals the
    Pallas kernel's (interpret mode), causal, at a tiling S."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(1, 2, S, 64).astype(np.float32) for _ in range(3))
    scale = 64 ** -0.5
    _, lse_j = ja._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             True, scale, None, None, None)
    assert lse_j is not None, "JAX took its reference path"
    _, lse_t = ta._flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), True, scale)
    np.testing.assert_allclose(_np(lse_t), np.asarray(lse_j), **TOL)


def _decode_inputs(G, seed=0):
    rng = np.random.RandomState(seed)
    N, Hp, P, D, T = 4, 2, 2, 64, 32
    q = rng.randn(N, Hp, P * G, P * D).astype(np.float32)
    K = rng.randn(N, Hp, T, P * D).astype(np.float32)
    V = rng.randn(N, Hp, T, P * D).astype(np.float32)
    lens = np.array([1, 7, 16, 32], np.int32)
    return q, K, V, lens


@pytest.mark.parametrize("G", [1, 2])
def test_flash_decode_matches_jax(G):
    q, K, V, lens = _decode_inputs(G)
    jq, jK, jV, jl = map(jnp.asarray, (q, K, V, lens))
    ker = np.asarray(ja.flash_decode(jq, jK, jV, jl, scale=0.125, groups=G,
                                     use_kernel=True))
    ref = np.asarray(ja.flash_decode_reference(jq, jK, jV, jl, scale=0.125,
                                               groups=G))
    tq, tK, tV, tl = map(torch.from_numpy, (q, K, V, lens))
    got = _np(ta.flash_decode(tq, tK, tV, tl, scale=0.125))
    np.testing.assert_allclose(got, ker, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(
        _np(ta.flash_decode_reference(tq, tK, tV, tl, 0.125)), ref, **TOL)


def _paged_inputs(seed=0):
    rng = np.random.RandomState(seed)
    N, Hp, P, G, D, ps, M, n_pages = 3, 2, 2, 2, 64, 8, 4, 16
    PD, Q = P * D, P * G
    q = rng.randn(N, Hp, Q, PD).astype(np.float32)
    kp = rng.randn(n_pages, Hp, ps, PD).astype(np.float32)
    vp = rng.randn(n_pages, Hp, ps, PD).astype(np.float32)
    pt = rng.randint(0, n_pages, (N, M)).astype(np.int32)
    lens = np.array([5, 16, 32], np.int32)     # mid / page edge / full
    return q, kp, vp, pt, lens, ps, G


def test_paged_attention_matches_jax():
    """At the shapes of tests/test_engine.py's
    test_paged_kernel_matches_reference."""
    q, kp, vp, pt, lens, ps, G = _paged_inputs()
    j = list(map(jnp.asarray, (q, kp, vp, pt, lens)))
    ker = np.asarray(ja.paged_attention(*j, ps, scale=0.125, groups=G,
                                        use_kernel=True))
    ref = np.asarray(ja.paged_attention_reference(*j, ps, scale=0.125,
                                                  groups=G))
    t = list(map(torch.from_numpy, (q, kp, vp, pt, lens)))
    got = _np(ta.paged_attention(*t, ps, scale=0.125))
    np.testing.assert_allclose(got, ker, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("q_tokens", [1, 3])
def test_row_limits_matches_jax(q_tokens):
    lens = np.array([4, 9, 17], np.int32)
    Q = 4 * q_tokens + 2
    want = np.asarray(ja._row_limits(jnp.asarray(lens), Q, 4, q_tokens))
    got = _np(ta._row_limits(torch.from_numpy(lens), Q, 4, q_tokens))
    np.testing.assert_array_equal(got, want)


def test_verify_ladder_reference_matches_jax():
    """The plain version keeps the JAX reference's q_tokens ladder (the
    kernels' ladder is held against it on the card; the quantized modes
    in test_torch_quant_decode.py)."""
    q, K, V, lens = _decode_inputs(1, seed=3)
    q = np.concatenate([q, q * 0.5], axis=2)      # 2 tokens of P*G rows
    lens = np.maximum(lens, 2)
    want = np.asarray(ja.flash_decode_reference(
        *map(jnp.asarray, (q, K, V, lens)), scale=0.125, q_tokens=2))
    got = ta.flash_decode_reference(*map(torch.from_numpy, (q, K, V, lens)),
                                    scale=0.125, q_tokens=2)
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    """On CPU tensors every wrapper runs its plain version: the launch
    counters stay 0, use_kernel=False gives the same result, and
    use_kernel=True raises instead of falling back."""
    ta.reset_launches()
    q, K, V, lens = (torch.from_numpy(a) for a in _decode_inputs(1))
    a = ta.flash_decode(q, K, V, lens, 0.125)
    b = ta.flash_decode(q, K, V, lens, 0.125, use_kernel=False)
    assert torch.equal(a, b)
    x = torch.randn(1, 2, 8, 64)
    ta.flash_attention(x, x, x, True)
    xg = x.clone().requires_grad_()
    ta.flash_attention(xg, xg, xg, True).sum().backward()   # plain backward
    pq, kp, vp, pt, pl, ps, _ = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in _paged_inputs())
    ta.paged_attention(pq, kp, vp, pt, pl, ps, 0.125)
    assert ta.LAUNCHES == {"flash_fwd": 0, "flash_bwd_fused": 0,
                           "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                           "flash_decode": 0, "paged_attention": 0}
    with pytest.raises(ValueError, match="use_kernel=True"):
        ta.flash_decode(q, K, V, lens, 0.125, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True"):
        ta.paged_attention(pq, kp, vp, pt, pl, ps, 0.125, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True"):
        ta.flash_attention(x, x, x, True, use_kernel=True)
