"""Port parity, the ring attention's hop loop in this process: the
loopback ring (`ops.attention._Loopback`, every rank of an n-rank ring
in one process, lock step, the schedule `chip_smoke.py` drives on the
card) and `ring_attention` on a bound mesh of one rank with no process
group.

- The loopback ring at n = 2 and 4, causal and not, fp32, on
  tests/test_attention.py:60-95's (1, 2, 64, 16) inputs: the blocks'
  outputs against JAX's `ring_attention_sharded` over {sp 4}, rtol and
  atol 2e-4; the gradients of sum(o^2) (the backward ring from the
  merged O and lse) against JAX's through it, 2e-3.
- The ragged shard S_local = 2032 (tests/test_attention.py:220), causal,
  n = 4: JAX falls back to `_ring_jnp` there; the port's ring takes any
  S_local. Against JAX's result, rtol 2e-4 and atol 2e-5 as JAX's test.
- With the axis unbound, `autograd.attention(seq_axis=...)` is
  `flash_attention` and `ring_attention` raises NameError; bound at one
  rank, the one-hop ring equals flash attention bitwise, forward and
  gradients (hop 0's merge is exact).
- The hops each rank runs: a causal ring n (n + 1) / 2 forward and as
  many backward hops (n on the diagonal, causal; the rest in full), a
  non-causal one n^2; each backward hop takes K2a or K2b + K2c by
  `_FUSED_DQ_BYTES_CAP` on S_local * D * 4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singa_tpu.ops import attention as jatt
from singa_tpu.parallel import make_mesh as jmake_mesh
from singa_tpu_torch import autograd as tag
from singa_tpu_torch.ops import attention as A
from singa_tpu_torch.parallel import make_mesh
from test_torch_sp import jax_ring, ring_inputs

torch.set_num_threads(2)


def _blocks(t, n):
    return [b.contiguous() for b in torch.as_tensor(t).chunk(n, dim=2)]


def loopback(qkv, n, causal, dos=None):
    """The loopback ring on the global arrays `qkv`: (out, lse) of the
    blocks concatenated, and with `dos` (global dO) the gradients."""
    qs, ks, vs = (_blocks(t, n) for t in qkv)
    ring, scale = A._Loopback(n), qs[0].shape[-1] ** -0.5
    outs, lses = A._ring_fwd(qs, ks, vs, ring, causal, scale)
    res = [torch.cat(outs, 2), torch.cat(lses, 2)]
    if dos is not None:
        grads = A._ring_bwd(qs, ks, vs, outs, lses, _blocks(dos, n), ring,
                            causal, scale)
        res.append([torch.cat(g, 2) for g in grads])
    return res


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_loopback_ring_matches_jax(n, causal):
    out, grads = jax_ring(causal)
    got, _ = loopback(ring_inputs(), n, causal)
    np.testing.assert_allclose(got.numpy(), out, rtol=2e-4, atol=2e-4)
    _, _, got = loopback(ring_inputs(), n, causal, 2 * got)
    for name, a, b in zip("qkv", got, grads):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3, atol=2e-3,
                                   err_msg=name)


def test_ragged_shard_matches_jax_ring_jnp():
    q = np.random.RandomState(0).rand(1, 1, 4 * 2032, 16) \
        .astype(np.float32)
    want = jatt.ring_attention_sharded(jnp.asarray(q), jnp.asarray(q),
                                       jnp.asarray(q), jmake_mesh({"sp": 4}),
                                       "sp", causal=True)
    got, _ = loopback((q, q, q), 4, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_one_hop_ring_is_flash_attention(causal):
    q, k, v = (torch.as_tensor(t) for t in ring_inputs())
    want = A.flash_attention(q, k, v, causal)
    assert torch.equal(tag.attention(q, k, v, causal, seq_axis="sp"), want)
    with pytest.raises(NameError, match="sp"):
        A.ring_attention(q, k, v, "sp", causal)
    leaves = [[t.clone().requires_grad_(True) for t in (q, k, v)]
              for _ in range(2)]
    with make_mesh({"sp": 1}).bind():
        got = A.ring_attention(*leaves[0], "sp", causal)
        assert torch.equal(tag.attention(q, k, v, causal, seq_axis="sp"),
                           want)
    ref = A.flash_attention(*leaves[1], causal)
    assert torch.equal(got, ref)
    for a, b in zip(torch.autograd.grad((got ** 2).sum(), leaves[0]),
                    torch.autograd.grad((ref ** 2).sum(), leaves[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_hops_of_each_kind(monkeypatch, n, causal):
    fwd, bwd = [], []
    flash_fwd, bwd_hop = A._flash_fwd, A._ring_bwd_hop

    def count_fwd(q, k, v, c, *a):
        fwd.append(c)
        return flash_fwd(q, k, v, c, *a)

    def count_bwd(*a):
        bwd.append((a[7], a[9]))          # (causal, fused)
        return bwd_hop(*a)

    monkeypatch.setattr(A, "_flash_fwd", count_fwd)
    monkeypatch.setattr(A, "_ring_bwd_hop", count_bwd)
    qkv = ring_inputs()
    S_local, D = 64 // n, 16
    # fused while S_local * D * 4 <= the cap: the split pair one byte past
    for cap, fused in ((S_local * D * 4, True), (S_local * D * 4 - 1, False)):
        monkeypatch.setattr(A, "_FUSED_DQ_BYTES_CAP", cap)
        out, _ = loopback(qkv, n, causal)
        fwd.clear()
        bwd.clear()
        loopback(qkv, n, causal, 2 * out)
        hops = n * (n + 1) // 2 if causal else n * n
        assert len(fwd) == len(bwd) == hops
        assert fwd.count(True) == (n if causal else 0)
        assert [c for c, _ in bwd].count(True) == fwd.count(True)
        assert {f for _, f in bwd} == {fused}
