"""The rounding budget of the tensor-core flash kernels (the bf16 paths of
`csrc/flash_fwd.cu`, `csrc/flash_bwd_fused.cu`, `csrc/flash_bwd_dq.cu` and
`csrc/flash_bwd_dkv.cu`), emulated on the CPU.

The kernels keep fp32 accumulators and round at fixed points: the forward
rounds P to bf16 before P V; the backward takes q pre-scaled in bf16 and
rounds P^T and dS^T to bf16 before dV = P^T dO, dK = dS^T q and dQ = dS k.
Each emulation below rounds at exactly those points, tile by tile as the
kernels walk (128-key tiles with the online softmax in the forward; 128
keys by 64 q rows in the fused backward K2a and in K2c, which runs K2a's
walk without dQ; q rows by 64-key tiles in K2b, dS rounded to bf16 before
dS k and dQ * scale rounded last), from numpy inputs made from a seed.

Held against the fp32 plain versions (`attention_reference`,
`flash_bwd_reference`) and the JAX package's `flash_attention` (its Pallas
kernels in interpret mode, and `jax.grad` through them, on the fused route
and, for K2b + K2c, on the split route forced through
`_FUSED_DQ_BYTES_CAP`), on the same bf16 values, the results stay within
the card checks' bf16 tolerances: 2e-2 absolute for the forward, 3e-2 of
max |ref| for each of dq, dk, dv. That is why those tolerances did not
have to be loosened for the redesign.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singa_tpu.ops import attention as ja
from singa_tpu_torch.ops import attention as ta

torch.set_num_threads(2)
FWD_TOL = 2e-2       # chip_smoke.TOL["bfloat16"]
BWD_TOL = 3e-2       # chip_smoke.BWD_TOL["bfloat16"], of max |ref|
S, BH = 1024, 2      # causal, batch 1 x 2 heads
BK_FWD, BK_BWD, BQ_BWD = 128, 128, 64
BK_DQ = 64           # K2b's key tiles
LOG2E = float(np.log2(np.e))


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _inputs(D, seed):
    """q, k, v, dO as bf16 values held in fp32, (1, BH, S, D)."""
    rng = np.random.RandomState(seed)
    return [_bf16(torch.from_numpy(rng.randn(1, BH, S, D)
                                   .astype(np.float32))) for _ in range(4)]


def _causal_mask(rows, cols):
    return cols[None, :] > rows[:, None]


def emulate_fwd(q, k, v, scale, rnd=_bf16):
    """(O in bf16, lse) as the bf16 kernel computes them: per 128-key
    tile, fp32 scores, an exp2 online softmax, P rounded to bf16 (`rnd`)
    before P V with fp32 accumulation; O / l rounded to bf16 at the end."""
    sl2 = scale * LOG2E
    rows = torch.arange(S)
    m = torch.full(q.shape[:-1], ta._NEG_INF)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, S, BK_FWD):
        kt, vt = k[..., k0:k0 + BK_FWD, :], v[..., k0:k0 + BK_FWD, :]
        s = q @ kt.transpose(-1, -2)
        s = s.masked_fill(_causal_mask(rows, torch.arange(k0, k0 + BK_FWD)),
                          ta._NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - m_new) * sl2)
        p = torch.exp2(s * sl2 - (m_new * sl2)[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + rnd(p) @ vt
        m = m_new
    return rnd(acc / l[..., None]), m * scale + torch.log(l)


def emulate_bwd(q, k, v, o, lse, do, scale, with_dq=True):
    """(dq, dk, dv) in bf16 as the fused bf16 kernel computes them: q
    pre-scaled in bf16, fp32 S^T and dP^T, P^T and dS^T rounded to bf16
    before the three products, fp32 accumulation, dQ scaled last.
    with_dq=False is K2c, the same walk without the dQ branch: dq is
    None."""
    qf = _bf16(q * scale)
    delta = (do * o).sum(-1)
    dq = torch.zeros(q.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for k0 in range(0, S, BK_BWD):
        ks = slice(k0, k0 + BK_BWD)
        keys = torch.arange(k0, k0 + BK_BWD)
        for q0 in range(k0 - k0 % BQ_BWD, S, BQ_BWD):
            qs = slice(q0, q0 + BQ_BWD)
            st = k[..., ks, :] @ qf[..., qs, :].transpose(-1, -2)
            pt = torch.exp2(st * LOG2E - (lse[..., qs] * LOG2E)[..., None, :])
            pt = pt.masked_fill(_causal_mask(torch.arange(q0, q0 + BQ_BWD),
                                             keys).T, 0.0)
            dpt = v[..., ks, :] @ do[..., qs, :].transpose(-1, -2)
            dst = _bf16(pt * (dpt - delta[..., None, qs]))
            pt = _bf16(pt)
            dv[..., ks, :] += pt @ do[..., qs, :]
            dk[..., ks, :] += dst @ qf[..., qs, :]
            if with_dq:
                dq[..., qs, :] += dst.transpose(-1, -2) @ k[..., ks, :]
    return (_bf16(dq * scale) if with_dq else None), _bf16(dk), _bf16(dv)


def emulate_bwd_dq(q, k, v, o, lse, do, scale):
    """dq in bf16 as K2b computes it: q pre-scaled in bf16; for each q row,
    the 64-key tiles up to the causal diagonal with fp32 S and dP,
    P = exp2(S log2e - lse log2e), dS rounded to bf16 before dS k, fp32
    accumulation, dQ * scale rounded to bf16 last. Rows are independent,
    so the kernel's 128-row q tiles need no loop of their own; tiles wholly
    above a row add exact zeros."""
    qf = _bf16(q * scale)
    delta = (do * o).sum(-1)
    rows = torch.arange(S)
    dq = torch.zeros(q.shape)
    for k0 in range(0, S, BK_DQ):
        ks = slice(k0, k0 + BK_DQ)
        s = qf @ k[..., ks, :].transpose(-1, -2)
        p = torch.exp2(s * LOG2E - (lse * LOG2E)[..., None])
        p = p.masked_fill(_causal_mask(rows, torch.arange(k0, k0 + BK_DQ)),
                          0.0)
        dp = do @ v[..., ks, :].transpose(-1, -2)
        dq += _bf16(p * (dp - delta[..., None])) @ k[..., ks, :]
    return _bf16(dq * scale)


def _jax(a):
    return jnp.asarray(a.numpy())


def _jax_fwd(q, k, v):
    return torch.from_numpy(np.array(ja.flash_attention(
        _jax(q), _jax(k), _jax(v), True, None, None, None, True)))


def _jax_grads(q, k, v, do, route="fused"):
    """jax.grad through the JAX package's flash attention in interpret
    mode; route "split" forces its K2b/K2c pair as its own test does (cap
    0), "fused" leaves S 1024's default."""
    def f(q_, k_, v_):
        out = ja.flash_attention(q_, k_, v_, True, None, None, None, True)
        return jnp.sum(out * _jax(do))
    cap = ja._FUSED_DQ_BYTES_CAP
    try:
        if route == "split":
            ja._FUSED_DQ_BYTES_CAP = 0
        grads = jax.grad(f, (0, 1, 2))(_jax(q), _jax(k), _jax(v))
    finally:
        ja._FUSED_DQ_BYTES_CAP = cap
    return [torch.from_numpy(np.array(g)) for g in grads]


@pytest.mark.parametrize("against", ["port_reference", "jax_interpret"])
@pytest.mark.parametrize("D", [64, 128])
def test_forward_rounding_within_bf16_tolerance(D, against):
    q, k, v, _ = _inputs(D, seed=D)
    scale = D ** -0.5
    out, lse = emulate_fwd(q, k, v, scale)
    if against == "port_reference":
        ref, ref_lse = ta._attention_plain(q, k, v, True, scale)
        # lse is fp32 throughout: only summation order and exp2 differ
        np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-4)
    else:
        ref = _jax_fwd(q, k, v)
    err = float((out - ref).abs().max())
    assert err <= FWD_TOL, err
    # the budget is spent on bf16 rounding, not on a wrong softmax: the
    # error is of the order of a bf16 step of |O| <= 1
    assert err > 1e-4, err


@pytest.mark.parametrize("against", ["port_reference", "jax_interpret"])
@pytest.mark.parametrize("D", [64, 128])
def test_backward_rounding_within_bf16_tolerance(D, against):
    q, k, v, do = _inputs(D, seed=D + 1)
    scale = D ** -0.5
    # the backward starts from the bf16 forward's O and lse, as on the card
    o, lse = emulate_fwd(q, k, v, scale)
    got = emulate_bwd(q, k, v, o, lse, do, scale)
    if against == "port_reference":
        ref = ta.flash_bwd_reference(q, k, v, o, lse, do, True, scale)
    else:
        ref = _jax_grads(q, k, v, do)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        rel = float((g - r).abs().max() / r.abs().max())
        assert rel <= BWD_TOL, (name, rel)


@pytest.mark.parametrize("against", ["port_reference", "jax_split_interpret"])
@pytest.mark.parametrize("D", [64, 128])
def test_split_backward_rounding_within_bf16_tolerance(D, against):
    """K2b's dq and K2c's dk, dv, emulated, within the bf16 budget of the
    fp32 plain backward and of JAX's split route."""
    q, k, v, do = _inputs(D, seed=D + 2)
    scale = D ** -0.5
    o, lse = emulate_fwd(q, k, v, scale)
    dq = emulate_bwd_dq(q, k, v, o, lse, do, scale)
    _, dk, dv = emulate_bwd(q, k, v, o, lse, do, scale, with_dq=False)
    if against == "port_reference":
        ref = ta.flash_bwd_reference(q, k, v, o, lse, do, True, scale)
    else:
        ref = _jax_grads(q, k, v, do, route="split")
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        rel = float((g - r).abs().max() / r.abs().max())
        assert rel <= BWD_TOL, (name, rel)
        # the budget is spent on bf16 rounding: the emulation is not fp32
        assert rel > 1e-4, (name, rel)


@pytest.mark.parametrize("D", [64, 128])
def test_split_dkv_emulation_equals_fused_bitwise(D):
    """K2c is K2a's walk without the dQ branch: same tiles, order and
    rounding, so its dk and dv equal the fused emulation's bit for bit
    (the card check holds the two kernels to the same)."""
    q, k, v, do = _inputs(D, seed=D + 3)
    scale = D ** -0.5
    o, lse = emulate_fwd(q, k, v, scale)
    _, dk_split, dv_split = emulate_bwd(q, k, v, o, lse, do, scale,
                                        with_dq=False)
    dq_fused, dk_fused, dv_fused = emulate_bwd(q, k, v, o, lse, do, scale)
    assert torch.equal(dk_split, dk_fused)
    assert torch.equal(dv_split, dv_fused)
    # and K2b's dq is a different sum (64-key tiles by q row, not 64-row
    # q tiles by 128 keys) within the budget of the fused one
    dq = emulate_bwd_dq(q, k, v, o, lse, do, scale)
    rel = float((dq - dq_fused).abs().max() / dq_fused.abs().max())
    assert rel <= BWD_TOL, rel


def test_emulation_rounds_where_the_kernel_rounds():
    """Rounding P to bf16 is what moves the forward off fp32: without it
    the emulation equals the fp32 plain version to fp32 rounding of O."""
    q, k, v, _ = _inputs(64, seed=3)
    scale = 64 ** -0.5
    out, _ = emulate_fwd(q, k, v, scale)
    ref = ta._attention_plain(q, k, v, True, scale)[0]
    err_bf16 = float((out - ref).abs().max())
    exact, _ = emulate_fwd(q, k, v, scale, rnd=lambda x: x)
    assert float((exact - ref).abs().max()) < 1e-5
    assert err_bf16 > 10 * float((exact - ref).abs().max())
