"""The decode kernels' split of the cache axis (flash-decoding), checked on
the CPU: a plain-torch emulation of what csrc/decode_common.cuh computes
(chunks of C positions, tiles of 32 with the online softmax, the empty
partial (-1e30, 0) of a chunk at or past the live end, the K scale folded
into the score after the dot product and before the mask, the V scale into
the weights after the running sum, and the merge of the partials in split
order) against the port's plain versions and the JAX package's
`flash_decode` / `paged_attention` (Pallas in interpret mode), on numpy
inputs from a seed, at 2e-5 (the JAX tests' KERNEL_ATOL); and the host's
split plan (`ops.attention._decode_plan`)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singa_tpu.ops import attention as ja
from singa_tpu_torch.ops import attention as ta

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
NEG = -1e30
DT = 32          # positions a tile (csrc/decode_common.cuh)


def _quantize(A, P, mode):
    """(…, T, P*D) fp32 -> (rows, scales (…, T, P)): int8, or int4 packed
    by the JAX package's nibble_pack."""
    qmax = 7.0 if mode == "int4" else 127.0
    A5 = A.reshape(A.shape[:-1] + (P, -1))
    s = np.maximum(np.abs(A5).max(axis=-1), 1e-8) / qmax
    q = np.clip(np.round(A5 / s[..., None]), -qmax, qmax).astype(np.int8)
    rows = q.reshape(A.shape)
    if mode == "int4":
        rows = np.asarray(ja.nibble_pack(jnp.asarray(rows)))
    return rows, s.astype(np.float32)


def _dequant(rows):
    """Cache rows -> fp32 values (int4: split-half nibbles, sign-extended
    through the 0x8 test)."""
    x = torch.from_numpy(np.array(rows))
    if x.dtype == torch.uint8:
        x = x.to(torch.int32)
        lo, hi = x & 0xF, (x >> 4) & 0xF
        x = torch.cat([lo - ((lo & 8) << 1), hi - ((hi & 8) << 1)], -1)
    return x.float()


def _factors(sc, Q, P, G, q_tokens):
    """(N, Hp, T, P) scales -> (N, Hp, Q, T) per-row factors: row r reads
    lane block (r % (P*G)) // G; rows past q_tokens*P*G read 1."""
    f = torch.ones(sc.shape[:2] + (Q, sc.shape[2]))
    for r in range(min(Q, q_tokens * P * G)):
        f[:, :, r] = sc[..., (r % (P * G)) // G]
    return f


def emulate(q, K, V, lengths, scale, chunk, k_scales=None, v_scales=None,
            groups=1, q_tokens=1):
    """The split kernels' arithmetic on a dense cache (N, Hp, T, W): per
    chunk a partial (m, l, acc) from tiles of DT positions, then the merge;
    returns (out (N, Hp, Q, PD), the partials)."""
    q = torch.as_tensor(q).float()
    kf, vf = _dequant(K), _dequant(V)
    N, Hp, Q, PD = q.shape
    T = kf.shape[2]
    kfac = vfac = None
    if k_scales is not None:
        P = k_scales.shape[-1]
        kfac = _factors(torch.as_tensor(k_scales), Q, P, groups, q_tokens)
        vfac = _factors(torch.as_tensor(v_scales), Q, P, groups, q_tokens)
    ln = torch.as_tensor(lengths).long().clamp(min=1)
    hz = ln.clamp(max=T)
    ti = (torch.arange(Q) // (Q // q_tokens)).clamp(max=q_tokens - 1)
    lim = torch.minimum(ln[:, None] - (q_tokens - 1 - ti)[None], hz[:, None])
    qs = q * scale
    parts = []
    for c0 in range(0, T, chunk):
        cend = torch.clamp(hz, max=c0 + chunk)                   # (N,)
        m = torch.full((N, Hp, Q), NEG)
        l = torch.zeros(N, Hp, Q)
        acc = torch.zeros(N, Hp, Q, PD)
        for t0 in range(c0, min(c0 + chunk, T), DT):
            pos = torch.arange(t0, t0 + DT)
            # zero-filled past the chunk's live end (and the cache's)
            load = (pos[None] < cend[:, None]).float()           # (N, DT)
            w = min(DT, T - t0)

            def tile(x):
                x = torch.nn.functional.pad(x[..., t0:t0 + w],
                                            (0, DT - w))
                return x * load[:, None, None]
            kt = torch.nn.functional.pad(kf[:, :, t0:t0 + w],
                                         (0, 0, 0, DT - w))
            vt = torch.nn.functional.pad(vf[:, :, t0:t0 + w],
                                         (0, 0, 0, DT - w))
            kt, vt = (x * load[:, None, :, None] for x in (kt, vt))
            s = torch.einsum("nhqd,nhtd->nhqt", qs, kt)
            if kfac is not None:
                s = s * tile(kfac)
            s = torch.where(pos[None, None, None] >= lim[:, None, :, None],
                            torch.tensor(NEG), s)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_new = l * corr + p.sum(-1)
            if vfac is not None:
                p = p * tile(vfac)
            acc_new = acc * corr[..., None] + torch.einsum(
                "nhqt,nhtd->nhqd", p, vt)
            run = (t0 < cend)[:, None, None]                     # the tile's
            m = torch.where(run, m_new, m)                       # block runs
            l = torch.where(run, l_new, l)
            acc = torch.where(run[..., None], acc_new, acc)
        live = (c0 < hz)[:, None, None]
        parts.append((torch.where(live, m, torch.tensor(NEG)),
                      torch.where(live, l, torch.tensor(0.)),
                      torch.where(live[..., None], acc, torch.tensor(0.))))
    M = torch.full((N, Hp, Q), NEG)
    for m, l, _ in parts:
        M = torch.where(l > 0, torch.maximum(M, m), M)
    L = torch.zeros(N, Hp, Q)
    out = torch.zeros(N, Hp, Q, PD)
    for m, l, acc in parts:                                      # in order
        w = torch.where(l > 0, torch.exp(m - M), torch.tensor(0.))
        L = L + l * w
        out = out + acc * w[..., None]
    return out / torch.clamp(L, min=1e-20)[..., None], parts


def _inputs(seed, N, Hp, P, D, G, q_tokens, T, mode):
    rng = np.random.RandomState(seed)
    q = rng.randn(N, Hp, q_tokens * P * G, P * D).astype(np.float32)
    K = rng.randn(N, Hp, T, P * D).astype(np.float32)
    V = rng.randn(N, Hp, T, P * D).astype(np.float32)
    if mode == "fp32":
        return q, K, V, None, None
    (K, ks), (V, vs) = _quantize(K, P, mode), _quantize(V, P, mode)
    return q, K, V, ks, vs


def _paged(rng, C, ps):
    """Dense (N, Hp, T, ·) -> (pool, page table): the rows of sequence n's
    page j at pool page table[n, j], a random permutation."""
    N, Hp, T = C.shape[:3]
    M = T // ps
    perm = rng.permutation(N * M)
    pages = C.reshape(N, Hp, M, ps, -1).transpose(0, 2, 1, 3, 4) \
        .reshape(N * M, Hp, ps, -1)
    pool = np.empty_like(pages)
    pool[perm] = pages
    return pool, perm.reshape(N, M).astype(np.int32)


# (name, N, Hp, P, D, G, q_tokens, T, chunk, lengths); chunk counts 1, 2
# and 16; lengths 1, C-1, C, C+1 and T; the 5-token ladder with inactive
# slots (limits <= 0) and with lengths past the horizon (the limits come
# from the unclamped length); GQA P 2 G 2 (20 rows); 64 rows x 256 lanes
CONFIGS = [
    ("1 chunk", 5, 2, 2, 32, 1, 1, 128, 128, [1, 127, 128, 64, 100]),
    ("2 chunks", 5, 2, 2, 32, 1, 1, 128, 64, [1, 63, 64, 65, 128]),
    ("16 chunks", 5, 1, 2, 32, 1, 1, 1024, 64, [1, 63, 64, 65, 1024]),
    ("ladder, inactive slots", 5, 2, 2, 32, 1, 5, 128, 64,
     [1, 3, 64, 65, 128]),
    ("ladder past the horizon", 2, 2, 2, 32, 1, 5, 128, 64, [131, 129]),
    ("GQA ladder, 20 rows", 3, 2, 2, 32, 2, 5, 128, 64, [2, 65, 128]),
    ("Q 64 x PD 256", 2, 1, 4, 64, 4, 4, 128, 64, [65, 128]),
]
MODES = ("fp32", "int8", "int4")


def _live(lengths, Q, q_tokens, T):
    """(N, Q) rows with a positive ladder limit (the others see no
    position: finite, discarded by the caller)."""
    ln = np.maximum(np.asarray(lengths), 1)
    ti = np.minimum(np.arange(Q) // (Q // q_tokens), q_tokens - 1)
    return (ln[:, None] - (q_tokens - 1 - ti)[None]) > 0


@pytest.mark.parametrize("kernel", ["dense", "paged"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_split_merge_matches_plain_and_jax(cfg, mode, kernel):
    name, N, Hp, P, D, G, qt, T, C, lens = cfg
    seed = CONFIGS.index(cfg) * 10 + MODES.index(mode)
    q, K, V, ks, vs = _inputs(seed, N, Hp, P, D, G, qt, T, mode)
    lens = np.asarray(lens, np.int32)
    got, parts = emulate(q, K, V, lens, 0.2, C, ks, vs, G, qt)
    assert len(parts) == -(-T // C)
    # a chunk at or past a sequence's live end is the empty partial
    for i, (m, l, acc) in enumerate(parts):
        empty = torch.as_tensor(i * C >= np.minimum(lens, T))
        assert bool((l[empty] == 0).all() and (m[empty] == NEG).all())
        assert bool((l[~empty] >= 1).all())
    assert bool(torch.isfinite(got).all())      # inactive rows too
    live = _live(lens, q.shape[2], qt, T)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa
    jsc = {} if ks is None else dict(k_scales=jnp.asarray(ks),
                                     v_scales=jnp.asarray(vs))
    tsc = {} if ks is None else dict(k_scales=t(ks), v_scales=t(vs))
    if kernel == "dense":
        plain = ta.flash_decode(t(q), t(K), t(V), t(lens), 0.2, groups=G,
                                q_tokens=qt, **tsc)
        want = ja.flash_decode(*map(jnp.asarray, (q, K, V, lens)), scale=0.2,
                               groups=G, use_kernel=True, q_tokens=qt,
                               block_t=32, **jsc)
    else:
        ps = 16
        rng = np.random.RandomState(seed + 1)
        state = rng.get_state()
        pools = []
        for a in (K, V, ks, vs):
            rng.set_state(state)      # one page table for all four
            pools.append(None if a is None else _paged(rng, a, ps))
        pt = pools[0][1]
        kp, vp = pools[0][0], pools[1][0]
        if ks is not None:
            tsc = dict(k_scales=t(pools[2][0]), v_scales=t(pools[3][0]))
            jsc = dict(k_scales=jnp.asarray(pools[2][0]),
                       v_scales=jnp.asarray(pools[3][0]))
        plain = ta.paged_attention(t(q), t(kp), t(vp), t(pt), t(lens), ps,
                                   0.2, groups=G, q_tokens=qt, **tsc)
        want = ja.paged_attention(*map(jnp.asarray, (q, kp, vp, pt, lens)),
                                  ps, scale=0.2, groups=G, use_kernel=True,
                                  q_tokens=qt, **jsc)
    sel = np.broadcast_to(live[:, None, :, None], got.shape)
    np.testing.assert_allclose(got.numpy()[sel], plain.numpy()[sel], **TOL)
    np.testing.assert_allclose(got.numpy()[sel], np.asarray(want)[sel],
                               **TOL)


# (n, hp) pairs, horizon, page size
PLANS = [(48, 1024, 1), (48, 256, 1), (48, 1024, 16), (1, 16384, 1),
         (768, 1024, 16), (6, 8192, 1), (3, 32, 1), (4, 960, 48),
         (2, 100, 100), (96, 2048, 16), (1, 0, 1), (8192, 65536, 16)]


@pytest.mark.parametrize("nh,horizon,ps", PLANS)
def test_decode_plan(nh, horizon, ps):
    """The chunk is a multiple of 64 and of the page size and at most 1024
    where that allows, the splits cover the horizon and no split starts
    past it, and the grid holds at least 2 x 132 blocks wherever the
    horizon allows."""
    chunk, splits = ta._decode_plan(nh, horizon, ps)
    base = 64 * ps // math.gcd(64, ps)
    assert chunk % base == 0 and splits >= 1
    assert splits * chunk >= horizon and (splits - 1) * chunk < max(horizon,
                                                                      1)
    assert nh * splits >= min(2 * 132, nh * -(-horizon // base))
    assert chunk <= max(1024, base)
