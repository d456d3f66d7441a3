"""Attention ops of the serving and training paths (counterpart of
singa_tpu/ops/attention.py): flash-attention forward (K1) and backward
(K2a fused, K2b dQ + K2c dK/dV split), dense flash-decode (K3) and paged
decode attention (K4), the decode pair over fp32/bf16, int8 and packed
int4 caches and with the speculative verify step's causal ladder.

Each op has two versions with the same math:

- a plain PyTorch version (`attention_reference`, `flash_bwd_reference`,
  `flash_decode_reference`, `paged_attention_reference`), the mirror of
  the JAX package's `*_reference`: the CPU path, and the yardstick the
  kernels are held against;
- a hand-written CUDA kernel for Hopper in `singa_tpu_torch/csrc/`, built
  by `ops._build` on first use and called through ctypes.

Dispatch goes by the tensor's device, with no fallback: a CPU tensor runs
the plain version, a CUDA tensor launches the kernel or raises on input the
kernel does not take. `LAUNCHES` counts each kernel's launches, so a run
can show its main path went through the kernels; `LAUNCHES_BY_MODE`
splits K3's and K4's by cache mode and ladder. K3 and K4 split the cache
axis over blocks (`_decode_plan`, from the shapes alone) into partials in
a workspace the wrapper allocates, which a second CUDA kernel of the same
C entry point merges: one wrapper call, one count. `flash_attention` is
differentiable through `FlashAttention`, a torch.autograd.Function (the
JAX package's custom_vjp), whose backward picks K2a or K2b + K2c by the
JAX package's rule (`_FUSED_DQ_BYTES_CAP`). `ring_attention` (sequence
parallelism) runs K1 and K2 per hop of a ring over a mesh axis, through
`RingAttention`; it adds no kernel.

While `introspect` counts a build's first call, each wrapper books its
kernel's flops and bytes by the formulas of chip_smoke.py's bounds
(`introspect.kernel_cost`), on either route, so the CPU and the card
count alike: K1 4 D flops per (query, key) pair it computes (S(S+1)/2
per head when causal), K2a 5 score-sized products (2 D flops a pair
each), K2b 3 and K2c 4; the decode pair 4 D flops per query row and live
cache position. Bytes: each input read once and each output written
once.

Layouts are the JAX package's: (B, H, S, D) for flash attention;
head-packed block-diagonal queries (N, Hp, Q, P*D), dense caches
(N, Hp, T, P*D), page pools (n_pages, Hp, page_size, P*D) and an (N, M)
int32 page table for decode. The plain versions take scores and the
softmax in fp32, as the kernels do.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import introspect
from . import _build

#: kernel launches since the last reset_launches(), by kernel
LAUNCHES = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "flash_decode": 0, "paged_attention": 0}
#: cache modes of the decode kernels, and their codes in csrc/
KV_MODES = ("fp", "int8", "int4")
_KV_MODE = {m: i for i, m in enumerate(KV_MODES)}
#: the decode kernels' launches by (kernel, cache mode, "single" for
#: q_tokens = 1 or "ladder" for the verify step), reset with LAUNCHES
LAUNCHES_BY_MODE = {(k, m, v): 0
                    for k in ("flash_decode", "paged_attention")
                    for m in KV_MODES for v in ("single", "ladder")}

_NEG_INF = -1e30
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh codes
_MAXQ, _MAXPD = 64, 256                          # csrc/decode_common.cuh
#: the decode kernels' split plan (K3/K4): a split's chunk of the cache
#: axis is a multiple of _DEC_ALIGN positions (and, paged, of the page
#: size) and at most _DEC_MAX_CHUNK where that allows; the plan aims at
#: _DEC_BLOCKS blocks, eight per SM of the H100's 132: the blocks past a
#: short sequence's length end at once, so the long sequences' chunks set
#: the time, and more blocks make those chunks shorter
_DEC_ALIGN, _DEC_MAX_CHUNK, _DEC_BLOCKS = 64, 1024, 8 * 132
#: the backward takes the fused kernel while its fp32 (Sq, D) dQ would fit
#: this many bytes, else the split pair: the JAX package's VMEM rule,
#: kept so each kernel lies on the path it lies on there (S <= 8192 at
#: D = 128 fused); tests force a route by setting it
_FUSED_DQ_BYTES_CAP = 4 * 1024 * 1024

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sg_flash_fwd": [_vp] * 5 + [_i] * 5 + [_f, _i, _vp],
    "sg_flash_bwd_fused": [_vp] * 10 + [_i] * 5 + [_f, _i, _vp],
    "sg_flash_bwd_dq": [_vp] * 7 + [_i] * 5 + [_f, _i, _vp],
    "sg_flash_bwd_dkv": [_vp] * 8 + [_i] * 6 + [_vp],
    "sg_flash_decode": [_vp] * 8 + [_i] * 10 + [_f, _i, _i, _vp],
    "sg_paged_attention": [_vp] * 9 + [_i] * 11 + [_f, _i, _i, _vp],
    "sg_wgmma_probe": [_vp] * 3 + [_i, _vp],
}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_MODE):
        for k in counts:
            counts[k] = 0


def launch_counts():
    """Copies of LAUNCHES and LAUNCHES_BY_MODE, for `launches_since`."""
    return dict(LAUNCHES), dict(LAUNCHES_BY_MODE)


def launches_since(before):
    """The launches counted since `before` (a `launch_counts()`), as
    (by kernel, by mode) dicts of the increments, with the counters set
    back to `before`. A CUDA graph's capture records its kernels without
    running them: `Model` takes the capture's counts this way and adds
    them at each replay (`add_launches`)."""
    delta = []
    for counts, old in zip((LAUNCHES, LAUNCHES_BY_MODE), before):
        delta.append({k: v - old[k] for k, v in counts.items()
                      if v != old[k]})
        counts.update(old)
    return tuple(delta)


def add_launches(delta) -> None:
    """Count a replay's launches (a `launches_since` result)."""
    for counts, d in zip((LAUNCHES, LAUNCHES_BY_MODE), delta):
        for k, v in d.items():
            counts[k] += v


def _entry(source: str, name: str):
    fn = getattr(_build.lib(source), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(what: str, *tensors, dtype=None):
    """Raise unless every tensor lies on one CUDA device, is contiguous
    and (when `dtype` is given) has that dtype."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor of shape {tuple(t.shape)} is "
                             "not contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{what}: dtype {t.dtype}, kernel takes "
                             f"{dtype}")


def _use_kernel(t: torch.Tensor, use_kernel, what: str) -> bool:
    """None: kernel on CUDA, plain version on the CPU. True forces the
    kernel (raises on a CPU tensor); False selects the plain version."""
    if use_kernel is None:
        return t.is_cuda
    if use_kernel and not t.is_cuda:
        raise ValueError(f"{what}: use_kernel=True needs CUDA tensors, got "
                         f"{t.device}")
    return bool(use_kernel)


def _row_limits(lengths, Q, rows_per_token, q_tokens):
    """(N,) final lengths -> (N, Q) per-query-row KV limits. Query rows
    are laid out (q_tokens, P, G): token ti's rows attend positions
    < lengths - (q_tokens - 1 - ti), the causal ladder of the multi-token
    verify step; q_tokens == 1 is plain decode. Padding rows inherit the
    last token's limit."""
    ti = torch.clamp(torch.arange(Q, device=lengths.device)
                     // rows_per_token, max=q_tokens - 1)
    return lengths.long()[:, None] - (q_tokens - 1 - ti)[None, :]


# ======================= K1: flash-attention forward =======================

def _attention_plain(q, k, v, causal, scale):
    """(out, lse) of softmax attention; scores and softmax in fp32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = (torch.arange(sk, device=q.device)[None, :]
                > torch.arange(sq, device=q.device)[:, None])
        s = s.masked_fill(mask, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return out.to(q.dtype), lse


def attention_reference(q, k, v, causal=False, scale=None):
    """q, k, v: (B, H, S, D). Returns (B, H, Sq, D)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _attention_plain(q, k, v, causal, scale)[0]


def _pairs(B, H, Sq, Sk, causal) -> float:
    """(query, key) pairs a flash kernel computes: a causal row r sees
    min(r + 1, Sk) keys."""
    if not causal:
        return float(B * H * Sq * Sk)
    n = min(Sq, Sk)
    return float(B * H * (n * (n + 1) // 2 + (Sq - n) * Sk))


def _fwd_cost(q, k, causal):
    B, H, Sq, D = q.shape
    Sk, el = k.shape[2], q.element_size()
    return [("flash_fwd", 4 * D * _pairs(B, H, Sq, Sk, causal),
             2 * B * H * (Sq + Sk) * D * el + 4 * B * H * Sq,
             f"{list(q.shape)}/{list(k.shape)} "
             f"{introspect._dtype_name(q.dtype)}"
             f"{' causal' if causal else ''}")]


def _bwd_cost(q, k, causal, fused):
    B, H, Sq, D = q.shape
    Sk, el = k.shape[2], q.element_size()
    pairs = _pairs(B, H, Sq, Sk, causal)
    ins = 2 * B * H * (Sq + Sk) * D * el + 2 * B * H * Sq * 4
    dq, dkv = B * H * Sq * D * el, 2 * B * H * Sk * D * el
    desc = (f"{list(q.shape)}/{list(k.shape)} "
            f"{introspect._dtype_name(q.dtype)}{' causal' if causal else ''}")
    if fused:
        return [("flash_bwd_fused", 5 * 2 * D * pairs, ins + dq + dkv, desc)]
    return [("flash_bwd_dq", 3 * 2 * D * pairs, ins + dq, desc),
            ("flash_bwd_dkv", 4 * 2 * D * pairs, ins + dkv, desc)]


def _flash_fwd(q, k, v, causal, scale, use_kernel=None):
    """(out, lse (B, H, Sq) fp32): the kernel on CUDA tensors, the plain
    version on CPU tensors or with `use_kernel=False`."""
    with introspect.kernel_cost(lambda: _fwd_cost(q, k, causal)):
        return _flash_fwd_call(q, k, v, causal, scale, use_kernel)


def _flash_fwd_call(q, k, v, causal, scale, use_kernel):
    if not _use_kernel(q, use_kernel, "flash_attention"):
        return _attention_plain(q, k, v, causal, scale)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    _check_cuda("flash_attention", q, k, v, dtype=q.dtype)
    if q.dtype not in _DTYPE or D not in (64, 128):
        raise ValueError(f"flash_attention kernel takes fp32/bf16 and "
                         f"D in (64, 128), got {q.dtype}, D={D}")
    if k.shape != (B, H, Sk, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if B * H > 65535 or Sq < 1 or Sk < 1:
        raise ValueError(f"flash_attention: B*H={B * H}, Sq={Sq}, Sk={Sk}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _entry("flash_fwd", "sg_flash_fwd")
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), B * H, Sq, Sk, D,
                    int(bool(causal)), float(scale), _DTYPE[q.dtype],
                    _stream(q)), "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_attention(q, k, v, causal=False, scale=None, use_kernel=None):
    """Fused attention over (B, H, S, D), any S; returns (B, H, Sq, D).
    Differentiable: when an input requires grad it runs through
    `FlashAttention`, whose backward is the K2 kernels."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale, use_kernel)
    return _flash_fwd(q, k, v, causal, scale, use_kernel)[0]


# ============ K2a / K2b / K2c: flash-attention backward ====================

def _flash_bwd_stats(o, do):
    """delta = rowsum(dO * O) in fp32, (B, H, Sq): the flash-2 backward
    term (a plain torch op, as the JAX package leaves it to XLA)."""
    return (do.float() * o.float()).sum(-1)


def flash_bwd_reference(q, k, v, o, lse, do, causal=False, scale=None,
                        block_k=512):
    """Plain backward of softmax attention from the forward's (O, lse):
    (dq, dk, dv) in the inputs' dtypes, fp32 math. A port of the JAX
    package's `_flash_bwd_blockwise`: a loop over key blocks recomputes
    P = exp(q k^T * scale - lse) per block, so memory is O(Sq * block_k),
    not O(Sq * Sk); the last block may be short (any S)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    sq, sk = q.shape[2], k.shape[2]
    qs = q.float() * scale
    do_ = do.float()
    delta = _flash_bwd_stats(o, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    rows = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, sk, block_k):
        k_blk = k[:, :, k0:k0 + block_k].float()
        v_blk = v[:, :, k0:k0 + block_k].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qs, k_blk)
        if causal:
            cols = torch.arange(k0, k0 + k_blk.shape[2], device=q.device)
            s = s.masked_fill(cols[None, :] > rows, _NEG_INF)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, do_))
        dp = torch.einsum("bhqd,bhkd->bhqk", do_, v_blk)
        ds = p * (dp - delta[..., None])
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qs))
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, k_blk)
    return ((dq * scale).to(q.dtype), torch.cat(dks, 2).to(k.dtype),
            torch.cat(dvs, 2).to(v.dtype))


def _bwd_prepare(q, k, v, o, lse, do, scale):
    """Check the backward's CUDA inputs; returns the kernels' extra inputs:
    q pre-scaled in its own dtype (as the TPU kernels take it) and delta
    (B, H, Sq) fp32."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    _check_cuda("flash_attention backward", q, k, v, o, do, dtype=q.dtype)
    _check_cuda("flash_attention backward", q, lse, dtype=None)
    if q.dtype not in _DTYPE or D not in (64, 128):
        raise ValueError(f"flash_attention backward kernels take fp32/bf16 "
                         f"and D in (64, 128), got {q.dtype}, D={D}")
    if (k.shape != (B, H, Sk, D) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape or lse.shape != (B, H, Sq)
            or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention backward: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"o {tuple(o.shape)}, do {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)} {lse.dtype}")
    if B * H > 65535 or Sq < 1 or Sk < 1:
        raise ValueError(f"flash_attention backward: B*H={B * H}, Sq={Sq}, "
                         f"Sk={Sk}")
    return (q * scale).to(q.dtype), _flash_bwd_stats(o, do)


def _dims(qf, k):
    B, H, Sq, D = qf.shape
    return B * H, Sq, k.shape[2], D


def _flash_bwd_fused(qf, k, v, do, lse, delta, causal, scale):
    """K2a on prepared inputs: dQ, dK, dV in one kernel (dQ through a
    zeroed fp32 workspace the blocks add into, then a scale-and-cast
    pass)."""
    BH, Sq, Sk, D = _dims(qf, k)
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(k), \
        torch.empty_like(v)
    ws = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
    fn = _entry("flash_bwd_fused", "sg_flash_bwd_fused")
    _build.check(fn(qf.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    ws.data_ptr(), BH, Sq, Sk, D, int(bool(causal)),
                    float(scale), _DTYPE[qf.dtype], _stream(qf)),
                 "flash_bwd_fused")
    LAUNCHES["flash_bwd_fused"] += 1
    return dq, dk, dv


def _flash_bwd_dq(qf, k, v, do, lse, delta, causal, scale):
    """K2b on prepared inputs: dQ, recomputing P and dS per key tile."""
    BH, Sq, Sk, D = _dims(qf, k)
    dq = torch.empty_like(qf)
    fn = _entry("flash_bwd_dq", "sg_flash_bwd_dq")
    _build.check(fn(qf.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), BH, Sq, Sk, D, int(bool(causal)),
                    float(scale), _DTYPE[qf.dtype], _stream(qf)),
                 "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _flash_bwd_dkv(qf, k, v, do, lse, delta, causal):
    """K2c on prepared inputs: dK and dV, recomputing P and dS per q
    tile; no atomics."""
    BH, Sq, Sk, D = _dims(qf, k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _entry("flash_bwd_dkv", "sg_flash_bwd_dkv")
    _build.check(fn(qf.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), BH, Sq, Sk, D,
                    int(bool(causal)), _DTYPE[qf.dtype], _stream(qf)),
                 "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _flash_bwd_split(qf, k, v, do, lse, delta, causal, scale):
    """K2b then K2c on prepared inputs: (dq, dk, dv), each kernel
    recomputing P and dS; no atomics."""
    args = (qf, k, v, do, lse, delta, causal)
    return (_flash_bwd_dq(*args, scale), *_flash_bwd_dkv(*args))


def _flash_bwd(q, k, v, o, lse, do, causal, scale, use_kernel=None):
    """(dq, dk, dv) of flash attention: the plain backward on CPU tensors
    (or with `use_kernel=False`); on CUDA the fused kernel K2a while
    Sq * D * 4 <= _FUSED_DQ_BYTES_CAP, else the split pair K2b + K2c
    (the JAX package's rule, `_flash_bwd_pallas`)."""
    fused = q.shape[2] * q.shape[3] * 4 <= _FUSED_DQ_BYTES_CAP
    with introspect.kernel_cost(lambda: _bwd_cost(q, k, causal, fused)):
        if not _use_kernel(q, use_kernel, "flash_attention backward"):
            return flash_bwd_reference(q, k, v, o, lse, do, causal, scale)
        qf, delta = _bwd_prepare(q, k, v, o, lse, do, scale)
        fn = _flash_bwd_fused if fused else _flash_bwd_split
        return fn(qf, k, v, do, lse, delta, causal, scale)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward (the port of the JAX
    package's `custom_vjp` around `flash_attention`): the forward saves
    q, k, v, O and lse; the backward recomputes P tile by tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, use_kernel):
        out, lse = _flash_fwd(q, k, v, causal, scale, use_kernel)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.use_kernel = causal, scale, use_kernel
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do.contiguous(),
                                ctx.causal, ctx.scale, ctx.use_kernel)
        return dq, dk, dv, None, None, None


# ============ ring attention: K1 and K2 per hop ============================
#
# Sequence parallelism (the JAX package's `_ring_flash`, attention.py
# :674-832). Each rank holds its shard of the sequence, (B, H, S_local, D).
# The K/V shards move one rank along the ring at each of n hops, so at hop
# i rank `my` holds the shard of rank src = (my - i) % n and runs K1 on it:
# in full for src < my, causal for src == my and not at all for src > my
# when causal, in full at every hop otherwise. The hops' (o, lse) merge by
# the running max in fp32. The backward runs the flash backward per hop
# from the merged O and lse, prepared once (q pre-scaled, delta): K2a, or
# K2b + K2c when S_local * D * 4 > _FUSED_DQ_BYTES_CAP, `_flash_bwd`'s rule
# on the shard. dQ adds up in fp32; dK and dV add onto a rotating fp32
# shard, so after n shifts each is back with its owner.
#
# The hop loop runs the ranks of a ring in lock step over a rank group of
# `parallel.communicator`: `_AxisRanks`, one rank a process, whose shift is
# the axis's ppermute, or `_Loopback`, every rank of one ring in one
# process, whose shift rotates a list: a check of the hop schedule on one
# device, not an API.

def _hop_causal(src, my, causal):
    """The causal flag of hop src -> my's kernel call, or None to skip it
    (a causal hop from a later shard contributes nothing)."""
    if not causal or src < my:
        return False
    return True if src == my else None


def _ring_fwd(qs, ks, vs, ring, causal, scale, use_kernel=None):
    """(outs, lses) of the ring's ranks (lists in `ring.local` order): K1
    (or the plain forward) per hop, merged by the running max in fp32.
    Hop 0 is the rank's own shard, never skipped, so the merge starts
    from it: m = lse, z = 1, num = o, which is what the JAX package's
    merge makes of it from (-inf, 0, 0)."""
    n = ring.n
    acc = [None] * len(qs)
    k_cur, v_cur = list(ks), list(vs)
    for i in range(n):
        for r, my in enumerate(ring.local):
            c = _hop_causal((my - i) % n, my, causal)
            if c is None:
                continue
            o, lse = _flash_fwd(qs[r], k_cur[r], v_cur[r], c, scale,
                                use_kernel)
            o = o.float()
            if acc[r] is None:
                acc[r] = (lse, torch.ones_like(lse), o)
                continue
            m, z, num = acc[r]
            m_new = torch.maximum(m, lse)
            corr = torch.exp(m - m_new)
            w = torch.exp(lse - m_new)
            acc[r] = (m_new, z * corr + w,
                      num * corr[..., None] + w[..., None] * o)
        if i < n - 1:
            k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
    outs, lses = [], []
    for q, (m, z, num) in zip(qs, acc):
        z = torch.clamp_min(z, 1e-20)
        outs.append((num / z[..., None]).to(q.dtype))
        lses.append(m + torch.log(z))
    return outs, lses


def _ring_bwd_hop(q, k, v, o, lse, do, prep, causal, scale, fused):
    """One backward hop: (dq, dk, dv) of q against this K/V shard, from
    the merged O and lse; the kernels on `prep` (the prepared q and
    delta), the plain backward when it is None."""
    with introspect.kernel_cost(lambda: _bwd_cost(q, k, causal, fused)):
        if prep is None:
            return flash_bwd_reference(q, k, v, o, lse, do, causal, scale)
        qf, delta = prep
        fn = _flash_bwd_fused if fused else _flash_bwd_split
        return fn(qf, k, v, do, lse, delta, causal, scale)


def _ring_bwd(qs, ks, vs, outs, lses, dos, ring, causal, scale,
              use_kernel=None):
    """(dqs, dks, dvs) of the ring's ranks, in the inputs' dtypes: one
    backward hop per forward hop, dQ added in fp32, dK and dV added onto
    the rotating fp32 shard and shifted after every hop, the last shift
    bringing them home (the K/V shift after the last hop is skipped)."""
    n = ring.n
    fused = qs[0].shape[2] * qs[0].shape[3] * 4 <= _FUSED_DQ_BYTES_CAP
    prep = [_bwd_prepare(q, k, v, o, lse, do, scale)
            if _use_kernel(q, use_kernel, "ring_attention backward")
            else None
            for q, k, v, o, lse, do in zip(qs, ks, vs, outs, lses, dos)]
    dq, dk, dv = [None] * len(qs), [None] * len(qs), [None] * len(qs)
    k_cur, v_cur = list(ks), list(vs)
    for i in range(n):
        for r, my in enumerate(ring.local):
            c = _hop_causal((my - i) % n, my, causal)
            if c is None:
                continue
            gq, gk, gv = (g.float() for g in _ring_bwd_hop(
                qs[r], k_cur[r], v_cur[r], outs[r], lses[r], dos[r],
                prep[r], c, scale, fused))
            if dq[r] is None:
                dq[r], dk[r], dv[r] = gq, gk, gv
            else:
                dq[r], dk[r], dv[r] = dq[r] + gq, dk[r] + gk, dv[r] + gv
        if i < n - 1:
            k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
        dk, dv = ring.shift(dk), ring.shift(dv)
    return ([g.to(q.dtype) for g, q in zip(dq, qs)],
            [g.to(k.dtype) for g, k in zip(dk, ks)],
            [g.to(v.dtype) for g, v in zip(dv, vs)])


class RingAttention(torch.autograd.Function):
    """Ring attention over one rank's shards (the JAX package's
    `_ring_flash` custom_vjp): the forward saves the local q, k, v and
    the merged O and lse; the backward runs the backward ring."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale, use_kernel):
        (out,), (lse,) = _ring_fwd([q], [k], [v], ring, causal, scale,
                                   use_kernel)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal = ring, causal
        ctx.scale, ctx.use_kernel = scale, use_kernel
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        (dq,), (dk,), (dv,) = _ring_bwd(
            [q], [k], [v], [out], [lse], [do.contiguous()], ctx.ring,
            ctx.causal, ctx.scale, ctx.use_kernel)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, axis_name, causal=False, scale=None,
                   use_kernel=None):
    """Sequence-parallel attention over the bound mesh axis `axis_name`
    (raises NameError when it is unbound, as `lax.axis_size` does): q, k,
    v are this rank's sequence shards (B, H, S_local, D); returns the
    rank's (B, H, S_local, D) output. Each hop runs K1 forward and K2a or
    K2b + K2c backward on CUDA tensors (the plain versions on CPU tensors
    or with `use_kernel=False`); K/V shards move by P2P over the axis's
    group, none at axis size 1. Any S_local: the kernels mask ragged
    tiles, so there is no einsum fallback. Differentiable through
    `RingAttention`."""
    from ..parallel.communicator import _AxisRanks
    from ..parallel.tp import _axis
    ring = _AxisRanks(_axis(axis_name))
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return RingAttention.apply(q, k, v, ring, causal, scale, use_kernel)
    return _ring_fwd([q], [k], [v], ring, causal, scale, use_kernel)[0][0]


class _SeqShard(torch.autograd.Function):
    """This rank's block of the sequence axis (dim 2); the backward
    gathers every rank's block gradient into the full one."""

    @staticmethod
    def forward(ctx, x, ax):
        n = x.shape[2] // ax.size
        if n * ax.size != x.shape[2]:
            raise ValueError(f"sequence of {x.shape[2]} does not split over "
                             f"{ax.size} ranks")
        ctx.ax = ax
        return x.narrow(2, ax.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        from ..parallel.tp import _gather_dim
        return _gather_dim(g, ctx.ax, 2), None


class _SeqGather(torch.autograd.Function):
    """Every rank's block concatenated along the sequence axis; the
    backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, ax):
        from ..parallel.tp import _gather_dim
        ctx.ax = ax
        return _gather_dim(x, ax, 2)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[2] // ctx.ax.size
        return g.narrow(2, ctx.ax.index * n, n).contiguous(), None


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False):
    """Ring attention over global (B, H, S, D) arrays, replicated on every
    rank of `mesh`: under `mesh.bind()` each rank takes its S block on
    `axis_name` and runs `ring_attention`; returns the global output,
    gathered along S (a collective every rank of the axis joins), as the
    JAX package's shard_map returns a global array. Differentiable: the
    gradient of a replicated input is gathered from the blocks'."""
    from ..parallel.tp import _mesh_axis
    ax = _mesh_axis(mesh, axis_name)
    with mesh.bind():
        out = ring_attention(*(_SeqShard.apply(t, ax) for t in (q, k, v)),
                             axis_name, causal)
        return _SeqGather.apply(out, ax)


# ============ int4 nibble packing and the quantized-KV helpers ==============
#
# int4 KV packs two 4-bit values per byte along the lane dimension in the
# JAX package's split-half layout: byte j of a packed row holds lane j in
# its low nibble and lane j + L/2 in its high nibble, so a per-token cache
# row write stays a contiguous byte slice. Values are symmetric int4 in
# [-7, 7] with the same per-(head, position) fp32 scales as int8.

def nibble_pack(q):
    """(..., L) integer values in [-8, 7] -> (..., L/2) uint8, split-half
    layout (low nibble = lane j, high nibble = lane j + L/2)."""
    L = q.shape[-1]
    if L % 2:
        raise ValueError(f"nibble_pack needs an even last dim, got {L}")
    u = q.to(torch.int32) & 0xF
    return ((u[..., L // 2:] << 4) | u[..., :L // 2]).to(torch.uint8)


def nibble_unpack(p, dtype=torch.float32):
    """(..., L/2) uint8 -> (..., L) `dtype`, inverting nibble_pack (sign
    extension through the 0x8 test, in int32)."""
    x = p.to(torch.int32)
    lo = x & 0xF
    hi = (x >> 4) & 0xF
    lo = lo - ((lo & 0x8) << 1)
    hi = hi - ((hi & 0x8) << 1)
    return torch.cat([lo, hi], dim=-1).to(dtype)


def _kv_dequant(blk, qdtype):
    """Cache rows -> matmul operand in the query dtype: int4 (packed
    uint8) unpacks nibbles, int8 casts, float passes through."""
    if blk.dtype == torch.uint8:
        return nibble_unpack(blk, qdtype)
    if blk.dtype == torch.int8:
        return blk.to(qdtype)
    return blk


def _paged_factors(sc, groups, rows, q_tokens=1):
    """(..., T, P) per-position scales -> (..., rows, T) row factors for
    packed block-diagonal queries laid out (q_tokens, P, groups): row r
    reads lane block (r % (P * groups)) // groups; rows past
    q_tokens * P * groups (padding) get factor 1."""
    f = sc.transpose(-1, -2).repeat_interleave(groups, dim=-2)
    if q_tokens > 1:
        f = torch.cat([f] * q_tokens, dim=-2)
    pg = sc.shape[-1] * groups * q_tokens
    if rows > pg:
        pad = f.new_ones(f.shape[:-2] + (rows - pg, f.shape[-1]))
        f = torch.cat([f, pad], dim=-2)
    return f


# ============ K3 / K4: dense flash-decode and paged decode =================

def _count(kernel, mode, q_tokens):
    LAUNCHES[kernel] += 1
    LAUNCHES_BY_MODE[kernel, mode,
                     "ladder" if q_tokens > 1 else "single"] += 1


def flash_decode_reference(q, K, V, lengths, scale=1.0, k_scales=None,
                           v_scales=None, groups=1, q_tokens=1):
    """Ground-truth dense decode attention.

    q:        (N, Hp, Q, PD) packed block-diagonal queries
              (Q = q_tokens * P * G; under q_tokens > 1, the verify step,
              token ti's rows attend q_tokens - 1 - ti fewer positions)
    K/V:      (N, Hp, T, PD) head-packed caches (float or int8), or packed
              uint8 (N, Hp, T, PD/2) for int4 KV
    lengths:  (N,) int32 live positions per sequence, counted at the last
              query token
    k_scales/v_scales: (N, Hp, T, P) fp32 (quantized KV only)

    Returns (N, Hp, Q, PD). Scores and the softmax are fp32."""
    N, Hp, Q, PD = q.shape
    T = K.shape[2]
    kf = _kv_dequant(K, q.dtype)
    vf = _kv_dequant(V, q.dtype)
    s = torch.einsum("nhqd,nhtd->nhqt", q.float(), kf.float()) * scale
    if k_scales is not None:
        s = s * _paged_factors(k_scales, groups, Q, q_tokens)
    limits = _row_limits(lengths, Q, Q // max(q_tokens, 1), q_tokens)
    valid = (torch.arange(T, device=q.device)[None, None, None, :]
             < limits[:, None, :, None])
    a = torch.softmax(torch.where(valid, s, float("-inf")), dim=-1)
    if v_scales is not None:
        a = a * _paged_factors(v_scales, groups, Q, q_tokens)
    return torch.einsum("nhqt,nhtd->nhqd", a.to(q.dtype), vf).to(q.dtype)


def _check_decode(what, q, K, V, lengths, k_scales, v_scales, q_tokens,
                  rows_shape):
    """Raise unless the kernel takes these inputs; returns the cache mode
    ("fp", "int8" or "int4"). `rows_shape` is the cache's shape up to the
    row width (dense (N, Hp, T), paged (n_pages, Hp, page_size))."""
    mode = {torch.int8: "int8", torch.uint8: "int4"}.get(K.dtype, "fp")
    _check_cuda(what, q, lengths, dtype=None)
    _check_cuda(what, q, K, V, dtype=None)
    if q.dtype not in _DTYPE:
        raise ValueError(f"{what} kernel takes fp32/bf16 queries, got "
                         f"{q.dtype}")
    want = q.dtype if mode == "fp" else K.dtype
    if K.dtype != want or V.dtype != want:
        raise ValueError(f"{what}: caches {K.dtype}/{V.dtype} with "
                         f"{q.dtype} queries; an fp cache has the query "
                         "dtype, a quantized one int8 or packed uint8 (int4)")
    if lengths.dtype != torch.int32:
        raise ValueError(f"{what}: lengths must be int32, got "
                         f"{lengths.dtype}")
    N, Hp, Q, PD = q.shape
    if Q > _MAXQ or PD > _MAXPD or N > 65535 or Hp > 65535:
        raise ValueError(f"{what} kernel takes at most {_MAXQ} packed query "
                         f"rows (q_tokens * P * G) and PD <= {_MAXPD}; got "
                         f"q {tuple(q.shape)}")
    if not 1 <= q_tokens <= Q:
        raise ValueError(f"{what}: q_tokens={q_tokens} for {Q} query rows")
    if lengths.shape != (N,):
        raise ValueError(f"{what}: lengths {tuple(lengths.shape)}, "
                         f"want ({N},)")
    W = PD // 2 if mode == "int4" else PD
    if (K.shape != tuple(rows_shape) + (W,) or V.shape != K.shape
            or (mode == "int4" and PD % 2)):
        raise ValueError(f"{what}: q {tuple(q.shape)}, caches "
                         f"{tuple(K.shape)}/{tuple(V.shape)} ({mode}), "
                         f"want rows {tuple(rows_shape) + (W,)}")
    if mode == "fp":
        if k_scales is not None or v_scales is not None:
            raise ValueError(f"{what}: scales given with an fp cache")
        return mode
    if k_scales is None or v_scales is None:
        raise ValueError(f"{what}: a {mode} cache needs k_scales and "
                         "v_scales")
    _check_cuda(what, q, k_scales, v_scales, dtype=None)
    if (k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32
            or k_scales.shape[:-1] != tuple(rows_shape)
            or v_scales.shape != k_scales.shape):
        raise ValueError(f"{what}: scales {tuple(k_scales.shape)} "
                         f"{k_scales.dtype}/{tuple(v_scales.shape)} "
                         f"{v_scales.dtype}, want fp32 "
                         f"{tuple(rows_shape) + ('P',)}")
    return mode


@functools.lru_cache(maxsize=256)
def _decode_plan(nh, horizon, page_size=1):
    """(chunk, splits) of the decode kernels' split of the cache axis, from
    the shapes alone (never the lengths, which live on the device): `nh`
    (n, hp) pairs over `horizon` positions. The chunk is a multiple of
    _DEC_ALIGN and of the page size; the splits aim at _DEC_BLOCKS blocks
    in all, as far as the horizon allows. Memoized: a serving loop asks
    for the same few shapes every step."""
    base = _DEC_ALIGN * page_size // math.gcd(_DEC_ALIGN, page_size)
    nbase = max(1, -(-horizon // base))
    want = max(-(-_DEC_BLOCKS // nh),
               -(-horizon // max(_DEC_MAX_CHUNK, base)))
    chunk = base * -(-nbase // min(want, nbase))
    return chunk, max(1, -(-horizon // chunk))


def _decode_workspace(q, splits):
    """The partials of a decode call, fp32: per (n, hp, split, row) PD
    accumulator lanes, then per (n, hp, split, row) (m, l). Left
    uninitialised: the merge reads only what the split kernel wrote (no
    accumulator of an empty partial)."""
    N, Hp, Q, PD = q.shape
    return torch.empty(N * Hp * splits * Q * (PD + 2), dtype=torch.float32,
                       device=q.device)


def _scale_args(k_scales, v_scales, groups):
    """(KS pointer, VS pointer, P, G) for the C entry points."""
    if k_scales is None:
        return 0, 0, 0, 1
    return (k_scales.data_ptr(), v_scales.data_ptr(), k_scales.shape[-1],
            int(groups))


def _decode_cost(name, q, K, k_scales, lengths, page_size=None):
    """K3/K4's booking: 4 PD flops per query row and live position; bytes
    of q, out and lengths, the live cache rows (K and V, with their
    scales) and, paged, one page-table entry per live page. The live
    positions (and pages) are sums on the device, read at the count's
    end (`introspect.on_device`), not a synchronize a call."""
    N, Hp, Q, PD = q.shape
    live = lengths.sum()
    row = K.shape[-1] * K.element_size() + (
        k_scales.shape[-1] * 4 if k_scales is not None else 0)
    terms = [(2 * Hp * row, live)]
    if page_size is not None:
        terms.append((4, ((lengths + (page_size - 1)) // page_size).sum()))
    nbytes = introspect.on_device(
        2 * N * Hp * Q * PD * q.element_size() + 4 * N, *terms)
    return [(name, introspect.on_device(0, (4 * Hp * Q * PD, live)), nbytes,
             f"{list(q.shape)} cache {list(K.shape)} "
             f"{introspect._dtype_name(K.dtype)}")]


def flash_decode(q, K, V, lengths, scale=1.0, k_scales=None, v_scales=None,
                 groups=1, use_kernel=None, q_tokens=1):
    """Dense decode attention (see flash_decode_reference for shapes):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    `use_kernel=False` selects the plain version explicitly. Quantized
    caches dequantize in the kernel; q_tokens > 1 runs the verify
    ladder."""
    with introspect.kernel_cost(lambda: _decode_cost(
            "flash_decode", q, K, k_scales, lengths)):
        return _flash_decode_call(q, K, V, lengths, scale, k_scales,
                                  v_scales, groups, use_kernel, q_tokens)


def _flash_decode_call(q, K, V, lengths, scale, k_scales, v_scales, groups,
                       use_kernel, q_tokens):
    if not _use_kernel(q, use_kernel, "flash_decode"):
        return flash_decode_reference(q, K, V, lengths, scale, k_scales,
                                      v_scales, groups, q_tokens)
    N, Hp, Q, PD = q.shape
    T = K.shape[2]
    mode = _check_decode("flash_decode", q, K, V, lengths, k_scales,
                         v_scales, q_tokens, (N, Hp, T))
    ks, vs, P, G = _scale_args(k_scales, v_scales, groups)
    chunk, splits = _decode_plan(N * Hp, T)
    out = torch.empty_like(q)
    ws = _decode_workspace(q, splits)
    fn = _entry("flash_decode", "sg_flash_decode")
    _build.check(fn(q.data_ptr(), K.data_ptr(), V.data_ptr(), ks, vs,
                    lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), N, Hp,
                    Q, T, PD, P, G, int(q_tokens), chunk, splits,
                    float(scale), _DTYPE[q.dtype], _KV_MODE[mode],
                    _stream(q)), "flash_decode")
    _count("flash_decode", mode, q_tokens)
    return out


def paged_attention_reference(q, k_pool, v_pool, page_table, lengths,
                              page_size, scale=1.0, k_scales=None,
                              v_scales=None, groups=1, q_tokens=1):
    """Ground-truth paged decode attention.

    q:          (N, Hp, Q, PD) packed block-diagonal queries
    k_pool/v_pool: (n_pages, Hp, page_size, PD) shared page pools (int8
                with scales; packed uint8 (…, PD/2) for int4)
    page_table: (N, M) int32 page ids per sequence, in time order
    lengths:    (N,) int32 valid positions per sequence, counted at the
                last query token
    k_scales/v_scales: (n_pages, Hp, page_size, P) fp32 (quantized KV)

    Returns (N, Hp, Q, PD): the dense math over the gathered pages."""
    N, Hp, Q, PD = q.shape
    M = page_table.shape[1]
    T = M * page_size

    def gather(pool):
        g = pool[page_table.long()]            # (N, M, Hp, ps, ·)
        return g.transpose(1, 2).reshape(N, Hp, T, g.shape[-1])

    return flash_decode_reference(
        q, gather(k_pool), gather(v_pool), lengths, scale,
        None if k_scales is None else gather(k_scales),
        None if v_scales is None else gather(v_scales), groups, q_tokens)


def paged_attention(q, k_pool, v_pool, page_table, lengths, page_size,
                    scale=1.0, k_scales=None, v_scales=None, groups=1,
                    use_kernel=None, q_tokens=1):
    """Paged decode attention (see paged_attention_reference for shapes):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    `use_kernel=False` selects the plain version explicitly. Quantized
    pools dequantize in the kernel; q_tokens > 1 runs the verify
    ladder."""
    ps = int(page_size)
    with introspect.kernel_cost(lambda: _decode_cost(
            "paged_attention", q, k_pool, k_scales, lengths, ps)):
        return _paged_call(q, k_pool, v_pool, page_table, lengths, ps,
                           scale, k_scales, v_scales, groups, use_kernel,
                           q_tokens)


def _paged_call(q, k_pool, v_pool, page_table, lengths, ps, scale, k_scales,
                v_scales, groups, use_kernel, q_tokens):
    if not _use_kernel(q, use_kernel, "paged_attention"):
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         lengths, ps, scale, k_scales,
                                         v_scales, groups, q_tokens)
    N, Hp, Q, PD = q.shape
    mode = _check_decode("paged_attention", q, k_pool, v_pool, lengths,
                         k_scales, v_scales, q_tokens,
                         (k_pool.shape[0], Hp, ps))
    _check_cuda("paged_attention", page_table, dtype=torch.int32)
    M = page_table.shape[1]
    if page_table.shape != (N, M) or page_table.device != q.device:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, "
                         f"page_table {tuple(page_table.shape)} on "
                         f"{page_table.device}")
    ks, vs, P, G = _scale_args(k_scales, v_scales, groups)
    chunk, splits = _decode_plan(N * Hp, M * ps, ps)
    out = torch.empty_like(q)
    ws = _decode_workspace(q, splits)
    fn = _entry("paged_attention", "sg_paged_attention")
    _build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks,
                    vs, page_table.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), N, Hp, Q, M, ps, PD, P, G,
                    int(q_tokens), chunk, splits, float(scale),
                    _DTYPE[q.dtype], _KV_MODE[mode], _stream(q)),
                 "paged_attention")
    _count("paged_attention", mode, q_tokens)
    return out


__all__ = ["FlashAttention", "KV_MODES", "LAUNCHES", "LAUNCHES_BY_MODE",
           "RingAttention", "add_launches", "launch_counts",
           "launches_since", "attention_reference", "flash_attention",
           "flash_bwd_reference", "flash_decode", "flash_decode_reference",
           "nibble_pack", "nibble_unpack", "paged_attention",
           "paged_attention_reference", "reset_launches", "ring_attention",
           "ring_attention_sharded"]
