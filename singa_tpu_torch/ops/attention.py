"""Attention ops of the serving path (counterpart of
singa_tpu/ops/attention.py): flash-attention forward, dense flash-decode
and paged decode attention.

Each op has two versions with the same math:

- a plain PyTorch version (`attention_reference`,
  `flash_decode_reference`, `paged_attention_reference`), the mirror of
  the JAX package's `*_reference`: the CPU path, and the yardstick the
  kernels are held against;
- a hand-written CUDA kernel for Hopper in `singa_tpu_torch/csrc/`, built
  by `ops._build` on first use and called through ctypes.

Dispatch goes by the tensor's device, with no fallback: a CPU tensor runs
the plain version, a CUDA tensor launches the kernel or raises on input the
kernel does not take. `LAUNCHES` counts each kernel's launches, so a run
can show its main path went through the kernels.

Layouts are the JAX package's: (B, H, S, D) for flash attention;
head-packed block-diagonal queries (N, Hp, Q, P*D), dense caches
(N, Hp, T, P*D), page pools (n_pages, Hp, page_size, P*D) and an (N, M)
int32 page table for decode. The plain versions take scores and the
softmax in fp32, as the kernels do.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches since the last reset_launches(), by kernel
LAUNCHES = {"flash_fwd": 0, "flash_decode": 0, "paged_attention": 0}

_NEG_INF = -1e30
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh codes
_MAXQ, _MAXPD = 16, 256                          # csrc/decode_common.cuh

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sg_flash_fwd": [_vp] * 5 + [_i] * 5 + [_f, _i, _vp],
    "sg_flash_decode": [_vp] * 5 + [_i] * 5 + [_f, _i, _vp],
    "sg_paged_attention": [_vp] * 6 + [_i] * 6 + [_f, _i, _vp],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _flash_fwd(q, k, v, causal, scale, use_kernel=None):
    """(out, lse (B, H, Sq) fp32): the kernel on CUDA tensors, the plain
    version on CPU tensors or with `use_kernel=False`."""
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
    """Fused attention over (B, H, S, D), any S; returns (B, H, Sq, D)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _flash_fwd(q, k, v, causal, scale, use_kernel)[0]


# ======================= K3: dense flash-decode ============================

def flash_decode_reference(q, K, V, lengths, scale=1.0, q_tokens=1):
    """Ground-truth dense decode attention.

    q:        (N, Hp, Q, PD) packed block-diagonal queries
    K/V:      (N, Hp, T, PD) head-packed caches
    lengths:  (N,) int32 live positions per sequence (counted at the last
              query token under q_tokens > 1)

    Returns (N, Hp, Q, PD)."""
    N, Hp, Q, PD = q.shape
    T = K.shape[2]
    s = torch.einsum("nhqd,nhtd->nhqt", q.float(), K.float()) * scale
    limits = _row_limits(lengths, Q, Q // max(q_tokens, 1), q_tokens)
    valid = (torch.arange(T, device=q.device)[None, None, None, :]
             < limits[:, None, :, None])
    a = torch.softmax(torch.where(valid, s, float("-inf")), dim=-1)
    return torch.einsum("nhqt,nhtd->nhqd", a.to(q.dtype), V).to(q.dtype)


def _check_decode(what, q, K, V, lengths, q_tokens):
    if q_tokens != 1:
        raise ValueError(f"{what} kernel: q_tokens={q_tokens}; the verify "
                         "ladder is not ported yet")
    _check_cuda(what, q, K, V, dtype=q.dtype)
    _check_cuda(what, q, lengths, dtype=None)
    if q.dtype not in _DTYPE:
        raise ValueError(f"{what} kernel takes fp32/bf16 caches, got "
                         f"{q.dtype} (quantized caches are not ported yet)")
    if lengths.dtype != torch.int32:
        raise ValueError(f"{what}: lengths must be int32, got "
                         f"{lengths.dtype}")
    N, Hp, Q, PD = q.shape
    if Q > _MAXQ or PD > _MAXPD or N > 65535 or Hp > 65535:
        raise ValueError(f"{what} kernel takes Q <= {_MAXQ}, PD <= "
                         f"{_MAXPD}; got {tuple(q.shape)}")
    if lengths.shape != (N,):
        raise ValueError(f"{what}: lengths {tuple(lengths.shape)}, "
                         f"want ({N},)")


def flash_decode(q, K, V, lengths, scale=1.0, q_tokens=1, use_kernel=None):
    """Dense decode attention (see flash_decode_reference for shapes):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    `use_kernel=False` selects the plain version explicitly."""
    if not _use_kernel(q, use_kernel, "flash_decode"):
        return flash_decode_reference(q, K, V, lengths, scale, q_tokens)
    _check_decode("flash_decode", q, K, V, lengths, q_tokens)
    N, Hp, Q, PD = q.shape
    T = K.shape[2]
    if K.shape != (N, Hp, T, PD) or V.shape != K.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, "
                         f"K {tuple(K.shape)}, V {tuple(V.shape)}")
    out = torch.empty_like(q)
    fn = _entry("flash_decode", "sg_flash_decode")
    _build.check(fn(q.data_ptr(), K.data_ptr(), V.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), N, Hp, Q, T, PD,
                    float(scale), _DTYPE[q.dtype], _stream(q)),
                 "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out


# ======================= K4: paged decode attention ========================

def paged_attention_reference(q, k_pool, v_pool, page_table, lengths,
                              page_size, scale=1.0, q_tokens=1):
    """Ground-truth paged decode attention.

    q:          (N, Hp, Q, PD) packed block-diagonal queries
    k_pool/v_pool: (n_pages, Hp, page_size, PD) shared page pools
    page_table: (N, M) int32 page ids per sequence, in time order
    lengths:    (N,) int32 valid positions per sequence (>= 1)

    Returns (N, Hp, Q, PD): the dense math over the gathered pages."""
    N, Hp, Q, PD = q.shape
    M = page_table.shape[1]
    T = M * page_size

    def gather(pool):
        g = pool[page_table.long()]            # (N, M, Hp, ps, PD)
        return g.transpose(1, 2).reshape(N, Hp, T, g.shape[-1])

    return flash_decode_reference(q, gather(k_pool), gather(v_pool),
                                  lengths, scale, q_tokens)


def paged_attention(q, k_pool, v_pool, page_table, lengths, page_size,
                    scale=1.0, q_tokens=1, use_kernel=None):
    """Paged decode attention (see paged_attention_reference for shapes):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    `use_kernel=False` selects the plain version explicitly."""
    ps = int(page_size)
    if not _use_kernel(q, use_kernel, "paged_attention"):
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         lengths, ps, scale, q_tokens)
    _check_decode("paged_attention", q, k_pool, v_pool, lengths, q_tokens)
    _check_cuda("paged_attention", page_table, dtype=torch.int32)
    N, Hp, Q, PD = q.shape
    n_pages = k_pool.shape[0]
    M = page_table.shape[1]
    if (k_pool.shape != (n_pages, Hp, ps, PD) or v_pool.shape != k_pool.shape
            or page_table.shape != (N, M)):
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"page_table {tuple(page_table.shape)}, "
                         f"page_size {ps}")
    out = torch.empty_like(q)
    fn = _entry("paged_attention", "sg_paged_attention")
    _build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    page_table.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), N, Hp, Q, M, ps, PD, float(scale),
                    _DTYPE[q.dtype], _stream(q)), "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out


__all__ = ["LAUNCHES", "attention_reference", "flash_attention",
           "flash_decode", "flash_decode_reference", "paged_attention",
           "paged_attention_reference", "reset_launches"]
