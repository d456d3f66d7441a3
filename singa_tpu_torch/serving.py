"""KV-cached autoregressive decoding for the GPT (counterpart of
singa_tpu/serving.py): the decode core (prefill, the single-token cached
step and the k-token verify step, dense and paged), weight-only int8
quantization, int8 and int4 KV caches, the decode-param tree and its memo,
and the decode loops behind `GPT.generate` (greedy/sampled and draft-model
speculative) and `GPT.generate_beam`.

Layouts are the JAX package's:

- HEAD-PACKED KV caches, (B, Hkv/P, T, P*D) with P = 128 // D when it
  divides the kv heads (else 1): P heads share one P*D-lane row, and the
  scores stay exactly per head through BLOCK-DIAGONAL queries
  (`_pack_q`/`_unpack_o`).
- Quantized caches (`kv_dtype="int8"` or `"int4"`): per-(head, position)
  symmetric scales, (B, Hp, T, P) fp32, beside int8 rows or packed-nibble
  uint8 rows of P*D/2 bytes. A cache is then ((K8, Ks), (V8, Vs)).
- Wq/Wk/Wv fuse into one (E, E + 2*Hkv*D) matmul at decode-param prep;
  `dtype="int8"` stores the big matrices as int8 plus a per-output-column
  scale (`_quant8`) and multiplies through `_mm`.
- An MoE block's MLP is `parallel.moe.moe_ffn` over every row of the
  call (`moeWg`, `moeW1`, `moeb1`, `moeW2`, `moeb2`; kept bf16 under
  `dtype="int8"`). Its capacity is batch-global, so a row's drop depends
  on the other rows of the same step: B in a token step, B * S0 in a
  prefill, B * k in a verify step, every slot (inactive ones too) in the
  engine's step, the bucket-padded prompt in its prefill, as in the JAX
  package. `moe_capacity_factor` overrides the layers' factor.

Where the JAX package runs prefill + `lax.scan` (or `lax.while_loop`) as
compiled programs, the port runs eagerly: the decode builders are Python
loops over the steps. Caches and page pools are written IN PLACE (JAX
returns updated copies), and a write JAX drops (mode="drop": an inactive
slot, a position past the cache or past `write_limits`) is masked out
here before it is made. Attention goes through the kernels of
ops.attention on CUDA tensors and their plain versions on CPU tensors;
`use_kernel=False` selects the plain versions on the card for
comparisons.

Builds (`introspect.AotExecutor`, the JAX package's keys): `generate`'s
prefill ("serving.prefill") and its whole decode loop
("serving.decode_scan"), the speculative prefill and rounds
("serving.spec_prefill", "serving.spec_verify") and the beam search
("serving.beam"). Each distinct argument signature registers one build
at its first call, which runs under introspect's counting mode; a
decode function is built once per shape and cached by `GPT.generate`,
so a repeated call registers nothing.
"""

from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from . import (autograd, health, introspect, memory, observe, resilience,
               slo, watchdog)
from .autograd import _top_k
from .layer import layernorm
from .parallel.moe import moe_ffn
from .ops.attention import (flash_attention, flash_decode, nibble_pack,
                            paged_attention)

#: serving dtypes of the decode-param tree: as stored (fp32), bf16
#: weights and activations, or int8 weights with bf16 activations (W8A16)
DTYPES = (None, "bfloat16", "int8")
#: KV-cache storage modes ("fp" is the activation-dtype cache, the
#: kv_dtype=None API spelling)
KV_DTYPES = ("fp", "int8", "int4")
#: speculative-decoding per-token verdicts (the `verdict=` label on
#: singa_spec_tokens_total, proven against this tuple by
#: tools/check_metrics_names.py rule 5): "drafted" every draft proposal,
#: "accepted" the proposals the target verified, "bonus" the target's own
#: token each round emits, "wasted" = drafted - accepted
SPEC_VERDICTS = ("drafted", "accepted", "bonus", "wasted")
_KVQ = ("int8", "int4")
#: the decode-param matrices `dtype="int8"` quantizes (and the head)
_Q8_KEYS = ("Wqkv", "Wo", "W1", "W2", "head")


def kv_label(kv_dtype) -> str:
    """Map the API spelling (None/'int8'/'int4') onto KV_DTYPES."""
    label = kv_dtype or "fp"
    if label not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in (None, 'int8', "
                         "'int4')")
    return label


def tree_leaves(tree):
    """The tensors of a nested list/tuple (caches, pools) in order."""
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in tree_leaves(sub)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, sub) for sub in tree)
    return fn(tree)


def _quant8(W):
    """Per-output-channel symmetric int8 quantization of an (in, out)
    weight: {"q8": int8, "sc": (1, out) fp32}. The scale commutes with
    the contraction, so the product runs on the int8 values and only the
    (…, out) result is rescaled. torch.round rounds half to even, as
    jnp.round does, so the bytes equal the JAX package's."""
    s = torch.clamp(W.abs().amax(dim=0, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(W / s), -127, 127).to(torch.int8)
    return {"q8": q, "sc": s.float()}


def _mm(x, W):
    """x @ W where W is a plain matrix or a _quant8 dict (W8A16: the int8
    values cast to x's dtype, one torch.matmul, then the column scale;
    the JAX package leaves this product to XLA, outside any kernel)."""
    if isinstance(W, dict):
        return (x @ W["q8"].to(x.dtype)) * W["sc"].to(x.dtype)
    return x @ W


def _cast_params(p, dtype):
    """Decode-param tree in the serving dtype: None = as stored (fp32),
    "bfloat16" = bf16 weights and activations, "int8" = bf16 with the
    _Q8_KEYS matrices quantized by _quant8 (biases, LayerNorm and the
    embedding, whose gather reads only B rows, stay bf16)."""
    if dtype is None:
        return p
    if dtype not in DTYPES:
        raise ValueError(f"serving dtype {dtype!r} not in {DTYPES}")

    def cast(a):
        return a.to(torch.bfloat16) if a.is_floating_point() else a

    out = {k: cast(v) for k, v in p.items() if k != "blocks"}
    out["blocks"] = [{k: cast(v) for k, v in bp.items()}
                     for bp in p["blocks"]]
    if dtype == "int8":
        out["head"] = _quant8(p["head"])
        for nb, bp in zip(out["blocks"], p["blocks"]):
            for k in _Q8_KEYS:
                if k in bp:
                    nb[k] = _quant8(bp[k])
    return out


class _DecodeCore:
    """The decode math shared by GPT.generate, GPT.generate_beam and the
    serving engine: the fp32-island LayerNorm, the causal prefill (which
    also yields the K/V rows), the single-token block step and the
    k-token verify step, each against a dense or a paged cache, in fp or
    quantized (int8/int4) KV. `moe_ks` holds per block (k, capacity
    factor) for an MoE block, None for a dense one."""

    def __init__(self, H, E, S0, T, scale, moe_ks=None, kv_heads=None,
                 rope=False, rope_theta=10000.0, kv_dtype=None):
        self.H, self.E, self.S0, self.T, self.scale = H, E, S0, T, scale
        self.moe_ks = moe_ks or []
        self.rope = bool(rope)
        self.rope_theta = float(rope_theta)
        # quantized KV: per-(head, position) symmetric scales; K's fold
        # into the scores and V's into the attention weights of the
        # diagonal (own-head) block, the only one _unpack_o keeps
        kv_label(kv_dtype)
        self.kv4 = kv_dtype == "int4"
        self.kvq = kv_dtype in _KVQ
        # GQA: Hkv kv heads each serve G = H/Hkv query heads; the caches
        # hold Hkv heads and the packed block-diagonal queries place G
        # rows per kv-head block
        self.Hkv = kv_heads or H
        self.G = H // self.Hkv
        D = E // H
        P = max(1, 128 // D)
        self.P = P if (P > 1 and self.Hkv % P == 0) else 1

    def ln(self, x, g, b, eps=1e-5):
        return layernorm(x, g, b, eps)

    def mlp(self, bp, x, li):
        """Block `li`'s MLP on (..., E): the dense two-layer one, or the
        MoE FFN over all of x's rows at once."""
        kcf = self.moe_ks[li] if li < len(self.moe_ks) else None
        if kcf is None:
            return _mm(autograd.gelu(_mm(x, bp["W1"]) + bp["bb1"]),
                       bp["W2"]) + bp["bb2"]
        k, cf = kcf
        y, _, _ = moe_ffn(x.reshape(-1, x.shape[-1]), bp["moeWg"],
                          bp["moeW1"], bp["moeb1"], bp["moeW2"],
                          bp["moeb2"], capacity_factor=cf, k=k)
        return y.reshape(x.shape).to(x.dtype)

    def head(self, p, h):
        return _mm(self.ln(h, p["gf"], p["bf"]), p["head"])

    def qkv(self, bp, x, n, S=None):
        """Fused QKV projection: one (E, E + 2*Hkv*D) matmul, split into
        q (n,[S,]H,D) and k/v (n,[S,]Hkv,D) — with S, heads come first:
        (n, H, S, D)."""
        H, D, E, Hkv = self.H, self.E // self.H, self.E, self.Hkv
        KE = Hkv * D
        fused = _mm(x, bp["Wqkv"]) + bp["bqkv"]
        bounds = ((0, E, H), (E, E + KE, Hkv), (E + KE, E + 2 * KE, Hkv))
        if S is None:
            return tuple(fused[..., a:b].reshape(n, h, D)
                         for a, b, h in bounds)
        return tuple(fused[..., a:b].reshape(n, S, h, D).transpose(1, 2)
                     for a, b, h in bounds)

    def _pack(self, kv, n, S):
        """(n, Hkv, S, D) per-kv-head K/V -> head-packed
        (n, Hkv/P, S, P*D)."""
        D, P, Hkv = self.E // self.H, self.P, self.Hkv
        return kv.reshape(n, Hkv // P, P, S, D).transpose(2, 3) \
            .reshape(n, Hkv // P, S, P * D)

    def _quant_kv(self, kv, n, S):
        """(n, Hkv, S, D) -> (packed quantized cache rows, scales
        (n, Hp, S, P) fp32), per-(head, position) symmetric: int8 rows
        (n, Hp, S, P*D), or for int4 packed-nibble uint8 rows
        (n, Hp, S, P*D/2) on a max|kv|/7 basis. Bit-identical to the JAX
        package's on the same values."""
        P, Hkv = self.P, self.Hkv
        qmax = 7.0 if self.kv4 else 127.0
        x = kv.float()
        s = torch.clamp(x.abs().amax(dim=-1), min=1e-8) / qmax
        q = torch.clamp(torch.round(x / s[..., None]), -qmax,
                        qmax).to(torch.int8)
        sp = s.reshape(n, Hkv // P, P, S).transpose(2, 3).contiguous()
        packed = self._pack(q, n, S)
        if self.kv4:
            packed = nibble_pack(packed)
        return packed, sp

    def _store(self, cache, kn, vn, n, S, put):
        """Write new K/V (n, Hkv, S, D) into one block's cache (fp (K, V)
        or quantized ((K8, Ks), (V8, Vs))) through `put(dst, rows)`, rows
        (n, Hp, S, ·), in place. Returns the attention operands (K, V,
        k_scales, v_scales)."""
        out = []
        for side, new in zip(cache, (kn, vn)):
            data, sc = side if self.kvq else (side, None)
            rows, rsc = (self._quant_kv(new, n, S) if self.kvq
                         else (self._pack(new, n, S), None))
            put(data, rows)
            if sc is not None:
                put(sc, rsc)
            out.append((data, sc))
        (K, Ks), (V, Vs) = out
        return K, V, Ks, Vs

    def new_cache(self, n, T, dtype, device):
        """One block's empty dense cache of T positions ((n, Hp, T, ·))
        in this core's KV mode; `dtype` is the fp cache's dtype."""
        P, D = self.P, self.E // self.H
        Hp = self.Hkv // P
        if not self.kvq:
            return tuple(torch.zeros((n, Hp, T, P * D), dtype=dtype,
                                     device=device) for _ in range(2))
        W = (P * D) // 2 if self.kv4 else P * D
        qd = torch.uint8 if self.kv4 else torch.int8
        return tuple((torch.zeros((n, Hp, T, W), dtype=qd, device=device),
                      torch.zeros((n, Hp, T, P), dtype=torch.float32,
                                  device=device)) for _ in range(2))

    def _pack_q(self, q, n):
        """(n, H, D) per-head queries -> packed BLOCK-DIAGONAL
        (n, Hp, P*G, P*D): packed slot c holds kv head (hp*P + c)'s G
        query rows in block c, zeros elsewhere. The two separated index
        tensors put their broadcast dimension first, as in numpy and
        JAX: the indexed view is (P, n, Hp, G, D)."""
        D, P, G = self.E // self.H, self.P, self.G
        Hp = self.Hkv // P
        ar = torch.arange(P, device=q.device)
        q6 = torch.movedim(q.reshape(n, Hp, P, G, D), 2, 0)
        z = q.new_zeros((n, Hp, P, G, P, D))
        z[:, :, ar, :, ar, :] = q6
        return z.reshape(n, Hp, P * G, P * D)

    def _unpack_o(self, O2, n):
        """(n, Hp, P*G, P*D) packed attention output -> (n, E): the
        DIAGONAL (own-head) blocks."""
        D, P, G = self.E // self.H, self.P, self.G
        Hp = self.Hkv // P
        ar = torch.arange(P, device=O2.device)
        return torch.movedim(
            O2.reshape(n, Hp, P, G, P, D)[:, :, ar, :, ar, :],
            0, 2).reshape(n, self.E)

    def _pack_q_multi(self, q, n, k):
        """(n, H, k, D) per-head queries for k tokens -> packed
        block-diagonal (n, Hp, k*P*G, P*D), token-major rows: the
        (q_tokens, P, G) layout of the kernels' verify ladder."""
        Hp, PG = self.Hkv // self.P, self.P * self.G
        PD = self.P * (self.E // self.H)
        Q2 = self._pack_q(q.transpose(1, 2).reshape(n * k, self.H,
                                                     self.E // self.H),
                          n * k)                        # (n*k, Hp, PG, PD)
        return torch.movedim(Q2.reshape(n, k, Hp, PG, PD), 1, 2) \
            .reshape(n, Hp, k * PG, PD)

    def _unpack_o_multi(self, O2, n, k):
        """(n, Hp, k*P*G, P*D) packed attention output -> (n, k, E)."""
        Hp, PG = self.Hkv // self.P, self.P * self.G
        PD = self.P * (self.E // self.H)
        O5 = torch.movedim(O2.reshape(n, Hp, k, PG, PD), 2, 1) \
            .reshape(n * k, Hp, PG, PD)
        return self._unpack_o(O5, n * k).reshape(n, k, self.E)

    def _embed(self, p, toks, pos):
        """Token (+ learned position) embedding of `toks` at `pos` (same
        shape), and the rope tables (pos.shape + (D,)) or None."""
        h = p["emb"][toks]
        if not self.rope:
            return h + p["pos"][pos], None
        rcos, rsin = autograd.rope_tables(pos.reshape(-1), self.E // self.H,
                                          self.rope_theta)
        shape = tuple(pos.shape) + (rcos.shape[-1],)
        return h, (rcos.reshape(shape), rsin.reshape(shape))

    def _block(self, li, bp, h, n, S, rope, attend):
        """Block `li` on h (n, [S,] E): qkv (rotated), then
        `attend(q, kn, vn)` -> the attention output (n, [S,] E), then the
        output projection and the MLP."""
        x = self.ln(h, bp["g1"], bp["b1"])
        q, kn, vn = self.qkv(bp, x, n, S)
        if rope is not None:
            # (n, [S,] D) tables broadcast over the heads: (n, 1, [S,] D)
            rcos, rsin = rope[0][:, None], rope[1][:, None]
            q = autograd.apply_rope(q, rcos, rsin)
            kn = autograd.apply_rope(kn, rcos, rsin)
        o = attend(q, kn, vn, x.dtype)
        h = h + _mm(o, bp["Wo"]) + bp["bo"]
        x = self.ln(h, bp["g2"], bp["b2"])
        return h + self.mlp(bp, x, li)

    def prefill_parts(self, p, prompt, n, use_kernel=None):
        """Causal pass over the (n, S) prompt: the final hidden states
        (n, S, E) and per block the raw (rotated, unpacked) k/v
        (n, Hkv, S, D). Attention runs through the flash-attention kernel
        at any S (GQA via repeat_interleave of K/V)."""
        D = self.E // self.H
        S = prompt.shape[1]
        h = p["emb"][prompt]
        if not self.rope:
            h = h + p["pos"][:S]
        else:
            rcos, rsin = autograd.rope_tables(
                torch.arange(S, device=prompt.device), D, self.rope_theta)
        kvs = []
        for li, bp in enumerate(p["blocks"]):
            x = self.ln(h, bp["g1"], bp["b1"])
            q, k, v = self.qkv(bp, x, n, S)
            if self.rope:
                q = autograd.apply_rope(q, rcos, rsin)
                k = autograd.apply_rope(k, rcos, rsin)
            kr = k.repeat_interleave(self.G, dim=1) if self.G > 1 else k
            vr = v.repeat_interleave(self.G, dim=1) if self.G > 1 else v
            o = flash_attention(q.contiguous(), kr.contiguous(),
                                vr.contiguous(), True, self.scale,
                                use_kernel=use_kernel)
            h = h + _mm(o.transpose(1, 2).reshape(n, S, self.E),
                        bp["Wo"]) + bp["bo"]
            x = self.ln(h, bp["g2"], bp["b2"])
            h = h + self.mlp(bp, x, li)
            kvs.append((k, v))
        return h, kvs

    def prefill(self, p, prompt, n, use_kernel=None):
        """Causal pass over the (n, S0) prompt: the last position's logits
        (n, V) and per block head-packed KV caches of T positions holding
        the prompt's rows (quantized under kv_dtype)."""
        S0 = self.S0
        h, kvs = self.prefill_parts(p, prompt, n, use_kernel)
        caches = []
        for k, v in kvs:
            cache = self.new_cache(n, self.T, k.dtype, k.device)

            def put(dst, rows):
                dst[:, :, :S0] = rows
            self._store(cache, k, v, n, S0, put)
            caches.append(cache)
        return self.head(p, h[:, -1]), caches

    def token_step(self, p, tok, caches, i, n, use_kernel=None):
        """Feed token `tok` (n,) at generated index `i` (position S0+i)
        through all blocks, writing each block's new K/V row into the
        caches in place; returns (logits (n, V), caches). Attention runs
        through the flash-decode kernel (use_kernel=None: by the tensors'
        device; False: the plain version)."""
        pos_idx = self.S0 + int(i)
        pos = torch.full((n,), pos_idx, dtype=torch.long, device=tok.device)
        h, rope = self._embed(p, tok, pos)
        lens = torch.full((n,), pos_idx + 1, dtype=torch.int32,
                          device=tok.device)

        def put(dst, rows):
            dst[:, :, pos_idx] = rows[:, :, 0]

        for li, (cache, bp) in enumerate(zip(caches, p["blocks"])):
            def attend(q, kn, vn, dt, cache=cache):
                K, V, Ks, Vs = self._store(cache, kn[:, :, None],
                                           vn[:, :, None], n, 1, put)
                O2 = flash_decode(self._pack_q(q, n), K, V, lens,
                                  self.scale, Ks, Vs, self.G,
                                  use_kernel=use_kernel)
                return self._unpack_o(O2.to(dt), n)
            h = self._block(li, bp, h, n, None, rope, attend)
        return self.head(p, h), caches

    def verify_step(self, p, toks, caches, pos, active, n, k,
                    use_kernel=None):
        """The speculative VERIFY step: feed `toks` (n, k) at per-row
        positions pos[i]..pos[i]+k-1 through all blocks in one batched
        forward, writing all k K/V rows in place (rows of inactive
        sequences and positions past the cache are not written), then
        attend with the causal ladder (token j sees positions <= pos+j)
        through flash-decode's q_tokens mode. Returns (logits (n, k, V),
        caches): logits[:, j] equals the j-th sequential token_step's.
        k == 1 is token_step's math at per-row positions (the draft loop
        uses it that way)."""
        dev = toks.device
        posk = pos.long()[:, None] + torch.arange(k, device=dev)[None, :]
        h, rope = self._embed(p, toks, torch.clamp(posk, max=self.T - 1))
        ok = active[:, None] & (posk < self.T)
        ni = torch.arange(n, device=dev)[:, None].expand(n, k)[ok]
        pi = posk[ok]
        # NOT clamped to T: token ti's limit is lens_att - (k-1-ti), and
        # clamping would cut the last tokens' masks near the cache end
        lens_att = (pos.long() + k).to(torch.int32)

        def put(dst, rows):
            dst[ni, :, pi] = rows.transpose(1, 2)[ok]

        for li, (cache, bp) in enumerate(zip(caches, p["blocks"])):
            def attend(q, kn, vn, dt, cache=cache):
                K, V, Ks, Vs = self._store(cache, kn, vn, n, k, put)
                O2 = flash_decode(self._pack_q_multi(q, n, k), K, V,
                                  lens_att, self.scale, Ks, Vs, self.G,
                                  use_kernel=use_kernel, q_tokens=k)
                return self._unpack_o_multi(O2.to(dt), n, k)
            h = self._block(li, bp, h, n, k, rope, attend)
        return self.head(p, h), caches

    def paged_token_step(self, p, tok, pools, page_table, lens, active, n,
                         page_size, use_kernel=None):
        """One ragged decode step against the PAGED KV cache (the serving
        engine's step): feed `tok` (n,) for each slot at its own position
        `lens[i]`, write the new K/V row into the slot's current page
        (active slots only, in place: JAX drops the inactive slots'
        out-of-range scatter, torch would raise, so they are masked out),
        and attend over each slot's pages through the paged kernel.
        `pools` is a list per block of (K, V) or, quantized,
        ((K8, Ks), (V8, Vs)), each (n_pages, Hp, page_size, ·). Returns
        (logits (n, V), pools)."""
        ps = page_size
        # clamp so an inactive slot's stale length never indexes outside
        # the table or the position table (its output is discarded)
        pos = torch.clamp(lens.long(), max=self.T - 1)
        h, rope = self._embed(p, tok, pos)
        rows = torch.arange(n, device=tok.device)[active]
        pvec = page_table.long()[rows, pos[rows] // ps]
        off = pos[rows] % ps
        ln_att = torch.where(active, pos + 1, 1).to(torch.int32)

        def put(dst, new):
            dst[pvec, :, off] = new[:, :, 0][rows]

        for li, (pool, bp) in enumerate(zip(pools, p["blocks"])):
            def attend(q, kn, vn, dt, pool=pool):
                K, V, Ks, Vs = self._store(pool, kn[:, :, None],
                                           vn[:, :, None], n, 1, put)
                O2 = paged_attention(self._pack_q(q, n), K, V, page_table,
                                     ln_att, ps, self.scale, Ks, Vs, self.G,
                                     use_kernel=use_kernel)
                return self._unpack_o(O2.to(dt), n)
            h = self._block(li, bp, h, n, None, rope, attend)
        return self.head(p, h), pools

    def paged_verify_step(self, p, toks, pools, page_table, lens, active,
                          n, page_size, k, use_kernel=None,
                          write_limits=None):
        """The speculative VERIFY step against the PAGED pool: feed `toks`
        (n, k) at per-slot positions lens[i]..lens[i]+k-1 in one batched
        forward, write the K/V rows into each slot's pages, then attend
        through paged_attention's q_tokens ladder. Returns (logits
        (n, k, V), pools). Writes of inactive slots and at or past
        `write_limits` (exclusive, default the cache horizon T) are not
        made: past its reserved pages a slot's table holds page 0, which
        belongs to another request. The page index is clamped to the
        table's width before the lookup; those positions only ever feed
        outputs the caller discards."""
        ps, dev = page_size, toks.device
        M = page_table.shape[1]
        posk = lens.long()[:, None] + torch.arange(k, device=dev)[None, :]
        h, rope = self._embed(p, toks, torch.clamp(posk, max=self.T - 1))
        wl = (write_limits.long() if write_limits is not None
              else torch.full((n,), self.T, dtype=torch.long, device=dev))
        ok = active[:, None] & (posk < wl[:, None])
        nidx = torch.arange(n, device=dev)[:, None]
        pg = page_table.long()[nidx, torch.clamp(posk // ps, max=M - 1)][ok]
        off = (posk % ps)[ok]
        ln_att = torch.where(active, lens.long() + k, 1).to(torch.int32)

        def put(dst, rows):
            dst[pg, :, off] = rows.transpose(1, 2)[ok]

        for li, (pool, bp) in enumerate(zip(pools, p["blocks"])):
            def attend(q, kn, vn, dt, pool=pool):
                K, V, Ks, Vs = self._store(pool, kn, vn, n, k, put)
                O2 = paged_attention(self._pack_q_multi(q, n, k), K, V,
                                     page_table, ln_att, ps, self.scale, Ks,
                                     Vs, self.G, use_kernel=use_kernel,
                                     q_tokens=k)
                return self._unpack_o_multi(O2.to(dt), n, k)
            h = self._block(li, bp, h, n, k, rope, attend)
        return self.head(p, h), pools


def _decode_core(m, S0, max_new, moe_capacity_factor=None, kv_dtype=None):
    """The _DecodeCore matching model `m`'s configuration. An MoE block
    routes with its own capacity factor unless `moe_capacity_factor`
    overrides it: a tight training factor need not drop tokens when
    serving (float(num_experts) drops none)."""
    T = S0 + max_new
    if T > m.max_seq:
        raise ValueError(f"prompt {S0} + new {max_new} exceeds max_seq "
                         f"{m.max_seq}")
    moe_ks = [(b.moe.k, float(moe_capacity_factor
                              if moe_capacity_factor is not None
                              else b.moe.capacity_factor))
              if b.moe_experts else None for b in m.blocks]
    return _DecodeCore(m.num_heads, m.dim, S0, T,
                       (m.dim // m.num_heads) ** -0.5, moe_ks,
                       kv_heads=m.num_kv_heads,
                       rope=m.pos_encoding == "rope",
                       rope_theta=m.rope_theta, kv_dtype=kv_dtype)


# ---- decode-param preparation + memo ---------------------------------------

@torch.no_grad()
def decode_params(m):
    """The decode-param tree of model `m` (fp32, unused biases
    zero-filled, QKV fused; an MoE block's expert weights in place of
    the MLP's)."""
    blocks = []
    for b in m.blocks:
        a = b.attn
        zeros = a.Wq.new_zeros((m.dim,))
        bp = {
            "g1": b.ln1.gamma, "b1": b.ln1.beta,
            "Wqkv": torch.cat([a.Wq, a.Wk, a.Wv], dim=1),
            "bqkv": torch.cat([a.bq, a.bk, a.bv]) if a.use_bias
            else a.Wq.new_zeros((a.Wq.shape[1] + a.Wk.shape[1]
                                 + a.Wv.shape[1],)),
            "Wo": a.Wo, "bo": a.bo if a.use_bias else zeros,
            "g2": b.ln2.gamma, "b2": b.ln2.beta,
        }
        if b.moe_experts:
            bp.update({"moeWg": b.moe.Wg, "moeW1": b.moe.W1,
                       "moeb1": b.moe.b1, "moeW2": b.moe.W2,
                       "moeb2": b.moe.b2})
        else:
            bp.update({"W1": b.fc1.W, "bb1": b.fc1.b, "W2": b.fc2.W,
                       "bb2": b.fc2.b})
        blocks.append({k: v.detach() for k, v in bp.items()})
    emb = m.tok_embed.W.detach()
    return {
        "emb": emb,
        "pos": (emb.new_zeros((m.max_seq, 0)) if m.pos_encoding == "rope"
                else m.pos_embed.detach()),
        "gf": m.ln_f.gamma.detach(), "bf": m.ln_f.beta.detach(),
        "head": m.head.W.detach(), "blocks": blocks,
    }


def decode_raw(m) -> list:
    """Every parameter the decode reads: the identity basis of the
    decode-param tree's memo."""
    arrs = [m.tok_embed.W, m.ln_f.gamma, m.ln_f.beta]
    if m.pos_encoding != "rope":
        arrs.append(m.pos_embed)
    arrs.append(m.head.W)
    for b in m.blocks:
        a = b.attn
        arrs += [b.ln1.gamma, b.ln1.beta, b.ln2.gamma, b.ln2.beta,
                 a.Wq, a.Wk, a.Wv, a.Wo]
        if a.use_bias:
            arrs += [a.bq, a.bk, a.bv, a.bo]
        if b.moe_experts:
            arrs += [b.moe.Wg, b.moe.W1, b.moe.b1, b.moe.W2, b.moe.b2]
        else:
            arrs += [b.fc1.W, b.fc1.b, b.fc2.W, b.fc2.b]
    return arrs


def decode_state(m, dtype):
    """Memoized decode-param tree per serving dtype: the QKV fusion and
    the cast run once per weight set. The memo holds weak references to
    the parameters (`decode_raw`) with their version counters and hits
    only while every parameter is the same tensor, unmodified in place
    (load_singa_params bumps the counters)."""
    params = decode_raw(m)
    cached = getattr(m, "_param_cache", None)
    if cached is not None:
        refs, trees = cached
        if len(refs) != len(params) or any(
                r() is not t or ver != t._version
                for (r, ver), t in zip(refs, params)):
            cached = None
    if cached is None:
        refs = tuple((weakref.ref(t), t._version) for t in params)
        cached = m._param_cache = (refs, {})
    trees = cached[1]
    if dtype not in trees:
        trees[dtype] = _cast_params(decode_params(m), dtype)
    return trees[dtype]


# ---- the decode loops -------------------------------------------------------

def build_decode(m, B, S0, max_new, temperature, top_k, dtype=None,
                 moe_capacity_factor=None, kv_dtype=None):
    """Greedy/sampled decode fn: (params, prompt (B, S0) on the model's
    device, seed) -> ids (B, S0 + max_new). Prefill plus the first token,
    then a Python loop of `token_step`s, one sampled token each.
    Sampling draws from a torch.Generator seeded with `seed` on the
    model's device. `moe_capacity_factor` overrides the MoE layers'
    factor; `kv_dtype` quantizes the caches (the JAX package's order).

    The call runs inside the span `serving.decode` under the watchdog's
    `decode` deadline, passing the fault point "serving.decode" first;
    the prefill and the first token inside `serving.prefill`, the token
    loop inside `serving.decode_scan` (an out-of-memory error in either
    writes the memory ledger's OOM bundle under that key). With a ledger
    installed and no engine owning the kv_cache region, the caches are
    noted as kv_cache until they die. With
    observe enabled, or an `slo` tracker installed, the prefill and the
    call are fenced (a device synchronize) for an honest TTFT and
    latency: observe's `record_decode` books them, and `slo.note_decode`
    feeds the tracker; otherwise nothing is fenced. With observe enabled
    the non-finite logits of the prefill and of every step are counted
    on the device into `decode.nan_logits` (a 0-d int64 tensor, else
    None), which the caller reads with the tokens
    (`GPT.generate` books it by `health.record_nan_logits`)."""
    core = _decode_core(m, S0, max_new, moe_capacity_factor, kv_dtype)

    def sample(logits, gen):
        logits = logits.float()
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        logits = logits / temperature
        if top_k is not None:
            kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
            logits = torch.where(logits < kth, float("-inf"), logits)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    kind = "greedy" if temperature == 0.0 else "sampled"

    def scan_stage(p, tok, caches, gen, nf):
        """The decode loop after the first token: (new tokens, nf)."""
        out = []
        for i in range(max_new - 1):
            logits, caches = core.token_step(p, tok, caches, i, B)
            if nf is not None:
                nf = nf + _nonfinite(logits)
            tok = sample(logits, gen)
            out.append(tok)
        return out, nf

    prefill_x = introspect.AotExecutor(
        lambda p, prompt: core.prefill(p, prompt, B), "serving.prefill",
        names=("params", "prompt"))
    scan_x = introspect.AotExecutor(
        scan_stage, "serving.decode_scan",
        names=("params", "tok0", "caches", "gen", "nf"))

    @torch.no_grad()
    def decode(p, prompt, seed=0):
        obs = observe.is_enabled()
        timed = obs or slo.get_tracker() is not None
        gen = torch.Generator(device=prompt.device)
        gen.manual_seed(int(seed))
        nf = None
        # the watchdog's `decode` deadline arms over the whole call
        with watchdog.guard("decode", batch=B), \
                observe.span("serving.decode", batch=B, new_tokens=max_new):
            resilience.fault_point("serving.decode", batch=B)
            t0 = time.perf_counter()
            ttft = None
            with observe.span("serving.prefill", batch=B,
                              prompt_tokens=S0), \
                    memory.on_oom("serving.prefill"):
                logits, caches = prefill_x(p, prompt)
                if obs:
                    nf = _nonfinite(logits)
                tok = sample(logits, gen)
                if timed:
                    _fence(prompt.device)
                    ttft = time.perf_counter() - t0
            # the memory ledger's note: the caches are alive until the
            # decode span exits (its snapshot), unless an engine's pools
            # own the kv_cache region
            if memory.get_ledger() is not None and \
                    not memory.region_has_provider(memory.REGION_KV_CACHE):
                memory.note_arrays(memory.REGION_KV_CACHE, caches)
            out = [tok]
            if max_new > 1:
                with observe.span("serving.decode_scan", batch=B,
                                  new_tokens=max_new), \
                        memory.on_oom("serving.decode_scan"):
                    toks, nf = scan_x(p, tok, caches, gen, nf)
                    out.extend(toks)
            ids = torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
            decode.nan_logits = nf
            if timed:
                _fence(prompt.device)
                total = time.perf_counter() - t0
                if obs:
                    observe.record_decode(
                        kind, total, new_tokens=B * max_new, batch=B,
                        ttft=ttft, prompt_tokens=B * S0)
                slo.note_decode(kind, total, B * max_new, ttft=ttft,
                                batch=B)
        return ids

    decode.kind = kind
    decode.nan_logits = None
    return decode


def _nonfinite(logits):
    """The count of non-finite entries, a 0-d int64 device tensor."""
    return (~torch.isfinite(logits)).sum()


def _fence(device):
    """Wait for the device's queued work (the serving telemetry's
    fence: observe enabled or an SLO tracker installed)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _spec_metrics():
    """Speculative-decoding metrics, spelled out for the static lint
    (verdict= values are members of SPEC_VERDICTS)."""
    return {
        "tokens": observe.counter(
            "singa_spec_tokens_total",
            "speculative-decoding tokens by verdict (drafted / "
            "accepted / bonus / wasted)"),
        "rounds": observe.counter(
            "singa_spec_rounds_total",
            "speculative verify rounds (one draft+verify cycle)"),
        "acceptance": observe.gauge(
            "singa_spec_acceptance_rate",
            "last call/sync's accepted-over-drafted fraction"),
    }


def record_spec(drafted: int, accepted: int, bonus: int, rounds: int):
    """Book one speculative call's (or engine sync's) draft economics into
    the singa_spec_* metrics. Returns the acceptance fraction (None when
    nothing was drafted)."""
    rate = accepted / drafted if drafted > 0 else None
    if not observe.is_enabled():
        return rate
    m = _spec_metrics()
    if drafted:
        m["tokens"].inc(float(drafted), verdict="drafted")
        m["tokens"].inc(float(accepted), verdict="accepted")
        m["tokens"].inc(float(drafted - accepted), verdict="wasted")
    if bonus:
        m["tokens"].inc(float(bonus), verdict="bonus")
    if rounds:
        m["rounds"].inc(float(rounds))
    if rate is not None:
        m["acceptance"].set(rate)
    return rate


def _spec_round(draft_step, verify, tok, active, budget, K, eos_id=None):
    """One speculative round, shared by `build_spec_decode` and the
    engine. The draft proposes K tokens after the pending `tok` (n,) in
    K + 1 steps (`draft_step(t, j)` -> logits (n, V); the last step only
    writes the draft's row for the bonus position), `verify(feed)` runs
    the target over the pending token and the proposals (n, K + 1) ->
    logits (n, K + 1, V), and each active row commits its longest
    accepted prefix plus the target's own next token, capped by `budget`
    (n,) and cut after an `eos_id`. Returns (g, take, tok, counts,
    ended): the target's greedy tokens (n, K + 1), how many of them each
    row commits, the new pending tokens, the round's (drafted, accepted,
    bonus) counts, the rows that committed an eos and the count of
    non-finite logits among those each row commits (the rest are ladder
    positions past the row's budget), all on the device."""
    dt, drafts = tok, []
    for j in range(K + 1):
        dt = torch.argmax(draft_step(dt, j).float(), dim=-1)
        drafts.append(dt)
    drafts = torch.stack(drafts[:K], dim=1)
    logits = verify(torch.cat([tok[:, None], drafts], dim=1))
    g = torch.argmax(logits.float(), dim=-1)
    a = torch.cumprod((g[:, :K] == drafts).long(), dim=1).sum(dim=1)
    take = torch.where(active, torch.minimum(a + 1, budget),
                       torch.zeros_like(a))
    ended = torch.zeros_like(active)
    if eos_id is not None:
        jj = torch.arange(K + 1, device=g.device)[None, :]
        iseos = (g == eos_id) & (jj < take[:, None])
        ended = iseos.any(dim=1)
        take = torch.where(ended, torch.minimum(
            take, torch.argmax(iseos.int(), dim=1) + 1), take)
    # the bonus: the round's own target token committed
    bonus = (take > 0) & (take > a)
    nidx = torch.arange(g.shape[0], device=g.device)
    tok = torch.where(active, g[nidx, torch.clamp(take - 1, 0, K)], tok)
    counts = torch.stack([K * active.sum(), (take - bonus.long()).sum(),
                          bonus.sum()])
    jj = torch.arange(K + 1, device=g.device)[None, :]
    nf = ((~torch.isfinite(logits))
          & (jj < take[:, None])[..., None]).sum()
    return g, take, tok, counts, ended, nf


def build_spec_decode(m, draft, B, S0, max_new, spec_k, dtype=None,
                      moe_capacity_factor=None, kv_dtype=None,
                      use_kernel=None):
    """Draft-model speculative GREEDY decode fn: (target params, draft
    params, prompt) -> ids (B, S0 + max_new); the call's counts
    (drafted, accepted, bonus, rounds) are left in `decode.stats`.

    Each round (`_spec_round`) the draft proposes `spec_k` tokens one
    step at a time against its own fp cache, the target verifies all of
    them in one `verify_step` (spec_k + 1 tokens, the causal ladder), and
    the longest accepted prefix plus the target's own next token commit.
    Every committed token is the target's argmax given the committed
    prefix, so the tokens equal greedy `build_decode`'s. The JAX package
    runs the rounds as one `lax.while_loop`; here a Python loop does,
    with the per-row state on the device and one host read a round (is
    any row still active). `use_kernel` goes to every attention op, as
    in `_DecodeCore`. Spans: `serving.decode` (the watchdog's `decode`
    deadline over it, the fault point "serving.decode" first),
    `serving.prefill` (both prefills and the first token; OOM key
    "serving.spec_prefill"), `serving.spec_verify` (the rounds; OOM key
    "serving.spec_verify"); the caches noted as kv_cache as in
    `build_decode`; with observe
    enabled `record_spec`, `observe.record_decode` ("spec") and
    `health.record_nan_logits` (the prefill's logits and each round's
    committed ones, read with the counts) book the call, fenced, and
    with a tracker installed `slo.note_decode` feeds it."""
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    K = int(spec_k)
    core = _decode_core(m, S0, max_new, moe_capacity_factor, kv_dtype)
    core_d = _decode_core(draft, S0, max_new, moe_capacity_factor)

    def prefill_stage(pt, pd, prompt):
        logits0, caches = core.prefill(pt, prompt, B, use_kernel)
        # the draft only fills its own cache over the prompt: the first
        # token is the target's
        _, dcaches = core_d.prefill(pd, prompt, B, use_kernel)
        return logits0, caches, dcaches

    def spec_stage(pt, pd, tok, caches, dcaches, nf):
        """The rounds: (tokens (B, max_new), nf, counts, rounds)."""
        dev = tok.device
        buf = torch.zeros((B, max_new), dtype=torch.long, device=dev)
        buf[:, 0] = tok
        cnt = torch.ones(B, dtype=torch.long, device=dev)
        rows = torch.arange(B, device=dev)[:, None].expand(B, K + 1)
        jj = torch.arange(K + 1, device=dev)[None, :]
        counts = torch.zeros(3, dtype=torch.long, device=dev)
        rounds = 0
        while max_new > 1:
            active = cnt < max_new
            if not bool(active.any()):
                break
            pos = S0 + cnt - 1          # the pending token's position

            def draft_step(t, j):
                return core_d.verify_step(pd, t[:, None], dcaches,
                                          pos + j, active, B, 1,
                                          use_kernel)[0][:, 0]

            def verify(feed):
                return core.verify_step(pt, feed, caches, pos, active,
                                        B, K + 1, use_kernel)[0]

            g, take, tok, c, _, n = _spec_round(
                draft_step, verify, tok, active, max_new - cnt, K)
            keep = jj < take[:, None]
            buf[rows[keep], (cnt[:, None] + jj)[keep]] = g[keep]
            cnt = cnt + take
            counts += c
            nf = nf + n
            rounds += 1
        return buf, nf, counts, rounds

    prefill_x = introspect.AotExecutor(
        prefill_stage, "serving.spec_prefill",
        names=("params", "draft_params", "prompt"))
    spec_x = introspect.AotExecutor(
        spec_stage, "serving.spec_verify",
        names=("params", "draft_params", "tok0", "caches", "draft_caches",
               "nf"))

    @torch.no_grad()
    def decode(pt, pd, prompt):
        with watchdog.guard("decode", batch=B), \
                observe.span("serving.decode", batch=B, new_tokens=max_new,
                             spec_k=K):
            resilience.fault_point("serving.decode", batch=B)
            return _spec(pt, pd, prompt)

    def _spec(pt, pd, prompt):
        obs = observe.is_enabled()
        timed = obs or slo.get_tracker() is not None
        dev = prompt.device
        t0 = time.perf_counter()
        ttft = None
        with observe.span("serving.prefill", batch=B, prompt_tokens=S0), \
                memory.on_oom("serving.spec_prefill"):
            logits0, caches, dcaches = prefill_x(pt, pd, prompt)
            tok = torch.argmax(logits0.float(), dim=-1)
            nf = _nonfinite(logits0)
            if timed:
                _fence(dev)
                ttft = time.perf_counter() - t0
        if memory.get_ledger() is not None and \
                not memory.region_has_provider(memory.REGION_KV_CACHE):
            memory.note_arrays(memory.REGION_KV_CACHE, (caches, dcaches))
        with observe.span("serving.spec_verify", batch=B,
                          new_tokens=max_new), \
                memory.on_oom("serving.spec_verify"):
            buf, nf, counts, rounds = spec_x(pt, pd, tok, caches, dcaches,
                                             nf)
        ids = torch.cat([prompt, buf], dim=1)
        # the call's one read of its counts, the non-finite logits with
        # them
        drafted, accepted, n_bonus, n_nf = torch.cat(
            [counts, nf.reshape(1)]).tolist()
        decode.stats = {"drafted": drafted, "accepted": accepted,
                        "bonus": n_bonus, "rounds": rounds}
        if timed:
            _fence(dev)
            total = time.perf_counter() - t0
            if obs:
                record_spec(drafted, accepted, n_bonus, rounds)
                observe.record_decode(
                    "spec", total, new_tokens=B * max_new, batch=B,
                    ttft=ttft, prompt_tokens=B * S0)
                health.record_nan_logits(n_nf, "spec")
            slo.note_decode("spec", total, B * max_new, ttft=ttft, batch=B)
        return ids

    decode.stats = None
    return decode


def _take_rows(buf, idx):
    """buf (B, K, L) rows picked per batch by idx (B, k) -> (B, k, L)."""
    return torch.gather(buf, 1, idx[..., None].expand(*idx.shape,
                                                      buf.shape[2]))


def _pool_merge(pool_tok, pool_norm, pool_raw, cand_tok, cand_norm,
                cand_raw, K):
    """Merge candidate finished hypotheses into the K-slot pool, keeping
    the K best by normalized score. Shapes: pool (B,K,L)/(B,K); cand
    (B,kk,L)/(B,kk). Candidates not actually finished carry NEG norm."""
    all_norm = torch.cat([pool_norm, cand_norm], dim=1)
    all_raw = torch.cat([pool_raw, cand_raw], dim=1)
    all_tok = torch.cat([pool_tok, cand_tok], dim=1)
    top_norm, pick = _top_k(all_norm, K)
    return (_take_rows(all_tok, pick), top_norm,
            torch.gather(all_raw, 1, pick))


def build_beam_decode(m, B, S0, max_new, num_beams, length_penalty,
                      eos_id, dtype=None, pad_id=None,
                      moe_capacity_factor=None, kv_dtype=None):
    """Beam-search decode fn: (params, prompt) -> (ids (B, S0 + max_new),
    the chosen hypothesis' joint log-prob (B,)). Prefill once, tile the
    caches across beams, then one token_step a step whose cache rows are
    reordered by the winning parent beams. With `eos_id`, finished
    hypotheses move to a length-normalized pool (the JAX package's
    semantics) and the tail after eos is `pad_id` (default eos_id).
    With observe enabled, or an `slo` tracker installed, the call runs
    inside the span `serving.beam_decode` under the watchdog's `decode`
    deadline, fenced: `observe.record_decode` ("beam") books it (observe
    enabled) and `slo.note_decode` feeds the tracker. An out-of-memory
    error writes the memory ledger's OOM bundle (key "serving.beam").
    With observe enabled the non-finite logits of the prefill
    and every step are counted into `run.nan_logits`, read by the
    caller with the tokens (`GPT.generate_beam`)."""
    V = m.vocab_size
    K = num_beams
    core = _decode_core(m, S0, max_new, moe_capacity_factor, kv_dtype)
    NEG = -1e9
    pad = 0 if eos_id is None else (pad_id if pad_id is not None
                                    else eos_id)

    def norm_len(score, length):
        return score / (torch.tensor(float(length)) ** length_penalty).to(
            score.device)

    @torch.no_grad()
    def decode(p, prompt, count_nf):
        dev = prompt.device
        logits0, caches = core.prefill(p, prompt, B)
        nf = _nonfinite(logits0) if count_nf else None
        # beam b*K+k from prompt b
        caches = _tree_map(lambda a: a.repeat_interleave(K, dim=0), caches)
        logp0 = torch.log_softmax(logits0.float(), dim=-1)      # (B, V)
        tokens = torch.full((B, K, max_new), pad, dtype=torch.long,
                            device=dev)
        pool_tok = tokens.clone()
        pool_norm = torch.full((B, K), NEG, device=dev)
        pool_raw = torch.full((B, K), NEG, device=dev)
        neg = torch.tensor(NEG, device=dev)
        if eos_id is None:
            scores, t0 = _top_k(logp0, K)
        else:
            # 2K candidates, so K alive beams survive when eos ranks high
            kk = min(2 * K, V)
            cs, ct = _top_k(logp0, kk)
            is_eos = ct == eos_id
            cand = torch.full((B, kk, max_new), pad, dtype=torch.long,
                              device=dev)
            cand[:, :, 0] = eos_id
            pool_tok, pool_norm, pool_raw = _pool_merge(
                pool_tok, pool_norm, pool_raw, cand,
                torch.where(is_eos, norm_len(cs, 1), neg), cs, K)
            scores, pick = _top_k(torch.where(is_eos, neg, cs), K)
            t0 = torch.gather(ct, 1, pick)
        tokens[:, :, 0] = t0
        for i in range(max_new - 1):
            logits, caches = core.token_step(p, tokens[:, :, i].reshape(
                B * K), caches, i, B * K)
            if count_nf:
                nf = nf + _nonfinite(logits)
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
            flat = (scores[..., None] + logp).reshape(B, K * V)
            cs, idx = _top_k(flat, min(2 * K, K * V))
            beam_idx = idx // V
            cand_hist = _take_rows(tokens, beam_idx)
            cand_hist[:, :, i + 1] = idx % V
            if eos_id is not None:
                is_eos = idx % V == eos_id
                pool_tok, pool_norm, pool_raw = _pool_merge(
                    pool_tok, pool_norm, pool_raw, cand_hist,
                    torch.where(is_eos, norm_len(cs, i + 2), neg), cs, K)
                cs = torch.where(is_eos, neg, cs)
            scores, pick = _top_k(cs, K)
            tokens = _take_rows(cand_hist, pick)
            src = (torch.arange(B, device=dev)[:, None] * K
                   + torch.gather(beam_idx, 1, pick)).reshape(B * K)
            caches = _tree_map(lambda a: a[src], caches)
        # the best of {pool, alive} by normalized score
        all_norm = torch.cat([pool_norm, norm_len(scores, max_new)], dim=1)
        all_raw = torch.cat([pool_raw, scores], dim=1)
        all_tok = torch.cat([pool_tok, tokens], dim=1)
        best = torch.argmax(all_norm, dim=1)
        nb = torch.arange(B, device=dev)
        run.nan_logits = nf
        return (torch.cat([prompt, all_tok[nb, best]], dim=1),
                all_raw[nb, best])

    beam_x = introspect.AotExecutor(decode, "serving.beam",
                                    names=("params", "prompt", "count_nf"))

    def run(p, prompt):
        obs = observe.is_enabled()
        if not obs and slo.get_tracker() is None:
            with memory.on_oom("serving.beam"):
                return beam_x(p, prompt, False)
        t0 = time.perf_counter()
        with watchdog.guard("decode", batch=B), \
                observe.span("serving.beam_decode", batch=B, beams=K), \
                memory.on_oom("serving.beam"):
            out = beam_x(p, prompt, obs)
            _fence(prompt.device)
        # one call: no prefill seam is timed, so no TTFT sample
        total = time.perf_counter() - t0
        if obs:
            observe.record_decode("beam", total, new_tokens=B * max_new,
                                  batch=B, prompt_tokens=B * S0)
        slo.note_decode("beam", total, B * max_new, batch=B)
        return out

    run.kind = "beam"
    run.nan_logits = None
    return run


def poisson_workload(seed, n_req, rps, vocab, prompt_lens, new_lens,
                     new_dist="bimodal"):
    """The seeded Poisson serving workload (the JAX package's, draw for
    draw): exponential inter-arrival times at `rps`, uniform prompt
    lengths in `prompt_lens = (lo, hi)`, output lengths in `new_lens =
    (lo, hi)`, bimodal by default (75% short, 25% long). Fully determined
    by `seed`. Returns {"arrivals": float array of cumulative offsets
    (s), "prompts": list of int32 prompt arrays, "new_lens": int
    array}."""
    p_lo, p_hi = (int(x) for x in prompt_lens)
    n_lo, n_hi = (int(x) for x in new_lens)
    n_req = int(n_req)
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / float(rps), n_req))
    prompts = [rng.randint(0, int(vocab),
                           (rng.randint(p_lo, p_hi + 1),)).astype(np.int32)
               for _ in range(n_req)]
    if new_dist == "bimodal":
        short_hi = max(n_lo + 1, n_lo + (n_hi - n_lo) // 4)
        long_lo = max(short_hi, n_hi - (n_hi - n_lo) // 8)
        is_long = rng.rand(n_req) < 0.25
        lens = np.where(is_long,
                        rng.randint(long_lo, n_hi + 1, n_req),
                        rng.randint(n_lo, short_hi + 1, n_req))
    else:
        lens = rng.randint(n_lo, n_hi + 1, n_req)
    return {"arrivals": arrivals, "prompts": prompts, "new_lens": lens}


__all__ = ["DTYPES", "KV_DTYPES", "SPEC_VERDICTS", "build_beam_decode",
           "build_decode", "build_spec_decode", "decode_params",
           "decode_raw", "decode_state", "kv_label", "poisson_workload",
           "record_spec", "tree_leaves"]
