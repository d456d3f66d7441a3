"""KV-cached autoregressive decoding for the GPT (counterpart of
singa_tpu/serving.py): the decode core (prefill + single-token cached
step, dense and paged), the decode-param tree and its memo, and the
greedy/sampled decode loop behind `GPT.generate`.

Layouts are the JAX package's:

- HEAD-PACKED KV caches, (B, Hkv/P, T, P*D) with P = 128 // D when it
  divides the kv heads (else 1): P heads share one P*D-lane row, and the
  scores stay exactly per head through BLOCK-DIAGONAL queries
  (`_pack_q`/`_unpack_o`).
- Wq/Wk/Wv fuse into one (E, E + 2*Hkv*D) matmul at decode-param prep.

Where the JAX package runs prefill + `lax.scan` as compiled programs, the
port runs eagerly: `build_decode` is a Python loop over `token_step`.
Caches and page pools are written IN PLACE (JAX returns updated copies):
one cache lives per call instead of two. Attention goes through the
kernels of ops.attention on CUDA tensors and their plain versions on CPU
tensors; `use_kernel=False` selects the plain versions on the card for
comparisons.
"""

from __future__ import annotations

import weakref

import torch

from . import autograd
from .layer import layernorm
from .ops.attention import flash_attention, flash_decode, paged_attention

#: serving dtypes of the decode-param tree (int8 weights come later)
DTYPES = (None, "bfloat16")


def _cast_params(p, dtype):
    """Decode-param tree in the serving dtype: None = as stored (fp32),
    "bfloat16" = bf16 weights and activations."""
    if dtype is None:
        return p
    if dtype != "bfloat16":
        raise ValueError(f"serving dtype {dtype!r} not in {DTYPES}")

    def cast(a):
        return a.to(torch.bfloat16) if a.is_floating_point() else a

    out = {k: cast(v) for k, v in p.items() if k != "blocks"}
    out["blocks"] = [{k: cast(v) for k, v in bp.items()}
                     for bp in p["blocks"]]
    return out


class _DecodeCore:
    """The decode math shared by GPT.generate and the serving engine: the
    fp32-island LayerNorm, the causal prefill (which also yields the
    K/V rows), and the single-token block step against a dense or a paged
    cache."""

    def __init__(self, H, E, S0, T, scale, kv_heads=None, rope=False,
                 rope_theta=10000.0):
        self.H, self.E, self.S0, self.T, self.scale = H, E, S0, T, scale
        self.rope = bool(rope)
        self.rope_theta = float(rope_theta)
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

    def mlp(self, bp, x):
        return autograd.gelu(x @ bp["W1"] + bp["bb1"]) @ bp["W2"] + bp["bb2"]

    def qkv(self, bp, x, n, S=None):
        """Fused QKV projection: one (E, E + 2*Hkv*D) matmul, split into
        q (n,[S,]H,D) and k/v (n,[S,]Hkv,D) — with S, heads come first:
        (n, H, S, D)."""
        H, D, E, Hkv = self.H, self.E // self.H, self.E, self.Hkv
        KE = Hkv * D
        fused = x @ bp["Wqkv"] + bp["bqkv"]
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
        for bp in p["blocks"]:
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
            h = h + o.transpose(1, 2).reshape(n, S, self.E) @ bp["Wo"] \
                + bp["bo"]
            x = self.ln(h, bp["g2"], bp["b2"])
            h = h + self.mlp(bp, x)
            kvs.append((k, v))
        return h, kvs

    def prefill(self, p, prompt, n, use_kernel=None):
        """Causal pass over the (n, S0) prompt: the last position's logits
        (n, V) and per block head-packed KV caches (n, Hp, T, P*D) holding
        the prompt's rows."""
        S0, T, P, D = self.S0, self.T, self.P, self.E // self.H
        h, kvs = self.prefill_parts(p, prompt, n, use_kernel)
        caches = []
        for k, v in kvs:
            shape = (n, self.Hkv // P, T, P * D)
            Kc = k.new_zeros(shape)
            Vc = v.new_zeros(shape)
            Kc[:, :, :S0] = self._pack(k, n, S0)
            Vc[:, :, :S0] = self._pack(v, n, S0)
            caches.append((Kc, Vc))
        logits0 = self.ln(h[:, -1], p["gf"], p["bf"]) @ p["head"]
        return logits0, caches

    def _rope_at(self, pos):
        """(cos, sin) of shape (len(pos), D) for a position vector."""
        return autograd.rope_tables(pos, self.E // self.H, self.rope_theta)

    def token_step(self, p, tok, caches, i, n, use_kernel=None):
        """Feed token `tok` (n,) at generated index `i` (position S0+i)
        through all blocks, writing each block's new K/V row into the
        caches in place; returns (logits (n, V), caches). Attention runs
        through the flash-decode kernel (use_kernel=None: by the tensors'
        device; False: the plain version)."""
        P, D = self.P, self.E // self.H
        Hp = self.Hkv // P
        pos_idx = self.S0 + int(i)
        h = p["emb"][tok]
        if not self.rope:
            h = h + p["pos"][pos_idx]
        else:
            rcos, rsin = self._rope_at(
                torch.tensor([pos_idx], device=tok.device))
            rcos, rsin = rcos[0], rsin[0]
        lens = torch.full((n,), pos_idx + 1, dtype=torch.int32,
                          device=tok.device)
        for (Kc, Vc), bp in zip(caches, p["blocks"]):
            x = self.ln(h, bp["g1"], bp["b1"])
            q, kn, vn = self.qkv(bp, x, n)
            if self.rope:
                q = autograd.apply_rope(q, rcos, rsin)
                kn = autograd.apply_rope(kn, rcos, rsin)
            Kc[:, :, pos_idx] = kn.reshape(n, Hp, P * D)
            Vc[:, :, pos_idx] = vn.reshape(n, Hp, P * D)
            O2 = flash_decode(self._pack_q(q, n), Kc, Vc, lens,
                              scale=self.scale, use_kernel=use_kernel)
            o = self._unpack_o(O2.to(x.dtype), n)
            h = h + o @ bp["Wo"] + bp["bo"]
            x = self.ln(h, bp["g2"], bp["b2"])
            h = h + self.mlp(bp, x)
        logits = self.ln(h, p["gf"], p["bf"]) @ p["head"]
        return logits, caches

    def paged_token_step(self, p, tok, pools, page_table, lens, active, n,
                         page_size, use_kernel=None):
        """One ragged decode step against the PAGED KV cache (the serving
        engine's step): feed `tok` (n,) for each slot at its own position
        `lens[i]`, write the new K/V row into the slot's current page
        (active slots only, in place: JAX drops the inactive slots'
        out-of-range scatter, torch would raise, so they are masked out),
        and attend over each slot's pages through the paged kernel.
        `pools` is a list per block of (K, V), each (n_pages, Hp,
        page_size, P*D). Returns (logits (n, V), pools)."""
        P, D, ps = self.P, self.E // self.H, page_size
        Hp = self.Hkv // P
        # clamp so an inactive slot's stale length never indexes outside
        # the table or the position table (its output is discarded)
        pos = torch.clamp(lens.long(), max=self.T - 1)
        h = p["emb"][tok]
        if not self.rope:
            h = h + p["pos"][pos]
        else:
            rcos, rsin = self._rope_at(pos)
            rcos, rsin = rcos[:, None, :], rsin[:, None, :]
        nidx = torch.arange(n, device=tok.device)
        rows = nidx[active]
        pvec = page_table.long()[rows, pos[rows] // ps]
        off = pos[rows] % ps
        ln_att = torch.where(active, pos + 1, 1).to(torch.int32)
        for bp, (K, V) in zip(p["blocks"], pools):
            x = self.ln(h, bp["g1"], bp["b1"])
            q, kn, vn = self.qkv(bp, x, n)
            if self.rope:
                q = autograd.apply_rope(q, rcos, rsin)
                kn = autograd.apply_rope(kn, rcos, rsin)
            K[pvec, :, off] = kn.reshape(n, Hp, P * D)[rows]
            V[pvec, :, off] = vn.reshape(n, Hp, P * D)[rows]
            O2 = paged_attention(self._pack_q(q, n), K, V, page_table,
                                 ln_att, ps, scale=self.scale,
                                 use_kernel=use_kernel)
            o = self._unpack_o(O2.to(x.dtype), n)
            h = h + o @ bp["Wo"] + bp["bo"]
            x = self.ln(h, bp["g2"], bp["b2"])
            h = h + self.mlp(bp, x)
        logits = self.ln(h, p["gf"], p["bf"]) @ p["head"]
        return logits, pools


def _decode_core(m, S0, max_new):
    """The _DecodeCore matching model `m`'s configuration."""
    T = S0 + max_new
    if T > m.max_seq:
        raise ValueError(f"prompt {S0} + new {max_new} exceeds max_seq "
                         f"{m.max_seq}")
    return _DecodeCore(m.num_heads, m.dim, S0, T,
                       (m.dim // m.num_heads) ** -0.5,
                       kv_heads=m.num_kv_heads,
                       rope=m.pos_encoding == "rope",
                       rope_theta=m.rope_theta)


# ---- decode-param preparation + memo ---------------------------------------

@torch.no_grad()
def decode_params(m):
    """The decode-param tree of model `m` (fp32, unused biases
    zero-filled, QKV fused)."""
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
            "W1": b.fc1.W, "bb1": b.fc1.b, "W2": b.fc2.W, "bb2": b.fc2.b,
        }
        blocks.append({k: v.detach() for k, v in bp.items()})
    emb = m.tok_embed.W.detach()
    return {
        "emb": emb,
        "pos": (emb.new_zeros((m.max_seq, 0)) if m.pos_encoding == "rope"
                else m.pos_embed.detach()),
        "gf": m.ln_f.gamma.detach(), "bf": m.ln_f.beta.detach(),
        "head": m.head.W.detach(), "blocks": blocks,
    }


def decode_state(m, dtype):
    """Memoized decode-param tree per serving dtype: the QKV fusion and
    the cast run once per weight set. The memo holds weak references to
    the parameters with their version counters and hits only while every
    parameter is the same tensor, unmodified in place
    (load_singa_params bumps the counters)."""
    params = list(m.parameters())
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


# ---- the decode loop --------------------------------------------------------

def build_decode(m, B, S0, max_new, temperature, top_k, dtype=None):
    """Greedy/sampled decode fn: (params, prompt (B, S0) on the model's
    device, seed) -> ids (B, S0 + max_new). Prefill plus the first token,
    then a Python loop of `token_step`s, one sampled token each.
    Sampling draws from a torch.Generator seeded with `seed` on the
    model's device."""
    core = _decode_core(m, S0, max_new)

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

    @torch.no_grad()
    def decode(p, prompt, seed=0):
        gen = torch.Generator(device=prompt.device)
        gen.manual_seed(int(seed))
        logits, caches = core.prefill(p, prompt, B)
        tok = sample(logits, gen)
        out = [tok]
        for i in range(max_new - 1):
            logits, caches = core.token_step(p, tok, caches, i, B)
            tok = sample(logits, gen)
            out.append(tok)
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)

    return decode


__all__ = ["DTYPES", "build_decode", "decode_params", "decode_state"]
