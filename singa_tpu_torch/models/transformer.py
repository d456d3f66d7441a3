"""GPT-style decoder-only LM (counterpart of
singa_tpu/models/transformer.py): a `model.Model` with the full-sequence
forward, `train_one_batch` (softmax cross-entropy over the flattened
logits, plus the MoE router losses, then the optimizer), `generate`
(greedy, temperature/top-k and draft-model speculative; fp32, bf16 or
int8 weights; fp, int8 or int4 KV caches), `generate_beam`, the weight
bridge from the JAX package (`load_singa_params`, `load_singa_states`;
`Model.load_states` reads the same zips) and from GPT-2-convention state
dicts (`load_gpt2_weights`).

`moe_experts` > 0 makes every block's MLP a top-`moe_k` mixture of
experts (MoE-GPT), expert-parallel over `ep_axis`. `tp_axis` makes every
block tensor-parallel and `vocab_tp` the embedding vocab-parallel with
the head tied to it (`_VocabTPMixin`); `seq_axis` makes every block's
attention a ring over that axis (sequence parallelism). Pipeline
parallelism comes with ROADMAP.md Queue 1 item 5c.
"""

from __future__ import annotations

import io
import zipfile
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from .. import autograd
from .. import device as device_mod
from .. import health, layer, model, serving
from ..tensor import Tensor, _raw


class _PosSlice(autograd.Operator):
    """`length` rows of the position table from this rank's global
    sequence offset: axis_index * length while `seq_axis` is bound (the
    rank's shard of a sequence-sharded batch), else 0."""

    def __init__(self, length, seq_axis=None):
        super().__init__("PosSlice")
        self.length = length
        self.seq_axis = seq_axis

    def forward(self, table):
        off = autograd._seq_offset(self.seq_axis, self.length)
        return table[off:off + self.length]


class _VocabTPMixin:
    """Megatron's vocab-parallel head: one (V_pad, E) table row-sharded
    over tp_axis serves as the embedding and, transposed, as the tied
    head; the loss consumes the sharded logits."""

    def _vp_active(self):
        return self.vocab_tp and autograd.axis_bound(self.tp_axis)

    def _tied_logits(self, h):
        """Logits through the embedding-tied head, h @ W_emb^T, fp32.
        While the axis is bound the table is this rank's vocab shard, so
        each rank makes its (B, S, V/tp) slice (Megatron's `f` on h)."""
        if self._vp_active():
            h = autograd.tp_copy(h, self.tp_axis)
        hc, Wc = autograd.compute_cast(h, self.tok_embed.W)
        return autograd.matmul(hc, autograd.transpose(Wc),
                               out_dtype="float32")

    def _slice_valid(self, logits):
        if self.padded_vocab == self.vocab_size:
            return logits
        return autograd.slice(logits, [0], [self.vocab_size],
                              [len(logits.shape) - 1])

    def _vp_loss_and_logits(self, local, targets):
        """(loss, caller-facing logits) from the tied head's logits: the
        vocab-parallel loss over the shards and the gathered logits (or
        the argmax predictions) while the axis is bound, else the plain
        loss over the valid columns."""
        tflat = autograd.reshape(targets, (-1,))
        if self._vp_active():
            flat = autograd.reshape(local, (-1, local.shape[-1]))
            loss = autograd.vocab_parallel_sce(
                flat, tflat, self.tp_axis, valid_vocab=self.vocab_size)
            if self.vocab_tp_return_logits:
                logits = self._slice_valid(
                    autograd.gather_last(local, self.tp_axis))
            else:
                logits = autograd.vocab_parallel_argmax(
                    local, self.tp_axis, valid_vocab=self.vocab_size)
        else:
            logits = self._slice_valid(local)
            flat = autograd.reshape(logits, (-1, self.vocab_size))
            loss = self.sce(flat, tflat)
        return loss, logits


class GPT(_VocabTPMixin, model.Model):
    """Decoder-only transformer: token embedding (+ learned positions,
    or RoPE in every block), pre-LN blocks, final LayerNorm, an untied
    fp32-output head.

    `device=None` resolves to CUDA and raises when there is none; pass
    `device="cpu"` to run the plain PyTorch versions of the kernels.
    Weights are drawn from `seed` with the JAX initializers' formulas.
    Training goes through the Model API: `set_optimizer`,
    `compile([ids], is_train=True, amp=...)`, then `logits, loss =
    m(ids, targets)`.

    `moe_experts` > 0 swaps every block's MLP for a top-`moe_k` MoE FFN
    (layer.MoE) with capacity factor `moe_capacity_factor`; the training
    loss adds each block's load-balance loss times `moe_aux_weight` and
    its router z-loss times `moe_z_weight`. `ep_axis` makes the experts
    expert-parallel over that mesh axis (layer.MoE): train such a model
    under `DistOpt(axis=("data", ep_axis))`. The positional order is the
    JAX GPT's, and `device` and `seed` come last.

    Tensor parallelism: `tp_axis` shards every block's heads and MLP over
    that mesh axis (layer.TransformerBlock). `vocab_tp=True` (which needs
    `tp_axis`) pads the vocab to a multiple of `vocab_pad_multiple`
    (`padded_vocab`), row-shards one (V_pad, E) table over the axis and
    ties the head to it (`head` is None); the padded columns are masked
    out of the loss and cut from the logits. Training on a mesh with the
    axis, each rank holds its shards and the loss never gathers the
    full logits; `train_one_batch` returns the gathered (B, S, V) logits,
    or with `vocab_tp_return_logits=False` the (B, S) int32 argmax
    predictions. Off the mesh the same model runs the serial math on the
    full weights.

    Sequence parallelism: with `seq_axis`, while that mesh axis is bound
    the ids are this rank's block of the sequence, every block's
    attention is a ring over the axis and the positions (the learned
    table's rows, or RoPE's) start at the block's global offset.
    Unbound, the same model runs the serial forward. The parameters do
    not change with it."""

    def __init__(self, vocab_size, max_seq=1024, dim=256, num_heads=8,
                 num_layers=4, mlp_ratio=4, seq_axis=None, tp_axis=None,
                 attn_bias=False, vocab_tp=False, vocab_pad_multiple=128,
                 vocab_tp_return_logits=True, moe_experts=0, moe_k=2,
                 ep_axis=None, moe_capacity_factor=1.25,
                 moe_aux_weight=0.01, moe_z_weight=1e-3, num_kv_heads=None,
                 pos_encoding="learned", rope_theta=10000.0, name=None,
                 device=None, seed=0):
        super().__init__(name)
        if vocab_tp and tp_axis is None:
            raise ValueError(
                "vocab_tp=True needs tp_axis: vocab parallelism shards the "
                "embedding/head over a tensor-parallel mesh axis. Without "
                "one the model would silently build a different parameter "
                "set (untied head, unpadded vocab)")
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"pos_encoding {pos_encoding!r}")
        dev = device_mod.resolve(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.vocab_size = vocab_size
        self.max_seq = max_seq
        self.dim = dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.pos_encoding = pos_encoding
        self.rope_theta = float(rope_theta)
        self.moe_experts = moe_experts
        self.moe_aux_weight = moe_aux_weight
        self.moe_z_weight = moe_z_weight
        self.seq_axis = seq_axis
        self.tp_axis = tp_axis
        self.vocab_tp = bool(vocab_tp)
        self.vocab_tp_return_logits = vocab_tp_return_logits
        if self.vocab_tp:
            m = vocab_pad_multiple
            self.padded_vocab = ((vocab_size + m - 1) // m) * m
            self.tok_embed = layer.Embedding(self.padded_vocab, dim,
                                             tp_axis=tp_axis, generator=gen)
            self.head = None           # tied to tok_embed.W
        else:
            self.padded_vocab = vocab_size
            self.tok_embed = layer.Embedding(vocab_size, dim, generator=gen)
            self.head = layer.Linear(dim, vocab_size, bias=False,
                                     out_dtype="float32", generator=gen)
        self.blocks = nn.ModuleList(
            layer.TransformerBlock(
                num_heads, mlp_ratio, causal=True, seq_axis=seq_axis,
                tp_axis=tp_axis, attn_bias=attn_bias,
                num_kv_heads=num_kv_heads,
                rope=pos_encoding == "rope", rope_theta=rope_theta,
                moe_experts=moe_experts, moe_k=moe_k, ep_axis=ep_axis,
                moe_capacity_factor=moe_capacity_factor, dim=dim,
                generator=gen)
            for _ in range(num_layers))
        self.ln_f = layer.LayerNorm(dim=dim)
        self.sce = layer.SoftMaxCrossEntropy()
        if pos_encoding == "learned":
            self.pos_embed = nn.Parameter(
                torch.randn((max_seq, dim), generator=gen) * 0.02)
        self.to(dev)
        nn.Module.train(self, False)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.W.device

    def forward(self, ids):
        """(B, S) token ids (a tensor, a Tensor or an array) -> (B, S, V)
        fp32 logits. Under the bf16 policy the embedding rows are bf16
        and adding the fp32 position table makes the residual stream
        fp32, as in the JAX package.

        A `tensor.Tensor` of ids in training mode (`autograd.training`)
        runs on the tape, as the JAX GPT does, and returns a Tensor with
        creators (what `sonnx.export` traces); anything else runs the
        same operators on raw tensors and records nothing. The position
        rows go through `_PosSlice` and Expand on both paths (on raw
        tensors the same values as the broadcast add). Under vocab_tp on
        a bound axis the logits are gathered from the shards."""
        h = self._backbone(ids)
        if not self.vocab_tp:
            return self.head(h)
        local = self._tied_logits(h)
        if self._vp_active():
            local = autograd.gather_last(local, self.tp_axis)
        return self._slice_valid(local)

    def _backbone(self, ids):
        """(B, S) ids -> (B, S, E) hidden states after the final norm."""
        on_tape = isinstance(ids, Tensor) and autograd.training
        if not on_tape:
            ids = torch.as_tensor(_raw(ids), device=self.device).long()
        h = self.tok_embed(ids)
        if self.pos_encoding == "learned":
            table = Tensor._wrap(self.pos_embed, h.device, True) \
                if on_tape else self.pos_embed
            pos = _PosSlice(ids.shape[1], self.seq_axis)(table)
            h = autograd.add(h, autograd.expand(pos, h.shape))
        for b in self.blocks:
            h = b(h)
        return self.ln_f(h)

    def _moe_losses(self, loss):
        """Fold every block's router losses into the training loss, in
        the JAX package's order."""
        if not self.moe_experts:
            return loss
        for b in self.blocks:
            loss = loss + b.moe.aux_loss * self.moe_aux_weight
            loss = loss + b.moe.z_loss * self.moe_z_weight
        return loss

    def train_one_batch(self, ids, targets):
        """One training step: forward, the mean cross-entropy over every
        position (plus the MoE router losses), backward and the
        optimizer's update. Returns (logits (B, S, V) fp32, loss),
        detached from the spent graph. Tensor ids train on the raw path
        too (the tape would give torch's same gradients). Under vocab_tp
        the loss consumes the sharded logits and the gathered logits (or
        the argmax predictions) exist only on the output."""
        tflat = torch.as_tensor(_raw(targets),
                                device=self.device).reshape(-1).long()
        if not self.vocab_tp:
            logits = nn.Module.__call__(self, _raw(ids))
            flat = logits.reshape(-1, self.vocab_size)
            loss = self.sce(flat, tflat)
        else:
            h = self._backbone(_raw(ids))
            loss, logits = self._vp_loss_and_logits(self._tied_logits(h),
                                                    tflat)
        loss = self._moe_losses(loss)
        self.optimizer(loss)
        for b in self.blocks:
            if b.moe_experts:
                # the router's values stay readable, without the spent
                # autograd graph (a live one would carry its
                # AccumulateGrad nodes into a CUDA-graph capture)
                m = b.moe
                m.aux_loss, m.z_loss, m.overflow = (
                    v.detach() for v in (m.aux_loss, m.z_loss, m.overflow))
        return logits.detach(), loss.detach()

    def _raw_params(self):
        """{JAX name: parameter} in the JAX GPT's order: its blocks are
        `TransformerBlock_<i>` and it registers the position table on
        itself, first; the optimizer's checkpoint keys follow this
        order (`get_params()` returns Tensor views in the same order)."""
        own = {_singa_name(n): p for n, p in self.named_parameters()}
        return OrderedDict(sorted(own.items(),
                                  key=lambda kv: kv[0] != "pos_embed"))

    def _prompt(self, prompt):
        ids = prompt.cpu().numpy() if isinstance(prompt, torch.Tensor) \
            else np.asarray(prompt)
        if ids.ndim != 2:
            raise ValueError("prompt must be (batch, length)")
        return ids

    def _ids(self, ids):
        return torch.as_tensor(ids.astype(np.int64), device=self.device)

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens, temperature=0.0, top_k=None,
                 seed=0, dtype=None, moe_capacity_factor=None,
                 kv_dtype=None, draft_model=None, spec_k=0):
        """Autoregressive sampling: greedy (temperature=0) or
        temperature/top-k. `prompt` is (B, S0) int (numpy or tensor);
        returns (B, S0 + max_new_tokens) numpy int32.
        `dtype="bfloat16"` decodes in bf16, `dtype="int8"` with int8
        weights (W8A16); `kv_dtype` ("int8" or packed-nibble "int4")
        quantizes the KV cache. `draft_model` with `spec_k` >= 1 switches
        greedy decoding to draft-model speculative decoding
        (serving.build_spec_decode): the same tokens as plain greedy, and
        the call's counts in `self.spec_stats`. `moe_capacity_factor`
        overrides the MoE layers' factor for the decode (the target's and
        the draft's): routing capacity is batch-global, so cached
        decoding equals the full forward only where nothing drops
        (`float(moe_experts)` drops nothing)."""
        ids = self._prompt(prompt)
        if max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        serving.kv_label(kv_dtype)
        if spec_k and draft_model is None:
            raise ValueError("spec_k needs a draft_model")
        if max_new_tokens == 0:
            return ids.astype(np.int32).copy()
        if ids.shape[1] < 1:
            raise ValueError("prompt must contain at least one token")
        if temperature == 0.0:
            top_k = None  # greedy ignores top_k
        elif top_k is not None:
            top_k = max(1, min(int(top_k), self.vocab_size))
        B, S0 = ids.shape
        cache = self.__dict__.setdefault("_decode_cache", {})
        if draft_model is not None and spec_k:
            if temperature != 0.0:
                raise ValueError("speculative decoding is greedy-only "
                                 "(temperature=0)")
            if draft_model.vocab_size < self.vocab_size:
                raise ValueError("draft vocab must cover the target's")
            if draft_model.device != self.device:
                raise ValueError(f"draft on {draft_model.device}, target "
                                 f"on {self.device}")
            # the builder holds the draft's decode core: key on what
            # shapes it, not on the draft object
            sig = ("spec", B, S0, max_new_tokens, int(spec_k), dtype,
                   moe_capacity_factor, kv_dtype, draft_model.num_heads,
                   draft_model.dim,
                   draft_model.num_kv_heads, draft_model.pos_encoding,
                   draft_model.rope_theta, draft_model.max_seq,
                   _moe_sig(draft_model))
            fn = cache.get(sig)
            if fn is None:
                fn = cache[sig] = serving.build_spec_decode(
                    self, draft_model, B, S0, max_new_tokens, int(spec_k),
                    dtype, moe_capacity_factor, kv_dtype)
            out = fn(serving.decode_state(self, dtype),
                     serving.decode_state(draft_model, dtype),
                     self._ids(ids))
            self.spec_stats = dict(fn.stats)
            return out.cpu().numpy().astype(np.int32)
        sig = (B, S0, max_new_tokens, float(temperature), top_k, dtype,
               moe_capacity_factor, kv_dtype)
        fn = cache.get(sig)
        if fn is None:
            fn = cache[sig] = serving.build_decode(
                self, B, S0, max_new_tokens, float(temperature), top_k,
                dtype, moe_capacity_factor, kv_dtype)
        out = fn(serving.decode_state(self, dtype), self._ids(ids), seed)
        return _host_ids(out, fn.nan_logits, fn.kind)

    @torch.no_grad()
    def generate_beam(self, prompt, max_new_tokens, num_beams=4,
                      length_penalty=1.0, eos_id=None, pad_id=None,
                      dtype=None, return_scores=False,
                      moe_capacity_factor=None, kv_dtype=None):
        """Beam-search decoding (serving.build_beam_decode): prefill
        once, tile the KV cache across beams, reorder its rows by the
        winning parent beams each step. With `eos_id`, finished
        hypotheses move to a length-normalized pool and the tail after
        eos is `pad_id` (default eos_id). Returns (B, S0 +
        max_new_tokens) numpy int32 ids (and the chosen hypothesis'
        joint log-prob, (B,) fp32, when `return_scores`).
        `moe_capacity_factor` as in `generate`."""
        ids = self._prompt(prompt)
        if ids.shape[1] < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1 or num_beams < 1:
            raise ValueError("max_new_tokens and num_beams must be >= 1")
        if num_beams > self.vocab_size:
            raise ValueError(f"num_beams {num_beams} exceeds vocab_size "
                             f"{self.vocab_size}")
        serving.kv_label(kv_dtype)
        B, S0 = ids.shape
        sig = ("beam", B, S0, max_new_tokens, num_beams,
               float(length_penalty), eos_id, pad_id, dtype,
               moe_capacity_factor, kv_dtype)
        cache = self.__dict__.setdefault("_decode_cache", {})
        fn = cache.get(sig)
        if fn is None:
            fn = cache[sig] = serving.build_beam_decode(
                self, B, S0, max_new_tokens, num_beams,
                float(length_penalty), eos_id, dtype, pad_id,
                moe_capacity_factor, kv_dtype)
        out, scores = fn(serving.decode_state(self, dtype), self._ids(ids))
        out = _host_ids(out, fn.nan_logits, fn.kind)
        if return_scores:
            return out, scores.cpu().numpy()
        return out


def _host_ids(ids, nan_logits, kind):
    """A decode call's ids as numpy int32, read in one copy together with
    its count of non-finite logits (when the call counted them), which
    `health.record_nan_logits` books under `kind`."""
    if nan_logits is None:
        return ids.cpu().numpy().astype(np.int32)
    flat = torch.cat([ids.reshape(-1).long(),
                      nan_logits.reshape(1)]).cpu().numpy()
    health.record_nan_logits(int(flat[-1]), kind)
    return flat[:-1].reshape(tuple(ids.shape)).astype(np.int32)


def _moe_sig(m):
    """What of a model's MoE shapes its decode: per block (k, capacity
    factor), or None for a dense block."""
    return tuple((b.moe.k, b.moe.capacity_factor) if b.moe_experts
                 else None for b in m.blocks)


def _singa_name(name: str) -> str:
    """This module's param name -> the JAX GPT's (inverse of
    _port_name)."""
    if name.startswith("blocks."):
        _, i, rest = name.split(".", 2)
        return f"TransformerBlock_{i}.{rest}"
    return name


def _port_name(name: str) -> str:
    """JAX param name -> this module's: blocks are registered as
    `TransformerBlock_<i>` there and live in `blocks.<i>` here."""
    if name.startswith("TransformerBlock_"):
        head, _, rest = name.partition(".")
        return f"blocks.{head[len('TransformerBlock_'):]}.{rest}"
    return name


@torch.no_grad()
def load_singa_params(model: GPT, params: dict) -> None:
    """Copy a JAX GPT's parameters into `model`, in place. `params` maps
    the JAX model's `get_params()` names to numpy arrays
    (`{k: tensor.to_numpy(v) for k, v in m.get_params().items()}`).
    Shapes stay in the JAX layout ((in, out) weights), so no transpose.
    The arrays are global: a model that holds tensor-parallel shards
    keeps this rank's block of each. Every parameter of `model` must be
    given; an unknown name or a shape mismatch raises."""
    own = dict(model.named_parameters())
    seen = set()
    for k, v in params.items():
        name = _port_name(k)
        if name not in own:
            raise KeyError(f"unknown param {k!r} (as {name!r}); have "
                           f"{sorted(own)}")
        t = own[name]
        arr = model._to_local(t, torch.from_numpy(np.array(v)))
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{k}: shape {tuple(arr.shape)}, model has "
                             f"{tuple(t.shape)}")
        t.copy_(arr.to(t.dtype))
        seen.add(name)
    missing = sorted(set(own) - seen)
    if missing:
        raise KeyError(f"params missing from the checkpoint: {missing}")


def load_singa_states(model: GPT, path: str) -> None:
    """Load a JAX `Model.save_states` zip (tensor_dict.npz inside a zip)
    into `model` with load_singa_params; `aux.*` entries are skipped."""
    with zipfile.ZipFile(path) as zf:
        raw = zf.read("tensor_dict.npz")
    with np.load(io.BytesIO(raw)) as npz:
        params = {k: npz[k] for k in npz.files if not k.startswith("aux.")}
    load_singa_params(model, params)


@torch.no_grad()
def load_gpt2_weights(m: GPT, state: dict) -> GPT:
    """Load GPT-2-convention weights into `m` for serving, in place.

    `state` maps torch-style GPT-2 names to numpy arrays (e.g.
    `{k: v.numpy() for k, v in torch_model.state_dict().items()}`):
    `wte.weight`, `wpe.weight`, `blocks.{i}.{ln1,ln2}.{weight,bias}`,
    `blocks.{i}.attn.{weight,bias}` (fused qkv, (3E, E) and (3E,)),
    `blocks.{i}.proj.{weight,bias}`, `blocks.{i}.{ff1,ff2}.{weight,bias}`,
    `ln_f.{weight,bias}`. Torch's Linear stores (out, in), so weights are
    transposed into the (in, out) layout; the fused attention weight is
    split into Wq, Wk and Wv, and the head gets wte's transpose (tied).
    The model must have learned positions, no more than the checkpoint's
    (`max_seq` <= wpe rows), and `attn_bias=True`; a shape mismatch
    raises, as in the JAX package."""
    E = m.dim
    if m.head is None:
        raise ValueError("GPT-2 weights fill an untied head; build the GPT "
                         "without vocab_tp")

    def put(t, arr):
        arr = np.asarray(arr, np.float32)
        if tuple(t.shape) != arr.shape:
            raise ValueError(f"shape mismatch: param {tuple(t.shape)} vs "
                             f"weight {arr.shape}")
        t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))

    wte = np.asarray(state["wte.weight"], np.float32)
    put(m.tok_embed.W, wte)
    n_wpe = state["wpe.weight"].shape[0]
    if m.max_seq > n_wpe:
        raise ValueError(
            f"model max_seq={m.max_seq} exceeds the checkpoint's {n_wpe} "
            f"position embeddings; build the GPT with max_seq<={n_wpe}")
    if m.pos_encoding != "learned":
        raise ValueError("GPT-2 weights need learned positions")
    put(m.pos_embed, np.asarray(state["wpe.weight"])[:m.max_seq])
    put(m.head.W, wte.T)
    put(m.ln_f.gamma, state["ln_f.weight"])
    put(m.ln_f.beta, state["ln_f.bias"])
    for i, blk in enumerate(m.blocks):
        if not blk.attn.use_bias:
            raise ValueError("build the GPT with attn_bias=True for GPT-2 "
                             "weights")
        if blk.moe_experts:
            raise ValueError("GPT-2 weights fill a dense MLP, not an MoE")
        pre = f"blocks.{i}."
        put(blk.ln1.gamma, state[pre + "ln1.weight"])
        put(blk.ln1.beta, state[pre + "ln1.bias"])
        put(blk.ln2.gamma, state[pre + "ln2.weight"])
        put(blk.ln2.beta, state[pre + "ln2.bias"])
        qkv_w = np.asarray(state[pre + "attn.weight"], np.float32)
        qkv_b = np.asarray(state[pre + "attn.bias"], np.float32)
        if qkv_w.shape != (3 * E, E):
            raise ValueError(f"shape mismatch: attn.weight {qkv_w.shape}, "
                             f"want {(3 * E, E)}")
        a = blk.attn
        for j, (W, b) in enumerate(((a.Wq, a.bq), (a.Wk, a.bk),
                                    (a.Wv, a.bv))):
            put(W, qkv_w[j * E:(j + 1) * E].T)
            put(b, qkv_b[j * E:(j + 1) * E])
        put(a.Wo, np.asarray(state[pre + "proj.weight"]).T)
        put(a.bo, state[pre + "proj.bias"])
        put(blk.fc1.W, np.asarray(state[pre + "ff1.weight"]).T)
        put(blk.fc1.b, state[pre + "ff1.bias"])
        put(blk.fc2.W, np.asarray(state[pre + "ff2.weight"]).T)
        put(blk.fc2.b, state[pre + "ff2.bias"])
    return m


def create_model(vocab_size=256, **kwargs):
    return GPT(vocab_size, **kwargs)


__all__ = ["GPT", "create_model", "load_gpt2_weights", "load_singa_params",
           "load_singa_states"]
