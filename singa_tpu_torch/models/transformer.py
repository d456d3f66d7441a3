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
attention a ring over that axis (sequence parallelism).

`PipelinedGPT` (`create_pipelined`, the zoo's "gpt_pipe") stacks the
blocks' parameters and runs them as one pipeline over a mesh axis
(`parallel.pipeline`: gpipe, interleaved, 1f1b), composed with tensor,
vocab and expert parallelism; `load_singa_params` takes a JAX
PipelinedGPT's weights too.
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
    """Copy a JAX GPT's or PipelinedGPT's parameters into `model`, in
    place. `params` maps the JAX model's `get_params()` names to numpy
    arrays (`{k: tensor.to_numpy(v) for k, v in m.get_params().items()}`).
    Shapes stay in the JAX layout ((in, out) weights), so no transpose.
    The arrays are global: a model that holds tensor- or
    pipeline-parallel shards keeps this rank's block of each. A
    PipelinedGPT's stacks (`Wq` ... `bb2`, `moeWg` ... `moeb2`) load from
    any pipeline degree's layout or the canonical (num_layers, ...) one
    (`PipelinedGPT.set_params`). Every parameter of `model` must be
    given; an unknown name or a shape mismatch raises."""
    own = dict(model.named_parameters())
    stacks = model._stack_attrs if isinstance(model, PipelinedGPT) else ()
    seen = set()
    for k, v in params.items():
        name = _port_name(k)
        if name not in own:
            raise KeyError(f"unknown param {k!r} (as {name!r}); have "
                           f"{sorted(own)}")
        t = own[name]
        arr = torch.from_numpy(np.array(v))
        if name in stacks:
            arr = model._from_canonical(name, arr)
        arr = model._to_local(t, arr)
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


# ---- the pipeline-parallel GPT ---------------------------------------------
# The block parameters are STACKED (layers, ...) tensors with the spec
# ("pp",): the model's first data-parallel build cuts each rank's
# contiguous rows of layers (`Model._shard`), and the whole schedule runs
# as one tape operator over the stage functions below
# (`parallel.pipeline`). The functional blocks compute in the dtypes they
# are given (the fp32 stacks, as the JAX package's functional blocks do);
# the bf16 policy casts only at the embedding and the head.

def _fn_layernorm(x, g, b, eps=1e-5):
    m = x.mean(dim=-1, keepdim=True)
    v = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + eps) * g + b


def _heads(x, B, S, n):
    """(B, S, n * D) -> (B, n, S, D), contiguous (the flash kernels'
    layout)."""
    return x.reshape(B, S, n, -1).permute(0, 2, 1, 3).contiguous()


def _fn_block(params, h, num_heads, tp_axis=None, num_kv_heads=None,
              rope=None):
    """Functional pre-LN transformer block; h (B, S, E), replicated over
    `tp_axis`. With tp, Wq/Wk/Wv/W1 are this rank's column shards (local
    heads num_heads / tp) and Wo/W2 its row shards: the Megatron layout,
    two reductions a block through `megatron_f`/`g`, correct under the
    tape (GPipe) and under the 1F1B schedule's explicit gradients.
    `num_kv_heads` < num_heads is GQA: Wk/Wv are (E, Hkv * D), each kv
    head repeated for num_heads / Hkv query heads before the attention.
    `rope`: the (cos, sin) (S, D) tables; q and k rotate per position, as
    in the GPT's layers, so RoPE stacks serve in a GPT."""
    from ..ops.attention import flash_attention
    from ..parallel.tp import _gelu, megatron_f, megatron_g
    from ..parallel.mesh import axis_size
    (g1, b1, Wq, Wk, Wv, Wo, g2, b2, W1, bb1, W2, bb2) = params
    B, S, E = h.shape
    heads = num_heads
    kv_heads = num_kv_heads or num_heads
    grp = heads // kv_heads
    if tp_axis is not None:
        tp_n = axis_size(tp_axis)
        heads //= tp_n
        kv_heads //= tp_n
    x = _fn_layernorm(h, g1, b1)
    if tp_axis is not None:
        x = megatron_f(x, tp_axis)
    q = _heads(x @ Wq, B, S, heads)
    k = _heads(x @ Wk, B, S, kv_heads)
    v = _heads(x @ Wv, B, S, kv_heads)
    if rope is not None:
        q = autograd.apply_rope(q, *rope)
        k = autograd.apply_rope(k, *rope)
    if grp > 1:
        k = k.repeat_interleave(grp, dim=1)
        v = v.repeat_interleave(grp, dim=1)
    o = flash_attention(q, k, v, True)
    o = o.permute(0, 2, 1, 3).reshape(B, S, -1) @ Wo
    if tp_axis is not None:
        o = megatron_g(o, tp_axis)
    h = h + o
    x = _fn_layernorm(h, g2, b2)
    if tp_axis is not None:
        x = megatron_f(x, tp_axis)
    y = _gelu(x @ W1 + bb1) @ W2
    if tp_axis is not None:
        y = megatron_g(y, tp_axis)
    return h + y + bb2


def _fn_block_moe(params, h, num_heads, k, capacity_factor, ep_axis=None,
                  rope=None):
    """Pre-LN transformer block whose MLP is a top-k MoE FFN (pp x ep).
    The expert stacks arrive replicated over the ep axis (the MoE layer's
    convention): while `ep_axis` is bound each rank slices its experts and
    the dispatch rides two all-to-alls (`moe_ffn_ep`), so the gradient
    reduction must cover (data, ep). Returns (h, aux, z_loss); the
    capacity counts the MICROBATCH's mb * S tokens (Megatron's
    per-microbatch routing: outside the no-drop regime it differs from
    the unpipelined model's batch-global routing)."""
    from ..ops.attention import flash_attention
    from ..parallel.mesh import axis_index, axis_size
    from ..parallel.moe import moe_ffn, moe_ffn_ep
    (g1, b1, Wq, Wk, Wv, Wo, g2, b2, Wg, W1e, b1e, W2e, b2e) = params
    B, S, E = h.shape
    x = _fn_layernorm(h, g1, b1)
    q = _heads(x @ Wq, B, S, num_heads)
    kk = _heads(x @ Wk, B, S, num_heads)
    v = _heads(x @ Wv, B, S, num_heads)
    if rope is not None:
        q = autograd.apply_rope(q, *rope)
        kk = autograd.apply_rope(kk, *rope)
    o = flash_attention(q, kk, v, True)
    h = h + o.permute(0, 2, 1, 3).reshape(B, S, -1) @ Wo
    x = _fn_layernorm(h, g2, b2)
    flat = x.reshape(-1, E)
    if ep_axis is not None and autograd.axis_bound(ep_axis):
        el = W1e.shape[0] // axis_size(ep_axis)
        lo = axis_index(ep_axis) * el
        y, aux, (z, _ovf) = moe_ffn_ep(
            flat, Wg, W1e[lo:lo + el], b1e[lo:lo + el], W2e[lo:lo + el],
            b2e[lo:lo + el], ep_axis, capacity_factor, k=k)
    else:
        y, aux, (z, _ovf) = moe_ffn(flat, Wg, W1e, b1e, W2e, b2e,
                                    capacity_factor, k=k)
    return h + y.reshape(B, S, E), aux, z


def _rope_tables_for(rope_cfg, S, device):
    """(cos, sin) (S, D) tables for positions [0, S) when rope_cfg =
    (theta, head_dim) is set (a microbatch carries the whole sequence);
    None otherwise."""
    if rope_cfg is None:
        return None
    theta, hd = rope_cfg
    return autograd.rope_tables(torch.arange(S, device=device), hd, theta)


def _make_stage_fn(num_heads, axis, total_layers, tp_axis=None,
                   num_kv_heads=None, rope_cfg=None):
    """A stage's blocks: the local stacks hold padded_layers / n rows of
    layers; rows whose GLOBAL index (stage * per + row) reaches
    total_layers are padding (zeros, never trained), skipped, so their
    gradients stay zero and `num_layers % stages != 0` works (late stages
    run fewer real layers). `tp_axis` also tensor-shards every block
    (pp x tp)."""
    from ..parallel.pipeline import stage_index

    def stage_fn(local_stacks, x):
        rows = [st.unbind(0) for st in local_stacks]
        per = len(rows[0])
        s = stage_index(axis)
        rope = _rope_tables_for(rope_cfg, x.shape[1], x.device)
        for li in range(min(per, total_layers - s * per)):
            x = _fn_block([r[li] for r in rows], x, num_heads, tp_axis,
                          num_kv_heads, rope)
        return x

    return stage_fn


def _make_stage_fn_moe(num_heads, axis, total_layers, k, capacity_factor,
                       ep_axis=None, rope_cfg=None):
    """The MoE stage: returns (x, aux), aux = [load balance, z-loss]
    summed over this stage's real layers."""
    from ..parallel.pipeline import stage_index

    def stage_fn(local_stacks, x):
        rows = [st.unbind(0) for st in local_stacks]
        per = len(rows[0])
        s = stage_index(axis)
        aux_acc = torch.zeros(2, dtype=torch.float32, device=x.device)
        rope = _rope_tables_for(rope_cfg, x.shape[1], x.device)
        for li in range(min(per, total_layers - s * per)):
            x, aux, z = _fn_block_moe([r[li] for r in rows], x, num_heads,
                                      k, capacity_factor, ep_axis, rope)
            aux_acc = aux_acc + torch.stack([aux.float(), z.float()])
        return x, aux_acc

    return stage_fn


def _make_chunk_fn(num_heads, axis, total_layers, pc, tp_axis=None,
                   num_kv_heads=None, rope_cfg=None):
    """The interleaved schedule's chunk: this stage's local stacks are
    (V, pc, ...), chunk c its rows [c pc, (c + 1) pc), global pipeline
    stage c n + d, so global layer (c n + d) pc + j decides the padding
    (rows past total_layers are skipped)."""
    from ..parallel.pipeline import _group, stage_index

    def chunk_fn(local_stacks, x, c):
        n = _group(axis)[0].n
        d = stage_index(axis)
        rows = [st[c].unbind(0) for st in local_stacks]
        rope = _rope_tables_for(rope_cfg, x.shape[1], x.device)
        for j in range(min(pc, total_layers - (c * n + d) * pc)):
            x = _fn_block([r[j] for r in rows], x, num_heads, tp_axis,
                          num_kv_heads, rope)
        return x

    return chunk_fn


def _bound(axis):
    return axis if axis is not None and autograd.axis_bound(axis) else None


class _PipelineBlocks(autograd.Operator):
    """All transformer blocks as one tape operator: GPipe (or the
    interleaved virtual-chunk GPipe) over the bound pipeline axis
    (`parallel.pipeline`), the serial layer loop otherwise."""

    def __init__(self, num_heads, axis=None, n_micro=1, total_layers=None,
                 tp_axis=None, interleave=1, pc=None, moe=None,
                 num_kv_heads=None, rope_cfg=None):
        super().__init__("PipelineBlocks")
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.axis = axis
        self.n_micro = n_micro
        self.total_layers = total_layers
        self.tp_axis = tp_axis
        self.interleave = interleave
        self.pc = pc          # layers per virtual chunk (interleave > 1)
        self.moe = moe        # (k, capacity_factor, ep_axis) or None
        self.rope_cfg = rope_cfg  # (theta, head_dim) or None

    def forward(self, h, *stacks):
        from ..parallel.pipeline import (bcast_from_last, gpipe,
                                         gpipe_interleaved)
        from ..parallel.tp import megatron_g
        nh = self.num_heads
        L = self.total_layers or stacks[0].shape[0]
        if _bound(self.axis) is not None:
            B, nm = h.shape[0], self.n_micro
            if B % nm:
                raise ValueError(f"batch {B} not divisible by n_micro {nm}")
            tp = _bound(self.tp_axis)
            x_micro = h.reshape(nm, B // nm, *h.shape[1:])
            if self.moe is not None:
                k, cf, ep = self.moe
                stage_fn = _make_stage_fn_moe(nh, self.axis, L, k, cf,
                                              _bound(ep), self.rope_cfg)
                outs, auxv = gpipe(stage_fn, list(stacks), x_micro,
                                   self.axis, with_aux=True)
                outs = bcast_from_last(self.axis, outs)
                # summed over the stages (each counts its own layers once:
                # g's backward is the identity), the mean over microbatches
                auxv = megatron_g(auxv, self.axis) / nm
                return outs.reshape(h.shape), auxv[0], auxv[1]
            if self.interleave > 1:
                chunk_fn = _make_chunk_fn(nh, self.axis, L, self.pc, tp,
                                          self.num_kv_heads, self.rope_cfg)
                outs = gpipe_interleaved(chunk_fn, list(stacks), x_micro,
                                         self.axis, self.interleave)
            else:
                stage_fn = _make_stage_fn(nh, self.axis, L, tp,
                                          self.num_kv_heads, self.rope_cfg)
                outs = gpipe(stage_fn, list(stacks), x_micro, self.axis)
            return bcast_from_last(self.axis, outs).reshape(h.shape)
        # serial (eval, one device): the (V, n pc, ...) interleaved stacks
        # share the canonical row order, so a reshape recovers layer rows;
        # padding rows past L are skipped
        if self.interleave > 1:
            stacks = [s.reshape((-1,) + tuple(s.shape[2:])) for s in stacks]
        rows = [s.unbind(0) for s in stacks]
        rope = _rope_tables_for(self.rope_cfg, h.shape[1], h.device)
        if self.moe is not None:
            k, cf, _ = self.moe
            aux_t = z_t = torch.zeros((), dtype=torch.float32,
                                      device=h.device)
            for g in range(L):
                h, aux, z = _fn_block_moe([r[g] for r in rows], h, nh, k, cf,
                                          None, rope)
                aux_t = aux_t + aux.float()
                z_t = z_t + z.float()
            return h, aux_t, z_t
        for g in range(L):
            h = _fn_block([r[g] for r in rows], h, nh,
                          num_kv_heads=self.num_kv_heads, rope=rope)
        return h


class _OneFOneB(torch.autograd.Function):
    """`one_f_one_b` as a node of torch's tape: the forward runs the whole
    schedule and keeps its cotangents on the context (per call: a
    captured step's replay refreshes them), the backward scales them by
    dloss and discards douts."""

    @staticmethod
    def forward(ctx, op, h, tgt, gf, bf, headW, *stacks):
        loss, outs, d_stage, d_last, dh = op._schedule(h, tgt, gf, bf,
                                                       headW, stacks)
        ctx.save_for_backward(dh, *d_last, *d_stage)
        return loss, outs

    @staticmethod
    def backward(ctx, dloss, douts):
        dh, dgf, dbf, dW, *d_stage = ctx.saved_tensors
        s = dloss
        return (None, dh * s, None, dgf * s, dbf * s, dW * s,
                *[g * s for g in d_stage])


class _Pipeline1F1B(autograd.Operator):
    """The pipeline training step under the 1F1B schedule as ONE tape
    operator with a HAND backward. 1F1B runs each microbatch's backward
    between later microbatches' forwards, which is only possible when the
    loss is computed inside the schedule (an operator that returns
    activations and waits for their cotangent cannot start a backward
    early), so this operator takes (h, targets, ln_f and head parameters,
    block stacks) and returns the loss itself; `one_f_one_b` runs the
    slots and hands back every cotangent, which the backward replays to
    the tape (`_OneFOneB`).

    CONTRACT (backward): the second output (activations for the
    caller-facing logits) is an OBSERVATION edge only: the backward
    discards its cotangent `douts`. A change that puts a differentiable
    term on the returned logits (an auxiliary loss in train_one_batch)
    would silently train with ZERO gradient through the pipeline blocks.
    Keep every loss term inside last_fn."""

    def __init__(self, num_heads, axis, n_micro, total_layers,
                 tp_axis=None, tied_vocab=None, num_kv_heads=None,
                 rope_cfg=None):
        super().__init__("Pipeline1F1B")
        self.rope_cfg = rope_cfg
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.axis = axis
        self.n_micro = n_micro
        self.total_layers = total_layers
        self.tp_axis = tp_axis
        # the true vocab size when headW is the vocab-sharded table
        self.tied_vocab = tied_vocab

    def forward(self, h, tgt, gf, bf, headW, *stacks):
        if _bound(self.axis) is None:
            raise ValueError("the 1f1b schedule needs a bound pipeline "
                             f"axis {self.axis!r}")
        return _OneFOneB.apply(self, h, tgt, gf, bf, headW, *stacks)

    def _schedule(self, h, tgt, gf, bf, headW, stacks):
        from ..parallel.pipeline import last_stage_value, one_f_one_b
        from ..parallel.tp import megatron_f, vocab_parallel_ce
        B, S, E = h.shape
        nm = self.n_micro
        if B % nm:
            raise ValueError(f"batch {B} not divisible by n_micro {nm}")
        tp = _bound(self.tp_axis)
        stage_fn = _make_stage_fn(self.num_heads, self.axis,
                                  self.total_layers, tp, self.num_kv_heads,
                                  self.rope_cfg)
        tied, V = self.tied_vocab is not None, self.tied_vocab

        def last_fn(lp, y, t):
            # the fp32 loss island: final LN, tied or untied head, the
            # token-mean CE (ln_f, head(out_dtype=fp32), SoftMaxCE)
            g, b, W = (a.float() for a in lp)
            z = _fn_layernorm(y.float(), g, b)
            if tied and tp is not None:
                # W is this rank's (V_pad / tp, E) table slice: sharded
                # logits and the vocab-parallel CE
                return vocab_parallel_ce(megatron_f(z, tp) @ W.T, t, tp,
                                         valid_vocab=V)
            if tied:
                # no bound tp axis: the full padded table, its padding
                # columns masked out
                logits = z @ W.T
                if logits.shape[-1] != V:
                    col = torch.arange(logits.shape[-1], device=z.device)
                    logits = logits.masked_fill(col >= V, -float("inf"))
            else:
                logits = z @ W
            lse = torch.logsumexp(logits, dim=-1)
            tl = logits.gather(-1, t.long()[..., None])[..., 0]
            return (lse - tl).mean()

        loss, outs, d_stage, d_last, dx = one_f_one_b(
            stage_fn, last_fn, list(stacks), (gf, bf, headW),
            h.reshape(nm, B // nm, S, E), tgt.reshape(nm, B // nm, S),
            self.axis)
        outs = last_stage_value(outs, self.axis)
        return loss, outs.reshape(B, S, E), d_stage, d_last, \
            dx.reshape(B, S, E)


class PipelinedGPT(_VocabTPMixin, model.Model):
    """GPT with pipeline parallelism through the Model API: compile with
    `pipeline_axis="pp", n_micro=M` under a DistOpt whose mesh carries a
    'pp' axis (and a 'data' axis, possibly of size 1) and train as usual.
    The block stacks, where the FLOPs are, are cut layer-wise over the
    pipeline; `pipeline_schedule` is "gpipe" or "1f1b".

    `tp_axis` composes pp x tp (Megatron's 3D layout without sequence
    dims): every block's QKV and MLP weights also shard over the tp axis,
    and `vocab_tp=True` row-shards ONE padded (V_pad, E) table over tp as
    the embedding and the tied head, the loss on sharded logits.
    `interleave` V > 1 gives each stage V round-robin virtual chunks
    (gpipe only). `moe_experts` > 0 makes every block's MLP a top-`moe_k`
    MoE, expert-parallel over `ep_axis` inside the stages (gpipe only,
    without tp, interleave or GQA; train it under DistOpt(axis=("data",
    ep_axis))). RoPE (`pos_encoding="rope"`) rotates q/k in every block
    and the model has no position table.

    The positional order is the JAX PipelinedGPT's, and `device` and
    `seed` come last, as the GPT's. The embedding, head and position
    table are drawn from `seed`; the stacks from np.random.RandomState(0)
    as the JAX package draws them (the same values whatever the pipeline
    degree), when `compile` lays them out for its pipeline: the stacks
    are padded to n ceil(L / n) rows (n ceil(L / (n V)) V with V chunks,
    shaped (V, n pc, ...)), the padding zeros and never trained.
    Off the pipeline mesh the same model runs the serial layer loop."""

    _STACK_ATTRS = ("g1", "b1", "Wq", "Wk", "Wv", "Wo",
                    "g2", "b2", "W1", "bb1", "W2", "bb2")
    _MOE_STACK_ATTRS = ("g1", "b1", "Wq", "Wk", "Wv", "Wo", "g2", "b2",
                        "moeWg", "moeW1", "moeb1", "moeW2", "moeb2")

    @property
    def _stack_attrs(self):
        return self._MOE_STACK_ATTRS if self.moe_experts \
            else self._STACK_ATTRS

    def __init__(self, vocab_size, max_seq=1024, dim=256, num_heads=8,
                 num_layers=4, mlp_ratio=4, tp_axis=None, vocab_tp=False,
                 vocab_pad_multiple=128, vocab_tp_return_logits=True,
                 interleave=1, moe_experts=0, moe_k=2, ep_axis=None,
                 moe_capacity_factor=1.25, moe_aux_weight=0.01,
                 moe_z_weight=1e-3, num_kv_heads=None,
                 pos_encoding="learned", rope_theta=10000.0, name=None,
                 device=None, seed=0):
        super().__init__(name)
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"pos_encoding {pos_encoding!r}")
        self.pos_encoding = pos_encoding
        self.rope_theta = float(rope_theta)
        self.vocab_size = vocab_size
        self.max_seq = max_seq
        self.dim = dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {self.num_kv_heads}")
        self.num_layers = num_layers
        self.mlp_ratio = mlp_ratio
        self.tp_axis = tp_axis
        if interleave < 1:
            raise ValueError(f"interleave {interleave} < 1")
        self.interleave = int(interleave)
        self.moe_experts = int(moe_experts)
        self.moe_k = moe_k
        self.ep_axis = ep_axis
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_aux_weight = moe_aux_weight
        self.moe_z_weight = moe_z_weight
        if self.moe_experts:
            if tp_axis is not None:
                raise ValueError(
                    "PipelinedGPT moe_experts does not compose with "
                    "tp_axis yet (expert dispatch and Megatron f/g would "
                    "need a fused layout); use pp x dp x ep")
            if self.interleave > 1:
                raise ValueError(
                    "PipelinedGPT moe_experts composes with the plain "
                    "gpipe schedule only (no interleave)")
            if num_kv_heads is not None and num_kv_heads != num_heads:
                raise ValueError(
                    "PipelinedGPT moe_experts does not compose with "
                    "num_kv_heads yet (the MoE stage fn's attention is "
                    "MHA); use GQA with the dense-MLP pipelined model")
        if vocab_tp and tp_axis is None:
            raise ValueError(
                "vocab_tp=True needs tp_axis (see GPT.__init__)")
        dev = device_mod.resolve(device)
        gen = torch.Generator().manual_seed(int(seed))
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
            # fp32-accumulated logits: under amp the CE would otherwise
            # upcast the whole (B, S, V) tensor
            self.head = layer.Linear(dim, vocab_size, bias=False,
                                     out_dtype="float32", generator=gen)
        self.ln_f = layer.LayerNorm(dim=dim)
        self.sce = layer.SoftMaxCrossEntropy()
        self._layout = None
        self._init_stacks(dev)
        if pos_encoding == "learned":
            self.pos_embed = nn.Parameter(
                torch.randn((max_seq, dim), generator=gen) * 0.02)
        self.to(dev)
        nn.Module.train(self, False)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.W.device

    def _layout_for_compile(self):
        """Lay the stacks out for the pipeline `compile` stored (the
        DistOpt's mesh gives its degree: set the optimizer first); 1f1b
        refuses interleave > 1 and the MoE blocks."""
        if self.pipeline_schedule == "1f1b" and self.interleave > 1:
            raise ValueError(
                "interleave>1 composes with the gpipe schedule only: "
                "1f1b's fused scan assumes one contiguous stage per "
                "device (see parallel/pipeline.py schedule_table for "
                "the bubble/memory/compute trade-offs)")
        if self.pipeline_schedule == "1f1b" and self.moe_experts:
            raise ValueError(
                "PipelinedGPT moe_experts composes with the gpipe "
                "schedule only (1f1b's in-schedule loss does not carry "
                "the router aux-loss channel yet)")
        self._init_stacks(self.device)

    def _mesh_axis_size(self, axis) -> int:
        """The degree of mesh axis `axis` on the DistOpt's mesh (1 with
        no such axis or mesh)."""
        mesh = getattr(getattr(self._optimizer, "communicator", None),
                       "mesh", None)
        if axis is None or mesh is None or axis not in mesh.shape:
            return 1
        return int(mesh.shape[axis])

    def _n_stages(self) -> int:
        return self._mesh_axis_size(self.pipeline_axis)

    def _rope_cfg(self):
        return (self.rope_theta, self.dim // self.num_heads) \
            if self.pos_encoding == "rope" else None

    def _blocks_op(self):
        moe = (self.moe_k, float(self.moe_capacity_factor), self.ep_axis) \
            if self.moe_experts else None
        return _PipelineBlocks(
            self.num_heads, self.pipeline_axis, self.n_micro,
            self.num_layers, self.tp_axis, interleave=self.interleave,
            pc=self._chunk_layers, moe=moe, num_kv_heads=self.num_kv_heads,
            rope_cfg=self._rope_cfg())

    def _stacks(self):
        return [getattr(self, a) for a in self._stack_attrs]

    @torch.no_grad()
    def _init_stacks(self, dev):
        """Create (at construction) or lay out anew (at compile) the block
        stacks for the pipeline's degree n and the interleave V: pc =
        ceil(L / (n V)) layers a chunk, padded_layers n V pc rows, shaped
        (padded_layers, ...) or (V, n pc, ...), whose row-major order is
        the canonical layer order either way; the specs ("pp",), the
        Megatron tp specs when the mesh's tp axis has more than one rank,
        and (None, "pp", ...) under interleave, so that `Model._shard`
        cuts the pipeline's dimension. The values are JAX's draws from
        np.random.RandomState(0); a layout anew keeps the current values
        (it moves rows, it redraws nothing)."""
        L, E, H = self.num_layers, self.dim, self.dim * self.mlp_ratio
        n_pp, V = self._n_stages(), self.interleave
        pc = -(-L // (n_pp * V))
        Lp = n_pp * V * pc
        tp_n = self._mesh_axis_size(self.tp_axis)
        pp, tp = self.pipeline_axis, self.tp_axis
        layout = (Lp, n_pp, pp, tp_n)
        if layout == self._layout:
            return
        if self._placements:
            raise ValueError("the stacks are sharded already; build the "
                             "model anew for another pipeline layout")
        if tp_n > 1:
            if pp is None:
                raise ValueError(
                    "PipelinedGPT tp_axis requires pipeline_axis (the "
                    "stacked blocks only run tensor-parallel inside the "
                    "pipeline mesh)")
            if E % tp_n or H % tp_n or self.num_heads % tp_n \
                    or self.num_kv_heads % tp_n:
                raise ValueError(
                    f"dim {E}/hidden {H}/heads {self.num_heads}/kv heads "
                    f"{self.num_kv_heads} must divide tp={tp_n}")
        lead = (V, n_pp * pc) if V > 1 else (Lp,)
        # the Megatron layout over the stacks: QKV/W1 cut their OUTPUT
        # dimension over tp, Wo/W2 their INPUT dimension
        tp_specs = {"Wq": (pp, None, tp), "Wk": (pp, None, tp),
                    "Wv": (pp, None, tp), "W1": (pp, None, tp),
                    "Wo": (pp, tp, None), "W2": (pp, tp, None),
                    "bb1": (pp, tp)}
        kv_e = E // self.num_heads * self.num_kv_heads
        X = self.moe_experts
        shapes = {"g1": ((E,), None), "b1": ((E,), None),
                  "Wq": ((E, E), E ** -0.5), "Wk": ((E, kv_e), E ** -0.5),
                  "Wv": ((E, kv_e), E ** -0.5), "Wo": ((E, E), E ** -0.5),
                  "g2": ((E,), None), "b2": ((E,), None)}
        if X:
            # the expert stacks stay REPLICATED over ep (each rank slices
            # its experts in the step); only the pp dimension is cut
            shapes.update(moeWg=((E, X), E ** -0.5),
                          moeW1=((X, E, H), E ** -0.5),
                          moeb1=((X, H), 0.0), moeW2=((X, H, E), H ** -0.5),
                          moeb2=((X, E), 0.0))
        else:
            shapes.update(W1=((E, H), E ** -0.5), bb1=((H,), 0.0),
                          W2=((H, E), H ** -0.5), bb2=((E,), 0.0))
        rng = np.random.RandomState(0)
        for attr in self._stack_attrs:
            shape, scale = shapes[attr]
            cur = getattr(self, attr, None)
            if cur is not None:     # a layout anew, on the stack's device
                vals = cur.detach().new_zeros((Lp,) + shape)
                vals[:L] = cur.detach().reshape((-1,) + shape)[:L]
            else:
                vals = torch.zeros((Lp,) + shape, dtype=torch.float32)
                if scale is None:   # the layer norms' gain and bias
                    vals[:L] = 1.0 if attr.startswith("g") else 0.0
                else:
                    draw = rng.standard_normal((L,) + shape)
                    draw *= scale   # JAX's float64 product, then fp32
                    vals[:L] = torch.from_numpy(draw)
            vals = vals.reshape(lead + shape).to(dev)
            if cur is None:
                p = nn.Parameter(vals)
                setattr(self, attr, p)
            else:
                p = cur
                p.data = vals
            spec = None
            if pp is not None:
                spec = tp_specs.get(attr, (pp,)) if tp_n > 1 else (pp,)
                if V > 1:
                    spec = (None,) + spec
            if spec is None:
                p.__dict__.pop("spec", None)
            else:
                p.spec = spec
        self.padded_layers, self._chunk_layers = Lp, pc
        self._stack_lead = lead
        self._layout = layout

    def _raw_params(self):
        """{name: parameter} in the JAX PipelinedGPT's order: the stacks
        and the position table (its own), then tok_embed, head, ln_f."""
        own = OrderedDict(self.named_parameters())
        first = list(self._stack_attrs) + (
            ["pos_embed"] if self.pos_encoding == "learned" else [])
        out = OrderedDict((k, own.pop(k)) for k in first)
        out.update(own)
        return out

    def _ids(self, ids):
        return torch.as_tensor(_raw(ids), device=self.device).long()

    def _embed(self, ids):
        h = self.tok_embed(ids)
        if self.pos_encoding == "learned":
            # RoPE: the positions live in every block's q/k rotation
            h = h + self.pos_embed[:ids.shape[1]]
        if _bound(self.pipeline_axis) is not None:
            # Megatron's f on the pipeline input: dL/dh is nonzero only
            # on stage 0 (the only stage that reads h); the sum in the
            # backward gives every stage the whole embedding gradient, so
            # the replicated embedding and position table stay in sync
            h = autograd.tp_copy(h, self.pipeline_axis)
        return h

    def forward(self, ids):
        """(B, S) token ids -> (B, S, V) fp32 logits."""
        h = self._embed(self._ids(ids))
        out = self._blocks_op()(h, *self._stacks())
        return self._caller_logits(out[0] if self.moe_experts else out)

    def _from_canonical(self, name, arr):
        """A stack in canonical layer order (L_in, ...) as this model's
        global stack: zero-padded to padded_layers and reshaped to its
        lead shape (a reshape: the layouts share the row order). Any
        other shape passes through."""
        shape = self._global_shape(getattr(self, name))
        body = shape[len(self._stack_lead):]
        if tuple(arr.shape) == shape or tuple(arr.shape[1:]) != body:
            return arr
        glob = torch.zeros((self.padded_layers,) + body, dtype=arr.dtype)
        m = min(self.padded_layers, arr.shape[0])
        glob[:m] = arr[:m]
        return glob.reshape(shape)

    def set_params(self, params: dict):
        """Model.set_params, taking stacks from a model of another
        pipeline degree too: a CANONICAL (num_layers, ...) stack loads by
        zero-padding to padded_layers and reshaping to the stack's lead
        shape; a stack of this model's (global) shape passes through, so
        get_params -> set_params between equal configs is exact."""
        fixed = {}
        for n, v in params.items():
            if n in self._stack_attrs:
                v = self._from_canonical(n, torch.as_tensor(
                    _raw(v).detach().cpu() if isinstance(
                        v, (Tensor, torch.Tensor)) else np.array(v)))
            fixed[n] = v
        super().set_params(fixed)

    def canonical_stacks(self) -> dict:
        """The block stacks as numpy arrays in CANONICAL layer order (row
        0 = layer 0, padded to padded_layers), whatever the interleave
        (a reshape, not a gather of rows); global arrays (a collective
        over a sharded model's mesh)."""
        out = {}
        for a in self._stack_attrs:
            t = self._global(getattr(self, a)).detach().cpu()
            out[a] = t.reshape((self.padded_layers,) + tuple(
                t.shape[len(self._stack_lead):])).numpy()
        return out

    def _caller_logits(self, h_out):
        """Caller-facing logits from the blocks' activations."""
        h_out = self.ln_f(h_out)
        if not self.vocab_tp:
            return self.head(h_out)
        local = self._tied_logits(h_out)
        if self._vp_active():
            local = autograd.gather_last(local, self.tp_axis)
        return self._slice_valid(local)

    def train_one_batch(self, ids, targets):
        """One training step on the compiled schedule; returns (logits
        (B, S, V) fp32, loss), detached. Under 1f1b on the bound pipeline
        axis the loss comes out of the schedule with every gradient, and
        the logits are computed from its activations outside the loss's
        graph (torch.no_grad: no term may train through that edge, see
        `_Pipeline1F1B`)."""
        ids = self._ids(ids)
        tgt = torch.as_tensor(_raw(targets), device=self.device).long()
        if self.pipeline_schedule == "1f1b" \
                and _bound(self.pipeline_axis) is not None:
            h = self._embed(ids)
            headW = self.tok_embed.W if self.vocab_tp else self.head.W
            op = _Pipeline1F1B(
                self.num_heads, self.pipeline_axis, self.n_micro,
                self.num_layers, self.tp_axis,
                tied_vocab=self.vocab_size if self.vocab_tp else None,
                num_kv_heads=self.num_kv_heads, rope_cfg=self._rope_cfg())
            loss, outs = op(h, tgt, self.ln_f.gamma, self.ln_f.beta, headW,
                            *self._stacks())
            with torch.no_grad():
                logits = self._caller_logits(outs)
            self.optimizer(loss)
            return logits, loss.detach()
        out = self._blocks_op()(self._embed(ids), *self._stacks())
        h = out[0] if self.moe_experts else out
        if self.vocab_tp:
            local = self._tied_logits(self.ln_f(h))
            loss, logits = self._vp_loss_and_logits(local, tgt)
        else:
            logits = self._caller_logits(h)
            loss = self.sce(logits.reshape(-1, self.vocab_size),
                            tgt.reshape(-1))
        if self.moe_experts:
            loss = self._fold_moe_losses(loss, out[1], out[2])
        self.optimizer(loss)
        return logits.detach(), loss.detach()

    def _fold_moe_losses(self, loss, aux, z):
        """loss + aux * moe_aux_weight + z * moe_z_weight."""
        return loss + aux * self.moe_aux_weight + z * self.moe_z_weight


def create_model(vocab_size=256, **kwargs):
    return GPT(vocab_size, **kwargs)


def create_pipelined(vocab_size=256, **kwargs):
    return PipelinedGPT(vocab_size, **kwargs)


__all__ = ["GPT", "PipelinedGPT", "create_model", "create_pipelined",
           "load_gpt2_weights", "load_singa_params", "load_singa_states"]
