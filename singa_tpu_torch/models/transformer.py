"""GPT-style decoder-only LM (counterpart of
singa_tpu/models/transformer.py): a `model.Model` with the full-sequence
forward, `train_one_batch` (softmax cross-entropy over the flattened
logits, then the optimizer), greedy and temperature/top-k `generate`, and
the weight bridge from the JAX package (`load_singa_params`,
`load_singa_states`; `Model.load_states` reads the same zips).

Beam search, speculative decoding, MoE, tensor/sequence/vocab
parallelism and int8 serving come with later slices of the port.
"""

from __future__ import annotations

import io
import zipfile

import numpy as np
import torch
from torch import nn

from .. import device as device_mod
from .. import layer, model, serving


class GPT(model.Model):
    """Decoder-only transformer: token embedding (+ learned positions,
    or RoPE in every block), pre-LN blocks, final LayerNorm, an untied
    fp32-output head.

    `device=None` resolves to CUDA and raises when there is none; pass
    `device="cpu"` to run the plain PyTorch versions of the kernels.
    Weights are drawn from `seed` with the JAX initializers' formulas.
    Training goes through the Model API: `set_optimizer`,
    `compile([ids], is_train=True, amp=...)`, then `logits, loss =
    m(ids, targets)`."""

    def __init__(self, vocab_size, max_seq=1024, dim=256, num_heads=8,
                 num_layers=4, mlp_ratio=4, attn_bias=False,
                 num_kv_heads=None, pos_encoding="learned",
                 rope_theta=10000.0, device=None, seed=0):
        super().__init__()
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
        self.tok_embed = layer.Embedding(vocab_size, dim, generator=gen)
        self.head = layer.Linear(dim, vocab_size, bias=False,
                                 out_dtype="float32", generator=gen)
        self.blocks = nn.ModuleList(
            layer.TransformerBlock(
                dim, num_heads, mlp_ratio, attn_bias=attn_bias,
                num_kv_heads=num_kv_heads, rope=pos_encoding == "rope",
                rope_theta=rope_theta, generator=gen)
            for _ in range(num_layers))
        self.ln_f = layer.LayerNorm(dim)
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
        """(B, S) token ids -> (B, S, V) fp32 logits. Under the bf16
        policy the embedding rows are bf16 and adding the fp32 position
        table makes the residual stream fp32, as in the JAX package."""
        ids = torch.as_tensor(ids, device=self.device).long()
        h = self.tok_embed(ids)
        if self.pos_encoding == "learned":
            h = h + self.pos_embed[:ids.shape[1]]
        for b in self.blocks:
            h = b(h)
        return self.head(self.ln_f(h))

    def train_one_batch(self, ids, targets):
        """One training step: forward, the mean cross-entropy over every
        position, backward and the optimizer's update. Returns (logits
        (B, S, V) fp32, loss), detached from the spent graph."""
        logits = nn.Module.__call__(self, ids)
        flat = logits.reshape(-1, self.vocab_size)
        tflat = torch.as_tensor(targets, device=self.device).reshape(-1)
        loss = self.sce(flat, tflat.long())
        self.optimizer(loss)
        return logits.detach(), loss.detach()

    def get_params(self):
        """{JAX name: parameter} in the JAX GPT's order: its blocks are
        `TransformerBlock_<i>` and it registers the position table on
        itself, first; the optimizer's checkpoint keys follow this
        order."""
        own = {_singa_name(n): p for n, p in self.named_parameters()}
        return dict(sorted(own.items(), key=lambda kv: kv[0] != "pos_embed"))

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens, temperature=0.0, top_k=None,
                 seed=0, dtype=None):
        """Autoregressive sampling: greedy (temperature=0) or
        temperature/top-k. `prompt` is (B, S0) int (numpy or tensor);
        returns (B, S0 + max_new_tokens) numpy int32.
        `dtype="bfloat16"` decodes in bf16."""
        ids = prompt.cpu().numpy() if isinstance(prompt, torch.Tensor) \
            else np.asarray(prompt)
        if ids.ndim != 2:
            raise ValueError("prompt must be (batch, length)")
        if max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
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
        sig = (B, S0, max_new_tokens, float(temperature), top_k, dtype)
        fn = cache.get(sig)
        if fn is None:
            fn = cache[sig] = serving.build_decode(
                self, B, S0, max_new_tokens, float(temperature), top_k,
                dtype)
        out = fn(serving.decode_state(self, dtype),
                 torch.as_tensor(ids.astype(np.int64), device=self.device),
                 seed)
        return out.cpu().numpy().astype(np.int32)


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
    Every parameter of `model` must be given; an unknown name or a shape
    mismatch raises."""
    own = dict(model.named_parameters())
    seen = set()
    for k, v in params.items():
        name = _port_name(k)
        if name not in own:
            raise KeyError(f"unknown param {k!r} (as {name!r}); have "
                           f"{sorted(own)}")
        arr = torch.from_numpy(np.array(v))
        t = own[name]
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


def create_model(vocab_size=256, **kwargs):
    return GPT(vocab_size, **kwargs)


__all__ = ["GPT", "create_model", "load_singa_params", "load_singa_states"]
