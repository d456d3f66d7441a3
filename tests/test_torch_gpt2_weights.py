"""Port parity, `load_gpt2_weights`: a random GPT-2-convention state dict
(torch (out, in) layouts, the fused (3E, E) attention weight) loaded into
a JAX GPT and into the port's GPT (dim 64, 2 layers, attention biases)
gives logits within 1e-5 and greedy tokens equal to JAX's; the head is
wte's transpose. The JAX function's refusals raise in the port too: more
positions than the checkpoint's, a model without attention biases, a
shape mismatch."""

import numpy as np
import pytest
import torch

from singa_tpu import device, models, tensor
from singa_tpu.models import transformer as jtr
from singa_tpu_torch import models as tmodels
from singa_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)
V, E, L, NPOS = 97, 64, 2, 64
CFG = dict(vocab_size=V, dim=E, num_heads=4, num_layers=L, attn_bias=True)


def _state(seed=0, e=E):
    rng = np.random.RandomState(seed)

    def r(*shape, scale=0.1):
        return (rng.randn(*shape) * scale).astype(np.float32)

    st = {"wte.weight": r(V, e), "wpe.weight": r(NPOS, e, scale=0.02),
          "ln_f.weight": 1.0 + r(e), "ln_f.bias": r(e)}
    for i in range(L):
        p = f"blocks.{i}."
        st.update({
            p + "ln1.weight": 1.0 + r(e), p + "ln1.bias": r(e),
            p + "ln2.weight": 1.0 + r(e), p + "ln2.bias": r(e),
            p + "attn.weight": r(3 * e, e), p + "attn.bias": r(3 * e),
            p + "proj.weight": r(e, e), p + "proj.bias": r(e),
            p + "ff1.weight": r(4 * e, e), p + "ff1.bias": r(4 * e),
            p + "ff2.weight": r(e, 4 * e), p + "ff2.bias": r(e)})
    return st


def _jax_gpt(**kw):
    cfg = dict(CFG, max_seq=NPOS)
    cfg.update(kw)
    m = models.create_model("gpt", **cfg)
    ids = np.zeros((1, 4), np.int32)
    m.compile([tensor.from_numpy(ids, device=device.best_device())],
              is_train=False, use_graph=False)
    m.eval()
    return m


def _port(**kw):
    cfg = dict(CFG, max_seq=NPOS)
    cfg.update(kw)
    return ttr.GPT(**cfg, device="cpu")


def test_logits_and_tokens_match_jax():
    st = _state()
    jm = jtr.load_gpt2_weights(_jax_gpt(), st)
    tm = ttr.load_gpt2_weights(_port(), st)
    x = np.random.RandomState(1).randint(0, V, (2, 23)).astype(np.int32)
    want = tensor.to_numpy(jm(tensor.from_numpy(
        x, device=device.best_device())))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tm.head.W.detach().numpy(),
                                  st["wte.weight"].T)
    np.testing.assert_array_equal(
        tm.blocks[1].attn.Wk.detach().numpy(),
        st["blocks.1.attn.weight"][E:2 * E].T)
    np.testing.assert_array_equal(tm.generate(x[:, :6], 8),
                                  np.asarray(jm.generate(x[:, :6], 8)))
    assert "load_gpt2_weights" in ttr.__all__
    assert tmodels.load_gpt2_weights is ttr.load_gpt2_weights


def test_loads_a_prefix_of_the_positions():
    """A model with fewer positions than the checkpoint takes its
    prefix."""
    st = _state(2)
    tm = ttr.load_gpt2_weights(_port(max_seq=32), st)
    np.testing.assert_array_equal(tm.pos_embed.detach().numpy(),
                                  st["wpe.weight"][:32])


REFUSALS = {
    "max_seq_past_wpe": (dict(max_seq=NPOS + 1), None),
    "no_attn_bias": (dict(attn_bias=False), None),
    "fused_qkv_shape": ({}, ("blocks.0.attn.weight", (3 * E, E + 1))),
    "ff1_shape": ({}, ("blocks.1.ff1.weight", (4 * E + 1, E))),
    "wte_shape": ({}, ("wte.weight", (V + 1, E))),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    kw, bad = REFUSALS[case]
    st = _state(3)
    if bad is not None:
        st[bad[0]] = np.zeros(bad[1], np.float32)
    with pytest.raises((AssertionError, ValueError)):
        jtr.load_gpt2_weights(_jax_gpt(**kw), st)
    with pytest.raises(ValueError):
        ttr.load_gpt2_weights(_port(**kw), st)
