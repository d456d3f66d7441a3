"""Port parity, flash-attention backward: the gradients of the port's
`FlashAttention` (its plain backward `flash_bwd_reference` runs on CPU
tensors) against `jax.grad` of the JAX package's `flash_attention`, whose
Pallas kernels run in interpret mode on the CPU (its reference VJP where
S does not tile). fp32, atol = rtol = 2e-4 (the JAX package's own
flash-grad tests allow 2e-3)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singa_tpu import autograd as jag
from singa_tpu import device, layer as jl, tensor
from singa_tpu.ops import attention as ja
from singa_tpu_torch import layer as tl
from singa_tpu_torch.ops import attention as ta

torch.set_num_threads(2)
TOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(S, D, seed, B=1, H=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype(np.float32) for _ in range(4)]


def _jax_grads(q, k, v, do, causal):
    def f(q_, k_, v_):
        out = ja.flash_attention(q_, k_, v_, causal, None, None, None, True)
        return jnp.sum(out * jnp.asarray(do))
    return jax.grad(f, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


def _port_grads(q, k, v, do, causal):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ta.flash_attention(*ts, causal)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    return torch.autograd.grad(out, ts, torch.from_numpy(do))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("S", [16, 37, 64])
def test_flash_grads_match_jax(S, D, causal):
    """S = 37 does not tile the TPU kernels, so JAX takes its reference
    VJP there; the port's backward takes any S."""
    q, k, v, do = _inputs(S, D, seed=S + D)
    want = _jax_grads(q, k, v, do, causal)
    got = _port_grads(q, k, v, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_jax_split_route(causal):
    """The JAX split pair (dq kernel, then dk/dv kernel) forced through
    its `_FUSED_DQ_BYTES_CAP`; the port's cap is forced with it (on CPU
    tensors both routes are the plain backward)."""
    q, k, v, do = _inputs(64, 32, seed=11)
    caps = ja._FUSED_DQ_BYTES_CAP, ta._FUSED_DQ_BYTES_CAP
    try:
        ja._FUSED_DQ_BYTES_CAP = ta._FUSED_DQ_BYTES_CAP = 0
        want = _jax_grads(q, k, v, do, causal)
        got = _port_grads(q, k, v, do, causal)
    finally:
        ja._FUSED_DQ_BYTES_CAP, ta._FUSED_DQ_BYTES_CAP = caps
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,block_k", [(50, 16), (64, 512)])
def test_flash_bwd_reference_matches_autograd(S, block_k, causal):
    """The blockwise plain backward (short last block at S = 50) against
    torch autograd of attention_reference."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(S, 32, seed=3))
    scale = 32 ** -0.5
    o, lse = ta._flash_fwd(q, k, v, causal, scale)
    got = ta.flash_bwd_reference(q, k, v, o, lse, do, causal, scale,
                                 block_k=block_k)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        ta.attention_reference(*leaves, causal, scale), leaves, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   atol=2e-5, rtol=2e-5)


def test_no_grad_inputs_skip_the_function():
    """Inputs that need no grad run the forward alone (no graph)."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(16, 16, seed=5))
    assert ta.flash_attention(q, k, v, True).grad_fn is None


def test_gqa_rope_attention_param_grads_match_jax():
    """GQA (4 query heads on 2 kv heads) with RoPE through
    MultiHeadAttention: the gradients of Wq..Wo and the attention biases
    sum over each kv head's group through the repeat, as JAX's do."""
    rng = np.random.RandomState(7)
    B, S, E = 2, 16, 64
    x = rng.randn(B, S, E).astype(np.float32)
    t = rng.randn(B, S, E).astype(np.float32)
    dev = device.best_device()
    jm = jl.MultiHeadAttention(4, causal=True, num_kv_heads=2, rope=True,
                               bias=True)
    prev = jag.training
    jag.training = True
    try:
        y = jm(tensor.from_numpy(x, device=dev))
        loss = jag.mse_loss(y, tensor.from_numpy(t, device=dev))
        grads = jag.gradients(loss)
    finally:
        jag.training = prev
    jparams = jm.get_params()
    want = {n: tensor.to_numpy(grads[p]) for n, p in jparams.items()}

    tm = tl.MultiHeadAttention(E, 4, causal=True, bias=True, num_kv_heads=2,
                               rope=True)
    with torch.no_grad():
        for n, p in tm.named_parameters():
            p.copy_(torch.tensor(tensor.to_numpy(jparams[n])))
    yt = tm(torch.from_numpy(x))
    tloss = 0.5 * ((yt - torch.from_numpy(t)) ** 2).sum() / B
    np.testing.assert_allclose(tloss.item(), float(tensor.to_numpy(loss)),
                               rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    got = torch.autograd.grad(tloss, [p for _, p in tm.named_parameters()])
    assert sorted(names) == sorted(want)
    for n, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), want[n], err_msg=n, **TOL)
