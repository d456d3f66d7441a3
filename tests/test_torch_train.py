"""Port parity, GPT training: a tiny GPT is compiled in the JAX package
(graph mode), its initial parameters are carried into singa_tpu_torch
with load_singa_params, and both take the same steps on the same numpy
batch. The per-step losses (rtol 1e-5), every parameter after the steps
(atol 1e-5) and the optimizer's checkpoint keys must agree, for SGD with
momentum, dampening and weight decay and for Adam with L2 decay, over
learned positions, RoPE + GQA and attention biases. Also: the bf16 amp
policy (losses within 2e-2, fp32 master weights), save_states /
load_states both ways, and greedy serving after training."""

import os

import numpy as np
import pytest
import torch

from singa_tpu import device, models, opt as jopt, tensor
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import opt as topt
from singa_tpu_torch import serving as tserving
from singa_tpu_torch.models import transformer as tt

torch.set_num_threads(2)
SMALL = dict(vocab_size=97, max_seq=64, dim=64, num_heads=4, num_layers=2)
B, S, STEPS = 2, 16, 3
VARIANTS = {
    "learned_mha": dict(),
    "rope_gqa": dict(num_kv_heads=2, pos_encoding="rope"),
    "attn_bias": dict(attn_bias=True),
}
OPTS = {
    "sgd": (lambda m: m.SGD(lr=0.1, momentum=0.9, dampening=0.1,
                            weight_decay=1e-5)),
    "adam": (lambda m: m.Adam(lr=1e-3, weight_decay=1e-4)),
}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 97, (B, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _dev():
    return device.best_device()


def _pair(opt_name, amp=None, **kw):
    """A JAX GPT compiled for training and the port's GPT holding its
    initial parameters, each with the named optimizer."""
    ids, _ = _batch()
    # the JAX initializers draw from the device's key: seed it, so the
    # weights do not depend on which tests ran before in this process
    _dev().SetRandSeed(0)
    jm = models.create_model("gpt", **SMALL, **kw)
    jm.set_optimizer(OPTS[opt_name](jopt))
    jm.compile([tensor.from_numpy(ids, device=_dev())], is_train=True,
               use_graph=True, amp=amp)
    # nonzero biases, so a dropped or misplaced bias shows
    rng = np.random.RandomState(1)
    for name, t in jm.get_params().items():
        if name.split(".")[-1] in ("b", "bq", "bk", "bv", "bo", "beta"):
            t.copy_from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1)
    tm = tt.GPT(**SMALL, **kw, device="cpu")
    tt.load_singa_params(
        tm, {k: tensor.to_numpy(v) for k, v in jm.get_params().items()})
    tm.set_optimizer(OPTS[opt_name](topt))
    tm.compile([torch.from_numpy(ids)], is_train=True, use_graph=True,
               amp=amp)
    return jm, tm


def _train(jm, tm, steps=STEPS):
    ids, tgt = _batch()
    tx = tensor.from_numpy(ids, device=_dev())
    ty = tensor.from_numpy(tgt, device=_dev())
    jl, tl = [], []
    for _ in range(steps):
        _, loss = jm(tx, ty)
        jl.append(float(tensor.to_numpy(loss)))
        logits, loss = tm(torch.from_numpy(ids), torch.from_numpy(tgt))
        assert logits.shape == (B, S, 97) and logits.dtype == torch.float32
        tl.append(loss.item())
    return np.array(jl), np.array(tl)


def _assert_params_close(jm, tm, atol):
    want = {k: tensor.to_numpy(v) for k, v in jm.get_params().items()}
    got = tm.get_params()
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, atol=atol,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("variant,opt_name", [
    ("learned_mha", "sgd"), ("learned_mha", "adam"), ("rope_gqa", "sgd"),
    ("attn_bias", "sgd")])
def test_training_steps_match_jax(variant, opt_name):
    """The variants run with SGD: Adam divides each gradient by its own
    root mean square, so an entry whose gradient is near rounding noise
    moves by about +-lr on the noise's sign. The key bias is such an
    entry everywhere (q.bk shifts a whole row of scores, which softmax
    ignores: its true gradient is zero), and in the RoPE + GQA model a
    few entries of Wq are too."""
    jm, tm = _pair(opt_name, **VARIANTS[variant])
    jl, tl = _train(jm, tm)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    _assert_params_close(jm, tm, atol=1e-5)
    js, ts = jm.optimizer.get_states(), tm.optimizer.get_states()
    assert sorted(ts) == sorted(js)
    assert float(ts["step_counter"]) == float(js["step_counter"]) == STEPS
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_bf16_amp_training_close_to_jax():
    """Under amp="bfloat16" both packages round at the same cast points;
    bf16 rounding order still differs, hence 2e-2. The master weights and
    the optimizer state stay fp32."""
    jm, tm = _pair("sgd", amp="bfloat16")
    jl, tl = _train(jm, tm)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    for k, p in tm.get_params().items():
        assert p.dtype == torch.float32, k
        assert tensor.to_numpy(jm.get_params()[k]).dtype == np.float32, k
    assert all(v.dtype == np.float32
               for v in tm.optimizer.get_states().values())
    assert tag.compute_dtype is None     # restored after each call


def test_checkpoints_load_both_ways(tmp_path):
    """A port save_states zip loads into the JAX GPT and gives the port's
    logits; a JAX zip loads into the port's GPT with the same params."""
    jm, tm = _pair("sgd", attn_bias=True)
    _train(jm, tm, steps=2)
    ids, _ = _batch(seed=3)
    port_zip = os.path.join(tmp_path, "port.zip")
    tm.save_states(port_zip, aux_states={"epoch": np.int32(4)})
    j2 = models.create_model("gpt", **SMALL, attn_bias=True)
    j2.compile([tensor.from_numpy(ids, device=_dev())], is_train=False,
               use_graph=False)
    assert int(j2.load_states(port_zip)["epoch"]) == 4
    j2.eval()
    tm.eval()
    want = tensor.to_numpy(j2(tensor.from_numpy(ids, device=_dev())))
    np.testing.assert_allclose(tm(torch.from_numpy(ids)).numpy(), want,
                               atol=1e-4, rtol=1e-4)

    jax_zip = os.path.join(tmp_path, "jax.zip")
    jm.save_states(jax_zip)
    t2 = tt.GPT(**SMALL, attn_bias=True, device="cpu", seed=9)
    assert t2.load_states(jax_zip) == {}
    for k, v in jm.get_params().items():
        np.testing.assert_array_equal(
            t2.get_params()[k].numpy(), tensor.to_numpy(v))
    with pytest.raises(ValueError, match="shape"):
        t2.set_states({"head.W": np.zeros((3, 3), np.float32)})


def test_generate_after_training_matches_jax():
    """Greedy decoding after two steps gives JAX's tokens: the decode
    memo sees the weights the optimizer changed in place."""
    jm, tm = _pair("sgd")
    prompt = np.random.RandomState(4).randint(0, 97, (2, 5)).astype(np.int32)
    before = tserving.decode_state(tm, None)
    _train(jm, tm, steps=2)
    after = tserving.decode_state(tm, None)
    assert after is not before
    assert torch.equal(after["head"], tm.head.W.detach())
    jm.eval()
    tm.eval()
    np.testing.assert_array_equal(tm.generate(prompt, 10),
                                  jm.generate(prompt, 10))


def test_model_modes_and_errors():
    """A new model is in eval mode; train()/eval() recurse like
    nn.Module's, return the model and set autograd.training; training
    before compile raises; backward yields (param, grad) pairs."""
    tm = tt.GPT(**SMALL, device="cpu")
    ids, tgt = _batch()
    assert not tm.training and not tm.blocks[0].attn.training
    with pytest.raises(RuntimeError, match="compile"):
        tm.train()(torch.from_numpy(ids), torch.from_numpy(tgt))
    assert tm.blocks[1].ln2.training and tag.training
    assert tm.eval() is tm and not tag.training
    assert tm(torch.from_numpy(ids)).grad_fn is None
    tm.train()
    loss = tm.sce(tm.forward(torch.from_numpy(ids)).reshape(-1, 97),
                  torch.from_numpy(tgt).reshape(-1).long())
    pairs = list(tag.backward(loss))
    assert {id(p) for p, _ in pairs} == {id(p) for p in tm.parameters()}
    assert all(g.shape == p.shape for p, g in pairs)
    tm.eval()
