"""Port parity, GPT serving: a tiny GPT built in JAX, carried into
singa_tpu_torch with load_singa_params (and through a save_states zip),
gives the same full-forward logits, prefill logits and caches,
teacher-forced token_step logits, and IDENTICAL greedy generate tokens.
Three variants: learned positions + MHA, RoPE + GQA, attention biases."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singa_tpu import device, models, serving as jserving, tensor
from singa_tpu_torch import serving as tserving
from singa_tpu_torch.models import transformer as tt

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(vocab_size=97, max_seq=64, dim=64, num_heads=4, num_layers=2)
VARIANTS = {
    "learned_mha": dict(),
    "rope_gqa": dict(num_kv_heads=2, pos_encoding="rope"),
    "attn_bias": dict(attn_bias=True),
}


def _jax_gpt(**kw):
    m = models.create_model("gpt", **SMALL, **kw)
    ids = np.random.RandomState(0).randint(0, 97, (2, 8)).astype(np.int32)
    m.compile([tensor.from_numpy(ids, device=device.best_device())],
              is_train=False, use_graph=False)
    m.eval()
    # nonzero biases, so a dropped or misplaced bias shows
    rng = np.random.RandomState(1)
    for name, t in m.get_params().items():
        if name.split(".")[-1] in ("b", "bq", "bk", "bv", "bo", "beta"):
            t.copy_from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1)
    return m


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    kw = VARIANTS[request.param]
    jm = _jax_gpt(**kw)
    tm = tt.GPT(**SMALL, **kw, device="cpu")
    tt.load_singa_params(
        tm, {k: tensor.to_numpy(v) for k, v in jm.get_params().items()})
    return jm, tm


def test_full_forward_logits_match(pair):
    jm, tm = pair
    x = np.random.RandomState(2).randint(0, 97, (2, 37)).astype(np.int32)
    want = tensor.to_numpy(jm(tensor.from_numpy(
        x, device=device.best_device())))
    got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_and_token_steps_match(pair):
    """Prefill logits and head-packed caches, then 5 teacher-forced
    token_steps, against the JAX decode core on the same weights."""
    jm, tm = pair
    B, S0, steps = 2, 11, 5
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, 97, (B, S0)).astype(np.int32)
    feed = rng.randint(0, 97, (B, steps)).astype(np.int32)
    jc = jserving._decode_core(jm, S0, steps)
    tc = tserving._decode_core(tm, S0, steps)
    jp = jserving.decode_state(jm, None)
    tp = tserving.decode_state(tm, None)
    jl, jcache = jc.prefill(jp, jnp.asarray(prompt), B)
    tl, tcache = tc.prefill(tp, torch.from_numpy(prompt).long(), B)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for (jk, jv), (tk, tv) in zip(jcache, tcache):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    for i in range(steps):
        jl, jcache = jc.token_step(jp, jnp.asarray(feed[:, i]), jcache,
                                   jnp.int32(i), B)
        tl, tcache = tc.token_step(tp, torch.from_numpy(feed[:, i]).long(),
                                   tcache, i, B)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_greedy_generate_tokens_identical(pair):
    jm, tm = pair
    prompt = np.random.RandomState(4).randint(0, 97, (2, 5)).astype(np.int32)
    want = jm.generate(prompt, 14)
    got = tm.generate(prompt, 14)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_save_states_zip_bridge(tmp_path):
    """load_singa_states reads a JAX Model.save_states zip: the same
    params, so the same greedy tokens."""
    jm = _jax_gpt(attn_bias=True)
    path = os.path.join(tmp_path, "gpt.zip")
    jm.save_states(path)
    tm = tt.GPT(**SMALL, attn_bias=True, device="cpu", seed=5)
    tt.load_singa_states(tm, path)
    own = dict(tm.named_parameters())
    for k, v in jm.get_params().items():
        np.testing.assert_array_equal(own[tt._port_name(k)].detach().numpy(),
                                      tensor.to_numpy(v))
    prompt = np.arange(6, dtype=np.int32)[None, :] % 97
    np.testing.assert_array_equal(tm.generate(prompt, 8),
                                  jm.generate(prompt, 8))


def test_load_singa_params_rejects_bad_input():
    jm = _jax_gpt()
    params = {k: tensor.to_numpy(v) for k, v in jm.get_params().items()}
    tm = tt.GPT(**SMALL, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        tt.load_singa_params(tm, {k: v for k, v in params.items()
                                  if k != "ln_f.beta"})
    bad = dict(params)
    bad["head.W"] = bad["head.W"].T
    with pytest.raises(ValueError, match="shape"):
        tt.load_singa_params(tm, bad)


def test_pack_q_unpack_o_match_jax():
    """_pack_q/_unpack_o index with two SEPARATED index arrays, whose
    broadcast dimension goes first in numpy, JAX and torch alike; held
    here at D=64 (P=2) with GQA (G=2), where packing is not trivial."""
    H, E, Hkv, n = 8, 512, 4, 3
    jc = jserving._DecodeCore(H, E, 4, 8, 0.125, kv_heads=Hkv)
    tc = tserving._DecodeCore(H, E, 4, 8, 0.125, kv_heads=Hkv)
    assert (tc.P, tc.G) == (jc.P, jc.G) == (2, 2)
    rng = np.random.RandomState(5)
    q = rng.randn(n, H, E // H).astype(np.float32)
    want = np.asarray(jc._pack_q(jnp.asarray(q), n))
    np.testing.assert_array_equal(tc._pack_q(torch.from_numpy(q), n).numpy(),
                                  want)
    O2 = rng.randn(*want.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tc._unpack_o(torch.from_numpy(O2), n).numpy(),
        np.asarray(jc._unpack_o(jnp.asarray(O2), n)))
    kv = rng.randn(n, Hkv, 5, E // H).astype(np.float32)
    np.testing.assert_array_equal(
        tc._pack(torch.from_numpy(kv), n, 5).numpy(),
        np.asarray(jc._pack(jnp.asarray(kv), n, 5)))


def test_sampled_generate_is_seeded_and_in_range():
    tm = tt.GPT(**SMALL, device="cpu")
    prompt = np.array([[1, 2, 3]], np.int32)
    a = tm.generate(prompt, 10, temperature=0.8, top_k=5, seed=3)
    b = tm.generate(prompt, 10, temperature=0.8, top_k=5, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, 13) and (a >= 0).all() and (a < 97).all()
    np.testing.assert_array_equal(a[:, :3], prompt)


def test_bf16_generate_close_to_fp32():
    """bf16 decoding runs end to end; its first greedy token matches the
    fp32 decode's on this tiny model."""
    tm = tt.GPT(**SMALL, device="cpu")
    prompt = np.random.RandomState(6).randint(0, 97, (2, 9)).astype(np.int32)
    b = tm.generate(prompt, 4, dtype="bfloat16")
    f = tm.generate(prompt, 4)
    assert b.shape == f.shape == (2, 13)
    np.testing.assert_array_equal(b[:, 9], f[:, 9])
    with pytest.raises(ValueError, match="serving dtype"):
        tm.generate(prompt, 2, dtype="float16")


def test_decode_state_memo_follows_weight_changes():
    tm = tt.GPT(**SMALL, device="cpu")
    p1 = tserving.decode_state(tm, None)
    assert tserving.decode_state(tm, None) is p1
    with torch.no_grad():
        tm.ln_f.gamma.mul_(2.0)
    p2 = tserving.decode_state(tm, None)
    assert p2 is not p1
    assert torch.equal(p2["gf"], tm.ln_f.gamma)


def test_gpt_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: GPT() resolves to it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tt.GPT(**SMALL)


def test_port_imports_neither_jax_nor_singa_tpu():
    """A fresh interpreter importing every module of the port holds no
    jax and no singa_tpu module afterwards, nor PIL (image_tool imports
    it at first use: the card's host has none)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import singa_tpu_torch, singa_tpu_torch.device, "
        "singa_tpu_torch.autograd, singa_tpu_torch.layer, "
        "singa_tpu_torch.serving, singa_tpu_torch.engine, "
        "singa_tpu_torch.opt, singa_tpu_torch.model, "
        "singa_tpu_torch.models, singa_tpu_torch.models.transformer, "
        "singa_tpu_torch.ops, singa_tpu_torch.ops.attention, "
        "singa_tpu_torch.ops._build, singa_tpu_torch.tensor, "
        "singa_tpu_torch.initializer, singa_tpu_torch.models.base, "
        "singa_tpu_torch.models.mlp, singa_tpu_torch.models.cnn, "
        "singa_tpu_torch.models.alexnet, singa_tpu_torch.models.resnet, "
        "singa_tpu_torch.models.xceptionnet, singa_tpu_torch.data, "
        "singa_tpu_torch.io, singa_tpu_torch.snapshot, "
        "singa_tpu_torch.overlap, singa_tpu_torch.native, "
        "singa_tpu_torch.introspect, singa_tpu_torch.parallel, "
        "singa_tpu_torch.parallel.moe, singa_tpu_torch.ops.rnn, "
        "singa_tpu_torch.utils, singa_tpu_torch.sonnx, "
        "singa_tpu_torch.sonnx.onnx_pb, singa_tpu_torch.sonnx.frontend, "
        "singa_tpu_torch.sonnx.backend, singa_tpu_torch.sonnx.interop, "
        "singa_tpu_torch.observe, singa_tpu_torch.config, "
        "singa_tpu_torch.channel, singa_tpu_torch.image_tool, "
        "singa_tpu_torch.slo, singa_tpu_torch.health, "
        "singa_tpu_torch.resilience, singa_tpu_torch.watchdog, "
        "singa_tpu_torch.memory, singa_tpu_torch.goodput, "
        "singa_tpu_torch.distributed, singa_tpu_torch.parallel.mesh, "
        "singa_tpu_torch.parallel.communicator, singa_tpu_torch.diag, "
        "singa_tpu_torch.fleet, singa_tpu_torch.router, "
        "singa_tpu_torch.capacity, singa_tpu_torch.audit, "
        "singa_tpu_torch.xprof, singa_tpu_torch.regress, "
        "singa_tpu_torch.warmstart\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'singa_tpu' or "
        "m.startswith('singa_tpu.') or m == 'PIL']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, (r.stdout, r.stderr)
