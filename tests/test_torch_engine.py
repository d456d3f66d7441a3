"""Port parity, serving engine: singa_tpu_torch.engine.ServingEngine on a
tiny GPT carried over from JAX answers the request mix of
tests/test_engine.py with exactly the JAX package's greedy generate
tokens, frees every page, and keeps its decode thread a daemon outside
the JAX engine's `singa-serve` names. Every test stops its engine."""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singa_tpu import device, models, serving as jserving, tensor
from singa_tpu_torch import engine
from singa_tpu_torch import serving as tserving
from singa_tpu_torch.models import transformer as tt
from singa_tpu_torch.ops import attention as ta

torch.set_num_threads(2)
SMALL = dict(vocab_size=97, max_seq=64, dim=64, num_heads=4, num_layers=2)
SPECS = [(5, 6), (16, 9), (1, 4), (17, 12), (8, 1), (30, 13)]


def _pair(**kw):
    jm = models.create_model("gpt", **SMALL, **kw)
    ids = np.random.RandomState(0).randint(0, 97, (2, 8)).astype(np.int32)
    jm.compile([tensor.from_numpy(ids, device=device.best_device())],
               is_train=False, use_graph=False)
    jm.eval()
    tm = tt.GPT(**SMALL, **kw, device="cpu")
    tt.load_singa_params(
        tm, {k: tensor.to_numpy(v) for k, v in jm.get_params().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _run(e, reqs_in):
    reqs = [e.submit(p, mn) for p, mn in reqs_in]
    for r in reqs:
        assert r.wait(120), f"request {r.id} never finished"
    return reqs


@pytest.mark.parametrize("kw", [dict(), dict(num_kv_heads=2,
                                             pos_encoding="rope")],
                         ids=["learned_mha", "rope_gqa"])
def test_engine_matches_jax_generate_and_frees_pages(kw):
    jm, tm = _pair(**kw)
    ta.reset_launches()
    e = engine.ServingEngine(tm, max_slots=3, page_size=8, max_ctx=64,
                             steps_per_sync=4).start()
    try:
        th = e._thread
        assert th.daemon and not th.name.startswith("singa-serve")
        rng = np.random.RandomState(1)
        reqs_in = [(rng.randint(0, 97, (s0,)), mn) for s0, mn in SPECS]
        reqs = _run(e, reqs_in)
        for (p, mn), r in zip(reqs_in, reqs):
            assert r.outcome == "completed"
            assert len(r.tokens) == mn
            want = jm.generate(p[None, :].astype(np.int32), mn)[0]
            np.testing.assert_array_equal(r.result(), want)
            assert r.ttft_s is not None and r.ttft_s >= 0
        rep = e.report()
        assert rep["pages_in_use"] == 0
        assert sorted(e._free_pages) == list(range(e.num_pages))
        assert rep["finished"]["completed"] == len(SPECS)
    finally:
        e.stop()
    assert not th.is_alive()
    assert ta.LAUNCHES == {"flash_fwd": 0, "flash_decode": 0,
                           "paged_attention": 0}


def test_paged_token_step_matches_jax(pair):
    """Teacher-forced paged steps on ragged slots (one inactive) against
    the JAX core's paged_token_step on the same pools and page table."""
    jm, tm = pair
    n, ps, n_pages, T = 3, 8, 12, 32
    jc = jserving._decode_core(jm, 0, T)
    tc = tserving._decode_core(tm, 0, T)
    jp = jserving.decode_state(jm, None)
    tp = tserving.decode_state(tm, None)
    rng = np.random.RandomState(2)
    shape = (n_pages, tc.Hkv // tc.P, ps, tc.P * (tc.E // tc.H))
    pools_np = [(rng.randn(*shape).astype(np.float32),
                 rng.randn(*shape).astype(np.float32)) for _ in range(2)]
    jpools = [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools_np]
    tpools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
              for k, v in pools_np]
    pt = rng.permutation(n_pages).reshape(n, 4).astype(np.int32)
    lens = np.array([3, 9, 20], np.int32)
    active = np.array([True, False, True])
    for step in range(3):
        tok = rng.randint(0, 97, (n,)).astype(np.int32)
        jl, jpools = jc.paged_token_step(
            jp, jnp.asarray(tok), jpools, jnp.asarray(pt), jnp.asarray(lens),
            jnp.asarray(active), n, ps, n_pages)
        tl, tpools = tc.paged_token_step(
            tp, torch.from_numpy(tok).long(), tpools, torch.from_numpy(pt),
            torch.from_numpy(lens), torch.from_numpy(active), n, ps)
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=1e-4,
                                   rtol=1e-4)
        for (jk, jv), (tk, tv) in zip(jpools, tpools):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                       atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       atol=1e-4, rtol=1e-4)
        lens = np.where(active, lens + 1, lens).astype(np.int32)


def test_engine_eos_rejects_and_buckets(pair):
    """eos_id stops a sequence at that token; over-length and empty
    requests are rejected at submit; prompt buckets cover max_ctx - 1."""
    jm, tm = pair
    prompt = np.random.RandomState(3).randint(0, 97, (7,)).astype(np.int32)
    ref = tm.generate(prompt[None, :], 6)[0, 7:]
    eos = int(ref[2])
    stop_at = int(np.argmax(ref == eos)) + 1
    e = engine.ServingEngine(tm, max_slots=2, page_size=8, max_ctx=64,
                             steps_per_sync=2, eos_id=eos).start()
    try:
        assert e.prompt_buckets == [16, 32, 63]
        r = _run(e, [(prompt, 6)])[0]
        assert r.outcome == "completed"
        np.testing.assert_array_equal(r.tokens, ref[:stop_at])
        long = e.submit(np.zeros(60, np.int32), 10)
        empty = e.submit(np.zeros(0, np.int32), 3)
        assert long.outcome == empty.outcome == "rejected"
        assert "exceeds max_ctx" in long.detail
        with pytest.raises(RuntimeError, match="rejected"):
            long.result(1)
    finally:
        e.stop()
    late = e.submit(prompt, 2)
    assert late.outcome == "rejected" and late.detail == "engine not running"


def test_engine_use_kernel(pair):
    """use_kernel=False reaches every attention op and gives the default
    engine's tokens; use_kernel=True on a CPU model raises at
    construction instead of falling back."""
    jm, tm = pair
    rng = np.random.RandomState(5)
    reqs_in = [(rng.randint(0, 97, (s0,)), mn) for s0, mn in SPECS[:4]]
    toks = []
    for use_kernel in (None, False):
        e = engine.ServingEngine(tm, max_slots=2, page_size=8, max_ctx=64,
                                 steps_per_sync=3,
                                 use_kernel=use_kernel).start()
        try:
            reqs = _run(e, reqs_in)
            assert all(r.outcome == "completed" for r in reqs)
            toks.append([list(r.tokens) for r in reqs])
        finally:
            e.stop()
    assert toks[0] == toks[1]
    with pytest.raises(ValueError, match="use_kernel=True"):
        engine.ServingEngine(tm, max_slots=2, page_size=8, max_ctx=64,
                             use_kernel=True)


def test_engine_graceful_drain_hands_back_queue(pair):
    """stop(drain=True) finishes the seated requests, hands back the
    queued ones untouched, and joins the thread; a request whose
    submit-to-first-token deadline passed while queued times out."""
    jm, tm = pair
    e = engine.ServingEngine(tm, max_slots=1, page_size=8, max_ctx=64,
                             steps_per_sync=1)
    e.start()
    try:
        rng = np.random.RandomState(4)
        first = e.submit(rng.randint(0, 97, (6,)), 20)
        queued = [e.submit(rng.randint(0, 97, (5,)), 3) for _ in range(3)]
        expired = e.submit(rng.randint(0, 97, (5,)), 3, ttft_deadline_s=0.0)
        assert expired.wait(60) and expired.outcome == "timeout"
    finally:
        back = e.stop(drain=True)
    assert first.outcome == "completed" and len(first.tokens) == 20
    assert all(r.outcome is None or r.outcome == "completed"
               for r in queued)
    assert {r.id for r in back} == {r.id for r in queued
                                    if r.outcome is None}
    assert not e.running()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("torch-serve") and t.is_alive()]
