"""Port parity, MoE-GPT serving: a tiny MoE-GPT (4 experts, top-2) built
in JAX and carried into singa_tpu_torch decodes the JAX package's greedy
tokens exactly in fp32, where routes drop (the layers' capacity factor
1.25: a decode step of 3 rows gives each expert one slot) and where none
do (moe_capacity_factor = E):

- `generate` over fp, int8 and int4 KV caches; teacher-forced logits of
  the int8-weight tree taken to fp32 (1e-5; the MoE weights stay bf16,
  only the dense matrices quantize);
- teacher-forced paged steps with an inactive slot, whose row takes
  capacity too;
- `generate_beam`, speculative `generate` with a clone draft;
- the engine (3 slots, prompts padded to their buckets, inactive slots),
  every request queued before the decode thread starts so both packages
  batch the same rows at every step; the speculative engine against
  JAX's greedy tokens where nothing drops;
- at moe_capacity_factor = E, one beam and speculative decoding equal
  greedy; at 1.25 they need not, as a verify step routes n * (k + 1)
  rows at once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import device, engine as jengine, models, serving as jserving
from singa_tpu import tensor
from singa_tpu_torch import engine as tengine
from singa_tpu_torch import serving as tserving
from singa_tpu_torch.models import transformer as tt

torch.set_num_threads(2)
E = 4
CFG = dict(vocab_size=97, max_seq=64, dim=64, num_heads=4, num_layers=2,
           moe_experts=E, moe_k=2)
CFS = [None, float(E)]
CF_IDS = ["cf_layer", "cf_E"]
SPECS = [(5, 6), (16, 9), (1, 4), (17, 12), (8, 1), (30, 13)]


def _jax_gpt(seed):
    device.best_device().SetRandSeed(seed)
    m = models.create_model("gpt", **CFG)
    ids = np.random.RandomState(0).randint(0, 97, (2, 8)).astype(np.int32)
    m.compile([tensor.from_numpy(ids, device=device.best_device())],
              is_train=False, use_graph=False)
    m.eval()
    return m


@pytest.fixture(scope="module")
def models4():
    """(JAX target, port target, JAX clone, port clone): the clones hold
    the target's weights in models of their own."""
    jm = _jax_gpt(0)
    params = {k: tensor.to_numpy(v) for k, v in jm.get_params().items()}
    jc = _jax_gpt(1)
    for k, v in jc.get_params().items():
        v.copy_from_numpy(params[k])
    tm, tc = (tt.GPT(**CFG, device="cpu", seed=s) for s in (0, 1))
    for m in (tm, tc):
        tt.load_singa_params(m, params)
    return jm, tm, jc, tc


def _prompt(seed=5, n=3, s0=9):
    return np.random.RandomState(seed).randint(0, 97, (n, s0)).astype(
        np.int32)


@pytest.mark.parametrize("kvd", [None, "int8", "int4"])
@pytest.mark.parametrize("cf", CFS, ids=CF_IDS)
def test_moe_generate_matches_jax(models4, cf, kvd):
    jm, tm = models4[:2]
    p = _prompt()
    want = np.asarray(jm.generate(p, 12, moe_capacity_factor=cf,
                                  kv_dtype=kvd))
    np.testing.assert_array_equal(
        tm.generate(p, 12, moe_capacity_factor=cf, kv_dtype=kvd), want)


def test_moe_capacity_factor_changes_tokens_and_memo(models4):
    """The override reaches the decode (the tokens move once routes stop
    dropping) and keys the decode memo."""
    tm = models4[1]
    p = _prompt(seed=6)
    a = tm.generate(p, 12)
    b = tm.generate(p, 12, moe_capacity_factor=float(E))
    assert not np.array_equal(a, b)
    sigs = [s for s in tm._decode_cache if s[0] == 3]
    assert {s[6] for s in sigs} >= {None, float(E)}


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def test_moe_int8_weights_keep_experts_bf16_and_match_jax(models4):
    """`dtype="int8"` quantizes the dense matrices only; the MoE weights
    stay bf16. Teacher-forced logits (prefill + 5 steps) of the two
    packages' int8 trees taken to fp32 agree within 1e-5."""
    jm, tm = models4[:2]
    t8 = tserving.decode_state(tm, "int8")
    blk = t8["blocks"][0]
    assert isinstance(blk["Wqkv"], dict) and "W1" not in blk
    assert all(blk[k].dtype == torch.bfloat16
               for k in ("moeWg", "moeW1", "moeb1", "moeW2", "moeb2"))
    n, S0, new = 3, 8, 6
    ids = np.random.RandomState(7).randint(0, 97, (n, S0 + new)).astype(
        np.int32)
    tc = tserving._decode_core(tm, S0, new)
    p = _f32(t8)
    lg, c = tc.prefill(p, torch.from_numpy(ids[:, :S0]).long(), n)
    got = [lg]
    for i in range(new - 1):
        lg, c = tc.token_step(p, torch.from_numpy(ids[:, S0 + i]).long(), c,
                              i, n)
        got.append(lg)
    j8 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        jserving.decode_state(jm, "int8"))
    jc = jserving._decode_core(jm, S0, new)
    lg, c = jc.prefill(j8, jnp.asarray(ids[:, :S0]), n)
    want = [np.asarray(lg)]
    for i in range(new - 1):
        lg, c = jc.token_step(j8, jnp.asarray(ids[:, S0 + i]), c,
                              jnp.int32(i), n)
        want.append(np.asarray(lg))
    np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                               np.stack(want, 1), atol=1e-5, rtol=1e-5)
    assert tm.generate(_prompt(), 4, dtype="int8").shape == (3, 13)


@pytest.mark.parametrize("cf", CFS, ids=CF_IDS)
def test_moe_paged_token_step_matches_jax(models4, cf):
    """Teacher-forced paged steps on ragged slots, one inactive: its row
    routes too and takes capacity in both packages."""
    jm, tm = models4[:2]
    n, ps, n_pages, T = 3, 8, 12, 32
    jc = jserving._decode_core(jm, 0, T, cf)
    tc = tserving._decode_core(tm, 0, T, cf)
    jp, tp = jserving.decode_state(jm, None), tserving.decode_state(tm, None)
    rng = np.random.RandomState(2)
    shape = (n_pages, tc.Hkv // tc.P, ps, tc.P * (tc.E // tc.H))
    pools = [tuple(rng.randn(*shape).astype(np.float32) for _ in range(2))
             for _ in range(2)]
    jpools = [tuple(jnp.asarray(a) for a in kv) for kv in pools]
    tpools = [tuple(torch.from_numpy(a.copy()) for a in kv) for kv in pools]
    pt = rng.permutation(n_pages).reshape(n, 4).astype(np.int32)
    lens = np.array([3, 9, 20], np.int32)
    active = np.array([True, False, True])
    for _ in range(3):
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
        lens = np.where(active, lens + 1, lens).astype(np.int32)


@pytest.mark.parametrize("cf", CFS, ids=CF_IDS)
def test_moe_generate_beam_matches_jax(models4, cf):
    jm, tm = models4[:2]
    p = _prompt(seed=8, n=2)
    want, wscore = jm.generate_beam(p, 8, num_beams=3, eos_id=5,
                                    return_scores=True,
                                    moe_capacity_factor=cf)
    got, score = tm.generate_beam(p, 8, num_beams=3, eos_id=5,
                                  return_scores=True,
                                  moe_capacity_factor=cf)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(score, np.asarray(wscore), rtol=1e-5)


@pytest.mark.parametrize("cf", CFS, ids=CF_IDS)
def test_moe_spec_generate_matches_jax(models4, cf):
    jm, tm, jc, tc = models4
    p = _prompt(seed=9, n=2, s0=11)
    want = np.asarray(jm.generate(p, 17, draft_model=jc, spec_k=3,
                                  moe_capacity_factor=cf))
    got = tm.generate(p, 17, draft_model=tc, spec_k=3,
                      moe_capacity_factor=cf)
    np.testing.assert_array_equal(got, want)
    assert tm.spec_stats["rounds"] > 0


def test_moe_identities_where_nothing_drops(models4):
    """At moe_capacity_factor = E: one beam and speculative decoding
    (the clone draft, int4 cache too) equal greedy."""
    tm, tc = models4[1], models4[3]
    p = _prompt(seed=10, n=2, s0=11)
    cf = float(E)
    greedy = tm.generate(p, 14, moe_capacity_factor=cf)
    np.testing.assert_array_equal(
        tm.generate_beam(p, 14, num_beams=1, moe_capacity_factor=cf), greedy)
    np.testing.assert_array_equal(
        tm.generate(p, 14, draft_model=tc, spec_k=3, moe_capacity_factor=cf),
        greedy)
    np.testing.assert_array_equal(
        tm.generate(p, 14, draft_model=tc, spec_k=4, kv_dtype="int4",
                    moe_capacity_factor=cf),
        tm.generate(p, 14, kv_dtype="int4", moe_capacity_factor=cf))


def _serve(eng_mod, e, reqs_in):
    """Queue every request, then start the decode thread: the admission
    order and each step's rows are then the same in both packages."""
    reqs = [eng_mod.EngineRequest(i, np.asarray(p, np.int32), mn, None, None)
            for i, (p, mn) in enumerate(reqs_in)]
    e._queue.extend(reqs)
    e.start()
    try:
        for r in reqs:
            assert r.wait(300), f"request {r.id} never finished"
    finally:
        e.stop()
    return reqs


@pytest.mark.parametrize("cf", CFS, ids=CF_IDS)
def test_moe_engine_matches_jax_engine(models4, cf):
    jm, tm = models4[:2]
    rng = np.random.RandomState(1)
    reqs_in = [(rng.randint(0, 97, (s0,)), mn) for s0, mn in SPECS]
    kw = dict(max_slots=3, page_size=8, max_ctx=64, steps_per_sync=4,
              moe_capacity_factor=cf)
    want = _serve(jengine, jengine.ServingEngine(jm, **kw), reqs_in)
    got = _serve(tengine, tengine.ServingEngine(tm, **kw), reqs_in)
    for w, g, (_, mn) in zip(want, got, reqs_in):
        assert g.outcome == w.outcome == "completed"
        assert len(g.tokens) == mn
        np.testing.assert_array_equal(g.result(), w.result())


def test_moe_spec_engine_equals_greedy_where_nothing_drops(models4):
    """The speculative engine with the clone draft at moe_capacity_factor
    = E gives each request the JAX package's greedy `generate` tokens.
    (The JAX spec engine is no reference here: an inactive slot's verify
    rows attend over nothing and come out NaN, and its one-hot dispatch
    einsum, 0 * NaN, spreads them to every row of the step; the port's
    index dispatch keeps a row's values in that row. ROADMAP.md, Queue
    3.)"""
    jm, tm, _, tc = models4
    rng = np.random.RandomState(1)
    reqs_in = [(rng.randint(0, 97, (s0,)), mn) for s0, mn in SPECS]
    cf = float(E)
    got = _serve(tengine, tengine.ServingEngine(
        tm, max_slots=3, page_size=8, max_ctx=64, steps_per_sync=4,
        moe_capacity_factor=cf, draft_model=tc, spec_k=3), reqs_in)
    for g, (p, mn) in zip(got, reqs_in):
        assert g.outcome == "completed" and len(g.tokens) == mn
        want = jm.generate(p[None, :].astype(np.int32), mn,
                           moe_capacity_factor=cf)[0]
        np.testing.assert_array_equal(g.result(), np.asarray(want))
