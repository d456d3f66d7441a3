"""Port parity, quantized and speculative serving: tiny GPTs built in JAX
and carried into singa_tpu_torch with load_singa_params give the JAX
package's quantized bytes (`_quant_kv`, `_quant8`), verify-step logits and
caches, greedy tokens under int8/int4 KV caches and int8 weights,
teacher-forced int8-weight logits, speculative tokens (a clone draft,
acceptance ~1, and a small random draft, acceptance ~0; memoized by the
draft's configuration), and beam-search ids and scores; the CPU engine
with int4 pools and a draft decodes plain greedy's tokens, eos included,
and its verify writes past a slot's reserved pages touch no other slot's
page. Two configs: tests/test_spec.py's rope + GQA, and learned positions
+ MHA with attention biases."""

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
BASE = dict(vocab_size=97, max_seq=96, dim=64, num_heads=4, num_layers=2)
CONFIGS = {
    "rope_gqa": dict(num_kv_heads=2, pos_encoding="rope"),
    "learned_mha_bias": dict(attn_bias=True),
}
DRAFT = dict(vocab_size=97, max_seq=96, dim=32, num_heads=2, num_layers=1,
             pos_encoding="rope")
KV = (None, "int8", "int4")


def _jax_gpt(cfg, seed):
    """A JAX GPT whose every weight comes from RandomState(seed) (the
    package's own initializers draw from process-wide state, and the
    quantized comparisons should see the same weights in every run):
    matrices N(0, 1/fan_in), LayerNorm gains 1 + N(0, 0.1^2), biases and
    shifts N(0, 0.1^2)."""
    m = models.create_model("gpt", **cfg)
    ids = np.random.RandomState(0).randint(0, 97, (2, 8)).astype(np.int32)
    m.compile([tensor.from_numpy(ids, device=device.best_device())],
              is_train=False, use_graph=False)
    m.eval()
    rng = np.random.RandomState(seed)
    for name, t in sorted(m.get_params().items()):
        w = rng.randn(*t.shape)
        if len(t.shape) == 2:
            w = w / np.sqrt(t.shape[0])
        else:
            w = w * 0.1 + (name.endswith("gamma"))
        t.copy_from_numpy(w.astype(np.float32))
    return m


def _port(jm, cfg):
    tm = tt.GPT(**cfg, device="cpu")
    tt.load_singa_params(
        tm, {k: tensor.to_numpy(v) for k, v in jm.get_params().items()})
    return tm


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models4(request):
    """(JAX target, port target, JAX/port clone draft, JAX/port random
    draft): the clone holds the target's weights, loaded into a model of
    its own."""
    cfg = dict(BASE, **CONFIGS[request.param])
    jm = _jax_gpt(cfg, 3)
    params = {k: tensor.to_numpy(v) for k, v in jm.get_params().items()}
    jclone = _jax_gpt(cfg, 4)
    for k, v in jclone.get_params().items():
        v.copy_from_numpy(params[k])
    jrand = _jax_gpt(DRAFT, 9)
    return (jm, _port(jm, cfg), (jclone, _port(jclone, cfg)),
            (jrand, _port(jrand, DRAFT)))


def _np(t):
    return t.detach().cpu().numpy()


def test_quant_kv_and_quant8_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    kv = (rng.randn(3, 4, 5, 32) * rng.rand(3, 4, 5, 1) * 3).astype(
        np.float32)
    kv[0, 0, 0] = 0.0                      # the 1e-8 floor
    kv[1, 1, 1] = 0.5                      # exact halves: round to even
    for kvd in ("int8", "int4"):
        jc = jserving._DecodeCore(4, 128, 4, 8, 0.25, kv_heads=4,
                                  kv_dtype=kvd)
        tc = tserving._DecodeCore(4, 128, 4, 8, 0.25, kv_heads=4,
                                  kv_dtype=kvd)
        assert tc.P == jc.P == 4
        jq, js = jc._quant_kv(jnp.asarray(kv), 3, 5)
        tq, ts = tc._quant_kv(torch.from_numpy(kv), 3, 5)
        assert _np(tq).dtype == np.asarray(jq).dtype
        np.testing.assert_array_equal(_np(tq), np.asarray(jq))
        np.testing.assert_array_equal(_np(ts), np.asarray(js))
    W = (rng.randn(64, 48) * rng.rand(1, 48)).astype(np.float32)
    W[:, 0] = 0.0
    W[3, 1] = np.abs(W[:, 1]).max() / 127.0 * 2.5
    jw, tw = jserving._quant8(jnp.asarray(W)), tserving._quant8(
        torch.from_numpy(W))
    np.testing.assert_array_equal(_np(tw["q8"]), np.asarray(jw["q8"]))
    np.testing.assert_array_equal(_np(tw["sc"]), np.asarray(jw["sc"]))


def _ints(a):
    """Cache bytes as their integer values (int4 nibbles unpacked)."""
    a = np.asarray(a)
    if a.dtype == np.uint8:
        a = _np(ta.nibble_unpack(torch.from_numpy(a.copy()), torch.int32))
    return a.astype(np.int32)


def _caches_close(tcache, jcache):
    """Caches against the JAX package's after the same steps: fp rows and
    scales within 1e-5; quantized values within one step. The quantizer
    is bit-equal on equal inputs (test_quant_kv_and_quant8_...), but the
    K/V that reach it differ here by fp32 rounding between XLA's and
    torch's products, so a value on a rounding boundary may land one
    step apart."""
    import jax
    for a, b in zip(tserving.tree_leaves(tcache),
                    jax.tree_util.tree_leaves(jcache)):
        if a.dtype in (torch.int8, torch.uint8):
            assert np.abs(_ints(_np(a)) - _ints(b)).max() <= 1
        else:
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("kvd", KV)
def test_verify_step_matches_jax(models4, kvd):
    """Dense verify_step (k = 4, one inactive row, one row whose last
    positions pass the cache) against the JAX core: logits at atol 1e-5
    on the positions that commit, caches as _caches_close says."""
    jm, tm = models4[:2]
    n, S0, k, new = 3, 8, 4, 12
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, 97, (n, S0)).astype(np.int32)
    toks = rng.randint(0, 97, (n, k)).astype(np.int32)
    pos = np.array([S0, S0 + 3, S0 + new - 2], np.int32)
    active = np.array([True, False, True])
    jc = jserving._decode_core(jm, S0, new, kv_dtype=kvd)
    tc = tserving._decode_core(tm, S0, new, kv_dtype=kvd)
    jp, tp = jserving.decode_state(jm, None), tserving.decode_state(tm, None)
    _, jcache = jc.prefill(jp, jnp.asarray(prompt), n)
    _, tcache = tc.prefill(tp, torch.from_numpy(prompt).long(), n)
    _caches_close(tcache, jcache)
    jl, jcache = jc.verify_step(jp, jnp.asarray(toks), jcache,
                                jnp.asarray(pos), jnp.asarray(active), n, k,
                                use_kernel=False)
    tl, tcache = tc.verify_step(tp, torch.from_numpy(toks).long(), tcache,
                                torch.from_numpy(pos),
                                torch.from_numpy(active), n, k)
    jl, tl = np.asarray(jl), _np(tl)
    # row 2's last two tokens sit past T = S0 + new: written nowhere,
    # their outputs discarded by the caller
    for i, upto in ((0, k), (2, 2)):
        np.testing.assert_allclose(tl[i, :upto], jl[i, :upto], atol=1e-5,
                                   rtol=1e-5)
    _caches_close(tcache, jcache)


@pytest.mark.parametrize("kvd", KV)
def test_verify_step_equals_sequential_token_steps(models4, kvd):
    """One k-token verify_step gives the k sequential token_steps'
    logits (atol 1e-5) and, quantized, bit-identical cache bytes; the
    fp32 scales (max|kv| / qmax) follow K/V rows that a batched product
    may round an ulp apart from a one-row one, so they agree to 2e-6
    relative."""
    tm = models4[1]
    n, S0, k = 2, 8, 4
    rng = np.random.RandomState(3)
    prompt = torch.from_numpy(rng.randint(0, 97, (n, S0))).long()
    toks = torch.from_numpy(rng.randint(0, 97, (n, k))).long()
    core = tserving._decode_core(tm, S0, 20, kv_dtype=kvd)
    p = tserving.decode_state(tm, None)
    _, c_seq = core.prefill(p, prompt, n)
    c_ver = tserving._tree_map(torch.clone, c_seq)
    seq = []
    for j in range(k):
        lg, c_seq = core.token_step(p, toks[:, j], c_seq, j, n)
        seq.append(_np(lg))
    vl, c_ver = core.verify_step(p, toks, c_ver,
                                 torch.full((n,), S0, dtype=torch.int32),
                                 torch.ones(n, dtype=torch.bool), n, k)
    np.testing.assert_allclose(_np(vl), np.stack(seq, axis=1), atol=1e-5)
    if kvd is not None:
        for a, b in zip(tserving.tree_leaves(c_ver),
                        tserving.tree_leaves(c_seq)):
            if a.dtype == torch.float32:
                np.testing.assert_allclose(_np(a), _np(b), rtol=2e-6,
                                           atol=0)
            else:
                assert torch.equal(a, b)


@pytest.mark.parametrize("kvd", KV)
def test_paged_verify_step_matches_jax(models4, kvd):
    """paged_verify_step (k = 3) on ragged slots, one inactive, with
    write_limits cutting one slot's last position, against the JAX
    core's on the same pools: logits at atol 1e-5 on the committed
    positions, pools as _caches_close says."""
    jm, tm = models4[:2]
    n, ps, n_pages, T, k = 3, 8, 12, 32, 3
    jc = jserving._decode_core(jm, 0, T, kv_dtype=kvd)
    tc = tserving._decode_core(tm, 0, T, kv_dtype=kvd)
    jp, tp = jserving.decode_state(jm, None), tserving.decode_state(tm, None)
    rng = np.random.RandomState(2)
    pools_t = [tc.new_cache(n_pages, ps, torch.float32, "cpu")
               for _ in range(2)]
    for t in tserving.tree_leaves(pools_t):
        if t.dtype == torch.float32:
            t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32)))
        else:
            t.copy_(torch.from_numpy(rng.randint(
                0, 120, t.shape).astype(np.int64)).to(t.dtype))
    import jax
    treedef = jax.tree_util.tree_structure(
        [tuple(tuple(s) if isinstance(s, tuple) else s for s in pool)
         for pool in pools_t])
    jpools = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(_np(t)) for t in
                  tserving.tree_leaves(pools_t)])
    pt = rng.permutation(n_pages).reshape(n, 4).astype(np.int32)
    lens = np.array([3, 9, 20], np.int32)
    active = np.array([True, False, True])
    wl = np.array([32, 32, 22], np.int32)
    toks = rng.randint(0, 97, (n, k)).astype(np.int32)
    jl, jpools = jc.paged_verify_step(
        jp, jnp.asarray(toks), jpools, jnp.asarray(pt), jnp.asarray(lens),
        jnp.asarray(active), n, ps, n_pages, k, write_limits=jnp.asarray(wl))
    tl, pools_t = tc.paged_verify_step(
        tp, torch.from_numpy(toks).long(), pools_t, torch.from_numpy(pt),
        torch.from_numpy(lens), torch.from_numpy(active), n, ps, k,
        write_limits=torch.from_numpy(wl))
    jl, tl = np.asarray(jl), _np(tl)
    for i, upto in ((0, k), (2, 2)):
        np.testing.assert_allclose(tl[i, :upto], jl[i, :upto], atol=1e-5,
                                   rtol=1e-5)
    _caches_close(pools_t, jpools)


def _jax_logits(jm, ids, S0, dtype, kvd):
    """The JAX package's logits teacher-forced on `ids` (B, S0 + new):
    (B, new, V) fp32, step i's being those that choose ids[:, S0 + i]."""
    B, new = ids.shape[0], ids.shape[1] - S0
    core = jserving._decode_core(jm, S0, new, kv_dtype=kvd)
    p = jserving.decode_state(jm, dtype)
    lg, caches = core.prefill(p, jnp.asarray(ids[:, :S0]), B)
    out = [np.asarray(lg, np.float32)]
    for i in range(new - 1):
        lg, caches = core.token_step(p, jnp.asarray(ids[:, S0 + i]), caches,
                                     jnp.int32(i), B)
        out.append(np.asarray(lg, np.float32))
    return np.stack(out, axis=1)


# the largest top-2 gap a token may part from the JAX package's greedy
# choice at: fp32 logits differ by summation order only; the bf16
# activations of int8 weights round at other places in XLA's fused
# programs and in torch's ops (teacher-forced logits differ by up to
# ~0.035 here, see test_int8_weight_logits_match_jax)
TIE = {None: 1e-4, "int8": 0.125}


@pytest.mark.parametrize("dtype,kvd", [(None, "int8"), (None, "int4"),
                                       ("int8", None)])
def test_quantized_greedy_tokens_match_jax(models4, dtype, kvd):
    """Greedy tokens equal the JAX package's, up to ties. Every generated
    token is held against the JAX logits teacher-forced on the port's own
    tokens: it is their argmax, or, where their top-2 gap is below
    TIE[dtype] (a tie within the frameworks' rounding), the runner-up.
    Where a sequence first parts from JAX's `generate`, the two tokens
    are that position's top two and the gap is below TIE[dtype] (in bf16
    JAX's compiled decode and its eager steps may pick either)."""
    jm, tm = models4[:2]
    S0, new = 7, 10
    prompt = np.random.RandomState(4).randint(0, 97, (2, S0)).astype(
        np.int32)
    want = np.asarray(jm.generate(prompt, new, dtype=dtype, kv_dtype=kvd))
    got = tm.generate(prompt, new, dtype=dtype, kv_dtype=kvd)
    np.testing.assert_array_equal(got[:, :S0], prompt)
    lg = _jax_logits(jm, got, S0, dtype, kvd)
    for row in range(2):
        diff = np.flatnonzero(got[row, S0:] != want[row, S0:])
        for i in range(new):
            x = lg[row, i]
            top = int(np.argmax(x))
            second = int(np.argmax(np.where(np.arange(x.size) == top,
                                            -np.inf, x)))
            gap = float(x[top] - x[second])
            tok = int(got[row, S0 + i])
            if tok != top:
                assert tok == second and gap < TIE[dtype], \
                    (row, i, tok, top, second, gap)
            if diff.size and i == diff[0]:
                assert {tok, int(want[row, S0 + i])} == {top, second} \
                    and gap < TIE[dtype], (row, i, gap)


def _f32(tree):
    """A decode-param tree with every floating leaf in fp32 (the int8
    values of `_quant8` dicts stay int8)."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def test_int8_weight_logits_match_jax(models4):
    """`dtype="int8"` serves the quantized weights. Teacher-forced logits
    (prefill + 5 token steps) of the port's int8 tree against the JAX
    package's int8 tree: as served (bf16 activations) within 0.0625, four
    bf16 steps at |logit| < 4, which the bf16 tree (no quantization)
    misses; and both trees taken to fp32 (int8 values and scales as they
    are, the bf16 leaves upcast) within 1e-5, which the fp32-upcast bf16
    tree misses by over 1e-2."""
    import jax
    jm, tm = models4[:2]
    n, S0, new = 3, 8, 6
    ids = np.random.RandomState(7).randint(0, 97, (n, S0 + new)).astype(
        np.int32)
    tc = tserving._decode_core(tm, S0, new)

    def port(p):
        lg, c = tc.prefill(p, torch.from_numpy(ids[:, :S0]).long(), n)
        out = [lg.float()]
        for i in range(new - 1):
            lg, c = tc.token_step(p, torch.from_numpy(ids[:, S0 + i]).long(),
                                  c, i, n)
            out.append(lg.float())
        return _np(torch.stack(out, dim=1))

    want = _jax_logits(jm, ids, S0, "int8", None)
    t8, tb = (tserving.decode_state(tm, d) for d in ("int8", "bfloat16"))
    assert isinstance(t8["head"], dict) and t8["head"]["q8"].dtype == \
        torch.int8
    assert np.abs(port(t8) - want).max() <= 0.0625
    assert np.abs(port(tb) - want).max() > 0.0625

    # fp32 activations over the same weights
    j8 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        jserving.decode_state(jm, "int8"))
    jc = jserving._decode_core(jm, S0, new)
    lg, c = jc.prefill(j8, jnp.asarray(ids[:, :S0]), n)
    want32 = [np.asarray(lg)]
    for i in range(new - 1):
        lg, c = jc.token_step(j8, jnp.asarray(ids[:, S0 + i]), c,
                              jnp.int32(i), n)
        want32.append(np.asarray(lg))
    want32 = np.stack(want32, axis=1)
    np.testing.assert_allclose(port(_f32(t8)), want32, atol=1e-5, rtol=1e-5)
    assert np.abs(port(_f32(tb)) - want32).max() > 1e-2


@pytest.mark.parametrize("draft", ["clone", "random"])
def test_spec_generate_matches_jax_and_greedy(models4, draft):
    """Speculative generate equals the JAX package's spec generate and
    the port's own greedy, token for token; the clone accepts
    everything, the random draft (almost) nothing. The clone also runs
    on an int4 cache against greedy int4."""
    jm, tm = models4[:2]
    jd, td = models4[2] if draft == "clone" else models4[3]
    prompt = np.random.RandomState(5).randint(0, 97, (2, 11)).astype(
        np.int32)
    greedy = tm.generate(prompt, 17)
    got = tm.generate(prompt, 17, draft_model=td, spec_k=3)
    np.testing.assert_array_equal(got, greedy)
    np.testing.assert_array_equal(
        got, np.asarray(jm.generate(prompt, 17, draft_model=jd, spec_k=3)))
    st = tm.spec_stats
    assert 0 < st["drafted"] <= 3 * 2 * st["rounds"]
    assert st["accepted"] + st["bonus"] == 2 * 16     # after the first
    rate = st["accepted"] / st["drafted"]
    assert rate > 0.8 if draft == "clone" else rate < 0.5
    if draft == "clone":
        np.testing.assert_array_equal(
            tm.generate(prompt, 17, kv_dtype="int4", draft_model=td,
                        spec_k=4),
            tm.generate(prompt, 17, kv_dtype="int4"))


def test_spec_decode_memo_keys_on_the_draft_config(models4):
    """The speculative decode fn is memoized by the draft's
    configuration, not by the draft object: another draft of the same
    configuration reuses it, one of another configuration gets its own,
    and each decodes greedy's tokens."""
    tm, (_, td), (_, tr) = models4[1], models4[2], models4[3]
    prompt = np.random.RandomState(8).randint(0, 97, (2, 6)).astype(
        np.int32)
    greedy = tm.generate(prompt, 9)

    def spec_fns():
        return {k for k in tm._decode_cache if k[0] == "spec"}

    before = spec_fns()
    twin = tt.GPT(td.vocab_size, max_seq=td.max_seq, dim=td.dim,
                  num_heads=td.num_heads, num_layers=len(td.blocks),
                  attn_bias=td.blocks[0].attn.use_bias,
                  num_kv_heads=td.num_kv_heads,
                  pos_encoding=td.pos_encoding, device="cpu", seed=11)
    for draft, grows in ((td, 1), (twin, 0), (tr, 1)):
        n = len(spec_fns())
        np.testing.assert_array_equal(
            tm.generate(prompt, 9, draft_model=draft, spec_k=2), greedy)
        assert len(spec_fns()) == n + grows
    assert len(spec_fns()) == len(before) + 2


def test_spec_generate_rejects_bad_config(models4):
    tm, (_, td) = models4[1], models4[2]
    p = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="greedy-only"):
        tm.generate(p, 4, temperature=0.7, draft_model=td, spec_k=2)
    with pytest.raises(ValueError, match="draft_model"):
        tm.generate(p, 4, spec_k=2)
    small = tt.GPT(**dict(DRAFT, vocab_size=50), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        tm.generate(p, 4, draft_model=small, spec_k=2)
    with pytest.raises(ValueError, match="kv_dtype"):
        tm.generate(p, 4, kv_dtype="nf4")


@pytest.mark.parametrize("eos_id,kvd", [(None, None), (5, None),
                                        (None, "int4")])
def test_generate_beam_matches_jax(models4, eos_id, kvd):
    jm, tm = models4[:2]
    prompt = np.random.RandomState(6).randint(0, 97, (2, 9)).astype(np.int32)
    kw = dict(num_beams=3, eos_id=eos_id, kv_dtype=kvd, return_scores=True)
    jids, jsc = jm.generate_beam(prompt, 6, **kw)
    tids, tsc = tm.generate_beam(prompt, 6, **kw)
    np.testing.assert_array_equal(tids, np.asarray(jids))
    np.testing.assert_allclose(tsc, np.asarray(jsc), rtol=1e-5)
    if eos_id is None and kvd is None:
        # one beam is greedy
        np.testing.assert_array_equal(
            tm.generate_beam(prompt, 6, num_beams=1), tm.generate(prompt, 6))


def _serve(e, reqs_in):
    reqs = [e.submit(p, mn) for p, mn in reqs_in]
    for r in reqs:
        assert r.wait(300), f"request {r.id} never finished"
    return reqs


def test_engine_int4_spec_matches_dense_greedy(models4):
    """int4 pools and the clone draft (then the random one, fp pools):
    every request's tokens equal dense greedy's under the same kv_dtype,
    through 3 slots and continuous admission; the report carries the
    spec counts, and the int4 pool is half the int8 pool's bytes."""
    tm, (_, td), (_, tr) = models4[1], models4[2], models4[3]
    rng = np.random.RandomState(1)
    specs = [(5, 6), (16, 9), (1, 4), (17, 12), (8, 1), (30, 13)]
    reqs_in = [(rng.randint(0, 97, (s0,)), mn) for s0, mn in specs]
    for draft, kvd, picks in ((td, "int4", reqs_in), (tr, None,
                                                      reqs_in[:3])):
        e = engine.ServingEngine(tm, max_slots=3, page_size=8, max_ctx=96,
                                 steps_per_sync=2, kv_dtype=kvd,
                                 draft_model=draft, spec_k=3).start()
        try:
            reqs = _serve(e, picks)
            for (p, mn), r in zip(picks, reqs):
                assert r.outcome == "completed" and len(r.tokens) == mn
                want = tm.generate(p[None, :].astype(np.int32), mn,
                                   kv_dtype=kvd)[0]
                np.testing.assert_array_equal(r.result(), want)
            rep = e.report()
            assert rep["pages_in_use"] == 0 and rep["spec_k"] == 3
            assert rep["kv_dtype"] == kvd and rep["spec"]["rounds"] > 0
            assert rep["spec"]["drafted"] > 0
            assert rep["spec_acceptance"] is not None
            assert e.draft_pool_bytes() > 0 and e.draft_param_bytes() > 0
        finally:
            e.stop()
    e8, e4 = (engine.ServingEngine(tm, max_slots=2, page_size=8, max_ctx=96,
                                   kv_dtype=k).start() for k in ("int8",
                                                                 "int4"))
    try:
        def split(e):
            leaves = tserving.tree_leaves(e._pools)
            return (sum(t.numel() for t in leaves if t.dtype !=
                        torch.float32),
                    sum(t.numel() * 4 for t in leaves if t.dtype ==
                        torch.float32))
        (kv8, sc8), (kv4, sc4) = split(e8), split(e4)
        assert kv8 == 2 * kv4 and sc8 == sc4
        assert e8.pool_bytes() - e4.pool_bytes() == kv4
    finally:
        e8.stop()
        e4.stop()


def test_engine_spec_eos_stops_early(models4):
    """An eos inside an accepted window stops the sequence at the eos
    token (inclusive), as the plain engine does."""
    tm, (_, td) = models4[1], models4[2]
    p = dense = j = None
    for seed in range(48):
        cand = np.random.RandomState(seed).randint(0, 97, (9,))
        out = [int(t) for t in tm.generate(cand[None, :], 8)[0][9:]]
        fresh = [i for i in range(1, len(out)) if out[i] not in out[:i]]
        if fresh:
            p, dense, j = cand, out, fresh[0]
            break
    assert p is not None, "no prompt with a mid-sequence fresh token"
    e = engine.ServingEngine(tm, max_slots=2, page_size=8, max_ctx=96,
                             eos_id=dense[j], steps_per_sync=4,
                             draft_model=td, spec_k=2, kv_dtype="int4")
    e.start()
    try:
        r = _serve(e, [(p, 8)])[0]
        assert r.outcome == "completed"
        want = [int(t) for t in tm.generate(p[None, :], 8,
                                            kv_dtype="int4")[0][9:]]
        stop = want.index(dense[j]) + 1 if dense[j] in want else 8
        assert r.tokens == want[:stop]
    finally:
        e.stop()
    with pytest.raises(ValueError, match="draft_model and spec_k"):
        engine.ServingEngine(tm, spec_k=3)
    with pytest.raises(ValueError, match="draft_model and spec_k"):
        engine.ServingEngine(tm, draft_model=td)


def test_paged_verify_writes_stay_in_reserved_pages(models4):
    """A slot whose verify positions run past its reserved pages (its
    table holds page 0 there, which another slot owns; that slot is idle
    this step) writes none of them: with write_limits the other slot's
    page stays bit-equal, and positions past the table's width are
    clamped for the lookup."""
    tm = models4[1]
    n, ps, k = 2, 8, 5
    tc = tserving._decode_core(tm, 0, 32, kv_dtype="int8")
    tp = tserving.decode_state(tm, None)
    pools = [tc.new_cache(6, ps, torch.float32, "cpu") for _ in range(2)]
    pt = torch.tensor([[3, 4, 0, 0], [0, 1, 2, 5]], dtype=torch.int32)
    # slot 0 reserved pages 3, 4: positions < 16; its verify covers 13..17
    lens = torch.tensor([13, 4], dtype=torch.int32)
    before = [t.clone() for t in tserving.tree_leaves(pools)]
    toks = torch.randint(0, 97, (n, k), generator=torch.Generator()
                         .manual_seed(0))
    _, pools = tc.paged_verify_step(
        tp, toks, pools, pt, lens, torch.tensor([True, False]), n, ps, k,
        write_limits=torch.tensor([16, 32], dtype=torch.int32))
    for a, b in zip(tserving.tree_leaves(pools), before):
        assert torch.equal(a[0], b[0])              # slot 1's page 0
        assert not torch.equal(a[4], b[4])          # slot 0 wrote its own
    # past the table's width (M * ps = 32), clamped: no error, no write
    lens = torch.tensor([30, 4], dtype=torch.int32)
    before = [t.clone() for t in tserving.tree_leaves(pools)]
    tc.paged_verify_step(tp, toks, pools, pt, lens,
                         torch.tensor([True, False]), n, ps, k,
                         write_limits=torch.tensor([16, 32],
                                                   dtype=torch.int32))
    for a, b in zip(tserving.tree_leaves(pools), before):
        assert torch.equal(a, b)


def test_engine_spec_writes_spare_the_neighbours_pages(models4):
    """Two requests fill the pool exactly: the first (14 + 2 tokens)
    holds pages 2 and 1, the second (3 + 5) page 0. The first one's
    verify round covers positions 14..18, past its two pages, where its
    table holds page 0: the second request's prompt rows. Both decode
    plain greedy's tokens, because writes past a slot's reserved
    positions are not made."""
    tm, (_, td) = models4[1], models4[2]
    rng = np.random.RandomState(9)
    reqs_in = [(rng.randint(0, 97, (14,)), 2), (rng.randint(0, 97, (3,)),
                                                5)]
    e = engine.ServingEngine(tm, max_slots=2, page_size=8, max_ctx=32,
                             num_pages=3, steps_per_sync=1, draft_model=td,
                             spec_k=4).start()
    try:
        reqs = _serve(e, reqs_in)
        assert e.report()["pages_in_use"] == 0
        for (p, mn), r in zip(reqs_in, reqs):
            assert r.outcome == "completed"
            np.testing.assert_array_equal(
                r.result(), tm.generate(p[None, :].astype(np.int32), mn)[0])
    finally:
        e.stop()
