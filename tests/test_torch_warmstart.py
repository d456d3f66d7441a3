"""The port's warm store (singa_tpu_torch.warmstart) against the JAX
package's (singa_tpu.warmstart), on the CPU.

The cases of tests/test_warmstart.py that apply to the port: a cold build
exports its record and a warm one hits; a disabled store is a no-op;
fingerprints differ by signature and by key (and equal JAX's on equal
leaves); a truncated blob, an undecodable record and an unparseable meta
are corrupt, a fingerprint or torch-version mismatch stale, each deleted
and rebuilt; keep-last-K eviction; the metrics and the /statusz section;
the env var; a hit across a process boundary; the engine's tokens equal
with the store off, cold and warm, and a warm engine counting nothing;
prewarm building every bucket; a graph-mode train step's warm restart
repeating the cold losses bitwise.

Beyond those: the same scripted corruptions fed to both packages'
`WarmStore` classify alike; the kernel-library path (`ops/_build.py`)
with g++ building a tiny C library in place of nvcc (a test-only swap of
`_build._compile_cmd`: this machine has no nvcc), store disabled and
enabled, through corrupt, stale and unloadable entries, each rebuilt by
the compiler; and one CPU run of `router --warm-ab`, where the
compile-fraction and speedup checks do not apply (nothing is compiled).
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ab
from singa_tpu import introspect as jintrospect
from singa_tpu import warmstart as jwarm
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import diag as tdiag
from singa_tpu_torch import engine as tengine
from singa_tpu_torch import goodput as tgoodput
from singa_tpu_torch import introspect as tintrospect
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import observe as tobserve
from singa_tpu_torch import opt as topt
from singa_tpu_torch import router as trouter
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch import warmstart as twarm
from singa_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _stores():
    """Both packages' stores disabled and their build state cleared
    around each test, the port's metrics registry cleared, and its diag
    server and the goodput tracker that server installs stopped
    (tests/conftest.py resets only the JAX package's and pops
    SINGA_TPU_COMPILE_CACHE)."""
    twarm.reset()
    tintrospect.reset()
    tobserve.get_registry().reset()
    tobserve.enable(True)
    yield
    twarm.reset()
    tintrospect.reset()
    tdiag.stop_diag_server()
    tgoodput.uninstall()
    tobserve.get_registry().reset()
    jwarm.reset()


def _fn(x):
    return x * 2 + 1


def _args():
    return (torch.arange(8, dtype=torch.float32),)


def _jargs():
    return (jnp.arange(8, dtype=jnp.float32),)


# ---- store round-trip -------------------------------------------------------

def test_cold_build_exports_then_warm_build_hits(tmp_path):
    jwarm.enable(str(tmp_path / "jax"))
    twarm.enable(str(tmp_path / "port"))
    _, jrec = jintrospect.build_compiled(jax.jit(lambda x: x * 2 + 1),
                                         _jargs(), "t.fn")
    fn, rec = tintrospect.build_compiled(_fn, _args(), "t.fn")
    assert rec["warm"] == jrec["warm"] == twarm.RESULT_MISS
    # equal leaves give equal fingerprints in both packages
    assert rec["fingerprint"] == jrec["fingerprint"]
    snap = twarm.snapshot()
    assert snap["exports"] == 1 and snap["entries"] == 1
    assert snap["lookups"]["miss"] == 1 and snap["xla_cache_dir"] is None
    jintrospect.reset()
    tintrospect.reset()
    _, jrec2 = jintrospect.build_compiled(jax.jit(lambda x: x * 2 + 1),
                                          _jargs(), "t.fn")
    fn2, rec2 = tintrospect.build_compiled(_fn, _args(), "t.fn")
    assert rec2["warm"] == jrec2["warm"] == twarm.RESULT_HIT
    assert rec2["fingerprint"] == rec["fingerprint"]
    assert rec2["cost"] == rec["cost"] and rec2["memory"] == rec["memory"]
    torch.testing.assert_close(fn2(*_args()), _args()[0] * 2 + 1)
    snap = twarm.snapshot()
    assert snap["lookups"]["hit"] == 1 and snap["hit_rate"] == 0.5
    assert snap["exports"] == 1 and snap["entries"] == 1
    # load_executable's first element is the stored record
    stored, result, _s = tintrospect.load_executable("t.fn",
                                                     rec["fingerprint"])
    assert result == "hit" and stored["cost"] == rec["cost"]
    assert stored["signature"]["leaves"] == [["a0", [8], "float32"]]


def test_export_executable_counts_fn_for_args(tmp_path):
    """Without a build's record, export_executable counts `fn(*args)`
    and writes what a build would: a later build of the same signature
    hits with that cost."""
    twarm.enable(str(tmp_path / "warm"))
    args = (torch.ones(4, 8),)
    fp = tintrospect._sig_fingerprint("t.exp",
                                      tintrospect.signature(args))
    assert tintrospect.export_executable(lambda x: x @ x.T, args, "t.exp",
                                         fp) is not None
    _f, rec = tintrospect.build_compiled(lambda x: x @ x.T, args, "t.exp")
    assert rec["warm"] == "hit" and rec["fingerprint"] == fp
    assert rec["cost"]["flops"] == 2 * 4 * 8 * 4
    assert rec["memory"] == {"arguments": 4 * 8 * 4, "outputs": 4 * 4 * 4}


def test_disabled_store_is_a_clean_noop():
    assert not twarm.is_enabled()
    _fn2, rec = tintrospect.build_compiled(_fn, _args(), "t.off")
    assert rec["warm"] is None
    assert twarm.snapshot()["lookups"] == {
        "hit": 0, "miss": 0, "stale": 0, "corrupt": 0}
    assert tintrospect.load_executable("t.off", rec["fingerprint"]) \
        == (None, None, 0.0)
    assert tintrospect.export_executable(_fn, _args(), "t.off",
                                         rec["fingerprint"]) is None


def test_fingerprint_differs_by_signature_and_key():
    sig4 = tintrospect.signature((torch.zeros(4),))
    sig8 = tintrospect.signature((torch.zeros(8),))
    f = tintrospect._sig_fingerprint
    assert f("k", sig4) != f("k", sig8)
    assert f("k", sig4) != f("k2", sig4)
    jsig4 = jintrospect.signature((jnp.zeros(4, jnp.float32),))
    assert f("k", sig4) == jintrospect._sig_fingerprint("k", jsig4)


# ---- integrity fallbacks ----------------------------------------------------

def _cold(tmp_path, key):
    twarm.enable(str(tmp_path / "warm"))
    _fn2, rec = tintrospect.build_compiled(_fn, _args(), key)
    tintrospect.reset()
    return twarm.get_store(), rec


def test_truncated_blob_classifies_corrupt_and_is_replaced(tmp_path):
    store, rec = _cold(tmp_path, "t.trunc")
    bin_path, _meta = store.entry_paths("t.trunc", rec["fingerprint"])
    with open(bin_path, "rb") as f:
        blob = f.read()
    with open(bin_path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    _fn2, rec2 = tintrospect.build_compiled(_fn, _args(), "t.trunc")
    assert rec2["warm"] == twarm.RESULT_CORRUPT
    assert rec2["cost"] == rec["cost"]   # counted afresh
    snap = twarm.snapshot()
    assert snap["lookups"]["corrupt"] == 1 and snap["exports"] == 2
    _blob, result = store.load("t.trunc", rec["fingerprint"])
    assert result == twarm.RESULT_HIT


@pytest.mark.parametrize("blob", ["bytes", "signature"])
def test_undecodable_record_with_matching_sha_is_corrupt(tmp_path, blob):
    """A blob whose sha verifies but that is no record (or a record of
    another signature) is corrupt: caught at decoding, not at the sha."""
    store, rec = _cold(tmp_path, "t.deser")
    if blob == "bytes":
        data = b"not-a-record"
    else:
        stored, _r, _s = tintrospect.load_executable(
            "t.deser", rec["fingerprint"], count=False)
        stored["signature"]["leaves"][0][1] = [9]
        data = json.dumps(stored).encode()
    assert store.save("t.deser", rec["fingerprint"], data)
    _fn2, rec2 = tintrospect.build_compiled(_fn, _args(), "t.deser")
    assert rec2["warm"] == twarm.RESULT_CORRUPT
    assert twarm.snapshot()["lookups"]["corrupt"] == 1


@pytest.mark.parametrize("field,value", [("fingerprint", "0" * 16),
                                         ("torch_version", "0.0.1")])
def test_meta_mismatch_classifies_stale_and_is_replaced(tmp_path, field,
                                                        value):
    store, rec = _cold(tmp_path, "t.stale")
    _bin, meta_path = store.entry_paths("t.stale", rec["fingerprint"])
    with open(meta_path, encoding="utf-8") as f:
        meta = json.load(f)
    meta[field] = value
    with open(meta_path, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    _fn2, rec2 = tintrospect.build_compiled(_fn, _args(), "t.stale")
    assert rec2["warm"] == twarm.RESULT_STALE
    snap = twarm.snapshot()
    assert snap["lookups"]["stale"] == 1 and snap["exports"] == 2
    assert store.load("t.stale", rec["fingerprint"])[1] == twarm.RESULT_HIT


def test_unparseable_meta_classifies_corrupt(tmp_path):
    store, rec = _cold(tmp_path, "t.meta")
    _bin, meta_path = store.entry_paths("t.meta", rec["fingerprint"])
    with open(meta_path, "w", encoding="utf-8") as f:
        f.write("{not json")
    blob, result = store.load("t.meta", rec["fingerprint"])
    assert blob is None and result == twarm.RESULT_CORRUPT
    # the distrusted entry is gone: the next lookup is a plain miss
    assert store.load("t.meta", rec["fingerprint"])[1] == twarm.RESULT_MISS


# ---- the same corruptions through both packages' stores --------------------

def _edit_meta(path, **kv):
    with open(path, encoding="utf-8") as f:
        meta = json.load(f)
    meta.update(kv)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(meta, f)


def _rewrite(path, text):
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def _truncate(path):
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:3])


def _flip(path):
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[0] ^= 1
    with open(path, "wb") as f:
        f.write(bytes(data))


#: name -> (what it does to (blob path, meta path, version field), the
#: result both stores must give)
SCRIPTS = {
    "intact": (lambda b, m, v: None, "hit"),
    "truncated_blob": (lambda b, m, v: _truncate(b), "corrupt"),
    "flipped_blob": (lambda b, m, v: _flip(b), "corrupt"),
    "blob_deleted": (lambda b, m, v: os.unlink(b), "corrupt"),
    "meta_deleted": (lambda b, m, v: os.unlink(m), "corrupt"),
    "meta_unparseable": (lambda b, m, v: _rewrite(m, "{not json"),
                         "corrupt"),
    "meta_not_a_dict": (lambda b, m, v: _rewrite(m, "[1, 2]"), "corrupt"),
    "meta_fingerprint": (lambda b, m, v: _edit_meta(m, fingerprint="f" * 16),
                         "stale"),
    "meta_version": (lambda b, m, v: _edit_meta(m, **{v: "0.0.1"}),
                     "stale"),
    "both_deleted": (lambda b, m, v: (os.unlink(b), os.unlink(m)), "miss"),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_corruptions_classify_alike(tmp_path, script):
    act, want = SCRIPTS[script]
    got = {}
    for name, mod, version in (("jax", jwarm, "jax_version"),
                               ("port", twarm, "torch_version")):
        store = mod.WarmStore(str(tmp_path / name))
        assert store.save("t.script", "a" * 16, b"blob-bytes-0123")
        act(*store.entry_paths("t.script", "a" * 16), version)
        blob, got[name] = store.load("t.script", "a" * 16)
        assert (blob == b"blob-bytes-0123") == (got[name] == "hit")
        # a bad entry is deleted: the next lookup is a miss
        again = store.load("t.script", "a" * 16)[1]
        assert again == ("hit" if got[name] == "hit" else "miss")
    assert got == {"jax": want, "port": want}


# ---- eviction ---------------------------------------------------------------

def test_eviction_keeps_last_k(tmp_path):
    twarm.enable(str(tmp_path / "warm"), keep=2)
    store = twarm.get_store()
    for i in range(5):
        path = store.save("t.evict", f"{i:016x}", b"blob-%d" % i)
        assert path is not None
        os.utime(path, (i + 1, i + 1))
    n, nbytes = store.occupancy()
    assert n == 2 and nbytes > 0
    assert {e["fingerprint"] for e in store.entries()} \
        == {f"{3:016x}", f"{4:016x}"}
    store.save("t.other", "f" * 16, b"other")
    assert {e["key"] for e in store.entries()} == {"t.evict", "t.other"}
    assert len(store.manifest()) == 6


def test_concurrent_saves_of_one_entry_leave_it_whole(tmp_path):
    """Replicas sharing a store export the same keys at once: eight
    writers saving one entry together each get its path, the entry then
    verifies, and no temporary file is left beside it."""
    import threading
    twarm.enable(str(tmp_path / "warm"))
    store = twarm.get_store()
    blob = bytes(range(256)) * (1 << 14)
    go = threading.Barrier(8)
    paths = []

    def _save():
        go.wait()
        for _ in range(4):
            paths.append(store.save("t.shared", "a" * 16, blob))

    threads = [threading.Thread(target=_save) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bin_path, meta_path = store.entry_paths("t.shared", "a" * 16)
    assert paths == [bin_path] * 32
    assert store.load("t.shared", "a" * 16) == (blob, twarm.RESULT_HIT)
    assert sorted(os.listdir(os.path.dirname(bin_path))) == sorted(
        os.path.basename(p) for p in (bin_path, meta_path))


# ---- metrics / reporting ----------------------------------------------------

def test_cache_metrics_and_statusz_section(tmp_path):
    import urllib.request
    twarm.enable(str(tmp_path / "warm"))
    tintrospect.build_compiled(_fn, _args(), "t.metrics")
    tintrospect.reset()
    tintrospect.build_compiled(_fn, _args(), "t.metrics")
    text = tobserve.to_prometheus_text()
    assert 'singa_compile_cache_lookups_total{key="t.metrics",' \
        'result="hit"} 1' in text
    assert 'singa_compile_cache_lookups_total{key="t.metrics",' \
        'result="miss"} 1' in text
    assert 'singa_compile_cache_exports_total{key="t.metrics"} 1' in text
    assert "singa_compile_cache_entries 1" in text
    assert "singa_compile_cache_store_bytes" in text
    assert "singa_compile_cache_load_seconds" in text
    rep = twarm.warm_report()
    assert "== warm start ==" in rep and "hit 1" in rep
    assert "xla persistent cache: none" in rep
    srv = tdiag.start_diag_server(port=0)
    try:
        body = urllib.request.urlopen(
            srv.url + "/statusz", timeout=10).read().decode()
    finally:
        tdiag.stop_diag_server()
    assert "== warm start ==" in body and "t.metrics" in body
    assert [h["result"] for h in twarm.lookup_history()] == ["miss", "hit"]
    # the build records and the EventLog carry the lookup
    assert [r["warm"] for r in tobserve.get_registry().recent
            if r.get("kind") in ("compile", "recompile")] == ["miss", "hit"]
    assert "warm store: hit" in tintrospect.format_explain(
        tintrospect.explain())


def test_env_var_enables_store(tmp_path, monkeypatch):
    monkeypatch.setenv(twarm.ENV_CACHE_DIR, str(tmp_path / "envw"))
    twarm.reset()   # clear the one-shot env probe
    _fn2, rec = tintrospect.build_compiled(_fn, _args(), "t.env")
    assert rec["warm"] == twarm.RESULT_MISS
    assert twarm.get_store().root == str(tmp_path / "envw")


# ---- the real process boundary ----------------------------------------------

_CHILD = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    import torch
    from singa_tpu_torch import introspect, warmstart
    warmstart.enable({store!r})
    fn = lambda x: torch.cumsum(x, 0) * 3
    args = (torch.arange(16, dtype=torch.float32),)
    _f, rec = introspect.build_compiled(fn, args, "t.sub")
    print(json.dumps({{"warm": rec["warm"], "fingerprint": rec["fingerprint"],
                      "cost": rec["cost"], "out": fn(*args).tolist(),
                      "snap": warmstart.snapshot()}}))
""")


def test_cache_hit_across_subprocess_boundary(tmp_path):
    script = _CHILD.format(root=ROOT, store=str(tmp_path / "warm"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop(twarm.ENV_CACHE_DIR, None)
    runs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", script],
                           capture_output=True, text=True, timeout=300,
                           env=env, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-2000:]
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    assert [r["warm"] for r in runs] == ["miss", "hit"]
    assert runs[0]["fingerprint"] == runs[1]["fingerprint"]
    assert runs[0]["out"] == runs[1]["out"]
    assert runs[0]["cost"] == runs[1]["cost"]
    assert runs[0]["snap"]["exports"] == 1
    assert runs[1]["snap"]["exports"] == 0
    assert runs[1]["snap"]["lookups"]["hit"] == 1


# ---- engine and training under warm load ------------------------------------

def _spy_counts(monkeypatch):
    """Counts of introspect's counting passes (`trace`) from here on."""
    calls = []
    real = tintrospect.trace

    def spy(fn, listing=False):
        calls.append(1)
        return real(fn, listing)
    monkeypatch.setattr(tintrospect, "trace", spy)
    return calls


def test_engine_tokens_identical_and_no_extra_counting(tmp_path,
                                                        monkeypatch):
    """Greedy engine decode over ONE model is token-identical with the
    store off, cold and warm; the warm engine runs no counting pass."""
    m = trouter._build_replica_model(61, 32, 1, 24, "cpu")
    calls = _spy_counts(monkeypatch)

    def run_arm():
        # a fresh engine's builds: the model keeps its executors
        m.__dict__.pop("_engine_executors", None)
        n0 = len(calls)
        e = tengine.ServingEngine(m, max_slots=2, page_size=8,
                                  max_ctx=24).start()
        try:
            w = e.submit(np.arange(1, 7, dtype=np.int32), 6)
            assert w.wait(300), "decode stalled"
            toks = list(w.tokens)
        finally:
            e.stop()
        return toks, len(calls) - n0

    toks_off, counted_off = run_arm()
    tintrospect.reset()
    twarm.enable(str(tmp_path / "warm"))
    toks_cold, counted_cold = run_arm()
    snap_cold = twarm.snapshot()
    tintrospect.reset()
    toks_warm, counted_warm = run_arm()
    snap_warm = twarm.snapshot()
    assert toks_off == toks_cold == toks_warm
    assert counted_off == counted_cold > 0 and counted_warm == 0
    assert snap_cold["lookups"]["miss"] == counted_cold
    assert snap_cold["exports"] == counted_cold
    assert snap_warm["lookups"]["hit"] == counted_cold
    assert {r["warm"] for rs in tintrospect.explain()["builds"].values()
            for r in rs} == {"hit"}


def test_prewarm_builds_every_bucket(tmp_path):
    twarm.enable(str(tmp_path / "warm"))
    m = trouter._build_replica_model(61, 32, 1, 24, "cpu")
    e = tengine.ServingEngine(m, max_slots=2, page_size=8,
                              max_ctx=24).start()
    try:
        buckets, first_wall = e.prewarm((4, 12))
    finally:
        e.stop()
    assert buckets == sorted({e._bucket(4), e._bucket(12)})
    assert first_wall is not None
    prefills = [en for en in twarm.get_store().entries()
                if en["key"] == "serving.engine_prefill"]
    assert len(prefills) == len(buckets)


def test_train_step_warm_restart_matches_cold_losses(tmp_path,
                                                     monkeypatch):
    """A graph-mode train step and eval built from the store repeat the
    cold run's losses and eval output bitwise, with every step and eval
    build a hit and no counting pass."""
    def run():
        rng = np.random.RandomState(0)
        torch.manual_seed(0)
        m = tmodels.create_model("mlp", data_size=8, num_classes=4)
        dev = tdevice.create_cpu_device()
        dev.SetRandSeed(0)
        tx = ttensor.from_numpy(
            rng.standard_normal((4, 8)).astype(np.float32), device=dev)
        ty = ttensor.from_numpy(rng.randint(0, 4, 4).astype(np.int32),
                                device=dev)
        m.set_optimizer(topt.SGD(lr=0.1))
        m.compile([tx], is_train=True, use_graph=True)
        losses = [float(m(tx, ty)[1].data) for _ in range(3)]
        m.eval()
        return losses, ttensor.to_numpy(m(tx))

    twarm.enable(str(tmp_path / "warm"))
    cold_losses, cold_eval = run()
    cold = twarm.snapshot()
    tintrospect.reset()
    calls = _spy_counts(monkeypatch)
    warm_losses, warm_eval = run()
    warm = twarm.snapshot()
    assert cold["lookups"]["hit"] == 0 and cold["exports"] >= 2
    assert warm["lookups"]["hit"] == cold["exports"] and not calls
    assert warm["lookups"]["corrupt"] == warm["lookups"]["stale"] == 0
    assert warm_losses == cold_losses
    np.testing.assert_array_equal(warm_eval, cold_eval)
    assert tintrospect.last_build("step")["warm"] == "hit"


def _resilience_events():
    return [r["event"] for r in tobserve.get_registry().recent
            if r.get("kind") == "resilience"]


@pytest.mark.parametrize("store_kept", [True, False])
def test_manifest_names_the_store_and_resume_rejoins_it(tmp_path,
                                                        store_kept):
    """A checkpoint's manifest holds the warm store's root, and a resume
    in a process without a store re-joins it before its `resume` event,
    as the JAX package's does; a store that is gone is skipped."""
    import shutil

    from singa_tpu_torch import resilience as tres
    root, ck = str(tmp_path / "warm"), str(tmp_path / "ck")
    dev = tdevice.create_cpu_device()

    def model():
        torch.manual_seed(0)
        m = tmodels.create_model("mlp", data_size=8, num_classes=4)
        m.set_optimizer(topt.SGD(lr=0.1))
        m.compile([ttensor.from_numpy(np.zeros((4, 8), np.float32),
                                      device=dev)], is_train=True,
                  use_graph=True)
        return m

    twarm.enable(root)
    ctrl = tres.TrainController(model(), ck, handle_signals=False)
    ctrl._step = 1
    ctrl._save(final=True)
    _path, man = tres.latest_checkpoint(ck)
    assert man["warm_store"] == root
    twarm.reset()
    if not store_kept:
        shutil.rmtree(root)
    assert tres.TrainController(model(), ck,
                                handle_signals=False).resume() == 1
    events = _resilience_events()
    if store_kept:
        assert twarm.get_store().root == root
        assert events.index("warm_store_rejoined") < events.index("resume")
    else:
        assert not twarm.is_enabled()
        assert "warm_store_rejoined" not in events and "resume" in events


# ---- the kernel-library path, g++ in place of nvcc --------------------------

_TINY = 'extern "C" int answer(void) { return %d; }\n'


@pytest.fixture
def gxx(tmp_path, monkeypatch):
    """`ops/_build.py` over a csrc holding tiny.cu and two.cu, built by
    g++ into tmp_path's `.kernel_build`; yields the compiler's calls."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "tiny.cu").write_text(_TINY % 42)
    (csrc / "two.cu").write_text(_TINY % 2)
    calls = []

    def cmd(name, out):
        calls.append(name)
        return ["g++", "-x", "c++", "-shared", "-fPIC", "-o", out,
                str(csrc / f"{name}.cu")]
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / ".kernel_build"))
    monkeypatch.setattr(_build, "SOURCES", ("tiny", "two"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_compile_cmd", cmd)
    yield calls


def _answer(name):
    return _build.lib(name).answer()


def test_kernel_library_without_store_goes_to_kernel_build(gxx, tmp_path):
    assert _answer("tiny") == 42 and gxx == ["tiny"]
    fp = _build._fingerprint("tiny")
    assert os.listdir(tmp_path / ".kernel_build") == [f"libtiny-{fp}.so"]
    rec = tintrospect.last_build("kernel.tiny")
    assert rec["warm"] is None and rec["fingerprint"] == fp
    assert rec["phases"]["compile"] > 0
    # loaded from .kernel_build/ without a build: nothing registers
    _build._libs.clear()
    tintrospect.reset()
    assert _answer("tiny") == 42 and gxx == ["tiny"]
    assert tintrospect.last_build("kernel.tiny") is None
    assert twarm.snapshot()["lookups"]["miss"] == 0


def test_kernel_library_store_miss_then_hit(gxx, tmp_path):
    twarm.enable(str(tmp_path / "warm"))
    _build.build_all()
    assert sorted(gxx) == ["tiny", "two"]
    assert not os.path.exists(tmp_path / ".kernel_build")
    assert {e["key"] for e in twarm.get_store().entries()} \
        == {"kernel.tiny", "kernel.two"}
    assert tintrospect.last_build("kernel.two")["warm"] == "miss"
    _build._libs.clear()
    _build.build_all()
    assert sorted(gxx) == ["tiny", "two"]   # no second build
    assert _answer("tiny") == 42 and _answer("two") == 2
    rec = tintrospect.last_build("kernel.tiny")
    assert rec["warm"] == "hit" and rec["phases"]["compile"] > 0
    assert twarm.snapshot()["lookups"] == {"hit": 2, "miss": 2,
                                           "stale": 0, "corrupt": 0}
    _bin, meta = twarm.get_store().entry_paths(
        "kernel.tiny", _build._fingerprint("tiny"))
    with open(meta, encoding="utf-8") as f:
        m = json.load(f)
    assert m["torch_version"] == torch.__version__
    assert m["cuda_version"] == torch.version.cuda
    assert "compute_capability" in m


def _break(store, kind):
    b, m = store.entry_paths("kernel.tiny", _build._fingerprint("tiny"))
    if kind == "truncated":
        # a new file in its place: a loaded library is never rewritten
        with open(b, "rb") as f:
            data = f.read()
        with open(b + ".x", "wb") as f:
            f.write(data[:len(data) // 2])
        os.replace(b + ".x", b)
    elif kind == "stale":
        _edit_meta(m, torch_version="0.0.1")
    else:   # sha-valid bytes that are no library
        store.save("kernel.tiny", _build._fingerprint("tiny"),
                   b"not a library")


@pytest.mark.parametrize("kind,want", [("truncated", "corrupt"),
                                       ("stale", "stale"),
                                       ("unloadable", "corrupt")])
def test_kernel_library_bad_entry_is_rebuilt(gxx, tmp_path, kind, want):
    """A truncated, stale or unloadable entry is rebuilt by the compiler.
    The unloadable one is planted before any load: a process that has
    loaded a path gets that library back from the dynamic loader for the
    same path, so only a fresh process can see the bytes refused."""
    twarm.enable(str(tmp_path / "warm"))
    if kind != "unloadable":
        assert _answer("tiny") == 42
        _build._libs.clear()
    _break(twarm.get_store(), kind)
    assert _answer("tiny") == 42
    # rebuilt by the compiler
    assert gxx == ["tiny"] * (1 if kind == "unloadable" else 2)
    assert tintrospect.last_build("kernel.tiny")["warm"] == want
    assert twarm.lookup_history()[-1]["result"] == want
    path, result = twarm.get_store().check("kernel.tiny",
                                           _build._fingerprint("tiny"))
    assert result == "hit"


def test_kernel_library_build_failure_raises(gxx, tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises."""
    twarm.enable(str(tmp_path / "warm"))
    (tmp_path / "csrc" / "tiny.cu").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="nvcc failed on csrc/tiny.cu"):
        _build.lib("tiny")
    assert "tiny" not in _build._libs


# ---- the cold-vs-warm spawn A/B ---------------------------------------------

def test_warm_ab_on_cpu(tmp_path, tmp_path_factory, monkeypatch):
    """`router --warm-ab --device cpu` at dim 64, 2 layers: the five
    checks that apply pass, the compile-fraction and speedup checks read
    null and are named in `not_applicable` (nothing is compiled on the
    CPU), and both arms decode the same tokens."""
    out = str(tmp_path / "WARM_test.json")
    with torch_ab.two_cores(tmp_path_factory, monkeypatch):
        rc = trouter.main(["--warm-ab", "--device", "cpu", "--dim", "64",
                           "--layers", "2", "--timeout", "120",
                           "--out", out])
    with open(out, encoding="utf-8") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rec = rows[-1]
    assert rc == 0 and rec["ok"] is True, rec
    assert rec["device"] == "cpu"
    assert rec["thresholds"] == {"warm_compile_frac": 0.1,
                                 "warm_speedup": 3.0}
    assert set(rec["not_applicable"]) == {"warm_compile_frac_ok",
                                          "warm_spawn_speedup_ok"}
    assert rec["checks"]["warm_compile_frac_ok"] is None
    assert rec["checks"]["warm_spawn_speedup_ok"] is None
    assert all(v is True for k, v in rec["checks"].items()
               if k not in rec["not_applicable"])
    assert rec["tokens"]["cold"] == rec["tokens"]["warm"] != []
    assert rec["warm"]["warm"]["lookups"]["hit"] > 0
    assert rec["cold"]["warm"]["exports"] > 0
    assert {r["metric"] for r in rows[:-1]} >= {
        "spawn_to_first_token_s", "compile_cache_hit_rate"}
