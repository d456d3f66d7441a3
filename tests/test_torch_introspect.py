"""Port parity, build introspection: singa_tpu_torch.introspect against
singa_tpu.introspect on the CPU.

- `signature`, `blame` and `_sig_fingerprint` on the same leaves give the
  same (reason, detail) and fingerprints in both packages.
- The MLP of tests/test_introspect.py (batch 32, 10->16->4, SGD), its
  weights carried over by `copy_from_numpy`, at batches 32, 32, 48:
  equal compile/recompile records (kind, key, reason, detail) and
  `singa_recompile_total`; the restore scenario (a checkpoint loaded,
  then two steps) records the same `new_function` rebuild in both; equal
  eval builds over a run of batch sizes; the cached path's EventLog kinds
  are `["step"] * 3` in both.
- The port's count: the MLP's step is exactly 32,768 flops (JAX's XLA
  count, printed, is not compared); a tiny GPT's step is 3 x its matmul
  forward plus K1's and K2a's formula flops, booked by the kernel
  wrappers on the CPU's plain route; `arguments` is the inputs +
  parameters + optimizer states exactly.
- MFU under a peak override, the verbosity-2 `PrintTimeProfiling` lines,
  `capture_hlo`'s op listing (with the booked kernel launches) and
  `manifest.jsonl`, the flight, hang and OOM bundles' `executables`
  (loaded with the JAX package's loaders), `explain`'s keys (params
  equal), the serving builds of `generate`, beam search and the engine
  (the same keys, one build each, as the JAX executors), one OOM bundle
  for an out-of-memory error inside a serving executor, a stubbed nvcc
  build registering `kernel.<source>`, and the CLI.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import engine as jengine
from singa_tpu import health as jhealth
from singa_tpu import introspect as jintro
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import models as jmodels
from singa_tpu import observe as jobserve
from singa_tpu import opt as jopt
from singa_tpu import overlap as joverlap
from singa_tpu import tensor as jtensor
from singa_tpu import watchdog as jwatchdog
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import engine as tengine
from singa_tpu_torch import (health, introspect, layer, memory, model,
                             observe, opt, overlap, watchdog)
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.models import transformer as tt
from singa_tpu_torch.ops import _build

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TDEV = tdevice.create_cpu_device()
GPT_SMALL = dict(vocab_size=97, max_seq=64, dim=64, num_heads=4,
                 num_layers=2)


@pytest.fixture(autouse=True)
def _port_state():
    """The port's introspect state, registry, watchdog, ledger and
    engines are reset around each test (tests/conftest.py resets only
    the JAX package's)."""
    def clean():
        introspect.reset()
        watchdog.uninstall_watchdog()
        jwatchdog.uninstall_watchdog()
        memory.reset()
        tengine.reset()
        health.set_active_monitor(None)
        observe.get_registry().reset()
        observe.set_event_log(None)
        observe.enable(True)
        for d in (TDEV,):
            d.SetVerbosity(0)
            d.step_times = []
            d.cost_analysis = None
    clean()
    yield
    clean()


class JMLP(jmodel.Model):
    def __init__(self):
        super().__init__()
        self.l1 = jlayer.Linear(16)
        self.relu = jlayer.ReLU()
        self.l2 = jlayer.Linear(4)
        self.ce = jlayer.SoftMaxCrossEntropy()

    def forward(self, x):
        return self.l2(self.relu(self.l1(x)))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.ce(out, y)
        self.optimizer(loss)
        return out, loss


class TMLP(model.Model):
    def __init__(self):
        super().__init__()
        self.l1 = layer.Linear(16)
        self.relu = layer.ReLU()
        self.l2 = layer.Linear(4)
        self.ce = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        return self.l2(self.relu(self.l1(x)))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.ce(out, y)
        self.optimizer(loss)
        return out, loss


def _data(b, seed=0):
    rng = np.random.RandomState(seed + b)
    return (rng.randn(b, 10).astype(np.float32),
            rng.randint(0, 4, b).astype(np.int32))


def _pair(batch=32):
    """The JAX MLP and the port's with its weights (SGD, lr 0.1), both
    compiled in graph mode on the batch's shape."""
    jdev = jdevice.get_default_device()
    X, _ = _data(batch)
    jm = JMLP()
    jm.set_optimizer(jopt.SGD(lr=0.1))
    jm.compile([jtensor.from_numpy(X, jdev)], is_train=True, use_graph=True)
    tm = TMLP()
    tm.set_optimizer(opt.SGD(lr=0.1))
    tm.compile([ttensor.from_numpy(X, TDEV)], is_train=True, use_graph=True)
    for k, v in jm.get_params().items():
        tm.get_params()[k].copy_from_numpy(jtensor.to_numpy(v))
    return (jm, jdev, jtensor), (tm, TDEV, ttensor)


def _step(side, b, seed=0):
    m, dev, mod = side
    X, Y = _data(b, seed)
    return m(mod.from_numpy(X, dev), mod.from_numpy(Y, dev))


def _builds(obs):
    return [(r["kind"], r["key"], r["reason"], r["detail"])
            for r in obs.get_registry().recent
            if r.get("kind") in ("compile", "recompile")]


def _recompiles(obs):
    c = obs.get_registry().get("singa_recompile_total")
    return None if c is None else sorted(
        (tuple(sorted(k)) if isinstance(k, dict) else k, v)
        for _, k, v in c.samples())


# ---- signatures and blame ---------------------------------------------------

_CASES = {
    "batch_crossed": ((32, 10), "float32", (48, 10), "float32", {}),
    "batch_within": ((48, 10), "float32", (40, 10), "float32", {}),
    "dtype": ((32, 10), "float32", (32, 10), "float16", {}),
    "bf16": ((32, 10), "float32", (32, 10), "bfloat16", {}),
    "shape": ((32, 10), "float32", (32, 12), "float32", {}),
    "tag": ((32, 10), "float32", (32, 10), "float32", {"tag": (0, 1)}),
    "static": ((32, 10), "float32", (32, 10), "float32",
               {"static": ("a", "b")}),
    "same": ((32, 10), "float32", (32, 10), "float32", {}),
}


def _leaf(pkg, shape, dt):
    if pkg == "jax":
        import jax.numpy as jnp
        return jnp.zeros(shape, getattr(jnp, dt))
    return torch.zeros(shape, dtype=getattr(torch, dt))


@pytest.mark.parametrize("case", sorted(_CASES))
def test_blame_and_fingerprints_match_jax(case):
    s0, d0, s1, d1, kw = _CASES[case]
    got = {}
    for pkg, mod in (("jax", jintro), ("port", introspect)):
        def sig(s, d, i):
            extra = {k: v[i] for k, v in kw.items()}
            return mod.signature(([_leaf(pkg, s, d), _leaf(pkg, (s[0],),
                                                          "int32")],),
                                 names=("arg",), batch_hint=s[0], **extra)
        a, b = sig(s0, d0, 0), sig(s1, d1, 1)
        got[pkg] = (a["leaves"], b["leaves"], mod.blame(a, b),
                    mod._sig_fingerprint("step", a),
                    mod._sig_fingerprint("step", b),
                    mod._nearest([a, b], b) is b)
    assert got["port"] == got["jax"]
    assert got["port"][2][0] in introspect.RECOMPILE_REASONS
    if case == "batch_crossed":
        assert got["port"][2] == (
            "batch_bucket", "arg `arg0` batch 32->48 crossed bucket 32->64")


def test_peak_tables_know_nvidia_cards_only():
    assert introspect.chip_peak("NVIDIA H100 80GB HBM3",
                                introspect.PEAK_TFLOPS_BF16) == 989.0
    assert introspect.chip_peak("NVIDIA H100 80GB HBM3",
                                introspect.PEAK_HBM_GBS) == 3350.0
    assert introspect.chip_peak("NVIDIA H100 PCIe",
                                introspect.PEAK_TFLOPS_BF16) == 756.0
    assert introspect.chip_peak("TPU v5 lite",
                                introspect.PEAK_TFLOPS_BF16) is None
    assert introspect.peak_tflops("cpu") is None
    assert introspect.set_peak_tflops(12.5) == introspect.peak_tflops("cpu")


# ---- the step's builds ------------------------------------------------------

def test_recompile_records_match_jax():
    j, t = _pair(32)
    for side in (j, t):
        for b in (32, 32, 48):
            _step(side, b)
    assert _builds(observe) == _builds(jobserve) == [
        ("compile", "step", None, None),
        ("recompile", "step", "batch_bucket",
         "arg `arg0` batch 32->48 crossed bucket 32->64")]
    assert _recompiles(observe) == _recompiles(jobserve)
    assert observe.get_registry().get("singa_recompile_total").value(
        reason="batch_bucket", key="step") == 1
    ph = observe.get_registry().get("singa_compile_phase_seconds")
    for p in introspect.COMPILE_PHASES:
        assert ph.count(phase=p, key="step") == 2, p
    # the CPU captures nothing: lower and compile are 0.0
    assert ph.sum(phase="trace", key="step") > 0
    assert ph.sum(phase="compile", key="step") == 0.0
    assert [b["detail"] for b in introspect.blame_history()] == \
        [b["detail"] for b in jintro.blame_history()]


def test_restore_records_the_rebuild_as_jax_does(tmp_path):
    """A checkpoint loaded into the model drops its step (JAX: the
    compiled step; the port: the graphs), so the next step builds the
    same signature again: one `new_function` recompile in both."""
    j, t = _pair(32)
    for side in (j, t):
        _step(side, 32)
        _step(side, 32)
    jp = j[0].save_checkpoint(str(tmp_path / "j"), step=2)
    joverlap.wait_for_checkpoints()
    tp = t[0].save_checkpoint(str(tmp_path / "t"), step=2)
    overlap.wait_for_checkpoints()
    j[0].load_checkpoint(jp)
    t[0].load_checkpoint(tp)
    for side in (j, t):
        _step(side, 32)
        _step(side, 32)
    assert _builds(observe) == _builds(jobserve) == [
        ("compile", "step", None, None),
        ("recompile", "step", "new_function",
         "identical signature rebuilt from a fresh callable")]


def test_eval_builds_per_bucket_match_jax():
    j, t = _pair(8)
    counts = {}
    for name, (m, dev, mod) in (("jax", j), ("port", t)):
        m(*(mod.from_numpy(a, dev) for a in _data(8)))
        m.eval()
        seen = []
        for n in (8, 8, 5, 3, 16, 6):
            m(mod.from_numpy(_data(n, 1)[0], dev))
            seen.append(m._eval_trace_count)
        counts[name] = seen
    assert counts["port"] == counts["jax"]
    assert len(introspect._builds["eval"]) == len(jintro._builds["eval"])
    h = observe.get_registry().get("singa_compile_phase_seconds")
    assert h.count(phase="compile", key="eval") == counts["port"][-1]


def test_cached_path_event_kinds_match_jax(tmp_path):
    j, t = _pair(16)
    kinds = {}
    for name, side, obs in (("jax", j, jobserve), ("port", t, observe)):
        _step(side, 16)
        path = str(tmp_path / f"{name}.jsonl")
        obs.set_event_log(path)
        for _ in range(3):
            _step(side, 16)
        obs.set_event_log(None)
        kinds[name] = [r["kind"] for r in obs.EventLog.read(path)]
    assert kinds["port"] == kinds["jax"] == ["step"] * 3
    assert observe.get_registry().get("singa_recompile_total") is None
    assert len(t[0]._train_steps) == 1


def test_mlp_step_cost_and_memory():
    """The port counts 32,768 flops for the MLP's step: 3 x forward (2 x
    32 x (10 x 16 + 16 x 4) = 14,336) less the first layer's input
    gradient (10,240), which nothing needs; JAX's XLA count adds
    elementwise work and is printed, not compared."""
    j, t = _pair(32)
    for side in (j, t):
        _step(side, 32)
    rec = introspect.last_build("step")
    print(f"port flops {rec['cost']['flops']:.0f}, JAX (XLA) flops "
          f"{jintro.last_build('step')['cost'].get('flops')}")
    assert rec["cost"]["flops"] == 32768.0
    assert rec["cost"]["kernel launches"] == 0.0
    m = t[0]
    X, Y = _data(32)
    want = sum(p.numel() * p.element_size()
               for p in m._raw_params().values()) \
        + sum(a.numel() * a.element_size()
              for a in m.optimizer.state_arrays()) + X.nbytes + Y.nbytes
    assert rec["memory"]["arguments"] == want
    assert rec["memory"]["outputs"] == 32 * 4 * 4 + 4
    assert set(rec["memory"]) == {"arguments", "outputs"}   # CPU: no temps
    assert rec["phases"]["lower"] == rec["phases"]["compile"] == 0.0
    assert rec["cost"]["bytes accessed"] > want
    reg = observe.get_registry()
    assert reg.get("singa_xla_flops_per_step").value(key="step") == 32768.0
    assert reg.get("singa_hbm_arguments_bytes").value(key="step") == want
    fit = memory.estimate_fit(model=m)
    assert fit["exec_arguments_bytes"] == want
    assert fit["source"] == "executable"


def _gpt_pair_free(B=2, S=16, seed=0):
    m = tt.GPT(**GPT_SMALL, device="cpu", seed=seed)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, GPT_SMALL["vocab_size"], (B, S)).astype(np.int64)
    tx, ty = torch.from_numpy(ids), torch.from_numpy(np.roll(ids, -1, 1))
    m.compile([tx], is_train=True, use_graph=True)
    return m, tx, ty


def test_gpt_step_flops_are_matmuls_plus_kernel_formulas(tmp_path):
    """A tiny GPT's counted step: 3 x the forward of every matmul (the
    attention projections, fc1, fc2, the head; every input needs its
    gradient) plus, per layer, K1's 4 D and K2a's 10 D flops a causal
    pair, booked by the wrappers on the plain route. The op listing names
    one flash_fwd and one flash_bwd_fused launch a layer."""
    introspect.capture_hlo(str(tmp_path / "hlo"))
    B, S = 2, 16
    m, tx, ty = _gpt_pair_free(B, S)
    m(tx, ty)
    rec = introspect.last_build("step")
    D, V, L, H = (GPT_SMALL["dim"], GPT_SMALL["vocab_size"],
                  GPT_SMALL["num_layers"], GPT_SMALL["num_heads"])
    fwd = 2 * B * S * (L * (4 * D * D + 2 * 4 * D * D) + D * V)
    pairs = B * H * S * (S + 1) / 2
    want = 3 * fwd + L * (4 + 10) * (D // H) * pairs
    assert rec["cost"]["flops"] == want
    assert rec["cost"]["kernel launches"] == 2 * L
    with open(rec["hlo_path"]) as f:
        text = f.read()
    assert text.count("kernel flash_fwd(") == L
    assert text.count("kernel flash_bwd_fused(") == L
    assert "aten.mm.default(" in text
    man = [json.loads(line) for line in
           open(tmp_path / "hlo" / "manifest.jsonl")]
    assert man[-1]["key"] == "step" and man[-1]["path"] == rec["hlo_path"]
    assert man[-1]["fingerprint"] == introspect.latest_fingerprint("step")
    ents = introspect.executable_manifest()
    assert ents[-1]["hlo_path"] == rec["hlo_path"]


def test_mfu_under_a_peak_override_both_packages():
    introspect.set_peak_tflops(1e-9)
    jintro.set_peak_tflops(1e-9)
    j, t = _pair(8)
    for side in (j, t):
        _step(side, 8)
        _step(side, 8)
    for obs in (jobserve, observe):
        g = obs.get_registry().get("singa_mfu_pct")
        assert g is not None and g.value() > 0


def test_print_time_profiling_verbosity_2(capsys):
    _j, t = _pair(8)
    TDEV.SetVerbosity(2)
    TDEV.SetSkipIteration(0)
    _step(t, 8)
    _step(t, 8)
    assert TDEV.cost_analysis["flops"] == \
        introspect.last_build("step")["cost"]["flops"] > 0
    TDEV.PrintTimeProfiling()
    out = capsys.readouterr().out
    assert "time profiling: 2 steps" in out
    assert "GFLOP/step" in out and "MB accessed/step" in out \
        and "TFLOP/s achieved" in out
    assert "MFU" not in out                # the CPU has no peak
    introspect.set_peak_tflops(1.0)
    TDEV.SetVerbosity(3)
    TDEV.PrintTimeProfiling()
    out = capsys.readouterr().out
    assert "MFU:" in out and "flops:" in out
    TDEV.cost_analysis = {}
    TDEV.PrintTimeProfiling()
    out = capsys.readouterr().out
    assert "time profiling" in out and "GFLOP" not in out


# ---- bundles ----------------------------------------------------------------

def test_bundles_carry_the_step_build_and_load_in_jax(tmp_path):
    _j, t = _pair(8)
    _step(t, 8)
    fp = introspect.latest_fingerprint("step")

    def check(execs):
        assert execs and execs[-1]["key"] == "step"
        assert execs[-1]["fingerprint"] == fp

    rec = health.FlightRecorder(out_dir=str(tmp_path))
    rec.record({"step": 1, "loss": 1.0})
    path = rec.dump(reason="nonfinite_grad", step=1)
    check(jhealth.load_flight_bundle(path)["header"]["executables"])
    wd = watchdog.install_watchdog(out_dir=str(tmp_path), action="warn")
    path = wd.dump_hang_bundle("step", 1.0)
    check(jwatchdog.load_hang_bundle(path)["header"]["executables"])
    path = memory.dump_oom_bundle(key="step", out_dir=str(tmp_path),
                                  device="cpu")
    b = jhealth.load_flight_bundle(path)
    assert b["header"]["reason"] == "oom"
    check(b["header"]["executables"])


# ---- explain ----------------------------------------------------------------

def test_explain_keys_match_jax(tmp_path):
    j, t = _pair(8)
    reps = {}
    for name, side, mod in (("jax", j, jintro), ("port", t, introspect)):
        m, dev, _ = side
        dev.SetVerbosity(1)
        dev.SetSkipIteration(0)
        dev.step_times = []
        try:
            _step(side, 8)
            _step(side, 8)
            reps[name] = mod.explain(model=m, device=dev)
        finally:
            dev.SetVerbosity(0)
            dev.step_times = []
    assert sorted(reps["port"]) == sorted(reps["jax"])
    assert reps["port"]["params"] == reps["jax"]["params"] == \
        10 * 16 + 16 + 16 * 4 + 4
    assert set(reps["port"]["compile_phases_s"]) == \
        set(introspect.COMPILE_PHASES)
    text = introspect.format_explain(reps["port"])
    assert "GFLOP/step" in text and "compile phases" in text
    assert "recompile history (0)" in text
    # a trace dir with no capture: no top ops, as in JAX
    assert introspect.explain(xplane=str(tmp_path))["top_ops"] \
        == jintro.explain(xplane=str(tmp_path))["top_ops"] == []


# ---- serving builds ---------------------------------------------------------

@pytest.fixture(scope="module")
def gpt_pair():
    jm = jmodels.create_model("gpt", **GPT_SMALL)
    ids = np.random.RandomState(0).randint(0, 97, (2, 8)).astype(np.int32)
    jm.compile([jtensor.from_numpy(ids, jdevice.best_device())],
               is_train=False, use_graph=False)
    jm.eval()
    tm = tt.GPT(**GPT_SMALL, device="cpu")
    tt.load_singa_params(
        tm, {k: jtensor.to_numpy(v) for k, v in jm.get_params().items()})
    return jm, tm, ids


def _counts(mod):
    return {k: len(v) for k, v in mod._builds.items()}


def test_generate_and_beam_builds_match_jax(gpt_pair):
    jm, tm, ids = gpt_pair
    for m in (jm, tm):
        a = m.generate(ids, 5)
        b = m.generate(ids, 5)
        np.testing.assert_array_equal(a, b)
        m.generate_beam(ids, 5, num_beams=2)
        m.generate_beam(ids, 5, num_beams=2)
    assert _counts(introspect) == _counts(jintro) == {
        "serving.prefill": 1, "serving.decode_scan": 1, "serving.beam": 1}
    for key in _counts(introspect):
        rec = introspect.last_build(key)
        assert rec["phases"]["lower"] == rec["phases"]["compile"] == 0.0
        assert rec["memory"]["arguments"] > 0
    # the decode scan books K3 once per step after the prefill's token
    scan = introspect.last_build("serving.decode_scan")["cost"]
    assert scan["kernel launches"] == 4 * GPT_SMALL["num_layers"]
    assert introspect.last_build("serving.prefill")["cost"][
        "kernel launches"] == GPT_SMALL["num_layers"]


def test_engine_builds_match_jax(gpt_pair):
    jm, tm, ids = gpt_pair
    for eng, m in ((jengine, jm), (tengine, tm)):
        e = eng.ServingEngine(m, max_slots=2, page_size=8, max_ctx=64,
                              steps_per_sync=2).start()
        try:
            reqs = [e.submit(ids[0], 4) for _ in range(3)]
            for r in reqs:
                assert r.wait(120)
        finally:
            e.stop()
    assert _counts(introspect) == _counts(jintro) == {
        "serving.engine_prefill": 1, "serving.engine_step": 1}
    assert introspect.last_build("serving.engine_step")["cost"][
        "kernel launches"] == 2 * GPT_SMALL["num_layers"]


def test_an_executor_oom_writes_one_bundle(gpt_pair, tmp_path,
                                          monkeypatch):
    """An out-of-memory error inside a serving executor's call (its
    first, the counted build) goes through the `memory.on_oom` context
    around the call site: one bundle under the executor's key, the error
    propagated unchanged, no build registered."""
    _jm, tm, ids = gpt_pair
    memory.install_ledger(device="cpu", out_dir=str(tmp_path))
    err = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "9.99 GiB")

    def boom(*a, **k):
        raise err
    monkeypatch.setitem(tm.__dict__, "_decode_cache", {})
    from singa_tpu_torch import serving
    monkeypatch.setattr(serving._DecodeCore, "prefill", boom)
    with pytest.raises(torch.OutOfMemoryError) as ei:
        tm.generate(ids, 3)
    assert ei.value is err
    bundles = [f for f in os.listdir(tmp_path)
               if f.startswith("flight_oom_")]
    assert len(bundles) == 1
    b = jhealth.load_flight_bundle(str(tmp_path / bundles[0]))
    assert b["header"]["oom"]["executable_key"] == "serving.prefill"
    assert introspect.last_build("serving.prefill") is None
    assert observe.get_registry().get(
        "singa_mem_oom_dumps_total").value() == 1


# ---- kernel builds and the CLI ----------------------------------------------

def test_nvcc_build_registers_a_kernel_build(monkeypatch):
    """A library built by nvcc (stubbed: no nvcc here) registers the
    build `kernel.<source>`: its seconds the compile phase, the library
    name's hash the fingerprint; a library found on disk registers
    nothing."""
    class Job(_build._Job):
        """nvcc's process stubbed: `built` says whether it ran."""
        built = True

        def __init__(self, name, warm=None):
            self.name, self.fp, self.warm = name, "0123456789abcdef", warm
            self.proc = types.SimpleNamespace() if self.built else None

        def finish(self):
            if self.proc is not None:
                _build.BUILD_SECONDS[self.name] = 0.25
            return object()

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_Job", Job)
    _build.lib("wgmma_probe")
    rec = introspect.last_build("kernel.wgmma_probe")
    assert rec["fingerprint"] == "0123456789abcdef"
    assert rec["phases"] == {"trace": 0.0, "lower": 0.0, "compile": 0.25}
    assert rec["warm"] is None
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(Job, "built", False)
    _build.lib("flash_fwd")
    assert introspect.last_build("kernel.flash_fwd") is None
    assert [r["kind"] for r in observe.get_registry().recent
            if r.get("kind") in ("compile", "recompile")] == ["compile"]


def test_cli_json(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.introspect", "--config",
         "tiny", "--device", "cpu", "--json", "--steps", "2", "--hlo-dir",
         str(tmp_path / "hlo")], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert rep["gflops_per_step"] > 0 and rep["params"] > 0
    assert [b["reason"] for b in rep["recompiles"]] == ["batch_bucket"]
    assert any(e["hlo_path"] for e in rep["executables"])
    trace = str(tmp_path / "trace")
    TDEV.StartTrace(trace)
    torch.ones(64, 64) @ torch.ones(64, 64)
    TDEV.StopTrace()
    r = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.introspect", "--device",
         "cpu", "--json", "--steps", "1", "--xplane", trace], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert "aten::mm" in [t["op"] for t in rep["top_ops"]]
