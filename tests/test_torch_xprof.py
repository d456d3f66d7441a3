"""Port parity, trace analysis: singa_tpu_torch.xprof against singa_tpu.xprof,
the port's trace capture, `Model.lower_step`/`step_cost_analysis`,
`introspect.explain(xplane=)`, /profilez and `overlap`'s report.

- The pure functions (`top_ops`, `diff_op_tables`, `category_table`,
  `format_table`, `format_hlo_categories`) give equal results on the same
  row lists: tests/test_xprof.py's cases and seeded tables.
- `_category` is JAX's on every op name of a real JAX capture and the
  HLO-style names JAX's tests use; a table of CUDA kernel and aten names
  maps to the categories the port gives them.
- The port's reader on a real CPU torch.profiler capture of the MLP's
  steps inside `observe.span`s: the CPU operators' rows (self time) sum to
  100%, the spans sit at their depth, a span opened in another thread is
  recorded, the operators' flops reach `hlo_category_table`. A second
  `StartTrace` raises JAX's message; `StopTrace` is idempotent.
- A card capture's warm-up, on synthetic Chrome traces with its first or
  last kernels lost: `_strip_warmup` takes out its range, host events,
  kernels and flow arrows and nothing else, and counts what came back.
- `lower_step` is None before a graph-mode step (as JAX's), then holds
  the build's counted cost (the MLP's 32,768 flops), changing no state.
- `explain(xplane=dir)` carries the capture's top ops; /profilez on a CPU
  server answers 200 with the op rows, and 409 while another capture
  holds the profiler; its trace dirs are bounded.
- `overlap_report()` prints JAX's text on the same records.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import model as jmodel
from singa_tpu import overlap as joverlap
from singa_tpu import xprof as jxprof
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import diag as tdiag
from singa_tpu_torch import introspect, layer, model, observe, opt, overlap
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch import xprof

TDEV = tdevice.create_cpu_device()


@pytest.fixture(autouse=True)
def _port_state():
    def clean():
        tdevice.Device.StopTrace(TDEV)
        tdiag.stop_diag_server()
        introspect.reset()
        observe.get_registry().reset()
        observe.enable(True)
    clean()
    yield
    clean()


# ---- the pure functions -----------------------------------------------------

_BEFORE = [
    {"op": "fusion.1", "category": "fusion", "total_ms": 2.0},
    {"op": "copy.2", "category": "copy", "total_ms": 1.0},
    {"op": "gone.3", "category": "fusion", "total_ms": 0.5},
    {"op": "singa.span/model.step", "category": "span", "total_ms": 9.9},
    {"op": "$train.py:10 step", "category": "host", "total_ms": 5.0},
]
_AFTER = [
    {"op": "fusion.1", "category": "fusion", "total_ms": 6.0},
    {"op": "copy.2", "category": "copy", "total_ms": 0.5},
    {"op": "new.4", "category": "fusion", "total_ms": 1.0},
    {"op": "singa.span/model.step", "category": "span", "total_ms": 30.0},
]
_SPLIT = [{"op": "a", "category": "fusion", "total_ms": 1.0},
          {"op": "a", "category": "fusion", "total_ms": 2.0}]


def _seeded_rows(seed, n=24):
    """An op_table-shaped row list: JAX-style and CUDA op names, spans."""
    rng = np.random.RandomState(seed)
    names = ["fusion.%d", "dot.%d", "copy.%d", "all-reduce.%d",
             "aten::mm.%d", "ampere_sgemm_%d", "singa.span/model.step/%d"]
    rows = []
    for i in range(n):
        op = names[rng.randint(len(names))] % rng.randint(4)
        ms = float(rng.choice([0.0, rng.exponential(2.0)]))
        cnt = int(rng.randint(1, 9))
        rows.append({"op": op, "category": jxprof._category(op),
                     "total_ms": ms, "count": cnt,
                     "avg_us": 1e3 * ms / cnt, "pct": float(rng.rand())})
    return rows


_PAIRS = {"tests": (_BEFORE, _AFTER), "split": (_SPLIT, _AFTER[:1]),
          "reversed": (_AFTER, _BEFORE), "empty": ([], []),
          "none": (None, None)}
_PAIRS.update({f"seed{s}": (_seeded_rows(s), _seeded_rows(s + 100))
               for s in range(4)})


@pytest.mark.parametrize("case", sorted(_PAIRS))
def test_pure_functions_equal_jax(case):
    before, after = _PAIRS[case]
    assert xprof.diff_op_tables(before, after) \
        == jxprof.diff_op_tables(before, after)
    for rows in (before, after):
        rows = [dict(r, count=r.get("count", 1), avg_us=r.get("avg_us", 0.0),
                     pct=r.get("pct", 0.0)) for r in rows or []]
        for k in (1, 3, 100):
            assert xprof.top_ops(rows, k) == jxprof.top_ops(rows, k)
        assert xprof.category_table(rows) == jxprof.category_table(rows)
        for top in (2, 25):
            assert xprof.format_table(rows, top) \
                == jxprof.format_table(rows, top)


def test_format_hlo_categories_equal_jax():
    rng = np.random.RandomState(3)
    rows = [{"category": c, "ms": float(rng.exponential()),
             "gbytes": float(rng.rand()), "tflops": float(rng.rand()),
             "pct": float(100 * rng.rand()),
             "achieved_gbs": float(1e3 * rng.rand()),
             "tflops_s": float(rng.rand())}
            for c in ("matmul", "attention", "copy", "other")]
    assert xprof.format_hlo_categories(rows) \
        == jxprof.format_hlo_categories(rows)


# ---- categories -------------------------------------------------------------

_HLO_NAMES = ["fusion.1", "copy.2", "gone.3", "new.4", "a",
              "singa.span/model.step", "$train.py:10 step", "dot.3",
              "%dot.7", "convolution.2", "%convolution.1", "convert.7",
              "convert_element_type", "all-reduce.2", "all-gather.1",
              "AllReduce", "transpose.1", "bitcast.4", "reduce.5",
              "reduce-window", "infeed", "outfeed.2", "custom-call.3",
              "add.4", "multiply", "tanh.2", "gemm_fusion", "matmul.1",
              "loop_fusion", "input_reduce_fusion", "broadcast.9"]


@pytest.fixture(scope="module")
def jax_trace(tmp_path_factory):
    """A real jax.profiler capture on the CPU (tests/test_xprof.py's)."""
    d = str(tmp_path_factory.mktemp("xplane"))
    f = jax.jit(lambda x: jnp.tanh(x @ x.T).sum())
    x = jnp.ones((64, 64), jnp.float32)
    f(x).block_until_ready()
    jax.profiler.start_trace(d)
    for _ in range(2):
        f(x).block_until_ready()
    jax.profiler.stop_trace()
    return d


def test_category_equal_jax_on_hlo_names(jax_trace):
    names = {r["op"] for r in jxprof.op_table(jax_trace,
                                               device_only=False)}
    assert names
    for op in sorted(names | set(_HLO_NAMES)):
        assert xprof._category(op) == jxprof._category(op), op


#: recorded CUDA kernel, memcpy/memset and aten names -> the port's category
CUDA_NAMES = {
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "matmul",
    "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT": "matmul",
    "ampere_sgemm_128x64_tn": "matmul",
    "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_"
    "align4>(cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_align4::Params)":
        "matmul",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, float>":
        "matmul",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc":
        "conv",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float>": "conv",
    "sm80_xmma_dgrad_implicit_gemm_indexed_f32f32_tf32f32_f32": "conv",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096"
    "ul>)": "allreduce",
    "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)":
        "allgather",
    "Memcpy HtoD (Pageable -> Device)": "copy",
    "Memcpy DtoD (Device -> Device)": "copy",
    "Memset (Device)": "copy",
    "void flash_fwd_kernel_tc<128, true, __nv_bfloat16>(FwdArgs)":
        "attention",
    "void flash_bwd_fused_tc_kernel<128, true>(BwdArgs)": "attention",
    "void flash_bwd_dq_tc_kernel<128>(BwdArgs)": "attention",
    "void flash_bwd_dkv_tc_kernel<128>(BwdArgs)": "attention",
    "void flash_decode_kernel<float, 0, 128>(DecodeArgs)": "attention",
    "void paged_kernel<float, 0, 128>(PagedArgs)": "attention",
    "void paged_kernel_merge<float>(MergeArgs)": "attention",
    "void scale_cast_kernel<__nv_bfloat16>(float const*, long)":
        "attention",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>>": "other",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>":
        "other",
    "aten::mm": "matmul", "aten::addmm": "matmul", "aten::bmm": "matmul",
    "aten::linear": "matmul", "aten::conv2d": "conv",
    "aten::cudnn_convolution": "conv", "aten::copy_": "copy",
    "aten::_to_copy": "copy", "aten::add": "other", "aten::relu": "other",
}


@pytest.mark.parametrize("name", sorted(CUDA_NAMES))
def test_category_of_cuda_and_aten_names(name):
    assert xprof._category(name) == CUDA_NAMES[name]


# ---- the port's reader on a real CPU capture --------------------------------

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


class JMLP(jmodel.Model):
    def __init__(self):
        from singa_tpu import layer as jlayer
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


def _data(b=32, seed=0):
    rng = np.random.RandomState(seed + b)
    return (ttensor.from_numpy(rng.randn(b, 10).astype(np.float32), TDEV),
            ttensor.from_numpy(rng.randint(0, 4, b).astype(np.int32), TDEV))


def _mlp(seed=0):
    m = TMLP()
    m.set_optimizer(opt.SGD(lr=0.1))
    tx, ty = _data(seed=seed)
    m.compile([tx], is_train=True, use_graph=True)
    return m, tx, ty


@pytest.fixture
def capture(tmp_path):
    """Two MLP steps (graph mode, eager on the CPU) inside an epoch span,
    and one in another thread, under a port trace."""
    m, tx, ty = _mlp()
    m(tx, ty)                      # the build, outside the capture
    d = str(tmp_path / "trace")
    TDEV.StartTrace(d)
    with observe.span("fit_epoch"):
        m(tx, ty)
        m(tx, ty)
    t = threading.Thread(target=lambda: m(tx, ty), name="other-thread")
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert TDEV.StopTrace() == d
    return d


def test_start_twice_raises_and_stop_is_idempotent(tmp_path):
    d = str(tmp_path / "t")
    assert TDEV.StopTrace() is None
    TDEV.StartTrace(d)
    with pytest.raises(RuntimeError, match="already active; StopTrace"):
        tdevice.of("cpu").StartTrace(str(tmp_path / "u"))
    assert TDEV.StopTrace() == d
    assert TDEV.StopTrace() is None
    assert len(xprof.find_xplane_files(d)) == 1
    TDEV.StartTrace(d)              # the flag reset: a new capture starts
    assert TDEV.StopTrace() == d
    assert len(xprof.find_xplane_files(d)) == 2


def test_cpu_rows_sum_to_100_and_spans_nest(capture):
    rows = xprof.op_table(capture)
    ops = [r for r in rows if r["category"] != "span"]
    assert ops and not any(r["op"].startswith(xprof.SPAN_PREFIX)
                           for r in ops)
    assert abs(sum(r["pct"] for r in ops) - 100.0) < 1e-6
    assert any(r["category"] == "matmul" for r in ops)
    spans = {r["op"]: r for r in xprof.span_table(capture)}
    assert spans["fit_epoch"]["depth"] == 0
    assert spans["fit_epoch/model.step"]["depth"] == 1
    assert spans["fit_epoch/model.step"]["count"] == 2
    # the other thread's step: its span is a root there
    assert spans["model.step"]["count"] == 1
    assert abs(sum(r["pct"] for r in spans.values()) - 100.0) < 1e-6
    top = xprof.top_ops(capture, 5)
    assert top == xprof.top_ops(rows, 5)
    assert all(r["category"] != "span" for r in top)
    cats = xprof.category_table(rows)
    assert abs(sum(r["pct"] for r in cats) - 100.0) < 1e-6


def test_self_time_is_wall_less_children(tmp_path):
    path = str(tmp_path / "h_1.1.pt.trace.json")
    ev = [{"ph": "X", "cat": "cpu_op", "name": n, "pid": 1, "tid": 7,
           "ts": ts, "dur": dur, "args": {"External id": i}}
          for i, (n, ts, dur) in enumerate(
              [("aten::linear", 0.0, 10.0), ("aten::t", 1.0, 2.0),
               ("aten::addmm", 4.0, 5.0), ("aten::relu", 12.0, 3.0)])]
    ev.append({"ph": "X", "cat": "user_annotation",
               "name": "singa.span/model.step", "pid": 1, "tid": 7,
               "ts": 0.0, "dur": 20.0, "args": {}})
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)
    got = {r["op"]: r["total_ms"] for r in xprof.op_table(str(tmp_path))}
    assert got == {"aten::linear": 0.003, "aten::t": 0.002,
                   "aten::addmm": 0.005, "aten::relu": 0.003,
                   "singa.span/model.step": 0.02}


def _card_trace(lost_head, lost_tail):
    """A card capture's Chrome events: StartTrace's warm-up on thread 7
    (its adds, sleep and synchronize, each with its runtime call and
    kernel), a kernel another thread launched meanwhile, then a window
    step with one kernel; the first `lost_head` warm-up kernels and the
    last `lost_tail` did not come back."""
    ev, kernels, ext = [], [], iter(range(1, 10 ** 6))
    n = tdevice.WARMUP_HEAD + 1 + tdevice.WARMUP_TAIL
    ev.append({"ph": "X", "cat": "user_annotation",
               "name": tdevice.TRACE_WARMUP, "pid": 1, "tid": 7, "ts": 100.0,
               "dur": 10.0 * n + 50.0, "args": {"External id": next(ext)}})
    ev.append({"ph": "X", "cat": "gpu_user_annotation",
               "name": tdevice.TRACE_WARMUP, "pid": 0, "tid": 7,
               "ts": 102.0, "dur": 10.0 * n, "args": {}})
    for i in range(n):
        ts, x = 101.0 + 10.0 * i, next(ext)
        sleep = i == tdevice.WARMUP_HEAD
        if not sleep:
            ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add_",
                       "pid": 1, "tid": 7, "ts": ts, "dur": 5.0,
                       "args": {"External id": x}})
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "pid": 1, "tid": 7,
                   "ts": ts + 1.0, "dur": 2.0,
                   "args": {"External id": x, "correlation": 1000 + i}})
        ev.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1000 + i,
                   "pid": 1, "tid": 7, "ts": ts + 1.0})
        kernels.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                        "name": "spin_kernel" if sleep else
                        "vectorized_elementwise_kernel<add>",
                        "ts": ts + 3.0, "dur": 2.0,
                        "args": {"correlation": 1000 + i,
                                 **({} if sleep else {"External id": x})}})
    ev += kernels[lost_head:n - lost_tail]
    ev.append({"ph": "X", "cat": "cuda_runtime",
               "name": "cudaDeviceSynchronize", "pid": 1, "tid": 7,
               "ts": 100.0 + 10.0 * n, "dur": 40.0,
               "args": {"External id": 0, "correlation": 2000}})
    # another thread's work during the warm-up, and the window's step
    for tid, ts, name, corr in ((8, 150.0, "other_kernel", 3000),
                                (7, 200.0 + 10.0 * n, "window_kernel", 3001)):
        x = next(ext)
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
                   "tid": tid, "ts": ts, "dur": 5.0,
                   "args": {"External id": x}})
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "pid": 1, "tid": tid,
                   "ts": ts + 1.0, "dur": 2.0,
                   "args": {"External id": x, "correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                   "tid": 9, "ts": ts + 3.0, "dur": 4.0,
                   "args": {"External id": x, "correlation": corr}})
    return {"traceEvents": ev}


@pytest.mark.parametrize("lost_head,lost_tail", [(0, 0), (60, 0), (129, 0),
                                                 (0, 1), (140, 0)])
def test_stop_trace_strips_the_card_warmup(tmp_path, lost_head, lost_tail):
    doc = _card_trace(lost_head, lost_tail)
    got = tdevice._strip_warmup(doc)
    n = tdevice.WARMUP_HEAD + 1 + tdevice.WARMUP_TAIL
    kept = n - lost_head - lost_tail
    assert got == {"launched": n, "recorded": kept,
                   "tail_recorded": min(tdevice.WARMUP_TAIL, kept)
                   - lost_tail,
                   "device_ms": pytest.approx(kept * 2.0 / 1e3)}
    names = {e.get("name") for e in doc["traceEvents"]}
    assert tdevice.TRACE_WARMUP not in names
    assert not {"aten::add_", "spin_kernel", "ac2g",
                "cudaDeviceSynchronize"} & names
    assert "vectorized_elementwise_kernel<add>" not in names
    (tmp_path / "h_1.1.pt.trace.json").write_text(json.dumps(doc))
    rows = {r["op"]: r["count"] for r in xprof.op_table(str(tmp_path))}
    assert rows == {"other_kernel": 1, "window_kernel": 1}


def test_hlo_category_table_carries_the_profilers_flops(capture):
    rows = {r["category"]: r for r in xprof.hlo_category_table(capture)}
    assert rows["matmul"]["tflops"] > 0.0
    assert all(r["gbytes"] == 0.0 for r in rows.values())
    assert abs(sum(r["pct"] for r in rows.values()) - 100.0) < 1e-6
    text = xprof.format_hlo_categories(list(rows.values()))
    assert text.splitlines()[0].startswith("category")


def test_empty_and_torn_traces(tmp_path):
    assert xprof.op_table(str(tmp_path)) == []
    (tmp_path / "x.pt.trace.json").write_text('{"traceEvents": [{"ph": ')
    assert xprof.parse_xspace(str(tmp_path / "x.pt.trace.json")) == []
    assert xprof.op_table(str(tmp_path)) == []
    assert xprof.hlo_category_table(str(tmp_path)) == []


# ---- lower_step / step_cost_analysis, explain --------------------------------

def test_lower_step_and_cost_analysis():
    m, tx, ty = _mlp()
    jm = JMLP()
    from singa_tpu import opt as jopt
    jm.set_optimizer(jopt.SGD(lr=0.1))
    assert m.lower_step() is None and jm.lower_step() is None
    assert m.step_cost_analysis() == {} == jm.step_cost_analysis()
    m(tx, ty)
    params = {k: v.numpy().copy() for k, v in m.get_params().items()}
    gen = TDEV.generator.get_state().clone()
    low = m.lower_step()
    assert low is not None and m.lower_step(tag=1) is None
    assert low.cost_analysis()["flops"] == 32768.0
    assert low.as_text() is None        # no op listing without capture_hlo
    assert m.step_cost_analysis()["flops"] == 32768.0
    assert "bytes accessed" in m.step_cost_analysis()
    assert torch.equal(TDEV.generator.get_state(), gen)
    for k, v in m.get_params().items():
        assert np.array_equal(v.numpy(), params[k]), k


def test_lower_step_as_text_is_the_op_listing(tmp_path):
    introspect.capture_hlo(str(tmp_path))
    try:
        m, tx, ty = _mlp()
        m(tx, ty)
    finally:
        introspect.capture_hlo(None)
    text = m.lower_step().as_text()
    assert "aten.addmm" in text or "aten.mm" in text, text[:400]


def test_explain_xplane_top_ops(capture):
    rep = introspect.explain(xplane=capture, top=4)
    assert rep["top_ops"] == [
        {"op": r["op"], "category": r["category"],
         "total_ms": round(r["total_ms"], 3), "pct": round(r["pct"], 1)}
        for r in xprof.top_ops(capture, 4)]
    assert "ops by device time (xplane):" in introspect.format_explain(rep)


# ---- /profilez ----------------------------------------------------------------

def _get(url, timeout=60.0):
    try:
        r = urllib.request.urlopen(url, timeout=timeout)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_profilez_captures_then_409_while_busy(tmp_path):
    m, tx, ty = _mlp()
    m(tx, ty)
    srv = tdiag.start_diag_server(port=0, device=TDEV)
    stop = threading.Event()

    def train():
        while not stop.is_set():
            m(tx, ty)

    t = threading.Thread(target=train, name="train")
    t.start()
    try:
        st, body = _get(srv.url + "/profilez?steps=2&seconds=30")
        assert st == 200, body
        js = json.loads(body)
        assert js["steps_captured"] >= 2 and not js["truncated"]
        assert js["top_ops"] and len(js["top_ops"]) <= 20
        assert any(r["category"] == "matmul" for r in js["top_ops"])
        assert os.path.isdir(js["trace_dir"])
        TDEV.StartTrace(str(tmp_path / "held"))
        st, body = _get(srv.url + "/profilez?steps=1")
        assert st == 409 and "already active" in json.loads(body)["error"]
        TDEV.StopTrace()
        st, _ = _get(srv.url + "/profilez?steps=x")
        assert st == 400
    finally:
        stop.set()
        t.join(timeout=60)
    dirs = [js["trace_dir"]]
    for _ in range(tdiag._MAX_TRACE_DIRS):
        st, body = _get(srv.url + "/profilez?steps=0")
        assert st == 200
        dirs.append(json.loads(body)["trace_dir"])
    assert not os.path.exists(dirs[0])
    assert all(os.path.isdir(d) for d in dirs[1:])


# ---- overlap ------------------------------------------------------------------

def test_overlap_report_equal_jax(tmp_path):
    from singa_tpu import observe as jobserve
    jobserve.get_registry().reset()
    assert overlap.async_available() is True
    assert overlap.overlap_report() == joverlap.overlap_report() \
        .replace("available=False", "available=True")
    for obs in (observe, jobserve):
        obs.record_prefetch(2, blocked_s=0.25, produced=True)
        obs.record_ckpt_async(1, blocking_s=0.5)
    text = overlap.overlap_report()
    assert "ring_depth=2 batches_moved=1" in text and "started=1" in text
    assert text == joverlap.overlap_report().replace("available=False",
                                                     "available=True")
    jobserve.get_registry().reset()
