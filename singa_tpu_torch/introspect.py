"""Build introspection (counterpart of singa_tpu/introspect.py): recompile
blame, the counted cost and memory of each build, MFU, and the `explain`
report.

The JAX module times XLA's three build phases of each executable (trace,
lower, compile) and harvests its cost and memory analysis. The port has
three kinds of build, and each keeps the three `COMPILE_PHASES` labels,
so `singa_compile_phase_seconds{phase,key}` reads as in the JAX package:

1. A graph-mode step or eval signature (`Model._run_buffered`, keys
   "step" and "eval"): its first call, the eager warm-up, is the trace
   phase; lower is 0.0, since a CUDA graph has no lowering stage; the
   capture at the second call (record and instantiate) is the compile
   phase, recorded when it happens (`complete_build`). On the CPU, and
   under `sequential`, nothing is captured and compile is 0.0.
2. A serving executor signature (`AotExecutor`, eager PyTorch): the
   first call of a new signature is the trace; lower and compile are
   0.0.
3. An nvcc build of a kernel library (`ops/_build.py`), under the key
   `kernel.<source>`: its wall time is the compile phase, and its
   fingerprint is the build hash that names the `.so`. A library loaded
   from `.kernel_build/` without a build registers nothing; one loaded
   from the warm store registers its lookup's time as the compile phase.
   A build nested in another's first call (a kernel built inside a
   step's warm-up) is netted out of that call's trace phase.

Each build registers a signature for recompile blame (`signature`,
`blame` against the nearest prior signature of its key, the fixed
`RECOMPILE_REASONS` enum in `singa_recompile_total{reason,key}`), a
`compile` or `recompile` EventLog record (emitted at registration: for
a CUDA-graph build that is the warm-up, before its capture, so the
record's compile phase is 0.0 and `last_build` carries the capture's
time), and a manifest entry.

Cost, the counterpart of `cost_analysis`: a counting mode (a
`TorchDispatchMode`) runs over the trace phase only, never in a capture
or any later call (the cached path does no per-step introspection):

- flops by `torch.utils.flop_counter`'s formulas (matmul, conv, bmm);
- bytes accessed as each aten op's input plus output bytes (eager
  PyTorch reads and writes those, since nothing is fused), view ops and
  bare allocations excluded (they move no data);
- the hand-written kernels are `ctypes` calls no dispatch mode sees, so
  each wrapper in `ops/attention.py` books its own flops and bytes by
  the formulas of `chip_smoke.py`'s bounds (`kernel_cost`), whichever
  route runs, the kernel on the card or its plain version on the CPU;
  the counter ignores the aten ops inside a booked call, so the CPU and
  the card count one step alike. A causal call counts the pairs it
  computes, S(S+1)/2 per head.

The count is the port's, not XLA's: for the MLP of
tests/test_introspect.py (batch 32, 10->16->4, SGD) the port counts
32,768 flops (three times the forward, less the first layer's input
gradient, which nothing needs) where XLA counts 39,350, elementwise work
included; the two are not held equal. The gauges keep the JAX names
`singa_xla_flops_per_step` and `singa_xla_bytes_accessed`; their help
text says what the port counts.

Memory, the counterpart of `memory_analysis`, for a step or eval build:
`arguments` (the bytes of the inputs, parameters, buffers and, for the
step, the optimizer's states: what the step updates in place, JAX's
donated arguments), `outputs` (the returned outputs) and, on CUDA only,
`temps` (the warm-up's rise of `torch.cuda.max_memory_allocated` over
its start, less the outputs and the states the warm-up created; the
peak is reset just before it). `generated_code` is absent: nothing on
the card corresponds to it. A serving build records its arguments and
outputs.

`capture_hlo(dir)` writes each build's op listing, the counterpart of
the HLO text: every aten op the trace phase dispatched with its shapes
and dtypes, and every booked kernel launch by name, as
`<key>_<sha>.ops.txt` with a `manifest.jsonl` line; on CUDA a captured
step or eval graph is also dumped (`CUDAGraph.debug_dump`) as
`<key>_<sha>.dot`.

MFU: a step build registers `_mfu_callback` with
`observe.set_step_callback`; it sets `singa_mfu_pct` from the dispatched
signature's flops and the card's dense bf16 peak (`peak_tflops`: the
override, then `config.PEAK_TFLOPS` / `SINGA_TPU_PEAK_TFLOPS`, then
`PEAK_TFLOPS_BF16` matched against `torch.cuda.get_device_name()`; a
card the table does not know has no MFU), dropping a sample above 100%
unless the peak is overridden.

The warm store (`warmstart`): with it enabled (`SINGA_TPU_COMPILE_CACHE`
or `warmstart.enable`), every step, eval and serving build first looks
its (key, signature fingerprint) up inside the span
`introspect.warm_load` (`load_executable`). A hit runs the first call
plainly, without the counting mode, and registers the stored cost,
memory and op listing; a miss, stale or corrupt entry counts as before
and then writes its record (`export_executable`). A CUDA-graph step still
warms up and captures: only the counting pass goes. Where the JAX
package stores a callable, the port stores the build record, so
`load_executable`'s first element is that record. The lookup's result
(hit|miss|stale|corrupt, None with the store disabled) lands on the build
record (`warm`), the EventLog record and `explain`.
`explain(xplane=dir)` (and `--xplane DIR`) appends the top ops of a
`Device.StartTrace` capture by measured device time (`xprof.top_ops`).

CLI: `python -m singa_tpu_torch.introspect --config tiny --device cpu`.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from . import config, observe

# ---- enums (the lint in tools/check_metrics_names.py greps these) ---------

#: Low-cardinality blame reasons for `singa_recompile_total{reason=...}`
#: (the JAX package's enum): batch_bucket (only a leading dim changed;
#: the detail names the power-of-two class crossed), shape, dtype,
#: new_step_tag, static_args, arg_count, donation, new_function (an
#: identical signature rebuilt, e.g. a step after a restore dropped its
#: graphs), unknown.
RECOMPILE_REASONS = ("batch_bucket", "shape", "dtype", "new_step_tag",
                     "static_args", "arg_count", "donation",
                     "new_function", "unknown")
REASON_BATCH_BUCKET = "batch_bucket"
REASON_SHAPE = "shape"
REASON_DTYPE = "dtype"
REASON_NEW_STEP_TAG = "new_step_tag"
REASON_STATIC_ARGS = "static_args"
REASON_ARG_COUNT = "arg_count"
REASON_DONATION = "donation"
REASON_NEW_FUNCTION = "new_function"
REASON_UNKNOWN = "unknown"

#: Build phases for `singa_compile_phase_seconds{phase=...}` (the mapping
#: of the port's builds onto them is in the module docstring).
COMPILE_PHASES = ("trace", "lower", "compile")
PHASE_TRACE = "trace"
PHASE_LOWER = "lower"
PHASE_COMPILE = "compile"

#: Executable keys (the `key=` label on the gauges and histograms).
EXEC_KEYS = ("step", "eval", "serving.prefill", "serving.decode_scan",
             "serving.beam")

# ---- per-card peaks (NVIDIA's public datasheets) ---------------------------

#: Dense bf16 tensor-core peak TFLOP/s, matched in order against the
#: lower-cased `torch.cuda.get_device_name()` (the first key it contains
#: wins). The H100 SXM ("NVIDIA H100 80GB HBM3") row is the value
#: chip_smoke.py's bounds use. Source: the NVIDIA H100 Tensor Core GPU
#: datasheet (SXM 1,979 / NVL 1,671 / PCIe 1,513 TFLOP/s bf16 with
#: sparsity, half of it dense), the NVIDIA H200 datasheet (as H100 SXM)
#: and the NVIDIA A100 datasheet (312 TFLOP/s bf16 dense).
PEAK_TFLOPS_BF16 = [
    ("h100 nvl", 835.0),
    ("h100 pcie", 756.0),
    ("h100", 989.0),
    ("h200", 989.0),
    ("a100", 312.0),
]

#: Memory bandwidth GB/s by card, from the same datasheets (H100 SXM
#: 3.35 TB/s, NVL 3.9 TB/s, PCIe 2 TB/s; H200 4.8 TB/s; A100 80GB
#: 2,039 GB/s, 40GB 1,555 GB/s).
PEAK_HBM_GBS = [
    ("h100 nvl", 3900.0),
    ("h100 pcie", 2000.0),
    ("h100", 3350.0),
    ("h200", 4800.0),
    ("a100-sxm4-80gb", 2039.0),
    ("a100 80gb", 2039.0),
    ("a100", 1555.0),
]


def chip_peak(device_kind: str, table):
    """The table's value for the first key `device_kind` contains (lower
    case), or None for a card the table does not know."""
    kind = (device_kind or "").lower()
    for key, peak in table:
        if key in kind:
            return peak
    return None


_peak_override: "float | None" = None


def set_peak_tflops(v: "float | None"):
    """Override the peak used by the MFU gauge (None = the table)."""
    global _peak_override
    _peak_override = float(v) if v else None
    return _peak_override


def peak_tflops(device_kind: "str | None" = None) -> "float | None":
    """Peak TFLOP/s for MFU: the override > `config.PEAK_TFLOPS`
    (`SINGA_TPU_PEAK_TFLOPS`) > `PEAK_TFLOPS_BF16` for `device_kind` (the
    last step build's card when None)."""
    if _peak_override is not None:
        return _peak_override
    cfg = getattr(config, "PEAK_TFLOPS", None)
    if cfg:
        return float(cfg)
    kind = device_kind if device_kind is not None else _step_device_kind
    return chip_peak(kind or "", PEAK_TFLOPS_BF16)


def device_kind(device) -> str:
    """The card's name (`torch.cuda.get_device_name`) of a Device or
    torch device, "cpu" off the card."""
    td = getattr(device, "torch_device", None) or torch.device(device)
    if td.type != "cuda":
        return td.type
    return torch.cuda.get_device_name(td)


# ---- state -----------------------------------------------------------------

MAX_HISTORY = 64

_history: dict = {}    # key -> [signature dicts]
_builds: dict = {}     # key -> [build records]
_blames: list = []     # chronological blame records
_manifest: list = []   # executable manifest ({key, fingerprint, hlo_path})
_hlo_dir: "str | None" = None
_step_flops = 0.0
_step_device_kind = ""
_lock = threading.Lock()


def reset():
    """Clear all introspection state (the tests call this between
    cases)."""
    global _hlo_dir, _step_flops, _step_device_kind, _peak_override
    with _lock:
        _history.clear()
        _builds.clear()
        del _blames[:]
        del _manifest[:]
    _hlo_dir = None
    _step_flops = 0.0
    _step_device_kind = ""
    _peak_override = None
    observe.set_step_callback(None)


# ---- abstract call signatures ---------------------------------------------

def _dtype_name(dt) -> str:
    """numpy's name of a dtype ("float32", "bfloat16", "int32")."""
    return str(dt).removeprefix("torch.")


def _aval(a):
    shape = getattr(a, "shape", None)
    dt = getattr(a, "dtype", None)
    return (tuple(int(s) for s in shape) if shape is not None else (),
            _dtype_name(dt) if dt is not None else type(a).__name__)


def _leaf(x):
    """A `tensor.Tensor`'s raw tensor, anything else as it is."""
    if not torch.is_tensor(x) and torch.is_tensor(getattr(x, "data", None)):
        return x.data
    return x


def _flatten(x, out):
    """The leaves of a tuple/list/dict tree in the JAX package's order
    (dict keys sorted; None holds no leaf)."""
    if isinstance(x, (tuple, list)):
        for v in x:
            _flatten(v, out)
    elif isinstance(x, dict):
        for k in sorted(x, key=str):
            _flatten(x[k], out)
    elif x is not None:
        out.append(_leaf(x))
    return out


def signature(args, names=None, tag=None, static=None, donated=(),
              batch_hint=None):
    """Abstract call signature of a positional-arg tuple: one
    (name, shape, dtype) entry per tensor or array leaf (containers
    expand to `name0`, `name1`, ...), plus the non-array dimensions a
    rebuild can key on: step tag, static-arg repr, donation set, and the
    true batch size (`batch_hint`) when the leading dim is a padded
    bucket. Dtypes carry numpy's names, so equal leaves give the JAX
    package's signature."""
    leaves = []
    seq = args if isinstance(args, (tuple, list)) else (args,)
    for i, a in enumerate(seq):
        nm = names[i] if names and i < len(names) else f"a{i}"
        if isinstance(a, (tuple, list, dict)):
            for j, leaf in enumerate(_flatten(a, [])):
                leaves.append((f"{nm}{j}",) + _aval(leaf))
        else:
            leaves.append((nm,) + _aval(_leaf(a)))
    return {"tag": tag, "static": static, "donated": tuple(donated),
            "leaves": leaves,
            "batch_hint": int(batch_hint) if batch_hint else None}


def _bucket(n) -> int:
    """Power-of-two batch-size class containing n."""
    n = int(n)
    return n if n <= 1 else 1 << (n - 1).bit_length()


def blame(prev: dict, cur: dict):
    """Diff two signatures into (reason, detail). `reason` is always a
    member of RECOMPILE_REASONS; `detail` is the one-liner that lands in
    the EventLog record."""
    if prev.get("tag") != cur.get("tag"):
        return (REASON_NEW_STEP_TAG,
                f"step tag {prev.get('tag')}->{cur.get('tag')}")
    if prev.get("static") != cur.get("static"):
        return (REASON_STATIC_ARGS,
                f"static args {prev.get('static')}->{cur.get('static')}")
    if prev.get("donated") != cur.get("donated"):
        return (REASON_DONATION,
                f"donated argnums {prev.get('donated')}"
                f"->{cur.get('donated')}")
    pl = {n: (s, d) for n, s, d in prev["leaves"]}
    cl = {n: (s, d) for n, s, d in cur["leaves"]}
    if set(pl) != set(cl):
        added = sorted(set(cl) - set(pl))[:4]
        gone = sorted(set(pl) - set(cl))[:4]
        return (REASON_ARG_COUNT,
                f"{len(pl)}->{len(cl)} array args"
                + (f" (+{','.join(added)})" if added else "")
                + (f" (-{','.join(gone)})" if gone else ""))
    for n, cs, cd in cur["leaves"]:
        ps, pd = pl[n]
        if pd != cd:
            return REASON_DTYPE, f"arg `{n}` dtype {pd}->{cd}"
    for n, cs, cd in cur["leaves"]:
        ps, _pd = pl[n]
        if ps == cs:
            continue
        if ps and cs and len(ps) == len(cs) and ps[1:] == cs[1:]:
            ho = prev.get("batch_hint") or ps[0]
            hn = cur.get("batch_hint") or cs[0]
            bo, bn = _bucket(ho), _bucket(hn)
            if bo != bn:
                return (REASON_BATCH_BUCKET,
                        f"arg `{n}` batch {ho}->{hn} "
                        f"crossed bucket {bo}->{bn}")
            return (REASON_BATCH_BUCKET,
                    f"arg `{n}` batch {ho}->{hn} within bucket {bn}")
        return REASON_SHAPE, f"arg `{n}` shape {ps}->{cs}"
    return (REASON_NEW_FUNCTION,
            "identical signature rebuilt from a fresh callable")


def _nearest(history, sig):
    """The prior signature with the fewest differences from `sig`, so the
    blame names what changed rather than diffing against an arbitrary
    ancestor."""
    best, best_score = None, None
    for prev in reversed(history):
        score = 0
        if prev.get("tag") != sig.get("tag"):
            score += 100
        if prev.get("static") != sig.get("static"):
            score += 100
        pl = {n: (s, d) for n, s, d in prev["leaves"]}
        cl = {n: (s, d) for n, s, d in sig["leaves"]}
        score += 10 * len(set(pl) ^ set(cl))
        score += sum(1 for n in set(pl) & set(cl) if pl[n] != cl[n])
        if best_score is None or score < best_score:
            best, best_score = prev, score
            if score == 0:
                break
    return best


def _sig_fingerprint(key: str, sig: dict) -> str:
    """16-hex fingerprint of (key, abstract call signature): the identity
    builds are manifested and blamed under, computable before the build
    (the JAX package's formula, so equal signatures give equal
    fingerprints in both packages)."""
    return hashlib.sha256(
        (key + "|" + json.dumps(
            {"tag": sig.get("tag"), "static": sig.get("static"),
             "donated": list(sig.get("donated") or ()),
             "leaves": [[n, list(s), d] for n, s, d in sig["leaves"]]},
            sort_keys=True, default=str)).encode()).hexdigest()[:16]


# ---- metric plumbing (enum-guarded: see tools/check_metrics_names.py) -----

def _count_recompile(reason, key):
    if reason not in RECOMPILE_REASONS:
        reason = REASON_UNKNOWN
    if observe.is_enabled():
        observe.counter(
            "singa_recompile_total",
            "retraces after the first compile, by structured blame reason"
        ).inc(reason=reason, key=key)


def _observe_phase(phase, key, seconds):
    assert phase in COMPILE_PHASES, phase
    if observe.is_enabled():
        observe.histogram(
            "singa_compile_phase_seconds",
            "build wall seconds per phase (trace: the first call, counted; "
            "lower: 0; compile: a CUDA-graph capture or an nvcc build)"
        ).observe(seconds, phase=phase, key=key)


def compile_phase_totals() -> dict:
    """{phase: total wall seconds} accumulated so far in
    singa_compile_phase_seconds, summed across build keys. Zeros before
    any build (or with observe disabled)."""
    out = {p: 0.0 for p in COMPILE_PHASES}
    h = observe.get_registry().get("singa_compile_phase_seconds")
    if h is None:
        return out
    for row in h.snapshot():
        ph = (row.get("labels") or {}).get("phase")
        if ph in out:
            out[ph] += float(row.get("sum") or 0.0)
    return out


def _set_hbm_gauges(mem, key):
    # spelled out (no loop over a name table) so the static metric-name
    # lint sees every registration
    if not observe.is_enabled():
        return
    if "arguments" in mem:
        observe.gauge("singa_hbm_arguments_bytes",
                      "build argument bytes (inputs, parameters, buffers, "
                      "optimizer states)").set(float(mem["arguments"]),
                                               key=key)
    if "outputs" in mem:
        observe.gauge("singa_hbm_outputs_bytes",
                      "build output bytes").set(float(mem["outputs"]),
                                                key=key)
    if "temps" in mem:
        observe.gauge("singa_hbm_temps_bytes",
                      "build temporary bytes (the warm-up's peak rise, "
                      "CUDA)").set(float(mem["temps"]), key=key)
    if "generated_code" in mem:
        observe.gauge("singa_hbm_generated_code_bytes",
                      "executable generated-code bytes"
                      ).set(float(mem["generated_code"]), key=key)


def note_step_flops(flops):
    """Record the flops of the step signature being dispatched (the model
    calls this when it switches signatures), so MFU uses the running
    signature's flops rather than the most recently built one's."""
    global _step_flops
    _step_flops = float(flops or 0.0)


def _mfu_callback(seconds):
    """Fed each step's wall seconds by observe.record_step (dispatch
    time) and record_step_fenced (device latency, when verbosity
    profiling is on). A sample implying more than the card's peak is an
    asynchronous-dispatch artifact and is dropped (unless the peak is
    overridden)."""
    peak = peak_tflops(_step_device_kind)
    if not peak or not _step_flops or seconds <= 0:
        return
    mfu = _step_flops / seconds / 1e12 / peak * 100.0
    if mfu > 100.0 and _peak_override is None:
        return
    observe.gauge(
        "singa_mfu_pct",
        "model flops utilization of the last step, percent of the card's "
        "dense bf16 peak (counted flops/step / step_seconds / peak)"
    ).set(mfu)


# ---- the counting mode -----------------------------------------------------

#: ops that allocate or alias and move no data
_NO_ACCESS = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "detach", "alias",
                        "lift_fresh"))
_counting = 0   # counts running in the process (the wrappers' fast path)
_PLANS: dict = {}   # op -> (flop formula or None, moves bytes)


def _nbytes(tree) -> int:
    """Bytes of the raw tensors in a tuple/list/dict tree (the counting
    mode's per-op hot path, hence no generic flatten)."""
    n, todo = 0, [tree]
    tensor, seq = torch.Tensor, (tuple, list)
    while todo:
        x = todo.pop()
        if isinstance(x, tensor):
            n += x.nbytes
        elif isinstance(x, seq):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
    return n


def _shapes(tree) -> str:
    return ", ".join(f"{_dtype_name(a.dtype)}{list(a.shape)}"
                     for a in _flatten(tree, []) if torch.is_tensor(a))


class _Counter(TorchDispatchMode):
    """The trace phase's counting mode: flops by flop_counter's formulas,
    bytes as each op's input plus output bytes, and (with `listing`) one
    line per op; the booked kernel calls add their own figures and mute
    the ops inside them. A collective of the data-parallel step
    (`c10d.allreduce_`, `c10d.allgather_`, ...) passes through and is
    listed with its tensors' types (its process group and work handle
    hold none), as `utils.dense_allreduce_types` reads it."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # no torch.compile runs under a count: keep __torch_dispatch__ out
        # of the dynamo-disabling wrapper, a third of the per-op cost
        return False

    def __init__(self, listing=False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.kernels: dict = {}
        self.lines = [] if listing else None
        self.quiet = 0
        # booked figures that live on the device (the decode kernels'
        # live positions), read in one transfer by cost()
        self.deferred: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.quiet:
            return out
        plan = _PLANS.get(func)
        if plan is None:
            packet = func._overloadpacket
            plan = _PLANS[func] = (
                flop_registry.get(packet),
                not func.is_view and packet.__name__ not in _NO_ACCESS)
        fc, moves = plan
        if fc is not None:
            self.flops += float(fc(*args, **kwargs, out_val=out))
        if moves:
            # the common case (flat args, one tensor out) inline
            n = 0
            for x in args:
                if isinstance(x, torch.Tensor):
                    n += x.nbytes
                elif isinstance(x, (tuple, list)):
                    n += _nbytes(x)
            if kwargs:
                n += _nbytes(kwargs)
            n += out.nbytes if isinstance(out, torch.Tensor) \
                else _nbytes(out)
            self.bytes += n
        self.n_ops += 1
        if self.lines is not None:
            self.lines.append(f"{func}({_shapes((args, kwargs))}) -> "
                              f"{_shapes(out)}")
        return out

    def cost(self) -> dict:
        by_dev: dict = {}
        for which, coef, t in self.deferred:
            by_dev.setdefault(t.device, []).append((which, coef, t))
        for terms in by_dev.values():
            vals = torch.stack([t for _, _, t in terms]).cpu().tolist()
            for (which, coef, _), v in zip(terms, vals):
                if which == "flops":
                    self.flops += coef * v
                else:
                    self.bytes += coef * v
        self.deferred = []
        return {"flops": self.flops, "bytes accessed": self.bytes,
                "aten ops": float(self.n_ops),
                "kernel launches": float(sum(self.kernels.values()))}


class on_device:
    """A booked figure that depends on data on the device: `const` plus
    coef x t for each (coef, t) in `terms`, t a 0-d integer tensor; the
    count reads every t in one transfer at its end."""

    __slots__ = ("const", "terms")

    def __init__(self, const, *terms):
        self.const = const
        self.terms = terms


def _active_counter() -> "_Counter | None":
    if not _counting:
        return None
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, _Counter):
            return m
    return None


class kernel_cost:
    """`with introspect.kernel_cost(cost): <the call>`, around a
    hand-written kernel's wrapper, both routes: while a count runs on
    this thread (or on the autograd thread its backward runs on), books
    `cost()` -> [(kernel name, flops, bytes, description), ...], one
    launch each, and mutes the aten ops inside (`cost`'s own included).
    Flops and bytes are numbers, or `on_device` sums where they depend
    on data on the device (no synchronize: the count reads them once, at
    its end). `cost` is only called then, so the wrappers pay nothing
    outside a build."""

    __slots__ = ("cost", "counter")

    def __init__(self, cost):
        self.cost = cost
        self.counter = None

    def __enter__(self):
        c = _active_counter()
        if c is not None and not c.quiet:
            c.quiet += 1
            self.counter = c
            for name, flops, nbytes, desc in self.cost():
                for which, v in (("flops", flops), ("bytes", nbytes)):
                    if isinstance(v, on_device):
                        const = v.const
                        c.deferred.extend((which, k, t) for k, t in v.terms)
                    else:
                        const = v
                    if which == "flops":
                        c.flops += float(const)
                    else:
                        c.bytes += float(const)
                c.kernels[name] = c.kernels.get(name, 0) + 1
                if c.lines is not None:
                    c.lines.append(f"kernel {name}({desc})")
        return self

    def __exit__(self, *exc):
        if self.counter is not None:
            self.counter.quiet -= 1
            self.counter = None
        return False


_nested = threading.local()   # seconds of kernel builds on this thread


def _nested_seconds() -> float:
    return getattr(_nested, "seconds", 0.0)


def _timed(fn):
    """(fn(), its wall seconds less the kernel builds nested in it)."""
    n0 = _nested_seconds()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0 - (_nested_seconds() - n0)


def trace(fn, listing=False):
    """Run `fn()` under a counting mode, the trace phase of a build:
    (out, counter, wall seconds less nested kernel builds);
    `counter.cost()` is the build's cost, `counter.lines` its op listing
    (kept while `capture_hlo` is on, or with `listing`)."""
    global _counting
    c = _Counter(listing or _hlo_dir is not None)
    with _lock:
        _counting += 1
    try:
        with c:
            out, seconds = _timed(fn)
    finally:
        with _lock:
            _counting -= 1
    return out, c, seconds


# ---- the op listing (the HLO text's counterpart) ---------------------------

def _write_ops(lines, key, fingerprint):
    if lines is None or not _hlo_dir:
        return None
    text = "\n".join(lines) + "\n"
    try:
        os.makedirs(_hlo_dir, exist_ok=True)
        safe = key.replace(".", "_").replace("/", "_")
        sha = hashlib.sha256(text.encode()).hexdigest()[:16]
        path = os.path.join(_hlo_dir, f"{safe}_{sha}.ops.txt")
        if not os.path.exists(path):
            with open(path, "w", encoding="utf-8") as f:
                f.write(text)
        with open(os.path.join(_hlo_dir, "manifest.jsonl"), "a",
                  encoding="utf-8") as f:
            f.write(json.dumps(
                {"key": key, "fingerprint": fingerprint, "hlo_sha": sha,
                 "path": path, "ts": round(time.time(), 6)}) + "\n")
        return path
    except OSError:
        return None


def capture_hlo(dir_path: "str | None"):
    """Enable (path) or disable (None) the per-build op listing: each
    later build writes `<key>_<sha>.ops.txt` plus a `manifest.jsonl` line
    under the directory (and, for a captured CUDA graph, `<key>_<sha>.dot`);
    `executable_manifest()` carries the paths."""
    global _hlo_dir
    _hlo_dir = str(dir_path) if dir_path else None
    return _hlo_dir


def executable_manifest():
    """Every build this process has seen: {key, fingerprint, hlo_path
    (when capture_hlo was on), ts}."""
    with _lock:
        return [dict(e) for e in _manifest]


def latest_fingerprint(key: str) -> "str | None":
    """The newest manifest fingerprint for `key`, or None before any
    build."""
    with _lock:
        for e in reversed(_manifest):
            if e.get("key") == key:
                return e.get("fingerprint")
    return None


def last_build(key: str) -> "dict | None":
    """The most recent build record for `key` (phases, cost, memory,
    blame)."""
    with _lock:
        recs = _builds.get(key)
        return dict(recs[-1]) if recs else None


def blame_history():
    """Chronological recompile-blame records ({key, reason, detail,
    ...})."""
    with _lock:
        return [dict(b) for b in _blames]


# ---- builds ----------------------------------------------------------------

def record_build(key, sig, phases, cost=None, memory=None, lines=None,
                 device=None, fingerprint=None, capture_pending=False,
                 warm=None):
    """Register one build (the port's `build_compiled` bookkeeping):
    phase histograms (all three, or trace and lower only while a CUDA
    graph's capture is pending: `complete_build` adds compile), the
    cost and memory gauges, the op listing, blame against the nearest
    prior signature of `key`, the EventLog record and the manifest
    entry; `warm` is the warm store's lookup result. Returns the build
    record."""
    fingerprint = fingerprint or _sig_fingerprint(key, sig)
    phases = {p: float(phases.get(p, 0.0)) for p in COMPILE_PHASES}
    for p in COMPILE_PHASES:
        if not (capture_pending and p == PHASE_COMPILE):
            _observe_phase(p, key, phases[p])
    cost = dict(cost or {})
    mem = dict(memory or {})
    if observe.is_enabled():
        observe.gauge("singa_xla_flops_per_step",
                      "flops of the build's first call, counted by the "
                      "port (flop_counter formulas, kernels by formula)"
                      ).set(float(cost.get("flops", 0.0) or 0.0), key=key)
        observe.gauge("singa_xla_bytes_accessed",
                      "bytes of the build's first call, counted by the "
                      "port (each op's inputs and outputs)"
                      ).set(float(cost.get("bytes accessed", 0.0) or 0.0),
                            key=key)
        _set_hbm_gauges(mem, key)
    rec = {"key": key, "fingerprint": fingerprint, "phases": phases,
           "cost": cost, "memory": mem,
           "hlo_path": _write_ops(lines, key, fingerprint),
           "warm": warm, "ts": round(time.time(), 6)}
    _register_build(key, sig, rec, device=device)
    return rec


def graph_dump_path(rec) -> "str | None":
    """Where a build's captured CUDA graph is dumped: `<key>_<sha>.dot`
    beside its op listing, or None when no listing was written."""
    path = (rec or {}).get("hlo_path")
    return path[:-len(".ops.txt")] + ".dot" if path else None


def complete_build(rec, compile_s, temps=None, graph_path=None):
    """A CUDA-graph build's capture: its seconds become the record's
    compile phase (and the histogram's sample), with `temps` its memory's
    temps when given and `graph_path` the graph's dump."""
    key = rec["key"]
    with _lock:
        rec["phases"]["compile"] = float(compile_s)
        if temps is not None:
            rec["memory"]["temps"] = int(temps)
        if graph_path is not None:
            rec["graph_path"] = graph_path
    _observe_phase(PHASE_COMPILE, key, float(compile_s))
    if temps is not None and observe.is_enabled():
        _set_hbm_gauges({"temps": temps}, key)
    return rec


# ---- the warm store's build records ----------------------------------------

RECORD_FORMAT = "singa_tpu_torch.build_record"


def _sig_json(sig) -> dict:
    return {"tag": sig.get("tag"), "static": sig.get("static"),
            "donated": list(sig.get("donated") or ()),
            "leaves": [[n, list(s), d] for n, s, d in sig["leaves"]],
            "batch_hint": sig.get("batch_hint")}


def export_executable(fn, args, key, fingerprint, *, sig=None,
                      record=None) -> "bytes | None":
    """Write the build record of `fn` for `args` into the warm store
    under (key, fingerprint): `record` (a build's, as `record_build`
    returned it) when given, else the count of one run of `fn(*args)`
    under the counting mode. The blob is JSON: the signature (`sig`, by
    default `signature(args)`), the cost, the memory and the op listing.
    Returns it, or None when the store is disabled or the write fails:
    the caller goes on without it."""
    from . import warmstart
    store = warmstart.get_store()
    if store is None:
        return None
    if sig is None:
        sig = signature(args)
    if record is None:
        out, c, _s = trace(lambda: fn(*args), listing=True)
        record = {"cost": c.cost(), "lines": c.lines,
                  "memory": {"arguments": _nbytes(_flatten(args, [])),
                             "outputs": _nbytes(_flatten(out, []))}}
    blob = json.dumps({
        "format": RECORD_FORMAT, "key": key, "fingerprint": fingerprint,
        "signature": _sig_json(sig), "cost": dict(record["cost"]),
        "memory": dict(record["memory"]), "lines": record.get("lines")},
        sort_keys=True, default=str).encode("utf-8")
    if store.save(key, fingerprint, blob) is None:
        return None
    return blob


def _decode(blob, key, fingerprint) -> "dict | None":
    """The stored record, or None when the blob is not one or was not
    written for this (key, signature)."""
    try:
        rec = json.loads(blob.decode("utf-8"))
        ok = (isinstance(rec, dict) and rec.get("format") == RECORD_FORMAT
              and rec.get("key") == key
              and _sig_fingerprint(key, rec["signature"]) == fingerprint
              and isinstance(rec.get("cost"), dict)
              and isinstance(rec.get("memory"), dict))
    except (ValueError, KeyError, TypeError, AttributeError):
        return None
    return rec if ok else None


def load_executable(key, fingerprint, *, count: bool = True):
    """Load the warm-store entry for (key, fingerprint): (record, result,
    seconds). The record is the stored build record ({signature, cost,
    memory, lines}; None unless `result` is "hit"), where the JAX
    package's is a callable; result is a member of
    warmstart.CACHE_RESULTS, or (None, None, 0.0) with the store
    disabled. An unreadable meta, a sha-256 mismatch, or a blob that does
    not decode or holds another signature classify as corrupt; a meta
    whose fingerprint or torch version differs as stale; both delete the
    entry, so the fresh build writes a clean replacement. With
    count=False the caller records the classification itself."""
    from . import warmstart
    store = warmstart.get_store()
    if store is None:
        return None, None, 0.0
    t0 = time.perf_counter()
    blob, result = store.load(key, fingerprint)
    rec = None
    if blob is not None:
        rec = _decode(blob, key, fingerprint)
        if rec is None:
            result = warmstart.RESULT_CORRUPT
            store.discard(key, fingerprint)
    seconds = time.perf_counter() - t0
    if count:
        warmstart.note_lookup(key, fingerprint, result, seconds)
    return rec, result, seconds


def first_call(fn, key, sig):
    """A build's trace phase with the warm store: look (key, signature
    fingerprint) up, then run `fn()` once, plainly on a hit (the stored
    record holds the count), else under the counting mode (with its
    listing while the store is enabled). Returns (out, cost, memory or
    None, lines, seconds, warm): `memory` is the stored one on a hit,
    `warm` the lookup's result (None with the store disabled)."""
    from . import warmstart
    warmstart.maybe_enable_from_env()
    stored = warm = None
    if warmstart.is_enabled():
        with observe.span("introspect.warm_load", key=key):
            stored, warm, _s = load_executable(key,
                                               _sig_fingerprint(key, sig))
    if stored is not None:
        out, seconds = _timed(fn)
        return (out, stored["cost"], stored["memory"], stored.get("lines"),
                seconds, warm)
    out, c, seconds = trace(fn, listing=warm is not None)
    return out, c.cost(), None, c.lines, seconds, warm


def build_compiled(fn, args, key, sig=None, device=None):
    """Build `fn` for `args`: the trace phase runs `fn(*args)` once (under
    the counting mode, or plainly on a warm-store hit), then the build
    registers (`record_build`). Returns (fn, build record); the call's
    outputs are discarded (`AotExecutor` keeps them)."""
    _out, rec = _build_call(fn, args, key, sig, device)
    return fn, rec


def _build_call(fn, args, key, sig=None, device=None):
    if sig is None:
        sig = signature(args)
    # span -> the goodput `compile` bucket; the watchdog taints a guard it
    # opens in
    with observe.span("introspect.build", key=key):
        out, cost, mem, lines, seconds, warm = first_call(
            lambda: fn(*args), key, sig)
    if mem is None:
        mem = {"arguments": _nbytes(_flatten(args, [])),
               "outputs": _nbytes(_flatten(out, []))}
    rec = record_build(key, sig, {"trace": seconds}, cost, mem, lines,
                       device=device, warm=warm)
    export_built(key, sig, rec, lines)
    return out, rec


def export_built(key, sig, rec, lines):
    """After a build whose lookup was not a hit (the store enabled):
    write its record, `lines` its op listing."""
    if rec.get("warm") not in (None, "hit"):
        export_executable(None, None, key, rec["fingerprint"], sig=sig,
                          record={"cost": rec["cost"],
                                  "memory": rec["memory"], "lines": lines})


def register_kernel_build(source, seconds, fingerprint, warm=None):
    """An nvcc build of `csrc/<source>.cu` (or, with the warm store, a
    hit's load): key `kernel.<source>`, its wall seconds the compile
    phase (netted out of any build whose first call it ran in), its
    fingerprint the source hash that names the library."""
    _nested.seconds = _nested_seconds() + float(seconds)
    sig = {"tag": None, "static": f"lib{source}-{fingerprint}.so",
           "donated": (), "leaves": [], "batch_hint": None}
    return record_build(f"kernel.{source}", sig, {"compile": seconds},
                        fingerprint=fingerprint, warm=warm)


def _register_build(key, sig, rec, device=None):
    with _lock:
        hist = _history.setdefault(key, [])
        recompile = bool(hist)
        reason = detail = None
        if recompile:
            reason, detail = blame(_nearest(hist, sig), sig)
            _blames.append({"key": key, "reason": reason, "detail": detail,
                            "fingerprint": rec["fingerprint"],
                            "ts": rec["ts"]})
            del _blames[:-4 * MAX_HISTORY]
        hist.append(sig)
        del hist[:-MAX_HISTORY]
        rec.update({"recompile": recompile, "reason": reason,
                    "detail": detail})
        _builds.setdefault(key, []).append(rec)
        del _builds[key][:-MAX_HISTORY]
        _manifest.append({"key": key, "fingerprint": rec["fingerprint"],
                          "hlo_path": rec["hlo_path"], "ts": rec["ts"]})
        del _manifest[:-4 * MAX_HISTORY]
    if recompile:
        _count_recompile(reason, key)
    if observe.is_enabled():
        observe.get_registry().emit({
            "kind": "recompile" if recompile else "compile",
            "key": key, "reason": reason, "detail": detail,
            "fingerprint": rec["fingerprint"],
            "phases": {k: round(v, 6) for k, v in rec["phases"].items()},
            "flops": rec["cost"].get("flops"),
            # the warm store's lookup result (hit|miss|stale|corrupt),
            # None with the store disabled: the EventLog doubles as the
            # warm-start audit trail
            "warm": rec.get("warm"),
        })
    if key == "step":
        global _step_flops, _step_device_kind
        _step_flops = float(rec["cost"].get("flops", 0.0) or 0.0)
        if device is not None:
            _step_device_kind = device_kind(device)
            if rec["cost"]:
                # refreshed at every step build: after a rebuild,
                # PrintTimeProfiling reports the current signature's cost
                device.cost_analysis = dict(rec["cost"])
        if _step_flops > 0:
            observe.set_step_callback(_mfu_callback)


class AotExecutor:
    """Wrap a callable so that every distinct abstract signature of its
    arguments registers a build (`build_compiled`'s bookkeeping: the
    first call under the counting mode, blame, manifest) and every call
    dispatches `fn`. There is no fallback branch: an error propagates,
    and an out-of-memory error writes its one bundle through the
    `memory.on_oom` context around the call site."""

    __slots__ = ("fn", "key", "names", "donated", "_execs")

    def __init__(self, fn, key, names=None, donated=()):
        self.fn = fn
        self.key = key
        self.names = names
        self.donated = tuple(donated)
        self._execs = {}

    @staticmethod
    def _sig_key(args):
        return tuple(_aval(a) for a in _flatten(args, []))

    def __call__(self, *args):
        k = self._sig_key(args)
        if k in self._execs:
            return self.fn(*args)
        sig = signature(args, names=self.names, donated=self.donated)
        out, rec = _build_call(self.fn, args, self.key, sig)
        self._execs[k] = rec["fingerprint"]
        return out


# ---- the explain report ----------------------------------------------------

def explain(model=None, device=None, xplane=None, top=10) -> dict:
    """Everything this module knows, as one report dict: per-key build
    records, the recompile history, the executable manifest and (given a
    model and device) params, GFLOP/step, the memory breakdown, the mean
    step time, achieved TFLOP/s and MFU, the memory ledger's live regions
    and the fit estimate; with `xplane` (a `Device.StartTrace` log dir),
    the top-K ops by measured device time (`xprof.top_ops`)."""
    from . import memory
    with _lock:
        rep = {"builds": {k: [dict(r) for r in v]
                          for k, v in _builds.items()}}
    rep["recompiles"] = blame_history()
    rep["executables"] = executable_manifest()
    if model is not None:
        rep["params"] = int(sum(t.numel()
                                for t in model._raw_params().values()))
    step = last_build("step")
    flops = 0.0
    if step:
        flops = float(step["cost"].get("flops", 0.0) or 0.0)
        rep["gflops_per_step"] = flops / 1e9
        rep["bytes_accessed_per_step"] = float(
            step["cost"].get("bytes accessed", 0.0) or 0.0)
        rep["hbm"] = dict(step.get("memory") or {})
        rep["compile_phases_s"] = {
            k: round(v, 6) for k, v in (step.get("phases") or {}).items()}
        rep["fingerprint"] = step.get("fingerprint")
    if device is not None and device.step_times:
        mean_s = sum(device.step_times) / len(device.step_times)
        rep["step_ms_mean"] = mean_s * 1e3
        if flops and mean_s > 0:
            ach = flops / mean_s / 1e12
            rep["achieved_tflops"] = ach
            peak = peak_tflops(device_kind(device))
            if peak:
                rep["peak_tflops"] = peak
                rep["mfu_pct"] = ach / peak * 100.0
    if xplane:
        from . import xprof
        rep["top_ops"] = [
            {"op": r["op"], "category": r["category"],
             "total_ms": round(r["total_ms"], 3),
             "pct": round(r["pct"], 1)}
            for r in xprof.top_ops(xplane, top)]
    led = memory.get_ledger()
    if led is not None and led.timeline:
        rep["mem_regions"] = dict(led.timeline[-1]["regions"])
    if model is not None:
        rep["memory_fit"] = memory.estimate_fit(model=model, device=device)
    return rep


def _mb(b):
    return f"{(b or 0) / 1e6:.2f} MB"


def format_explain(rep: dict) -> str:
    lines = ["== singa_tpu_torch introspect: build & memory explain =="]
    if "params" in rep:
        lines.append(f"params: {rep['params'] / 1e6:.3f} M")
    if "gflops_per_step" in rep:
        lines.append(f"step build [{rep.get('fingerprint', '?')}]: "
                     f"{rep['gflops_per_step']:.4f} GFLOP/step, "
                     f"{_mb(rep.get('bytes_accessed_per_step'))} accessed")
    ph = rep.get("compile_phases_s")
    if ph:
        warm = ((rep.get("builds") or {}).get("step") or [{}])[-1].get(
            "warm")
        lines.append("  compile phases: " + "  ".join(
            f"{p} {ph.get(p, 0.0):.3f}s" for p in COMPILE_PHASES)
            + (f"  (warm store: {warm})" if warm else ""))
    hbm = rep.get("hbm")
    if hbm:
        lines.append("  memory: " + " | ".join(
            f"{k} {_mb(v)}" for k, v in sorted(hbm.items())))
    if "step_ms_mean" in rep:
        tail = ""
        if "achieved_tflops" in rep:
            tail = f" -> {rep['achieved_tflops']:.4f} TFLOP/s achieved"
            if "mfu_pct" in rep:
                tail += (f" (MFU {rep['mfu_pct']:.2f}% of "
                         f"{rep['peak_tflops']:g} peak)")
        lines.append(f"  step time: {rep['step_ms_mean']:.3f} ms mean"
                     + tail)
    for key, recs in sorted(rep.get("builds", {}).items()):
        if key == "step":
            continue
        r = recs[-1]
        fl = float(r["cost"].get("flops", 0.0) or 0.0)
        lines.append(f"{key} build [{r['fingerprint']}]: "
                     f"{fl / 1e9:.4f} GFLOP, compile "
                     f"{r['phases'].get('compile', 0.0):.3f}s"
                     + (f", warm store: {r['warm']}" if r.get("warm")
                        else ""))
    mr = rep.get("mem_regions")
    if mr:
        live = " | ".join(f"{k} {_mb(v)}" for k, v in sorted(mr.items())
                          if v)
        lines.append(f"  live memory (ledger): {live or 'empty'}")
    fit = rep.get("memory_fit")
    if fit:
        lim = fit.get("limit_bytes")
        lines.append(
            f"  memory fit: est peak {_mb(fit['estimated_peak_bytes'])}"
            + (f" vs limit {_mb(lim)} -> "
               f"{'fits' if fit['fits'] else 'DOES NOT FIT'}"
               if lim else " (device limit unknown)"))
    blames = rep.get("recompiles", [])
    lines.append(f"recompile history ({len(blames)}):")
    for b in blames:
        lines.append(f"  [{b['key']}] {b['reason']}: {b['detail']}")
    execs = rep.get("executables", [])
    if execs:
        lines.append(f"executables ({len(execs)}):")
        for e in execs:
            lines.append(f"  {e['key']}@{e['fingerprint']}"
                         + (f"  hlo: {e['hlo_path']}" if e.get("hlo_path")
                            else ""))
    tops = rep.get("top_ops")
    if tops:
        lines.append(f"top {len(tops)} ops by device time (xplane):")
        for r in tops:
            lines.append(f"  {r['op'][:60]:<60} {r['total_ms']:>8.3f} ms "
                         f"{r['pct']:>5.1f}%")
    return "\n".join(lines)


# ---- CLI: python -m singa_tpu_torch.introspect -----------------------------

_CLI_PRESETS = {
    "tiny": dict(model="mlp", batch=8, size=16),
    "mlp": dict(model="mlp", batch=32, size=64),
    "cnn": dict(model="cnn", batch=4, size=28),
    "resnet18": dict(model="resnet18", batch=4, size=32),
    "gpt": dict(model="gpt", batch=2, size=64,
                gpt_dim=128, gpt_layers=2, gpt_heads=4),
}


def _build_cli_model(cfg: str, dev, seed=0):
    """The preset's model (from the port's own `models`) and one
    synthetic batch on `dev`: (model, tx, ty), in the shapes bench.py
    gives the JAX CLI's presets."""
    import numpy as np

    from . import models, tensor
    p = dict(_CLI_PRESETS[cfg])
    rng = np.random.RandomState(seed)
    b, size = p["batch"], p["size"]
    if p["model"] == "gpt":
        vocab = 8192
        m = models.create_model("gpt", vocab_size=vocab, max_seq=size,
                                dim=p["gpt_dim"], num_heads=p["gpt_heads"],
                                num_layers=p["gpt_layers"],
                                device=dev.torch_device, seed=seed)
        ids = rng.randint(0, vocab, (b, size)).astype(np.int32)
        tgt = np.roll(ids, -1, axis=1).astype(np.int32)
        return m, tensor.from_numpy(ids, dev), tensor.from_numpy(tgt, dev)
    if p["model"] == "mlp":
        m = models.create_model("mlp", data_size=size, num_classes=10)
        x = rng.standard_normal((b, size)).astype(np.float32)
    else:
        m = models.create_model(p["model"], num_channels=3)
        x = rng.standard_normal((b, 3, size, size)).astype(np.float32)
    y = rng.randint(0, 10, b).astype(np.int32)
    return m, tensor.from_numpy(x, dev), tensor.from_numpy(y, dev)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m singa_tpu_torch.introspect",
        description="Build & memory explain report: build a preset model, "
                    "run a few graph-mode steps, and print GFLOP/step, "
                    "the memory breakdown, compile-phase times and the "
                    "recompile history.")
    ap.add_argument("--config", default="tiny",
                    choices=sorted(_CLI_PRESETS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--no-retrace", dest="retrace", action="store_false",
                    default=True,
                    help="skip the 3/4-batch step that demonstrates "
                         "recompile blame")
    ap.add_argument("--xplane", default=None, metavar="DIR",
                    help="a Device.StartTrace log dir: append the top-K "
                         "ops by measured device time (xprof.top_ops)")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--hlo-dir", default=None, metavar="DIR",
                    help="write each build's op listing + manifest")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="override the card's peak for the MFU line")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from . import device as device_mod
    from . import opt as opt_mod
    from . import tensor
    dev = device_mod.of(device_mod.resolve(args.device))
    if dev.torch_device.type == "cuda":
        dev = device_mod.best_device()
    if args.peak_tflops:
        set_peak_tflops(args.peak_tflops)
    if args.hlo_dir:
        capture_hlo(args.hlo_dir)
    m, tx, ty = _build_cli_model(args.config, dev)
    m.set_optimizer(opt_mod.SGD(lr=0.1, momentum=0.9))
    m.compile([tx], is_train=True, use_graph=True)
    dev.SetVerbosity(1)
    dev.SetSkipIteration(0)
    for _ in range(max(args.steps, 1)):
        m(tx, ty)
    b = int(tx.shape[0])
    if args.retrace and b >= 4:
        nb = (3 * b) // 4
        m(tensor.from_numpy(tx.numpy()[:nb], dev),
          tensor.from_numpy(ty.numpy()[:nb], dev))
    rep = explain(model=m, device=dev, xplane=args.xplane, top=args.top)
    if args.json:
        print(json.dumps(rep, default=str))
    else:
        print(format_explain(rep))
    return 0


__all__ = [
    "RECOMPILE_REASONS", "COMPILE_PHASES", "EXEC_KEYS",
    "PEAK_TFLOPS_BF16", "PEAK_HBM_GBS", "chip_peak",
    "set_peak_tflops", "peak_tflops", "device_kind",
    "signature", "blame", "build_compiled", "record_build",
    "complete_build", "graph_dump_path", "register_kernel_build",
    "kernel_cost", "on_device", "trace",
    "export_executable", "load_executable", "first_call", "export_built",
    "AotExecutor", "note_step_flops",
    "capture_hlo", "executable_manifest", "latest_fingerprint",
    "last_build", "blame_history",
    "compile_phase_totals",
    "explain", "format_explain", "reset", "main",
]


if __name__ == "__main__":
    import sys as _sys
    # run through the package module so the CLI's state (capture, peak
    # override) and the model's build records live in one instance
    from singa_tpu_torch import introspect as _canonical
    _sys.exit(_canonical.main())
