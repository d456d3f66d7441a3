"""Per-op trace analysis (counterpart of singa_tpu/xprof.py): torch.profiler
traces read into op time tables.

The JAX package decodes `jax.profiler`'s `*.xplane.pb` files. The port
reads what its own `Device.StopTrace` writes: torch.profiler's Chrome
trace JSON (`export_chrome_trace`), one `*.pt.trace.json` file a capture
under the log dir, each CPU operator's counted flops added to its
arguments as `"flops"`. From those files it builds the JAX package's rows.

  - `parse_xspace(path)` -> planes. `/host:CPU` holds the CPU operators
    (`cpu_op`) and the `record_function` ranges (`user_annotation`), one
    line per thread; `/device:GPU:<n>` holds the CUDA kernels, memcpys and
    memsets, one line per stream. A range also shows on the device, as one
    event from its first kernel to its last (`gpu_user_annotation`): that
    is an envelope, not a kernel, and is left out.
  - `op_table(logdir)`: device rows are the CUDA events. A trace with no
    device plane (a CPU capture) falls back to the CPU operators, as
    JAX's falls back to its host plane. CPU operators nest
    (`aten::linear` around `aten::addmm`), where XLA's host ops are flat,
    so each counts its SELF time (its wall time less its children's on
    the same thread): every microsecond of operator time is counted once
    and the pct still sums to 100.
  - `singa.span/...` rows are the ranges `observe.span` opens while a
    profile runs; they keep JAX's separate pct pool, and `span_table`
    its `depth` column.
  - `_category` keeps JAX's rules for HLO-style names and adds the names
    the card prints: cuBLAS/cuBLASLt/CUTLASS `gemm`/`xmma`/`nvjet`
    kernels are `matmul` wherever the match falls, cuDNN convolutions
    `conv`, NCCL's `ncclDevKernel_AllReduce`/`_AllGather` `allreduce`/
    `allgather`, memcpy and memset `copy`, and the hand-written kernels
    of `csrc/` (`flash_*`, `paged_kernel*`, `scale_cast_kernel`)
    `attention`; aten names map the same way (`aten::mm` is `matmul`).
  - `hlo_category_table`: there is no HLO on the card. Its rows are
    `_category`'s categories over the same events op_table counts, with
    the flops torch.profiler's `with_flops` gives (an operator's flops go
    to its first kernel's category on the device) and 0 bytes (the
    profiler gives none).

Usage:
    dev.StartTrace(logdir); ...steps...; dev.StopTrace()
    table = xprof.op_table(logdir)          # list of dicts, sorted by time
    print(xprof.format_table(table))
"""

from __future__ import annotations

import glob
import json
import os
import re
from collections import defaultdict

from .observe import SPAN_TRACE_PREFIX as SPAN_PREFIX

#: the file name ending of one capture (torch's tensorboard handler's)
TRACE_SUFFIX = ".pt.trace.json"

#: Chrome-trace event categories of the device plane, and the host's
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation")


class _Plane:
    """One plane of a trace: `name` ("/host:CPU" or "/device:GPU:<n>")
    and `lines`, [(line name, [(op, dur_ps, args)])] in time order."""

    __slots__ = ("name", "lines")

    def __init__(self, name):
        self.name = name
        self.lines = []


def _self_times(events):
    """[(name, dur_ps, args)] of one thread's nested CPU operators, each
    its own time less its children's. `events`: [(ts_us, dur_us, name,
    args)]."""
    out, stack = [], []          # stack: [index into out, end_us]
    for ts, dur, name, args in sorted(events, key=lambda e: (e[0], -e[1])):
        while stack and stack[-1][1] <= ts:
            stack.pop()
        if stack:
            parent = out[stack[-1][0]]
            parent[1] -= dur
        out.append([name, dur, args])
        stack.append((len(out) - 1, ts + dur))
    return [(n, max(0, round(d * 1e6)), a) for n, d, a in out]


def parse_xspace(path: str):
    """One `*.pt.trace.json` capture -> its planes (see the module
    docstring). A torn or empty file yields no plane rather than raising,
    as JAX's reader ends at a torn tail."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    host = defaultdict(list)       # (tid, cat) -> [(ts, dur, name, args)]
    dev = defaultdict(lambda: defaultdict(list))  # pid -> tid -> [...]
    for e in events or ():
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ev = (float(e.get("ts") or 0.0), float(e.get("dur") or 0.0),
              str(e.get("name", "")), e.get("args") or {})
        if cat in _HOST_CATS:
            host[e.get("tid"), cat].append(ev)
        elif cat in _DEVICE_CATS:
            dev[e.get("pid")][e.get("tid")].append(ev)
    planes = []
    if host:
        p = _Plane("/host:CPU")
        for (tid, cat), evs in sorted(host.items(), key=lambda kv:
                                      (str(kv[0][0]), kv[0][1])):
            if cat == "cpu_op":
                p.lines.append((f"ops {tid}", _self_times(evs)))
            else:
                p.lines.append((f"annotations {tid}", [
                    (n, max(0, round(d * 1e6)), a)
                    for _, d, n, a in sorted(evs, key=lambda e: e[0])]))
        planes.append(p)
    for pid in sorted(dev, key=str):
        p = _Plane(f"/device:GPU:{pid}")
        for tid in sorted(dev[pid], key=str):
            p.lines.append((f"stream {tid}", [
                (n, max(0, round(d * 1e6)), a)
                for _, d, n, a in sorted(dev[pid][tid],
                                         key=lambda e: e[0])]))
        planes.append(p)
    return planes


# ---- aggregation -----------------------------------------------------------

_CATEGORY_RULES = [
    # the JAX package's rules for HLO-style names, first and unchanged
    ("span", re.compile(r"^singa\.span/")),
    ("conv", re.compile(r"^(%?)conv(?!ert)", re.I)),
    ("matmul", re.compile(r"^(%?)(dot|gemm|matmul)", re.I)),
    ("fusion", re.compile(r"^(%?)fusion", re.I)),
    ("allreduce", re.compile(r"(all-reduce|allreduce)", re.I)),
    ("allgather", re.compile(r"(all-gather|allgather)", re.I)),
    ("copy", re.compile(r"^(%?)(copy|transpose|bitcast)", re.I)),
    ("reduce", re.compile(r"^(%?)reduce", re.I)),
    ("infeed/outfeed", re.compile(r"(infeed|outfeed)", re.I)),
    # the names the card and torch print
    ("attention", re.compile(r"(^|[\s:])(flash_(fwd|bwd|decode)\w*|"
                             r"paged_kernel\w*|scale_cast_kernel)\b")),
    ("conv", re.compile(r"(cudnn|convolve|convolution|implicit_gemm|"
                        r"fprop|dgrad|wgrad|^aten::(_?conv|cudnn_conv))",
                        re.I)),
    ("matmul", re.compile(r"(gemm|xmma|nvjet|cutlass|cublas|"
                          r"^aten::(mm|addmm|bmm|baddbmm|matmul|linear|"
                          r"einsum)$)", re.I)),
    ("copy", re.compile(r"(^memcpy|^memset|^aten::(copy_|_to_copy|"
                        r"clone|contiguous)$)", re.I)),
]


def _category(op_name: str) -> str:
    for cat, rx in _CATEGORY_RULES:
        if rx.search(op_name):
            return cat
    return "other"


def find_xplane_files(logdir: str):
    """The trace files of every capture under `logdir` (the name is the
    JAX package's: there they are `*.xplane.pb`)."""
    return sorted(glob.glob(
        os.path.join(logdir, "**", "*" + TRACE_SUFFIX), recursive=True))


def _planes(logdir):
    return [p for path in find_xplane_files(logdir)
            for p in parse_xspace(path)]


def op_table(logdir: str, device_only: bool = True,
             include_async: bool = False):
    """Aggregate per-op device time across all traces under `logdir`.

    Returns a list of dicts sorted by total_ms desc:
      {op, category, total_ms, count, avg_us, pct}
    With `device_only` and a device plane, only the device's events count
    (kernels, memcpy, memset); otherwise every plane's events, the CPU
    operators at their self time. `include_async` is the JAX package's
    (its overlapped DMA lines); a torch trace has no such line, so it
    changes nothing.

    Span rows (`observe.span`'s ranges, category "span") come from the
    host's annotation lines and are appended after the device rows in
    their own pct pool, as in the JAX package; a range's extent on the
    device is never a row.
    """
    all_planes = _planes(logdir)
    dev_planes = [p for p in all_planes if p.name.startswith("/device:")]
    planes = dev_planes if device_only and dev_planes else all_planes
    total_ps = defaultdict(int)
    count = defaultdict(int)
    span_ps = defaultdict(int)
    span_count = defaultdict(int)
    for plane in all_planes:
        for line_name, events in plane.lines:
            if not line_name.startswith("annotations"):
                continue
            for op, dur_ps, _ in events:
                if op.startswith(SPAN_PREFIX):
                    span_ps[op] += dur_ps
                    span_count[op] += 1
    for plane in planes:
        for line_name, events in plane.lines:
            if line_name.startswith("annotations"):
                continue  # ranges: the span pool above, or not ops
            for op, dur_ps, _ in events:
                total_ps[op] += dur_ps
                count[op] += 1

    def make_rows(ps_map, n_map):
        grand = sum(ps_map.values()) or 1
        rows = [
            {
                "op": op,
                "category": _category(op),
                "total_ms": ps / 1e9,
                "count": n_map[op],
                "avg_us": ps / 1e6 / max(n_map[op], 1),
                "pct": 100.0 * ps / grand,
            }
            for op, ps in ps_map.items()
        ]
        rows.sort(key=lambda r: -r["total_ms"])
        return rows

    return make_rows(total_ps, count) + make_rows(span_ps, span_count)


def top_ops(path_or_table, k: int = 10):
    """Top-k ops by total device time: the explain report's "where did
    the step actually go" section. Accepts a trace logdir (runs
    `op_table` on it) or an already-built op_table row list. Span
    envelope rows are excluded — a span is host wall time AROUND the
    device ops already in the ranking."""
    rows = op_table(path_or_table) if isinstance(path_or_table, str) \
        else [dict(r) for r in path_or_table]
    # JAX's python-frame TraceMe rows ("$file.py:NN fn") are dropped as
    # there: a table read by either package ranks the same
    rows = [r for r in rows if r.get("category") != "span"
            and not r.get("op", "").startswith("$")]
    rows.sort(key=lambda r: -r.get("total_ms", 0.0))
    return rows[:int(k)]


def diff_op_tables(before, after):
    """Per-op time delta between two op_table row lists: the evidence
    bundle's "which ops got slower" section, useful standalone for any
    before/after trace pair.

    Returns rows sorted by regression contribution (delta_ms desc):
      {op, category, before_ms, after_ms, delta_ms, ratio,
       pct_of_regression}
    `ratio` is after/before (None for ops absent on one side — a new op
    diffs against 0, a vanished op contributes its negative delta).
    `pct_of_regression` is each op's share of the total POSITIVE delta,
    so the top rows name the regression even when other ops got faster.
    Span envelope rows and python-frame "$file.py" rows are excluded,
    matching top_ops — the diff ranks device ops."""
    def fold(rows):
        out = {}
        for r in rows or []:
            if r.get("category") == "span" \
                    or str(r.get("op", "")).startswith("$"):
                continue
            op = r.get("op")
            if op is None:
                continue
            prev = out.get(op)
            if prev is None:
                out[op] = dict(r)
            else:  # same op split across planes: sum it
                prev["total_ms"] = (prev.get("total_ms") or 0.0) \
                    + (r.get("total_ms") or 0.0)
        return out

    b, a = fold(before), fold(after)
    rows = []
    for op in set(b) | set(a):
        bm = float((b.get(op) or {}).get("total_ms") or 0.0)
        am = float((a.get(op) or {}).get("total_ms") or 0.0)
        rows.append({
            "op": op,
            "category": (a.get(op) or b.get(op) or {}).get("category"),
            "before_ms": round(bm, 6),
            "after_ms": round(am, 6),
            "delta_ms": round(am - bm, 6),
            "ratio": round(am / bm, 4) if bm > 0.0 and op in a
            else None,
        })
    pos = sum(r["delta_ms"] for r in rows if r["delta_ms"] > 0.0)
    for r in rows:
        r["pct_of_regression"] = (
            round(100.0 * r["delta_ms"] / pos, 2)
            if pos > 0.0 and r["delta_ms"] > 0.0 else 0.0)
    rows.sort(key=lambda r: -r["delta_ms"])
    return rows


def span_table(logdir: str):
    """Just the observe.span() rows of op_table (category "span"),
    with the `singa.span/` prefix stripped — the bridge between the
    live `singa_span_seconds` histogram and the post-hoc trace: both
    key on the same slash-joined span path.

    Each row carries a `depth` column (0 = top-level span, 1 = one
    enclosing span, ...) derived from the slash-joined path."""
    rows = [dict(r) for r in op_table(logdir, device_only=False)
            if r["category"] == "span"]
    for r in rows:
        r["op"] = r["op"][len(SPAN_PREFIX):]
        r["depth"] = r["op"].count("/")
    grand = sum(r["total_ms"] for r in rows) or 1.0
    for r in rows:
        r["pct"] = 100.0 * r["total_ms"] / grand
    return rows


def hlo_category_table(logdir: str, steps: int = 1):
    """Per-category time/bytes/flops table over the events `op_table`
    counts (the device's, or the CPU operators' self time on a CPU
    capture). There is no HLO on the card: the categories are
    `_category`'s, the flops torch.profiler's `with_flops` counted for
    the CPU operators (on the device an operator's flops go to its first
    kernel, matched by the trace's "External id"), and the bytes 0 (the
    profiler gives none). `steps`: divide totals to get per-step
    numbers. Returns rows sorted by time: {category, ms, gbytes, tflops,
    pct, achieved_gbs, tflops_s}."""
    planes = _planes(logdir)
    dev = [p for p in planes if p.name.startswith("/device:")]
    op_flops = {}
    for p in planes:
        for line_name, events in p.lines:
            if line_name.startswith("ops"):
                for _, _, args in events:
                    if args.get("flops"):
                        op_flops[args.get("External id")] = \
                            float(args["flops"])
    agg = defaultdict(lambda: [0, 0.0, 0.0])
    for plane in (dev or planes):
        for line_name, events in plane.lines:
            if line_name.startswith("annotations"):
                continue
            for op, dur_ps, args in events:
                a = agg[_category(op)]
                a[0] += dur_ps
                if dev:
                    a[2] += op_flops.pop(args.get("External id"), 0.0)
                else:
                    a[2] += float(args.get("flops") or 0.0)
    grand_ps = sum(a[0] for a in agg.values()) or 1
    rows = []
    for cat, (ps, b, fl) in agg.items():
        ms = ps / 1e9 / steps
        sec = ps / 1e12
        rows.append({
            "category": cat,
            "ms": ms,
            "gbytes": b / 1e9 / steps,
            "tflops": fl / 1e12 / steps,
            "pct": 100.0 * ps / grand_ps,
            "achieved_gbs": (b / steps) / (ms / 1e3) / 1e9 if ms else 0.0,
            "tflops_s": (fl / 1e12) / sec if sec else 0.0,
        })
    rows.sort(key=lambda r: -r["ms"])
    return rows


def format_hlo_categories(rows) -> str:
    lines = [f"{'category':<26} {'ms/step':>8} {'pct':>6} {'GB/step':>8} "
             f"{'GB/s':>7} {'TF/step':>8} {'TF/s':>7}"]
    for r in rows:
        lines.append(
            f"{r['category']:<26} {r['ms']:>8.3f} {r['pct']:>5.1f}% "
            f"{r['gbytes']:>8.3f} {r['achieved_gbs']:>7.0f} "
            f"{r['tflops']:>8.4f} {r['tflops_s']:>7.1f}")
    return "\n".join(lines)


def category_table(rows):
    """Collapse an op_table into per-category totals. Span rows are
    dropped: a span is a host-side envelope AROUND the device ops
    already counted in the other categories."""
    agg = defaultdict(lambda: [0.0, 0])
    for r in rows:
        if r["category"] == "span":
            continue
        agg[r["category"]][0] += r["total_ms"]
        agg[r["category"]][1] += r["count"]
    grand = sum(v[0] for v in agg.values()) or 1
    out = [
        {"category": c, "total_ms": ms, "count": n,
         "pct": 100.0 * ms / grand}
        for c, (ms, n) in agg.items()
    ]
    out.sort(key=lambda r: -r["total_ms"])
    return out


def format_table(rows, top: int = 25) -> str:
    lines = [f"{'op':<56} {'cat':<10} {'total_ms':>9} {'count':>6} "
             f"{'avg_us':>9} {'pct':>6}"]
    for r in rows[:top]:
        lines.append(
            f"{r['op'][:56]:<56} {r['category']:<10} {r['total_ms']:>9.3f} "
            f"{r['count']:>6} {r['avg_us']:>9.1f} {r['pct']:>5.1f}%")
    rest = rows[top:]
    if rest:
        ms = sum(r["total_ms"] for r in rest)
        pct = sum(r["pct"] for r in rest)
        lines.append(f"{'... ' + str(len(rest)) + ' more':<56} {'':<10} "
                     f"{ms:>9.3f} {'':>6} {'':>9} {pct:>5.1f}%")
    return "\n".join(lines)


__all__ = ["TRACE_SUFFIX", "parse_xspace", "find_xplane_files", "op_table",
           "top_ops", "diff_op_tables", "span_table", "hlo_category_table",
           "format_hlo_categories", "category_table", "format_table"]
