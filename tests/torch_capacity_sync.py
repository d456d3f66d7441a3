"""The capacity A/B's served rate on the CPU, for either package.

    python tests/torch_capacity_sync.py singa_tpu_torch [--root DIR] [--runs N]
    python tests/torch_capacity_sync.py singa_tpu [--root DIR] [--runs N]
    python tests/torch_capacity_sync.py singa_tpu_torch --profile-sync

The first two forms run `<package>.capacity --ab` (the port with
`--device cpu`) N times in this process, one after another, from the
checkout at DIR (default: this one), and print per run its `ok`, the
sustainable rps of the last decision, the ramp leg's polls, the first
scale-down poll and the median wall time of the engines' decode syncs
(each sync's window holds the A/B's fixed 0.15 s stall, so the host's own
cost is the median less 0.15 s), read from every engine's sync ring
before it stops; for the port also the median of the decode call alone
(`ServingEngine._decode`, inside the sync). The cores it ran on are
printed first.

`--profile-sync` builds one port engine at the A/B's widths on one
intra-op thread, times 20 of its decode calls (one sync each) after a
warm-up, and prints the aten operators that took the time (cProfile's
view is the same: eager dispatch).

Not a test: the A/B reads wall clocks, so run it on an otherwise idle
host.
"""

import argparse
import contextlib
import importlib
import io
import json
import os
import statistics
import sys
import tempfile
import time


def run_once(pkg: str, out: str) -> dict:
    cap = importlib.import_module(pkg + ".capacity")
    eng = importlib.import_module(pkg + ".engine")
    durs, decodes = [], []
    stop = eng.ServingEngine.stop
    decode = getattr(eng.ServingEngine, "_decode", None)

    def keep_syncs(self, *a, **k):
        durs.extend(r["dur"] for r in self.sync_records())
        return stop(self, *a, **k)

    def timed_decode(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return decode(self, *a, **k)
        finally:
            decodes.append(time.perf_counter() - t0)

    eng.ServingEngine.stop = keep_syncs
    if pkg.endswith("_torch"):
        eng.ServingEngine._decode = timed_decode
    argv = ["--ab", "--out", out]
    if pkg.endswith("_torch"):
        argv += ["--device", "cpu"]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cap.main(argv)
    finally:
        eng.ServingEngine.stop = stop
        if decode is not None:
            eng.ServingEngine._decode = decode
    with open(out, encoding="utf-8") as f:
        rec = [json.loads(x) for x in f if x.strip()][-1]
    res = {"rc": rc, "ok": rec["ok"],
           "sustainable_rps": rec["decision_tail"][-1]["sustainable_rps"],
           "ramp_polls": rec["ramp_polls"],
           "first_scale_down_poll": rec["first_scale_down_poll"],
           "direction_changes": [rec["ramp_direction_changes"],
                                 rec["cool_direction_changes"]],
           "syncs": len(durs),
           "median_sync_ms": round(1e3 * statistics.median(durs), 2)}
    if decodes:
        res["median_decode_ms"] = round(1e3 * statistics.median(decodes), 2)
    return res


def profile_sync(n=20):
    """One port engine at the A/B's widths (2 slots, dim 64, 2 layers,
    vocab 211, page 8) on one intra-op thread: 20 decode calls timed
    after a warm-up, then the aten operators of 5 under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from singa_tpu_torch import engine, router, serving
    torch.set_num_threads(1)
    T = 12 + 12 + 4
    m = router._build_replica_model(211, 64, 2, T, "cpu")
    e = engine.ServingEngine(m, max_slots=2, page_size=8, max_ctx=T)
    e._params = serving.decode_state(m, e.dtype)
    e._pools = e._alloc_pools(e.core, m)
    tok = torch.zeros(2, dtype=torch.long)
    ptab = torch.as_tensor(e._ptab).clone()
    ptab[0, :3] = torch.tensor([0, 1, 2])
    ptab[1, :3] = torch.tensor([3, 4, 5])
    lens, limits = torch.tensor([8, 8]), torch.tensor([20, 20])
    active = torch.tensor([True, True])

    def sync():
        return e._decode(tok, ptab, lens, limits, active, False)

    for _ in range(5):
        sync()
    t0 = time.perf_counter()
    for _ in range(n):
        sync()
    ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            sync()
    ops = sum(e.count for e in prof.key_averages()
              if e.key.startswith("aten::")) / 5
    print(json.dumps({"decode_ms": round(ms, 3), "steps_per_sync":
                      e.steps_per_sync, "aten_calls_per_sync": ops}))
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=12))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("package", choices=("singa_tpu_torch", "singa_tpu"))
    p.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--profile-sync", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    print(json.dumps({"package": args.package, "root": args.root,
                      "cores": len(os.sched_getaffinity(0)),
                      "cpu_count": os.cpu_count()}), flush=True)
    if args.profile_sync:
        profile_sync()
        return 0
    with tempfile.TemporaryDirectory() as d:
        for i in range(args.runs):
            res = run_once(args.package, os.path.join(d, f"cap{i}.json"))
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
