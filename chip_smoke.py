#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (singa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Environment: the card's name and power limit, torch/CUDA/nvcc
   versions, and the build of every kernel (one nvcc per source, all
   started together) with its time.
2. Each kernel against its plain PyTorch version on the card, at the
   serving path's shapes: max abs error against the stated tolerance,
   and the kernel's time beside the plain version's, its bound and the
   one-call library yardstick where there is one.
3. Full-width GPT-2-small (random weights from a seed), teacher-forced:
   prefill + token_step on the kernels against use_kernel=False in fp32
   (dense and paged), and the bf16 logit drift and top-1 agreement.
4. The main path, two entry points run one after the other:
   GPT.generate (batch 8, prompt 128, 128 new tokens, bf16), then a
   ServingEngine answering 16 requests. Every kernel launch counter is
   reset just before each and read just after it, and each path's
   counts must be exactly one launch per layer per prefill or step.
   4b. The engine in fp32 on the card: its greedy tokens on the kernels
   must equal its tokens with use_kernel=False and fp32 GPT.generate's.
5. Where the time goes: device time by kernel under torch.profiler for a
   short generate call and a short engine run.
6. The `kernels` JSON line, then the card line, then the result line.

Needs one CUDA card; with none it prints no result and exits 1.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# tolerances of a kernel against its plain version on the same inputs:
# fp32 differs by summation order only; a bf16 kernel rounds O to bf16
# (held against the plain version evaluated in fp32 on the same values)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# fp32 teacher-forced GPT-2-small logits, kernels against plain versions
LOGIT_TOL = 1e-3
HBM_BYTES_S = 3.35e12                  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,      # dense tensor cores
              "float32": 67e12}        # fp32 outside the tensor cores
GPT2_SMALL = dict(vocab_size=50257, max_seq=1024, dim=768, num_heads=12,
                  num_layers=12, attn_bias=True)
SEED = 0


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, n=25, warm=3):
    """Median ms of `fn` over n launches, CUDA events around each."""
    for _ in range(warm):
        fn()
    evs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def bound_ms(nbytes, flops, dtype):
    tb, tf = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
def phase_env(torch, build):
    print("== phase 1: environment")
    print(f"card: {card_line()}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc.splitlines()[-1]}")
    print(f"device: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({len(build.SOURCES)} sources, parallel nvcc)")
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def _case(torch, rows, name, route_src, replaces, dtype, shape, out, ref,
          plain_fn, kernel_fn, library_fn, nbytes, flops):
    err = float((out.float() - ref.float()).abs().max())
    tol = TOL[dtype]
    ms = time_ms(torch, kernel_fn)
    plain_ms = time_ms(torch, plain_fn)
    lib_ms = time_ms(torch, library_fn) if library_fn else None
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    ok = err <= tol and np.isfinite(err)
    print(f"  {name} {dtype} {shape}: max_abs_err {err:.3e} (tol {tol}) "
          f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
          f"{'%.4f ms' % lib_ms if lib_ms is not None else 'none'}")
    rows.append(dict(name=name, route="cuda", source=route_src,
                     replaces=replaces, dtype=dtype, shape=shape,
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    if not ok:
        fail(f"{name} {dtype} {shape} disagrees with its plain version")


def phase_kernels(torch, A):
    """Each kernel against its plain version at the slice's shapes."""
    import torch.nn.functional as F
    print("== phase 2: kernels against their plain versions")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    # K1: flash-attention forward, causal, D=64, the prefill shapes
    for B, S in ((1, 16), (1, 128), (1, 1023), (8, 128)):
        H, D = 12, 64
        for dn, dt in dts.items():
            q, k, v = (torch.randn((B, H, S, D), generator=g, device=dev)
                       .to(dt) for _ in range(3))
            out = A.flash_attention(q, k, v, True)
            torch.cuda.synchronize()
            ref = A.attention_reference(q.float(), k.float(), v.float(),
                                        True)
            el = q.element_size()
            _case(torch, rows, "flash_fwd",
                  "singa_tpu_torch/csrc/flash_fwd.cu",
                  "singa_tpu/ops/attention.py:112 _flash_fwd_kernel", dn,
                  [B, H, S, D], out, ref,
                  lambda: A.attention_reference(q, k, v, True),
                  lambda: A.flash_attention(q, k, v, True),
                  lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True),
                  4 * B * H * S * D * el + 4 * B * H * S,
                  4 * B * H * D * S * (S + 1) / 2)
    # K3 / K4: decode at N=8 slots, Hp=6, Q=2, PD=128, T=1024
    N, Hp, Q, PD, T, ps, n_pages = 8, 6, 2, 128, 1024, 16, 512
    lens_l = [1, 17, 512, 1024, 100, 333, 777, 64]
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    M = T // ps
    perm = torch.randperm(n_pages, generator=g, device=dev)
    pt = perm[:N * M].reshape(N, M).to(torch.int32).contiguous()
    live = sum(lens_l)
    pages_live = sum(-(-n // ps) for n in lens_l)
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None,
                                                                  None, :]
    for dn, dt in dts.items():
        el = torch.tensor([], dtype=dt).element_size()
        q = torch.randn((N, Hp, Q, PD), generator=g, device=dev).to(dt)
        K, V = (torch.randn((N, Hp, T, PD), generator=g, device=dev).to(dt)
                for _ in range(2))
        out = A.flash_decode(q, K, V, lens, scale=0.125)
        torch.cuda.synchronize()
        ref = A.flash_decode_reference(q.float(), K.float(), V.float(),
                                       lens, 0.125)
        io_bytes = 2 * N * Hp * Q * PD * el + 4 * N
        flops = 4 * Hp * Q * PD * live
        _case(torch, rows, "flash_decode",
              "singa_tpu_torch/csrc/flash_decode.cu",
              "singa_tpu/ops/attention.py:1237 _flash_decode_kernel", dn,
              [N, Hp, Q, PD, T], out, ref,
              lambda: A.flash_decode(q, K, V, lens, 0.125, use_kernel=False),
              lambda: A.flash_decode(q, K, V, lens, 0.125),
              lambda: F.scaled_dot_product_attention(q, K, V, attn_mask=mask,
                                                     scale=0.125),
              io_bytes + 2 * live * Hp * PD * el, flops)
        kp, vp = (torch.randn((n_pages, Hp, ps, PD), generator=g,
                              device=dev).to(dt) for _ in range(2))
        out = A.paged_attention(q, kp, vp, pt, lens, ps, scale=0.125)
        torch.cuda.synchronize()
        ref = A.paged_attention_reference(q.float(), kp.float(), vp.float(),
                                          pt, lens, ps, 0.125)
        _case(torch, rows, "paged_attention",
              "singa_tpu_torch/csrc/paged_attention.cu",
              "singa_tpu/ops/attention.py:1019 _paged_fwd_kernel", dn,
              [N, Hp, Q, PD, ps, n_pages], out, ref,
              lambda: A.paged_attention(q, kp, vp, pt, lens, ps, 0.125,
                                        use_kernel=False),
              lambda: A.paged_attention(q, kp, vp, pt, lens, ps, 0.125),
              None,
              io_bytes + 2 * live * Hp * PD * el + 4 * pages_live, flops)
    return rows


def _paged_from_dense(torch, caches, ps, g):
    """Dense (n, Hp, T, PD) caches -> page pools with a random page
    table holding the same rows."""
    n, Hp, T, PD = caches[0][0].shape
    M = T // ps
    perm = torch.randperm(n * M, generator=g, device=caches[0][0].device)
    pools = []
    for Kc, Vc in caches:
        pair = []
        for C in (Kc, Vc):
            pages = C.reshape(n, Hp, M, ps, PD).transpose(1, 2) \
                .reshape(n * M, Hp, ps, PD)
            pool = torch.empty_like(pages)
            pool[perm] = pages
            pair.append(pool)
        pools.append(tuple(pair))
    return pools, perm.reshape(n, M).to(torch.int32).contiguous()


def phase_teacher_forced(torch, model, serving):
    print("== phase 3: GPT-2-small teacher-forced, kernels against plain")
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    n, S0, steps, ps = 4, 128, 64, 16
    prompt = torch.randint(0, model.vocab_size, (n, S0), generator=g,
                           device=dev)
    feed = torch.randint(0, model.vocab_size, (n, steps), generator=g,
                         device=dev)
    core = serving._decode_core(model, S0, steps)

    def dense(p, use_kernel):
        logits, caches = core.prefill(p, prompt, n, use_kernel)
        out = [logits]
        for i in range(steps):
            logits, caches = core.token_step(p, feed[:, i], caches, i, n,
                                             use_kernel)
            out.append(logits)
        return torch.stack(out, 1).float()

    def paged(p, use_kernel):
        _, caches = core.prefill(p, prompt, n, use_kernel)
        pools, pt = _paged_from_dense(
            torch, caches, ps, torch.Generator(device=dev).manual_seed(7))
        active = torch.ones(n, dtype=torch.bool, device=dev)
        out = []
        for i in range(steps):
            lens = torch.full((n,), S0 + i, dtype=torch.int32, device=dev)
            logits, pools = core.paged_token_step(
                p, feed[:, i], pools, pt, lens, active, n, ps, use_kernel)
            out.append(logits)
        return torch.stack(out, 1).float()

    with torch.no_grad():
        p32 = serving.decode_state(model, None)
        dk, dp = dense(p32, None), dense(p32, False)
        pk, pp = paged(p32, None), paged(p32, False)
        torch.cuda.synchronize()
        d_err = float((dk - dp).abs().max())
        p_err = float((pk - pp).abs().max())
        x_err = float((pk - dk[:, 1:]).abs().max())
        print(f"  fp32 dense: max |dlogit| kernel vs plain {d_err:.3e} "
              f"(tol {LOGIT_TOL}), logit range "
              f"[{float(dk.min()):.2f}, {float(dk.max()):.2f}]")
        print(f"  fp32 paged: max |dlogit| kernel vs plain {p_err:.3e} "
              f"(tol {LOGIT_TOL}); paged kernel vs dense kernel "
              f"{x_err:.3e}")
        for what, e in (("dense", d_err), ("paged", p_err),
                        ("paged vs dense", x_err)):
            if not (e <= LOGIT_TOL):
                fail(f"fp32 {what} teacher-forced logits differ by {e}")
        pb = serving.decode_state(model, "bfloat16")
        bk, bp = dense(pb, None), dense(pb, False)
        if not torch.isfinite(bk).all():
            fail("non-finite bf16 logits")
        top1 = float((bk.argmax(-1) == bp.argmax(-1)).float().mean())
        print(f"  bf16 dense: max |dlogit| kernel vs plain "
              f"{float((bk - bp).abs().max()):.3e}, top-1 agreement "
              f"{top1:.4f}; vs fp32 kernel max |dlogit| "
              f"{float((bk - dk).abs().max()):.3e}")


def seeded_requests(vocab):
    """The main path's inputs from one numpy seed: the generate batch,
    and 16 engine requests as (prompt, max_new) with prompts of 8-512
    tokens and max_new of 16-128."""
    rng = np.random.RandomState(SEED)
    prompts = rng.randint(0, vocab, (8, 128)).astype(np.int32)
    specs = [(int(rng.randint(8, 513)), int(rng.randint(16, 129)))
             for _ in range(16)]
    reqs_in = [(rng.randint(0, vocab, (s,)).astype(np.int32), mn)
               for s, mn in specs]
    return prompts, reqs_in


def check_launches(path, got, want):
    """Fail unless one path's launch counts are exactly the expected
    ones (a kernel the path runs launches once per layer per call)."""
    print(f"  launches on {path}: {got} (expected {want})")
    if got != want:
        fail(f"{path} launched {got}, expected {want}")


def serve(engine, model, reqs_in, timeout_s=600, **kw):
    """One ServingEngine answering `reqs_in`; fails unless every request
    completes with its token count, every page is back on the free
    list and the thread is joined after stop(). Returns (requests, wall
    seconds, report before stop, steps after stop)."""
    eng = engine.ServingEngine(model, page_size=16, max_ctx=1024,
                               steps_per_sync=4, **kw).start()
    t0 = time.perf_counter()
    try:
        reqs = [eng.submit(pr, mn) for pr, mn in reqs_in]
        for r in reqs:
            if not r.wait(timeout_s):
                fail(f"request {r.id} did not finish")
        wall = time.perf_counter() - t0
        rep = eng.report()
        free_ok = sorted(eng._free_pages) == list(range(eng.num_pages))
    finally:
        eng.stop()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("torch-serve") and t.is_alive()]
    bad = [(r.id, r.outcome, len(r.tokens), mn)
           for r, (_, mn) in zip(reqs, reqs_in)
           if r.outcome != "completed" or len(r.tokens) != mn]
    if bad:
        fail(f"requests not completed with their token counts: {bad}")
    if not free_ok or rep["pages_in_use"] != 0:
        fail(f"pages leaked: {rep}")
    if alive or eng.running():
        fail(f"engine thread still alive after stop(): {alive}")
    return reqs, wall, rep, eng.report()["steps"]


def phase_main_path(torch, model, engine, serving, A):
    """The two user entry points, each its own path: every counter is
    reset just before the path runs and read just after it."""
    print("== phase 4: main path (GPT.generate, then ServingEngine), bf16")
    prompts, reqs_in = seeded_requests(model.vocab_size)
    (B, S0), new = prompts.shape, 128
    L = len(model.blocks)
    # warm (cuBLAS handles, the decode-param tree) and time one prefill,
    # all before the counted runs
    model.generate(prompts[:, :8], 2, dtype="bfloat16")
    core = serving._decode_core(model, S0, new)
    p = serving.decode_state(model, "bfloat16")
    pt = torch.as_tensor(prompts.astype(np.int64), device=model.device)
    with torch.no_grad():
        pre_ms = time_ms(torch, lambda: core.prefill(p, pt, B), n=5, warm=1)
    torch.cuda.synchronize()

    A.reset_launches()
    t0 = time.perf_counter()
    out = model.generate(prompts, new, dtype="bfloat16")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen = dict(A.LAUNCHES)
    if out.shape != (B, S0 + new) or not (out >= 0).all() \
            or not (out < model.vocab_size).all():
        fail(f"generate returned {out.shape} / out-of-vocab tokens")
    print(f"  generate: batch {B}, prompt {S0}, {new} new: "
          f"{gen_s:.3f} s, {B * new / gen_s:.1f} tok/s, prefill "
          f"{pre_ms:.3f} ms")
    # one prefill, then new - 1 dense steps
    check_launches("generate", gen, {"flash_fwd": L,
                                     "flash_decode": L * (new - 1),
                                     "paged_attention": 0})

    A.reset_launches()
    reqs, wall, rep, steps = serve(engine, model, reqs_in, max_slots=8,
                                   dtype="bfloat16")
    torch.cuda.synchronize()
    eng = dict(A.LAUNCHES)
    ntok = sum(len(r.tokens) for r in reqs)
    ttft = statistics.median(r.ttft_s for r in reqs)
    print(f"  engine: {len(reqs)} requests completed, {ntok} tokens, "
          f"{wall:.3f} s, {ntok / wall:.1f} tok/s, median TTFT "
          f"{ttft * 1e3:.1f} ms, {steps} steps, pages leaked 0, "
          f"thread joined")
    # one prefill per request, one paged step per engine step
    check_launches("the engine", eng, {"flash_fwd": L * len(reqs),
                                       "flash_decode": 0,
                                       "paged_attention": L * steps})
    # engine tokens against GPT.generate on the same prompts (bf16:
    # batch shape and bucket padding change rounding, so print only;
    # phase 4b holds the engine to exact tokens in fp32)
    same_seq = same_tok = 0
    for r, (pr, _) in zip(reqs, reqs_in):
        want = model.generate(pr[None, :], r.max_new,
                              dtype="bfloat16")[0, len(pr):]
        got = np.asarray(r.tokens)
        same_seq += int((got == want).all())
        same_tok += int((got == want).sum())
    print(f"  engine vs generate (bf16): {same_seq}/{len(reqs)} sequences "
          f"identical, {same_tok}/{ntok} tokens at equal positions")
    return {"generate": gen, "engine": eng}


def phase_engine_fp32(torch, model, engine):
    """The engine on the card in fp32, off the counted runs: its greedy
    tokens on the kernels must equal its tokens on the plain versions
    (use_kernel=False) and fp32 GPT.generate's on the same prompts. Four
    slots for six requests make admission reuse slots and pages."""
    print("== phase 4b: ServingEngine fp32 on the card, exact tokens")
    _, reqs_in = seeded_requests(model.vocab_size)
    picks = [(pr, min(mn, 32)) for pr, mn in reqs_in[:6]]
    runs = {}
    for use_kernel in (None, False):
        reqs, wall, _, steps = serve(engine, model, picks, max_slots=4,
                                     use_kernel=use_kernel)
        runs[use_kernel] = [np.asarray(r.tokens) for r in reqs]
        print(f"  engine fp32 use_kernel={use_kernel}: {len(reqs)} "
              f"requests, {sum(len(r.tokens) for r in reqs)} tokens, "
              f"{steps} steps, {wall:.3f} s")
    gen = [model.generate(pr[None, :], mn)[0, len(pr):] for pr, mn in picks]
    bad = []
    for i, (k, pl, g) in enumerate(zip(runs[None], runs[False], gen)):
        for what, other in (("plain", pl), ("generate", g)):
            if not np.array_equal(k, other):
                at = int(np.argmax(k != other))
                bad.append(f"request {i} vs {what}: first differs at "
                           f"{at} ({k[at]} != {other[at]})")
    print(f"  engine fp32 on the kernels vs plain engine and vs fp32 "
          f"generate: {len(picks) * 2 - len(bad)}/{len(picks) * 2} "
          f"sequence pairs identical")
    if bad:
        fail("fp32 engine tokens differ: " + "; ".join(bad))


_OURS = ("flash_fwd_kernel", "flash_decode_kernel", "paged_kernel")
_GEMM = ("gemm", "nvjet", "cutlass", "xmma")


def _breakdown(torch, what, fn):
    """Device time by kernel over one call of `fn` under torch.profiler:
    busy share of the wall time (profiler on), and the time split into
    this port's attention kernels, matrix products and the rest."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    # device-side events only (kernels, copies): a CPU op's own device
    # time counts the kernels it launched a second time
    rows = [(e.device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"  {what}: wall {wall_ms:.2f} ms; device time not measured "
              "(the profiler saw no device activity)")
        return
    cats = {"attention kernels": 0.0, "matmul": 0.0, "other": 0.0}
    for ms, _, name in rows:
        low = name.lower()
        cat = ("attention kernels" if any(k in name for k in _OURS)
               else "matmul" if any(k in low for k in _GEMM) else "other")
        cats[cat] += ms
    print(f"  {what}: wall {wall_ms:.2f} ms (profiler on), device busy "
          f"{busy:.2f} ms ({busy / wall_ms:.1%}), idle "
          f"{1 - busy / wall_ms:.1%}; "
          + ", ".join(f"{k} {v:.2f} ms ({v / busy:.1%})"
                      for k, v in cats.items()))
    for ms, count, name in sorted(rows, reverse=True)[:6]:
        print(f"    {ms:9.3f} ms {ms / busy:6.1%} x{count:<5d} {name[:70]}")


def phase_profile(torch, model, engine):
    """Where the time goes on the card, for both entry points (bf16)."""
    print("== profile: device time by kernel (torch.profiler)")
    rng = np.random.RandomState(SEED + 2)
    prompts = rng.randint(0, model.vocab_size, (8, 128)).astype(np.int32)
    _breakdown(torch, "generate b8 prompt 128 +32",
               lambda: model.generate(prompts, 32, dtype="bfloat16"))
    reqs_in = [(rng.randint(0, model.vocab_size, (256,)).astype(np.int32),
                32) for _ in range(8)]
    _breakdown(torch, "engine 8 requests prompt 256 +32",
               lambda: serve(engine, model, reqs_in, timeout_s=300,
                             max_slots=8, dtype="bfloat16"))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from singa_tpu_torch import engine, models, serving
    from singa_tpu_torch.ops import _build
    from singa_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase_env(torch, _build)
    rows = phase_kernels(torch, A)
    t0 = time.perf_counter()
    model = models.create_model("gpt", device="cuda", seed=SEED,
                                **GPT2_SMALL)
    print(f"GPT-2-small built on {model.device} in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in model.parameters())} parameters")
    phase_teacher_forced(torch, model, serving)
    by_path = phase_main_path(torch, model, engine, serving, A)
    phase_engine_fp32(torch, model, engine)
    phase_profile(torch, model, engine)

    # the JSON line reports each kernel at the main path's shape and
    # dtype; `launches` sums the two paths' counted runs
    main_shape = {"flash_fwd": [8, 12, 128, 64]}
    kernels = []
    for name in A.LAUNCHES:
        cands = [r for r in rows if r["name"] == name
                 and r["dtype"] == "bfloat16"
                 and r["shape"] == main_shape.get(name, r["shape"])]
        r = dict(cands[-1])
        r["launches_by_path"] = {k: v[name] for k, v in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["launches"] <= 0:
            fail(f"kernel {name} was not launched on the main path")
        kernels.append(r)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
