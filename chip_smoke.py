#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (singa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Environment: the card's name and power limit, torch/CUDA/nvcc
   versions, and the build of every kernel (one nvcc per source, all
   started together) with its time, per source too.
2. Each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes: the error against the stated
   tolerance, and the kernel's time beside the plain version's, its bound
   and the one-call library yardstick where there is one. The backward
   kernels (K2a fused, K2b dQ + K2c dK/dV split) run both routes of the
   dispatch, forced through `_FUSED_DQ_BYTES_CAP`, against
   `flash_bwd_reference`, with dq, dk and dv compared separately.
3. Full-width GPT-2-small (random weights from a seed), teacher-forced:
   prefill + token_step on the kernels against use_kernel=False in fp32
   (dense and paged), and the bf16 logit drift and top-1 agreement.
4. The serving main path, two entry points run one after the other:
   GPT.generate (batch 8, prompt 128, 128 new tokens, bf16), then a
   ServingEngine answering 16 requests. Every kernel launch counter is
   reset just before each and read just after it, and each path's
   counts must be exactly one launch per layer per prefill or step.
   4b. The engine in fp32 on the card: its greedy tokens on the kernels
   must equal its tokens with use_kernel=False and fp32 GPT.generate's.
6. The training main path: the repo's GPT training benchmark model
   (vocab 8192, dim 2048, 16 heads, 8 layers; random weights from a seed)
   through Model.compile(amp="bfloat16") and `m(ids, targets)` with SGD,
   batch 8 x 1024: one warm step, then timed steps with exact launch
   counts per step (K1 and K2a once per layer); then save_states,
   load_states into a fresh model, identical logits.
   6b. fp32 training on the card against the same steps on the CPU (plain
   versions), from identical weights: losses and parameters.
   6c. Long-context training (S = 16384, 2 layers, bf16), where the
   backward takes the split pair K2b + K2c, with exact launch counts, and
   one layer's backward held against `flash_bwd_reference`.
5. Where the time goes: device time by kernel under torch.profiler for a
   short generate call, a short engine run and one training step.
7. The `kernels` JSON line, then the card line, then the result line.

Needs one CUDA card; with none it prints no result and exits 1.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# tolerances of a kernel against its plain version on the same inputs:
# fp32 differs by summation order only; a bf16 kernel rounds O to bf16
# (held against the plain version evaluated in fp32 on the same values)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# flash backward against flash_bwd_reference, dq/dk/dv each: fp32 max abs
# error (the JAX package's flash-grad tolerance); bf16 max abs error over
# max |ref| (the pre-scaled q and the outputs round to bf16; the fused
# kernel's atomic dQ sums also change order from run to run)
BWD_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
# fp32 teacher-forced GPT-2-small logits, kernels against plain versions
LOGIT_TOL = 1e-3
# fp32 training on the card against the CPU: relative loss, absolute param
TRAIN_TOL = 1e-4
HBM_BYTES_S = 3.35e12                  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,      # dense tensor cores
              "float32": 67e12}        # fp32 outside the tensor cores
GPT2_SMALL = dict(vocab_size=50257, max_seq=1024, dim=768, num_heads=12,
                  num_layers=12, attn_bias=True)
# the repo's GPT training benchmark (bench.py): ~436 M parameters, D = 128
BENCH_GPT = dict(vocab_size=8192, max_seq=1024, dim=2048, num_heads=16,
                 num_layers=8)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 5
LONG_S, LONG_LAYERS = 16384, 2
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
          f"({len(build.SOURCES)} sources, parallel nvcc); per source: "
          + ", ".join(f"{n} {t:.2f} s"
                      for n, t in build.BUILD_SECONDS.items()))
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
    # K1 at the training shape (bench GPT, D=128)
    B, H, S, D = TRAIN_B, 16, TRAIN_S, 128
    q, k, v = (torch.randn((B, H, S, D), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    out = A.flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    ref = A.attention_reference(q.float(), k.float(), v.float(), True)
    _case(torch, rows, "flash_fwd", "singa_tpu_torch/csrc/flash_fwd.cu",
          "singa_tpu/ops/attention.py:112 _flash_fwd_kernel", "bfloat16",
          [B, H, S, D], out, ref,
          lambda: A.attention_reference(q, k, v, True),
          lambda: A.flash_attention(q, k, v, True),
          lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
          4 * B * H * S * D * 2 + 4 * B * H * S,
          4 * B * H * D * S * (S + 1) / 2)
    del q, k, v, out, ref
    # K2a / K2b / K2c: the backward, both routes, at the training shapes
    for shape, dn in (((TRAIN_B, 16, TRAIN_S, 128), "bfloat16"),
                      ((TRAIN_B, 12, TRAIN_S, 64), "bfloat16"),
                      ((1, 16, TRAIN_S, 128), "float32"),
                      ((1, 16, 4096, 128), "bfloat16")):
        bwd_case(torch, A, rows, g, shape, dn)
    return rows


def _bwd_bound(shape, el, n_products, n_out, causal=True):
    """(bound ms, by) of a backward kernel: it reads q, k, v, dO and the
    two fp32 row statistics once, writes n_out (B, H, S, D) tensors, and
    does n_products score-sized products over the (causal) pairs."""
    B, H, S, D = shape
    pairs = B * H * (S * (S + 1) / 2 if causal else S * S)
    nbytes = (4 + n_out) * B * H * S * D * el + 2 * B * H * S * 4
    return bound_ms(nbytes, n_products * 2 * D * pairs,
                    "bfloat16" if el == 2 else "float32")


def bwd_case(torch, A, rows, g, shape, dn, routes=("fused", "split"),
             n=10, n_plain=5):
    """The flash backward at one shape, causal: each route of the
    dispatch (forced through _FUSED_DQ_BYTES_CAP, as the JAX package's
    test forces it) against flash_bwd_reference on the same q, k, v, O,
    lse and dO; then the kernels' times, the plain version's, the bounds
    and SDPA's backward (forward + backward less forward)."""
    import torch.nn.functional as F
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dn]
    dev = torch.device("cuda")
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for _ in range(4))
    scale = shape[-1] ** -0.5
    o, lse = A._flash_fwd(q, k, v, True, scale)
    ref = A.flash_bwd_reference(q, k, v, o, lse, do, True, scale)
    tol = BWD_TOL[dn]
    errs = {}
    cap = A._FUSED_DQ_BYTES_CAP
    try:
        for route in routes:
            A._FUSED_DQ_BYTES_CAP = (1 << 60) if route == "fused" else 0
            got = A._flash_bwd(q, k, v, o, lse, do, True, scale)
            torch.cuda.synchronize()
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                d = float((a.float() - b.float()).abs().max())
                rel = d / float(b.float().abs().max())
                errs[route, name] = (d, rel)
                bad = not (rel if dn == "bfloat16" else d) <= tol
                print(f"  flash_bwd {route} {dn} {list(shape)} {name}: max "
                      f"abs err {d:.3e}, / max|ref| {rel:.3e} (tol {tol} "
                      f"{'relative' if dn == 'bfloat16' else 'absolute'}) "
                      f"{'FAIL' if bad else 'ok'}")
                if bad:
                    fail(f"flash_bwd {route} {dn} {shape} {name} disagrees "
                         "with flash_bwd_reference")
    finally:
        A._FUSED_DQ_BYTES_CAP = cap
    qf, delta = A._bwd_prepare(q, k, v, o, lse, do, scale)
    args = (qf, k, v, do, lse, delta, True)
    plain_ms = time_ms(torch, lambda: A.flash_bwd_reference(
        q, k, v, o, lse, do, True, scale), n=n_plain, warm=1)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_ms = (time_ms(torch, lambda: torch.autograd.grad(
        sdpa(), (ql, kl, vl), do), n=n, warm=2)
        - time_ms(torch, sdpa, n=n, warm=2))
    el = q.element_size()
    kernels = {"fused": [("flash_bwd_fused", "flash_bwd_fused.cu",
                          "351 _flash_bwd_fused_kernel", 5, 3,
                          ("dq", "dk", "dv"), lib_ms,
                          lambda: A._flash_bwd_fused(*args, scale))],
               "split": [("flash_bwd_dq", "flash_bwd_dq.cu",
                          "269 _flash_bwd_dq_kernel", 3, 1, ("dq",), None,
                          lambda: A._flash_bwd_dq(*args, scale)),
                         ("flash_bwd_dkv", "flash_bwd_dkv.cu",
                          "308 _flash_bwd_dkv_kernel", 4, 2, ("dk", "dv"),
                          None, lambda: A._flash_bwd_dkv(*args))]}
    for route in routes:
        for name, src, line, n_prod, n_out, outs, lib, fn in kernels[route]:
            ms = time_ms(torch, fn, n=n, warm=2)
            b_ms, b_by = _bwd_bound(shape, el, n_prod, n_out)
            err = max(errs[route, o_][0] for o_ in outs)
            rel = max(errs[route, o_][1] for o_ in outs)
            lib_s = f"{lib:.4f} ms (SDPA backward)" if lib else "none"
            print(f"  {name} {dn} {list(shape)}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"library {lib_s}")
            rows.append(dict(
                name=name, route="cuda", source=f"singa_tpu_torch/csrc/{src}",
                replaces=f"singa_tpu/ops/attention.py:{line}", dtype=dn,
                shape=list(shape), max_abs_err=err, rel_err=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib))
    if "split" in routes:
        print(f"  split pair {dn} {list(shape)}: SDPA backward "
              f"{lib_ms:.4f} ms")


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
    ones (a kernel the path runs launches once per layer per call; a
    kernel `want` does not name, zero times)."""
    want = {k: want.get(k, 0) for k in got}
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


_GEMM = ("gemm", "nvjet", "cutlass", "xmma")
SERVE_CATS = (("attention kernels", ("flash_fwd_kernel", "flash_decode_kernel",
                                     "paged_kernel")),)
TRAIN_CATS = (("flash fwd", ("flash_fwd_kernel",)),
              ("flash bwd", ("flash_bwd_", "scale_cast_kernel")))


def _breakdown(torch, what, fn, cats=SERVE_CATS):
    """Device time by kernel over one call of `fn` under torch.profiler:
    busy share of the wall time (profiler on), and the time split into
    the named kernel categories, matrix products and the rest."""
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
    totals = {label: 0.0 for label, _ in cats}
    totals.update({"matmul": 0.0, "other": 0.0})
    for ms, _, name in rows:
        cat = next((label for label, keys in cats
                    if any(k in name for k in keys)), None)
        if cat is None:
            cat = ("matmul" if any(k in name.lower() for k in _GEMM)
                   else "other")
        totals[cat] += ms
    print(f"  {what}: wall {wall_ms:.2f} ms (profiler on), device busy "
          f"{busy:.2f} ms ({busy / wall_ms:.1%}), idle "
          f"{1 - busy / wall_ms:.1%}; "
          + ", ".join(f"{k} {v:.2f} ms ({v / busy:.1%})"
                      for k, v in totals.items()))
    for ms, count, name in sorted(rows, reverse=True)[:6]:
        print(f"    {ms:9.3f} ms {ms / busy:6.1%} x{count:<5d} {name[:70]}")


def phase_profile(torch, model, engine, train_step):
    """Where the time goes on the card, for both serving entry points
    (bf16) and one training step at the bench width."""
    print("== phase 5: device time by kernel (torch.profiler)")
    rng = np.random.RandomState(SEED + 2)
    prompts = rng.randint(0, model.vocab_size, (8, 128)).astype(np.int32)
    _breakdown(torch, "generate b8 prompt 128 +32",
               lambda: model.generate(prompts, 32, dtype="bfloat16"))
    reqs_in = [(rng.randint(0, model.vocab_size, (256,)).astype(np.int32),
                32) for _ in range(8)]
    _breakdown(torch, "engine 8 requests prompt 256 +32",
               lambda: serve(engine, model, reqs_in, timeout_s=300,
                             max_slots=8, dtype="bfloat16"))
    _breakdown(torch, "train step b8 s1024 bf16 (bench width)", train_step,
               TRAIN_CATS)


def _train_batch(torch, vocab, B, S, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int64)
    tgt = np.roll(ids, -1, axis=1)
    return torch.as_tensor(ids), torch.as_tensor(tgt)


def _steps(torch, m, tx, ty, n):
    """n training steps, each fenced by loss.item(): (losses, ms)."""
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        _, loss = m(tx, ty)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    return losses, ms


def phase_train(torch, models, opt, A):
    """The training main path at the bench width: counters reset just
    before the timed steps and read just after them."""
    print("== phase 6: GPT training, bench width, bf16 amp, SGD")
    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))
    t0 = time.perf_counter()
    m = models.create_model("gpt", device="cuda", seed=SEED, **BENCH_GPT)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    m.compile([tx], is_train=True, use_graph=True, amp="bfloat16")
    print(f"  model: {sum(p.numel() for p in m.parameters())} parameters, "
          f"built in {time.perf_counter() - t0:.2f} s; batch {TRAIN_B} x "
          f"{TRAIN_S}; use_graph=True runs eagerly (no CUDA graph yet)")
    warm, warm_ms = _steps(torch, m, tx, ty, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    losses, ms = _steps(torch, m, tx, ty, TRAIN_STEPS)
    counts = dict(A.LAUNCHES)
    step = statistics.median(ms)
    print(f"  warm step {warm_ms[0]:.1f} ms, loss {warm[0]:.4f}; "
          f"{TRAIN_STEPS} timed steps: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; step ms {', '.join(f'{x:.2f}' for x in ms)}; median "
          f"{step:.2f} ms, {TRAIN_B * TRAIN_S / step * 1e3:.0f} tokens/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_launches("training", counts, {"flash_fwd": L * TRAIN_STEPS,
                                        "flash_bwd_fused": L * TRAIN_STEPS})

    # checkpoint round trip: a fresh model loading the zip gives the same
    # logits bit for bit
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "gpt.zip")
        t0 = time.perf_counter()
        m.save_states(path)
        save_s, size = time.perf_counter() - t0, os.path.getsize(path)
        fresh = models.create_model("gpt", device="cuda", seed=SEED + 1,
                                    **BENCH_GPT)
        fresh.compile([tx], is_train=False, amp="bfloat16")
        t0 = time.perf_counter()
        fresh.load_states(path)
        load_s = time.perf_counter() - t0
    m.eval()
    same = torch.equal(m(tx[:2]), fresh(tx[:2]))
    m.train()
    print(f"  save_states {size / 2**30:.2f} GiB in {save_s:.1f} s, "
          f"load_states into a fresh model {load_s:.1f} s; logits "
          f"identical: {same}")
    if not same:
        fail("logits differ after save_states/load_states")
    del fresh
    torch.cuda.empty_cache()
    return m, (tx, ty), counts


def phase_train_fp32(torch, models, opt, transformer):
    """Three fp32 SGD steps on the card (kernels) and on the CPU (plain
    versions) from identical weights."""
    print("== phase 6b: fp32 training, card against CPU")
    cfg = dict(vocab_size=8192, max_seq=256, dim=512, num_heads=8,
               num_layers=2)
    tx, ty = _train_batch(torch, cfg["vocab_size"], 2, 256, SEED + 4)
    mc = models.create_model("gpt", device="cpu", seed=SEED + 5, **cfg)
    mg = models.create_model("gpt", device="cuda", seed=SEED + 6, **cfg)
    transformer.load_singa_params(mg, {k: p.detach().numpy()
                                       for k, p in mc.get_params().items()})
    runs = []
    for m in (mc, mg):
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        m.compile([tx], is_train=True)
        dev = next(m.parameters()).device
        runs.append(_steps(torch, m, tx.to(dev), ty.to(dev), 3)[0])
    lc, lg = runs
    rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    pc = mc.get_params()
    perr = max(float((p.detach().cpu() - pc[k].detach()).abs().max())
               for k, p in mg.get_params().items())
    print(f"  losses card {[round(x, 6) for x in lg]}, CPU "
          f"{[round(x, 6) for x in lc]}: max relative difference "
          f"{rel:.3e}; params after 3 steps max abs difference {perr:.3e} "
          f"(tol {TRAIN_TOL} each)")
    if not (rel <= TRAIN_TOL and perr <= TRAIN_TOL):
        fail("fp32 training on the card differs from the CPU")


def phase_train_long(torch, models, opt, A, rows, g):
    """Long-context training, where the backward takes K2b + K2c; counters
    reset just before its steps and read just after them."""
    print(f"== phase 6c: long-context training, S {LONG_S}, "
          f"{LONG_LAYERS} layers, bf16 amp")
    cfg = dict(BENCH_GPT, max_seq=LONG_S, num_layers=LONG_LAYERS)
    tx, ty = (t.cuda() for t in _train_batch(torch, cfg["vocab_size"], 1,
                                             LONG_S, SEED + 6))
    m = models.create_model("gpt", device="cuda", seed=SEED + 6, **cfg)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    m.compile([tx], is_train=True, amp="bfloat16")
    A.reset_launches()
    losses, ms = _steps(torch, m, tx, ty, 2)
    counts = dict(A.LAUNCHES)
    print(f"  2 steps: losses {', '.join(f'{x:.4f}' for x in losses)}; step "
          f"ms {', '.join(f'{x:.1f}' for x in ms)} (the first includes "
          f"warm-up), {LONG_S / ms[-1] * 1e3:.0f} tokens/s at the second")
    check_launches("long-context training", counts, {
        "flash_fwd": 2 * LONG_LAYERS, "flash_bwd_dq": 2 * LONG_LAYERS,
        "flash_bwd_dkv": 2 * LONG_LAYERS})
    del m
    torch.cuda.empty_cache()
    bwd_case(torch, A, rows, g, (1, 16, LONG_S, 128), "bfloat16",
             routes=("split",), n=3, n_plain=2)
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from singa_tpu_torch import engine, models, opt, serving
    from singa_tpu_torch.models import transformer
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
    train_model, (tx, ty), by_path["train"] = phase_train(torch, models,
                                                          opt, A)
    phase_profile(torch, model, engine,
                  lambda: train_model(tx, ty)[1].item())
    del train_model
    torch.cuda.empty_cache()
    phase_train_fp32(torch, models, opt, transformer)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    by_path["train_long"] = phase_train_long(torch, models, opt, A, rows, g)

    # the JSON line reports each kernel at its main path's shape and
    # dtype; `launches` sums the paths' counted runs
    main_shape = {"flash_fwd": [8, 12, 128, 64],
                  "flash_bwd_fused": [TRAIN_B, 16, TRAIN_S, 128],
                  "flash_bwd_dq": [1, 16, LONG_S, 128],
                  "flash_bwd_dkv": [1, 16, LONG_S, 128]}
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
