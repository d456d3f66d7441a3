"""Devices (counterpart of singa_tpu/device.py).

A `Device` wraps a `torch.device` where the JAX package's wraps a
`jax.Device`: it is where tensors land, and the device's random stream,
an explicit `torch.Generator` that the initializers and `Dropout` draw
from (`SetRandSeed` seeds it). It keeps the reference's profiling
switches (`SetVerbosity`, `SetSkipIteration`, `PrintTimeProfiling`) and
the trace capture `StartTrace`/`StopTrace` over torch.profiler, which
`xprof` reads.

The port runs on CUDA. The CPU is used only when a caller asks for it by
name (the CPU parity tests do), never as a silent fallback: the default
device is the first card, and without one `get_default_device`,
`best_device` and `resolve(None)` raise.

TF32: `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` are global switches of the caller's
process. cuDNN's is on by default, so an fp32 convolution on the card
runs in TF32 unless the caller turns it off (`chip_smoke.py` turns both
off for its fp32 checks). The library sets neither flag.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time

import numpy as np
import torch

# the profiler is process-global: the active capture (log dir, profiler)
# lives at module level, so Start/Stop pair up across Device objects
_trace = None
_trace_lock = threading.Lock()

#: the `record_function` range around StartTrace's device warm-up, and
#: its kernels: WARMUP_HEAD small adds, a sleep kernel of WARMUP_CYCLES
#: clock cycles (~20 ms at the H100's 1.98 GHz), WARMUP_TAIL adds
TRACE_WARMUP = "singa.trace_warmup"
WARMUP_HEAD, WARMUP_TAIL, WARMUP_CYCLES = 128, 32, 40_000_000
#: Chrome-trace categories of device events (xprof's device plane)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _warmup(x):
    """StartTrace's device warm-up on `x`'s card, inside the capture,
    under the TRACE_WARMUP range; returns when the card has run it."""
    with torch.cuda.device(x.device), \
            torch.profiler.record_function(TRACE_WARMUP):
        for _ in range(WARMUP_HEAD):
            x.add_(1.0)
        torch.cuda._sleep(WARMUP_CYCLES)
        for _ in range(WARMUP_TAIL):
            x.add_(1.0)
        torch.cuda.synchronize(x.device)


def _strip_warmup(doc: dict) -> dict:
    """Take StartTrace's warm-up out of a Chrome trace `doc` in place: the
    TRACE_WARMUP range, the host events inside it on its thread, and the
    device events they launched (by "External id", or by "correlation"
    for a runtime call), with their flow arrows. Returns {"launched",
    "recorded", "tail_recorded", "device_ms"}: the warm-up's kernels,
    those the trace holds, those of them launched after the sleep, and
    the device time of the events taken out."""
    ev = doc.get("traceEvents", [])
    w = next((e for e in ev if e.get("cat") == "user_annotation"
              and e.get("name") == TRACE_WARMUP), None)
    if w is None:
        raise RuntimeError(f"the trace holds no {TRACE_WARMUP} range")
    t0, t1 = w["ts"], w["ts"] + w["dur"]
    host = [e for e in ev if e.get("ph") == "X"
            and (e.get("pid"), e.get("tid")) == (w.get("pid"), w.get("tid"))
            and e.get("cat") not in _DEVICE_CATS + ("gpu_user_annotation",)
            and t0 <= e["ts"] and e["ts"] + e.get("dur", 0) <= t1]
    ext = {(e.get("args") or {}).get("External id") for e in host} - {None}
    corr = {(e.get("args") or {}).get("correlation") for e in host} - {None}
    adds = sorted((e for e in host if e.get("cat") == "cpu_op"
                   and e.get("name") == "aten::add_"), key=lambda e: e["ts"])
    tail_ext = {(e.get("args") or {}).get("External id")
                for e in adds[-WARMUP_TAIL:]} - {None}
    tail_corr = {(e.get("args") or {}).get("correlation") for e in host
                 if (e.get("args") or {}).get("External id") in tail_ext}
    tail_corr -= {None}
    drop = {id(e) for e in host} | {id(w)}
    kept, recorded, tail, device_ms = [], 0, 0, 0.0
    for e in ev:
        a = e.get("args") or {}
        cat = e.get("cat")
        if cat in _DEVICE_CATS and (a.get("External id") in ext
                                    or a.get("correlation") in corr):
            device_ms += e.get("dur", 0) / 1e3
            if cat == "kernel":
                recorded += 1
                tail += (a.get("External id") in tail_ext
                         or a.get("correlation") in tail_corr)
        elif not (id(e) in drop
                  or (cat == "gpu_user_annotation"
                      and e.get("name") == TRACE_WARMUP)
                  or (cat == "ac2g" and e.get("id") in corr)):
            kept.append(e)
    doc["traceEvents"] = kept
    return {"launched": WARMUP_HEAD + 1 + WARMUP_TAIL, "recorded": recorded,
            "tail_recorded": tail, "device_ms": device_ms}



class Device:
    """A compute device: where tensors land, and its random stream."""

    def __init__(self, torch_device, id: int = 0, lang: str = "kCuda"):
        self.torch_device = torch.device(torch_device)
        self.id = id
        self.lang = lang
        self._generator = None
        self._seed = 0
        self.graph_enabled = True
        self.verbosity = 0
        self.skip_iteration = 5
        #: fenced wall seconds per step at verbosity >= 1
        self.step_times: "list[float]" = []
        #: the last step build's counted cost ({"flops", "bytes
        #: accessed", ...}; `introspect` refreshes it at every step build)
        self.cost_analysis: "dict | None" = None
        #: the last card capture's warm-up, as `StopTrace` found it in
        #: the trace (`_strip_warmup`'s counts)
        self.last_trace_warmup: "dict | None" = None

    # ---- RNG ------------------------------------------------------------
    @property
    def generator(self) -> torch.Generator:
        """The device's random stream, made at first use (a CUDA
        generator initializes the card)."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.torch_device)
            self._generator.manual_seed(self._seed)
        return self._generator

    def SetRandSeed(self, seed: int):
        self._seed = int(seed)
        self.generator.manual_seed(self._seed)

    @property
    def rng_state(self) -> torch.Tensor:
        """The random stream's state (a CPU uint8 tensor, the generator's
        `get_state()`): what a checkpoint saves to resume the stream."""
        return self.generator.get_state()

    @rng_state.setter
    def rng_state(self, state):
        """Restore a state taken by the getter, in place: a CUDA graph
        that registered the generator draws from the restored stream."""
        self.generator.set_state(torch.as_tensor(state, dtype=torch.uint8)
                                 .cpu())

    def rand_key(self) -> int:
        """A fresh seed drawn from the device's random stream (the JAX
        Device splits its key here): seed a generator of your own from
        it."""
        return int(torch.randint(0, 2 ** 62, (), generator=self.generator,
                                 device=self.torch_device))

    @contextlib.contextmanager
    def drawing_from(self, generator: "torch.Generator | None"):
        """Inside the block the device's random stream is `generator` (a
        data-parallel step's per-rank stream; None keeps the device's
        own), which comes back after it."""
        if generator is None:
            yield
            return
        own = self.generator
        self._generator = generator
        try:
            yield
        finally:
            self._generator = own

    def Sync(self):
        """Fence: wait for all queued work on this device."""
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    # ---- graph control (the reference's core_device.i) ------------------
    def EnableGraph(self, enable: bool = True):
        """The reference's switch; a model's graph mode is set by
        `Model.compile(use_graph=...)` or `Model.graph(...)`."""
        self.graph_enabled = bool(enable)

    def ResetGraph(self):
        """A Model drops its CUDA graphs itself (`Model.graph`, a load)."""

    # ---- profiling (the reference's device.h:115-129) -------------------
    def SetVerbosity(self, v: int):
        """At verbosity >= 1 a Model's graph-mode step records its fenced
        wall time (a device synchronize after the step) into
        `step_times`, past the first `skip_iteration` steps."""
        self.verbosity = int(v)

    def SetSkipIteration(self, n: int):
        self.skip_iteration = int(n)

    def PrintTimeProfiling(self):
        """The step summary of the fenced times in `step_times` (the
        reference's Graph::PrintTimeProfiling, whole steps: the forward
        and backward are one CUDA graph). At verbosity >= 2 with a step
        build's cost (`cost_analysis`, counted by `introspect`): GFLOP
        and MB accessed per step, the TFLOP/s achieved and, on a card
        introspect's peak table knows, MFU; at >= 3 every cost field."""
        if not self.step_times:
            print("time profiling: no steps recorded "
                  "(SetVerbosity(>=1) before training)")
            return
        t = np.asarray(self.step_times)
        print(f"time profiling: {len(t)} steps, "
              f"mean {t.mean() * 1e3:.3f} ms, std {t.std() * 1e3:.3f} ms, "
              f"min {t.min() * 1e3:.3f} ms")
        if self.verbosity >= 2 and self.cost_analysis:
            from . import introspect
            ca = self.cost_analysis
            flops = ca.get("flops", 0.0)
            bytes_ = ca.get("bytes accessed", 0.0)
            achieved = flops / max(t.mean(), 1e-12) / 1e12
            print(f"  counted cost: {flops / 1e9:.2f} GFLOP/step, "
                  f"{bytes_ / 1e6:.1f} MB accessed/step, "
                  f"{achieved:.2f} TFLOP/s achieved")
            peak = introspect.peak_tflops(introspect.device_kind(self))
            if peak:
                print(f"  MFU: {achieved / peak * 100.0:.2f}% of "
                      f"{peak:g} TFLOP/s peak")
        if self.verbosity >= 3 and self.cost_analysis:
            for k, v in sorted(self.cost_analysis.items()):
                if isinstance(v, (int, float)):
                    print(f"  {k}: {v:.3g}")

    # ---- trace capture ---------------------------------------------------
    def StartTrace(self, log_dir: str):
        """Begin capturing a torch.profiler trace into `log_dir`: the CPU
        operators and `record_function` ranges (`observe.span`'s) and, on
        a card, the CUDA kernels, memcpys and memsets, of every thread of
        the process (`profile_all_threads`: the profiler records only
        the starting thread's operators otherwise, and an engine's
        decode thread or a diag handler's capture runs elsewhere), with
        each operator's flops. One trace a process: a second raises.

        On a card the capture opens with a device warm-up (`_warmup`,
        ~20 ms) and returns after it: in a long-lived process the first
        1-3 ms of device activity of a capture did not come back from
        the profiler (fresh processes lost none), so that loss falls on
        the warm-up. `StopTrace` takes the warm-up out of the trace and
        raises if the loss reached past it."""
        global _trace
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        with _trace_lock:
            if _trace is not None:
                raise RuntimeError(
                    f"a trace into {_trace[0]} is already active; "
                    "StopTrace() it first (the profiler is process-global)")
            acts = [ProfilerActivity.CPU]
            card = self.torch_device.type == "cuda"
            if card:
                acts.append(ProfilerActivity.CUDA)
                x = torch.zeros(4096, device=self.torch_device)
            prof = profile(activities=acts, with_flops=True,
                           experimental_config=_ExperimentalConfig(
                               profile_all_threads=True))
            prof.start()
            if card:
                try:
                    _warmup(x)
                except BaseException:
                    prof.stop()
                    raise
            _trace = (log_dir, prof)

    def StopTrace(self) -> "str | None":
        """Stop the capture and write it under the log dir as one
        `<host>_<pid>.<ns>.pt.trace.json` Chrome trace, each CPU
        operator's counted flops added to its arguments (`"flops"`, by
        its "External id"); returns the log dir. Idempotent: with no
        trace active it returns None. On a card it first waits for the
        device's queued work, and writes the trace without StartTrace's
        warm-up; `last_trace_warmup` then holds what the warm-up launched
        and what came back of it. A failed stop or write raises, and
        leaves no trace active; so does a capture that lost any of the
        kernels the warm-up launched after its sleep."""
        global _trace
        with _trace_lock:
            cur, _trace = _trace, None
        if cur is None:
            return None
        from .xprof import TRACE_SUFFIX
        log_dir, prof = cur
        card = self.torch_device.type == "cuda"
        if card:
            torch.cuda.synchronize(self.torch_device)
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}"
                                     f".{time.time_ns()}{TRACE_SUFFIX}")
        prof.export_chrome_trace(path)
        flops = {e.id: e.flops for e in prof.events() if e.flops}
        if flops or card:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            if card:
                self.last_trace_warmup = _strip_warmup(doc)
            for e in doc.get("traceEvents", ()):
                if e.get("cat") == "cpu_op":
                    n = flops.get((e.get("args") or {}).get("External id"))
                    if n:
                        e["args"]["flops"] = n
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f)
        if card:
            w = self.last_trace_warmup
            if w["tail_recorded"] < WARMUP_TAIL:
                raise RuntimeError(
                    f"the trace in {path} lost device events past its "
                    f"warm-up: {w['tail_recorded']} of the {WARMUP_TAIL} "
                    f"kernels launched after its sleep came back "
                    f"({w['recorded']} of {w['launched']} in all)")
        return log_dir

    # ---- info ------------------------------------------------------------
    @property
    def platform(self) -> str:
        return "gpu" if self.torch_device.type == "cuda" else "cpu"

    def is_host(self) -> bool:
        return self.torch_device.type == "cpu"

    def __repr__(self):
        return f"Device(lang={self.lang}, id={self.id}, torch={self.torch_device})"

    def __reduce__(self):
        # one Device per torch device: a copy or an unpickled Device is
        # the process's own
        return (of, (str(self.torch_device),))


_DEVICES: dict = {}   # torch.device -> Device


def of(torch_device) -> Device:
    """The one `Device` of a torch device (created at first use)."""
    td = torch.device(torch_device)
    if td.type == "cuda" and td.index is None:
        td = torch.device("cuda", torch.cuda.current_device())
    dev = _DEVICES.get(td)
    if dev is None:
        if td.type == "cuda":
            dev = Device(td, id=td.index, lang="kCuda")
        else:
            dev = Device(td, id=0, lang="kCpp")
        _DEVICES[td] = dev
    return dev


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "singa_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device=\"cpu\" to run the plain PyTorch versions of the "
            "kernels on the CPU")


def best_device() -> Device:
    """The first CUDA device, or a RuntimeError when there is none."""
    _require_cuda()
    return of(torch.device("cuda", torch.cuda.current_device()))


def get_default_device() -> Device:
    """The default device is the card (the JAX package's is the host):
    tensors made without a device land there."""
    return best_device()


def create_cpu_device() -> Device:
    return of("cpu")


def create_cuda_gpu(set_default: bool = False) -> Device:
    """The first CUDA device (the reference's canonical call). The
    default device is the card already, so `set_default` changes
    nothing."""
    del set_default
    return best_device()


def create_cuda_gpu_on(device_id: int) -> Device:
    _require_cuda()
    return of(torch.device("cuda", int(device_id)))


def create_cuda_gpus(num: int):
    """A list of the first `num` CUDA Devices."""
    return [create_cuda_gpu_on(i) for i in range(num)]


def create_cuda_gpus_on(device_ids):
    return [create_cuda_gpu_on(i) for i in device_ids]


def get_num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def get_gpu_mem_size(id: int):  # noqa: A002  (name mandated by parity)
    """(total bytes, bytes this process has allocated) of card `id`."""
    _require_cuda()
    return (torch.cuda.get_device_properties(id).total_memory,
            torch.cuda.memory_allocated(id))


def get_gpu_ids() -> list:
    return list(range(get_num_gpus()))


def device_query(id: int, verbose=False) -> dict:  # noqa: A002
    """{id, kind (the card's name), platform} of card `id`."""
    _require_cuda()
    info = {"id": id, "kind": torch.cuda.get_device_name(id),
            "platform": "gpu"}
    if verbose:
        print(info)
    return info


def enable_lazy_alloc(flag: bool):
    """No-op: PyTorch's caching allocator allocates at first use."""
    del flag


def _no_opencl():
    raise AssertionError(
        "built without OpenCL (as the reference's USE_OPENCL=OFF wheels); "
        "use the CUDA or CPU devices")


def get_num_opencl_platforms():
    _no_opencl()


def get_num_opencl_devices():
    _no_opencl()


def create_opencl_device():
    _no_opencl()


# the JAX package's names for the accelerator calls
create_tpu_device = create_cuda_gpu
create_tpu_device_on = create_cuda_gpu_on
create_tpu_devices = create_cuda_gpus


def resolve(device=None) -> torch.device:
    """`device=` argument (a Device, a torch.device, a string or None) ->
    torch.device: None means the default device."""
    if device is None:
        return best_device().torch_device
    if isinstance(device, Device):
        return device.torch_device
    return torch.device(device)


__all__ = ["Device", "best_device", "create_cpu_device", "create_cuda_gpu",
           "create_cuda_gpu_on", "create_cuda_gpus", "create_cuda_gpus_on",
           "create_opencl_device", "create_tpu_device",
           "create_tpu_device_on", "create_tpu_devices", "device_query",
           "enable_lazy_alloc", "get_default_device", "get_gpu_ids",
           "get_gpu_mem_size", "get_num_gpus", "get_num_opencl_devices",
           "get_num_opencl_platforms", "of", "resolve"]
