"""Devices (counterpart of singa_tpu/device.py).

A `Device` wraps a `torch.device` where the JAX package's wraps a
`jax.Device`: it is where tensors land, and the device's random stream,
an explicit `torch.Generator` that the initializers and `Dropout` draw
from (`SetRandSeed` seeds it). The JAX Device's graph and profiling
flags come with the operations layers (`xprof`).

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

import torch


class Device:
    """A compute device: where tensors land, and its random stream."""

    def __init__(self, torch_device, id: int = 0, lang: str = "kCuda"):
        self.torch_device = torch.device(torch_device)
        self.id = id
        self.lang = lang
        self._generator = None
        self._seed = 0

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

    def Sync(self):
        """Fence: wait for all queued work on this device."""
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    # ---- info ------------------------------------------------------------
    @property
    def platform(self) -> str:
        return "gpu" if self.torch_device.type == "cuda" else "cpu"

    def is_host(self) -> bool:
        return self.torch_device.type == "cpu"

    def __repr__(self):
        return f"Device(lang={self.lang}, id={self.id}, torch={self.torch_device})"


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


def resolve(device=None) -> torch.device:
    """`device=` argument (a Device, a torch.device, a string or None) ->
    torch.device: None means the default device."""
    if device is None:
        return best_device().torch_device
    if isinstance(device, Device):
        return device.torch_device
    return torch.device(device)


__all__ = ["Device", "best_device", "create_cpu_device",
           "create_cuda_gpu_on", "create_cuda_gpus", "create_cuda_gpus_on",
           "get_default_device", "get_gpu_mem_size", "get_num_gpus", "of",
           "resolve"]
