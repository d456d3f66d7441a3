"""Multi-process bootstrap (counterpart of singa_tpu/distributed.py).

The reference's `Communicator(nDev, buffSize)` runs MPI_Init, broadcasts
the NCCL unique id and calls ncclCommInitRank; the JAX package calls
`jax.distributed.initialize`, whose coordinator address plays the NCCL
id's part. The port is PyTorch's own idiom: one process per rank, joined
by `torch.distributed.init_process_group` over a TCP store at the
coordinator's address, NCCL on the card and gloo on the CPU. Each rank
drives one device, so a mesh's devices are the ranks of the group.

On a host with several cards, start one process per card with
`SINGA_COORDINATOR=host0:port`, `SINGA_NPROCS=<ranks>` and
`SINGA_PROC_ID=<rank>` (or pass the three arguments to `init`); each
rank takes the card `rank % torch.cuda.device_count()` unless
`local_device_ids` names it.

Known differences from the JAX package:

- `global_batch` returns the FULL batch on the rank's device, where JAX
  assembles a global array of which each host materialises its shard.
  Every rank holds the whole batch and `Model`'s data-parallel step takes
  the rank's rows of it (`P(axis)`).
- `topology()["n_devices"]` is the world size: one device a rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from . import device as device_module

_initialized = False


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None,
         local_device_ids=None, device: str | None = None):
    """Join (or form) the process group.

    The arguments fall back on SINGA_COORDINATOR ("host:port"),
    SINGA_NPROCS and SINGA_PROC_ID; with no address either, torch's
    `env://` rendezvous (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as
    torchrun sets them) is used. The backend is NCCL, which needs the
    card (a RuntimeError without one), or gloo with `device="cpu"`. On
    the card the rank's CUDA device is set first: `local_device_ids[0]`,
    else `rank % torch.cuda.device_count()`, so `device.best_device()`
    is the rank's card. Idempotent; a process group that is already
    initialized (a test's `file://` store) is adopted as it is."""
    global _initialized
    if _initialized:
        return
    if dist.is_initialized():
        _initialized = True
        return
    coordinator_address = coordinator_address or \
        os.environ.get("SINGA_COORDINATOR")
    if num_processes is None and "SINGA_NPROCS" in os.environ:
        num_processes = int(os.environ["SINGA_NPROCS"])
    if process_id is None and "SINGA_PROC_ID" in os.environ:
        process_id = int(os.environ["SINGA_PROC_ID"])
    if device not in (None, "cpu", "cuda"):
        raise ValueError(f"device={device!r}; the port takes 'cuda' "
                         "(NCCL, the default) or 'cpu' (gloo)")
    backend = "gloo" if device == "cpu" else "nccl"
    if backend == "nccl":
        device_module._require_cuda()
        if local_device_ids is not None:
            local = int(list(local_device_ids)[0])
        else:
            rank = process_id if process_id is not None \
                else int(os.environ.get("RANK", 0))
            local = int(rank) % torch.cuda.device_count()
        torch.cuda.set_device(local)
    kw = {}
    if coordinator_address:
        kw["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend, **kw)
    _initialized = True


def shutdown():
    """Leave the process group (a no-op when none is initialized)."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (reference: MPIGlobalRank); 0 without a
    process group."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def device_type() -> str:
    """"cuda" under NCCL, "cpu" under gloo or without a process group
    (a mesh's devices are the ranks' devices)."""
    if is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def rank_device() -> torch.device:
    """The device this rank drives: its card under NCCL, else the CPU."""
    if device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier():
    """Every rank waits for the others; a no-op without a process
    group."""
    if is_initialized():
        dist.barrier()


def on_rank0(fn):
    """fn() on rank 0 alone while the other ranks wait for it. An
    exception there is raised on every rank (on the others as a
    RuntimeError naming it), so no rank goes on to a collective that
    rank 0 never joins. Without a process group, fn() here."""
    if not is_initialized():
        fn()
        return
    err = None
    if process_index() == 0:
        try:
            fn()
        except Exception as e:  # noqa: BLE001  raised below, on every rank
            err = e
    box = [None if err is None else f"{type(err).__name__}: {err}"]
    dist.broadcast_object_list(box, src=0)
    if err is not None:
        raise err
    if box[0] is not None:
        raise RuntimeError(f"rank 0 failed: {box[0]}")


def global_mesh(axis_sizes: dict | None = None):
    """Mesh over every rank of the job. Default: one 'data' axis over
    all of them; with `axis_sizes`, `parallel.make_mesh`'s contract over
    the whole job (the last axis innermost)."""
    from .parallel.mesh import make_mesh
    n_all = process_count()
    if axis_sizes is None:
        axis_sizes = {"data": n_all}
    n = int(np.prod(list(axis_sizes.values())))
    if n != n_all:
        raise ValueError(f"mesh wants {n} devices, slice has {n_all}")
    return make_mesh(axis_sizes)


def topology() -> dict:
    """The live topology: the device count (the world size: one device a
    rank), the process count and this process's rank.
    `resilience.build_manifest` embeds it in each checkpoint manifest's
    `mesh` section beside the mesh `axes`."""
    n = process_count()
    return {"n_devices": n, "n_processes": n,
            "process_index": process_index()}


def host_label() -> str:
    """The bounded-cardinality `host=` metric label of this process:
    "host<process_index>", or SINGA_FLEET_HOST where it is set."""
    env = os.environ.get("SINGA_FLEET_HOST")
    if env:
        return env
    return f"host{topology()['process_index']}"


def resume_mesh(n: int | None = None, axis: str = "data"):
    """A data mesh over the ranks this incarnation of the job has: the
    first `n` (all by default). Every rank must call it (the subgroup is
    created on all of them); a rank past `n` holds a mesh it is not in.
    More ranks than the job has raises."""
    from .parallel.mesh import make_mesh
    have = process_count()
    if n is None:
        n = have
    if n > have:
        raise ValueError(
            f"resume_mesh wants {n} devices, only {have} available")
    return make_mesh({axis: int(n)}, devices=list(range(int(n))))


def global_batch(host_array, mesh, axis: str = "data"):
    """The global batch (identical on every process) as a tensor on this
    rank's device, once `axis`'s size is checked to divide it. The whole
    batch, not the rank's shard: the data-parallel step takes the rank's
    rows."""
    n = mesh.shape[axis]
    host = np.asarray(host_array)
    if host.shape[0] % n != 0:
        raise ValueError(
            f"axis '{axis}' has {n} shards; they must divide the global "
            f"batch of {host.shape[0]}")
    return torch.as_tensor(host).to(mesh.device)


__all__ = ["init", "shutdown", "process_index", "process_count",
           "global_mesh", "topology", "host_label", "resume_mesh",
           "global_batch", "barrier", "on_rank0", "is_initialized",
           "rank_device"]
