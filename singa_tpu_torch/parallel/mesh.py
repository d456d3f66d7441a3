"""Device meshes (counterpart of singa_tpu/parallel/mesh.py).

A JAX mesh names the parallelism dimensions of a device array and XLA
routes each axis's collectives. The port runs one process per rank, each
driving one device (`distributed`), so a `Mesh` is an array of global
ranks with named axes, over `torch.distributed.device_mesh`: `group(axis)`
is the process group of this rank's slice along `axis`, and a tuple of
axes gives the group over their product. Axis order is JAX's: dict
order, the last axis innermost (adjacent ranks).

A mesh of one rank without an initialized process group is allowed and
carries no group: its collectives are the identity (`Communicator`), as
the JAX package's are at world size 1.

Bound axes. A JAX axis name is bound inside the shard_map body over its
mesh, and the tensor-parallel layers gate their collectives on it
(`autograd.axis_bound`). Here `Mesh.bind()` binds every axis of a mesh
while its block runs: the data-parallel graph-mode step binds its
DistOpt's mesh around the step body (`Model._dp_call`), a functional
caller binds one explicitly. `bound_mesh(name)` is the innermost bound
mesh with that axis; `axis_size` reads it, and raises NameError for an
unbound name, as `lax.axis_size` does. The binding is
process-wide, not per thread: a backward that autograd runs on its own
thread still sees it (the operators keep the group they found at their
forward anyway).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from contextlib import contextmanager

import numpy as np
import torch

from .. import distributed


class Mesh:
    """`shape` (an ordered dict from axis to size), `size`, `axis_names`,
    `devices` (the global ranks, shaped like the mesh), `device` (this
    rank's torch device) and `device_mesh` (the DeviceMesh, or None
    without a process group)."""

    def __init__(self, axis_sizes: dict, ranks):
        self.shape = OrderedDict((str(k), int(v))
                                 for k, v in axis_sizes.items())
        self.axis_names = tuple(self.shape)
        sizes = tuple(self.shape.values())
        self.size = int(np.prod(sizes)) if sizes else 1
        self.devices = np.asarray(ranks, dtype=np.int64).reshape(sizes)
        self.device_type = distributed.device_type()
        self.device = distributed.rank_device()
        self.device_mesh = None
        self._groups = {}
        if distributed.is_initialized():
            from torch.distributed.device_mesh import (DeviceMesh,
                                                       init_device_mesh)
            if self.size == distributed.process_count() and \
                    list(self.devices.ravel()) == list(range(self.size)):
                self.device_mesh = init_device_mesh(
                    self.device_type, sizes, mesh_dim_names=self.axis_names)
            else:
                self.device_mesh = DeviceMesh(
                    self.device_type, torch.as_tensor(self.devices),
                    mesh_dim_names=self.axis_names)

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, ranks={self.devices.tolist()})"

    @contextmanager
    def bind(self):
        """Bind every axis of this mesh while the block runs (the JAX
        package's shard_map body; see the module's docstring)."""
        _BOUND.append(self)
        try:
            yield self
        finally:
            _BOUND.pop()

    @property
    def member(self) -> bool:
        """Whether this process's rank is in the mesh."""
        return int(distributed.process_index()) in set(
            self.devices.ravel().tolist())

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis` (0 without a process group)."""
        if self.device_mesh is None:
            return 0
        self._check_member()
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis):
        """The process group of this rank's slice along `axis` (a name or
        a tuple of names: the group over their product); None without a
        process group. Every rank of the job must ask for a tuple's group
        in the same order (its subgroups are created on all ranks)."""
        if self.device_mesh is None:
            return None
        axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        for a in axes:
            if a not in self.shape:
                raise KeyError(f"mesh has no axis {a!r} (axes: "
                               f"{self.axis_names})")
        if len(axes) == 1:
            self._check_member()
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            self._groups[axes] = self._product_group(axes)
        self._check_member()
        return self._groups[axes]

    def _product_group(self, axes):
        """One subgroup per slice of the mesh over `axes` (created on
        every rank, in the same order); this rank's."""
        import torch.distributed as dist
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        arr = np.transpose(self.devices, rest + keep)
        arr = arr.reshape(-1, int(np.prod([arr.shape[len(rest) + j]
                                           for j in range(len(keep))])))
        me, mine = distributed.process_index(), None
        for ranks in arr.tolist():
            g = dist.new_group(ranks)
            if me in ranks:
                mine = g
        return mine

    def _check_member(self):
        if not self.member:
            raise ValueError(f"rank {distributed.process_index()} is not in "
                             f"{self!r}")


#: the meshes bound by `Mesh.bind()`, the innermost last
_BOUND = []


def bound_mesh(name: str):
    """The innermost bound mesh that has an axis `name`, or None."""
    for mesh in reversed(_BOUND):
        if name in mesh.shape:
            return mesh
    return None


def _bound(name: str) -> Mesh:
    mesh = bound_mesh(name)
    if mesh is None:
        raise NameError(f"unbound axis name: {name}")
    return mesh


def axis_size(name: str) -> int:
    """The size of the bound axis `name` (`lax.axis_size`)."""
    return int(_bound(name).shape[name])


def local_device_count() -> int:
    """The devices a mesh can span: the ranks of the process group (one
    device each), 1 without one."""
    return distributed.process_count()


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """make_mesh({'data': 4, 'model': 2}) -> a Mesh over the first 8 ranks
    (or of `devices`, a list of global ranks). Axis order follows dict
    order; the last axis is innermost."""
    sizes = [int(v) for v in axis_sizes.values()]
    n = int(np.prod(sizes)) if sizes else 1
    ranks = list(devices if devices is not None
                 else range(local_device_count()))[:n]
    if len(ranks) != n:
        raise ValueError(f"need {n} devices, have {len(ranks)}")
    return Mesh(axis_sizes, ranks)


def data_parallel_mesh(n: int | None = None, axis: str = "data") -> Mesh:
    n = n if n is not None else local_device_count()
    return make_mesh({axis: n})


def factor_mesh(n_devices: int, axes=("dp", "sp", "tp")) -> Mesh:
    """Balanced factorization of n_devices over the given axes (trailing
    axes get the larger factors, as in the JAX package)."""
    sizes = [1] * len(axes)
    remaining = n_devices
    i = len(axes) - 1
    while remaining > 1:
        f = 2 if remaining % 2 == 0 else remaining
        sizes[i] *= f
        remaining //= f
        i = (i - 1) % len(axes)
    assert math.prod(sizes) == n_devices
    return make_mesh(dict(zip(axes, sizes)))


__all__ = ["Mesh", "axis_size", "bound_mesh",
           "local_device_count", "make_mesh", "data_parallel_mesh",
           "factor_mesh"]
