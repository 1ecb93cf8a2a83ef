"""Meshes: the abstract production meshes, and the host's own over a process group.

The port of ``repro.launch.mesh``.  A :class:`Mesh` is ordered axis
names and sizes.  The production meshes are abstract (no devices and no
process group), so the sharding rules (``repro_torch.sharding.rules``)
and the dry-run (``repro_torch.launch.dryrun``) can place a step on 256
or 512 devices from any host.  Single pod: ``(data=16, model=16)``, 256
devices.  Multi pod: ``(pod=2, data=16, model=16)``, 512; ``pod``
composes with ``data`` for batch sharding.

Under ``torch.distributed`` the host's mesh is a process group:
:func:`init_distributed` is the counterpart of
``jax.distributed.initialize()`` (it reads ``torchrun``'s ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``), and :func:`make_host_mesh` then gives
``("data", world_size)`` with a ``torch.distributed.device_mesh.
DeviceMesh`` behind it, one process a device, as JAX's host mesh is 1-D.
:func:`make_group_mesh` lays any ordered axes over the group (``(("data",
2), ("model", 2))``: the counterpart of ``jax.sharding.Mesh`` over a
device array, rank ``r`` at the row-major coordinate of ``r``), and
:func:`make_production_mesh` does so at 256 (512) ranks.  Such a mesh
moves values: ``sharding.rules.place`` gives each rank its block of
every parameter, optimizer leaf and cache, ``rules.constrain_batch`` its
block of a batch, and the model and the training loop reduce over the
groups ``sharding.collectives.process_group`` names (re-exported here).

:func:`counting_mesh` makes an abstract mesh act as rank 0 of its
process group, with no ``torch.distributed`` group behind it: its
``device_mesh`` is a :class:`RankZero` stand-in, so ``coordinate`` is 0
on every axis (``rules.shard``, ``rules.relayout`` and
``collectives.block_index`` cut rank 0's blocks, of fake tensors too),
and ``collectives.process_group`` gives ``collectives.CountingGroup``s
holding the global ranks of rank 0's group (row-major, as
:func:`make_group_mesh` lays ranks).  The dry-run runs a cell's step on
such a mesh under ``collectives.record`` to count what each rank sends.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Tuple

from repro_torch.sharding.collectives import (  # noqa: F401 (re-exported)
    CountingGroup, process_group)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ordered axes: ``axis_names[i]`` has ``axis_sizes[i]`` devices.
    ``device_mesh`` is the ``DeviceMesh`` of a process group spanning
    the axes, or None for an abstract mesh."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device_mesh: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes) or \
                len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} do not pair up")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Devices the mesh spans."""
        return math.prod(self.axis_sizes)

    def coordinate(self, axis: str) -> int:
        """This process's index along ``axis`` (``ValueError`` on an
        abstract mesh)."""
        if self.device_mesh is None:
            raise ValueError(f"mesh {self.shape} is abstract: this process "
                             f"has no place on its axis {axis!r}")
        return self.device_mesh.get_local_rank(axis)


class RankZero:
    """The ``device_mesh`` of a counting mesh (:func:`counting_mesh`):
    this process is rank 0 of a group laid row-major over the axes."""

    def __init__(self, axis_names, axis_sizes):
        self.axis_names, self.axis_sizes = tuple(axis_names), tuple(axis_sizes)
        self._groups: Dict[Tuple[str, ...], CountingGroup] = {}

    def get_local_rank(self, axis: str) -> int:
        return 0

    def counting_group(self, axes: Tuple[str, ...]) -> CountingGroup:
        """Rank 0's group along ``axes``: the ranks whose coordinates are
        0 off ``axes``, in row-major order over ``axes``."""
        if axes not in self._groups:
            shape = dict(zip(self.axis_names, self.axis_sizes))
            stride = {a: math.prod(self.axis_sizes[i + 1:])
                      for i, a in enumerate(self.axis_names)}
            ranks = [0]
            for a in axes:
                ranks = [r + c * stride[a] for r in ranks
                         for c in range(shape[a])]
            self._groups[axes] = CountingGroup(tuple(ranks), axes)
        return self._groups[axes]


def counting_mesh(mesh: Mesh) -> Mesh:
    """``mesh``'s axes acting as rank 0 of a process group over them (a
    :class:`RankZero` behind it; module docstring)."""
    return Mesh(mesh.axis_names, mesh.axis_sizes,
                RankZero(mesh.axis_names, mesh.axis_sizes))


def make_group_mesh(axes, device=None) -> Mesh:
    """A mesh of ordered ``(name, size)`` axes over the initialised process
    group, e.g. ``(("data", 2), ("model", 2))``: rank r sits at the
    row-major coordinate of r, as device r of ``jax.sharding.Mesh(
    np.array(devices).reshape(sizes), names)``.  A ``DeviceMesh`` of
    ``device``'s type (``cuda`` by default) is behind it.  The sizes'
    product must be the world size (``ValueError``); without a group it
    raises ``RuntimeError``."""
    import torch
    import torch.distributed as dist
    names = tuple(a for a, _ in axes)
    sizes = tuple(int(n) for _, n in axes)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"a mesh {dict(zip(names, sizes))} over "
                           f"processes needs an initialised process group "
                           f"(launch.mesh.init_distributed)")
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} spans "
                         f"{math.prod(sizes)} devices; the process group "
                         f"has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if device is None else torch.device(device).type
    return Mesh(names, sizes, init_device_mesh(kind, sizes,
                                               mesh_dim_names=names))


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         counting: bool = False) -> Mesh:
    """Single pod ``(data=16, model=16)``, multi pod ``(pod=2, data=16,
    model=16)``.  Abstract without a process group; over an initialised
    group of exactly 256 (512) ranks it has a ``DeviceMesh`` behind it
    (:func:`make_group_mesh`), and with a group of another size it raises
    ``ValueError``, as ``jax.make_mesh`` does with too few devices.
    ``counting`` gives the abstract mesh acting as rank 0
    (:func:`counting_mesh`), group or not."""
    import torch.distributed as dist
    axes = ((("pod", 2),) if multi_pod else ()) + (("data", 16),
                                                   ("model", 16))
    mesh = Mesh(tuple(a for a, _ in axes), tuple(n for _, n in axes))
    if counting:
        return counting_mesh(mesh)
    if dist.is_available() and dist.is_initialized():
        return make_group_mesh(axes, device)
    return mesh


def init_distributed(device=None, backend=None,
                     init_method: str = "env://"):
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and its rendezvous address) and return
    this rank's device: ``cuda:LOCAL_RANK`` (made current) unless
    ``device`` names the CPU.  The backend is ``nccl`` on ``cuda`` and
    ``gloo`` on the CPU unless ``backend`` names another; ``nccl`` without
    a GPU raises, and a failed init raises its own error.  Without
    ``WORLD_SIZE`` in the environment there is no group (world size 1)
    and the device is ``device`` (``cuda`` by default, raising without a
    GPU).  A group already initialised is kept."""
    import torch
    import torch.distributed as dist

    from repro_torch.api.build import resolve_device
    if "WORLD_SIZE" not in os.environ:
        return resolve_device(device)
    kind = "cuda" if device is None else torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if (kind == "cuda" or backend == "nccl") and \
            not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for a {backend} "
                           f"rank on {kind}; pass device='cpu' (gloo)")
    if kind == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def make_host_mesh(device=None) -> Mesh:
    """A 1-D ``("data",)`` mesh.  Under an initialised
    ``torch.distributed`` group it spans the group's ranks, with a
    ``DeviceMesh`` of ``device``'s type (``cuda`` by default) behind it.
    Without one it is abstract: this host's CUDA devices (raising without
    a GPU) or, for ``device="cpu"``, one device on the CPU."""
    import torch
    import torch.distributed as dist
    kind = "cuda" if device is None else torch.device(device).type
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        n = dist.get_world_size()
        return Mesh(("data",), (n,), init_device_mesh(
            kind, (n,), mesh_dim_names=("data",)))
    if kind == "cpu":
        return Mesh(("data",), (1,))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' for a "
            "one-device mesh on the CPU")
    return Mesh(("data",), (torch.cuda.device_count(),))


def batch_axes(mesh) -> tuple:
    """Mesh axes a global batch dimension shards over."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh):
    return "model" if "model" in mesh.axis_names else None
