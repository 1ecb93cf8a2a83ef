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
DeviceMesh`` behind it, one process a device.  That mesh moves values:
``rules.constrain_batch`` gives each rank its block of a batch, and the
training loop all-reduces gradients over its group.  A ``model`` axis
over processes waits for ROADMAP.md Queue 1 item 4b.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Tuple


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


def process_group(mesh, axis: str):
    """The process group along ``axis`` of a :class:`Mesh` over
    ``torch.distributed``, or None where no value moves between
    processes: no mesh, an abstract one, or a mesh of another kind
    (``serve.sharding.LocalMesh``)."""
    device_mesh = getattr(mesh, "device_mesh", None)
    return None if device_mesh is None else device_mesh.get_group(axis)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


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
