"""Meshes: the abstract production meshes and the host's own.

The port of ``repro.launch.mesh``.  A :class:`Mesh` is ordered axis
names and sizes and nothing else: no devices and no process group, so
the sharding rules (``repro_torch.sharding.rules``) and the dry-run
(``repro_torch.launch.dryrun``) can place a step on 256 or 512 devices
from any host.  Single pod: ``(data=16, model=16)``, 256 devices.  Multi
pod: ``(pod=2, data=16, model=16)``, 512; ``pod`` composes with ``data``
for batch sharding.  A mesh over real devices (a ``DeviceMesh`` and its
collectives) waits for the sharded part of ROADMAP.md Queue 1 item 4;
nothing here initialises ``torch.distributed``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ordered axes: ``axis_names[i]`` has ``axis_sizes[i]`` devices."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device=None) -> Mesh:
    """A 1-D ``("data",)`` mesh over this host's CUDA devices (one on a
    one-card machine); raises without a GPU unless ``device="cpu"``,
    which gives a one-device mesh on the CPU."""
    import torch
    if device is not None and torch.device(device).type == "cpu":
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
