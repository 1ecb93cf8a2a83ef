"""Distribution context: the active mesh, visible to model code.

The port of ``repro.sharding.context``.  Model modules are
mesh-agnostic except where a mesh changes what they compute or must
move values: ``seq_parallel`` (``models/transformer.py``) and the
``moe_local*`` dispatch (``models/moe.py``).  ``current_mesh()`` is
None on a bare host, and those paths then run their one-device form.
The meshes are ``repro_torch.launch.mesh.Mesh`` values: the abstract
production meshes of the dry-run (axis names and sizes, no devices), or
the host's ``("data", world_size)`` mesh over a ``torch.distributed``
process group (``make_host_mesh`` under ``init_distributed``), whose
``DeviceMesh`` the data-parallel training step reduces over.
"""
from __future__ import annotations

import contextlib

_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` is current inside the block; the previous one comes back
    when the block ends or raises."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev
