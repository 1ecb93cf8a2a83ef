"""Distribution context: the active mesh, visible to model code.

The port of ``repro.sharding.context``.  Model modules are
mesh-agnostic except where a mesh changes what they compute or must
move values: ``seq_parallel`` (``models/transformer.py``), the
``moe_local*`` dispatch (``models/moe.py``), and, on a mesh over
processes, the collectives of a layer whose parameters each rank holds
a block of (``sharding.collectives``).  ``current_mesh()`` is None on a
bare host, and those paths then run their one-device form.  The meshes
are ``repro_torch.launch.mesh.Mesh`` values: the abstract production
meshes of the dry-run (axis names and sizes, no devices), or a mesh over
a ``torch.distributed`` process group (``make_host_mesh``,
``make_group_mesh``), whose ``DeviceMesh`` groups the steps reduce over.

``current_placement()`` is the port's own addition: the
``sharding.rules.Placement`` of the step running (its profile and
parameter shardings), which JAX's GSPMD reads from the jitted
function's shardings.  The decoder reads it to gather ``fsdp`` blocks
where a layer uses them.  A serve step's placement
(``launch.steps.serve_placement``, under ``cfg.sharding_profile`` for a
decode step, as JAX's dry-run places it) also says which axes its rows
split over and, under ``cache_seq``, the whole length of a cache whose
positions split over ``model``: the attention reads both.
"""
from __future__ import annotations

import contextlib

_MESH = None
_PLACEMENT = None


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


def current_placement():
    return _PLACEMENT


@contextlib.contextmanager
def use_placement(placement):
    """``placement`` (a ``rules.Placement`` or None) is current inside
    the block, and its mesh the current mesh (None keeps the mesh)."""
    global _PLACEMENT
    prev = _PLACEMENT
    _PLACEMENT = placement
    try:
        with use_mesh(current_mesh() if placement is None
                      else placement.mesh):
            yield
    finally:
        _PLACEMENT = prev
