"""Data-parallel sharded dispatch: split a batch over a 1-D device mesh.

The port of ``repro.serve.sharding``, HLS4PC's multi-PE unrolling in
software: one fixed-shape dispatch of ``max_batch`` lanes is split into
``max_batch // data_shards`` contiguous lanes per device of a
``("data",)`` mesh, params replicated, as ``P("data")`` splits them in
the JAX package.  The serving walk is lane-mapped (under serving
semantics a lane's result does not depend on the rest of its dispatch),
so the split is bit-identical to the one-device dispatch and both
serving engines take a sharded
:class:`~repro_torch.api.build.FrozenPipeline` with zero scheduler
changes.

No value moves between shards, so the dispatch is one process over
several ``torch.device`` values and needs no ``torch.distributed``: each
shard's slice of the clouds goes to its device, runs the built forward
(the kernels launch on that device), and the logits are gathered with
``torch.cat`` on the mesh's first device.  The shards run one after
another from the calling thread; on distinct cards their device work
overlaps, since a launch returns before its kernel ends.

LFSR placement follows the sampler semantics:

* ``shared_urs`` (serving specs): one index sequence serves every lane,
  so each shard gets the whole state, advances it identically, and the
  dispatch returns shard 0's advanced state.
* per-lane URS (``shared_urs=False``): lane ``b`` consumes stream ``b``,
  so the streams are split with the lanes and concatenated again, which
  needs exactly one stream per lane.

Each shard draws its URS indices on the host (``core.sampling``), so an
n-shard dispatch runs the host LFSR n times.

``per_sample_norm`` is required either way (RPA020): batch-statistic
normalization couples lanes across the dispatch, which a device split
would silently turn into shard-local statistics.  For the same reason
per-lane URS is refused where an int8 region runs W8A8 on the kernel
backend: its activations are quantized with one scale per dispatch
(``QuantConfig.per_lane`` holds only under ``shared_urs`` and
``per_sample_norm``), which a split would make one per shard.  The JAX
package has no such check (RPA020 looks at ``per_sample_norm`` alone).

``repro_torch.sharding.context.use_mesh`` is installed around the
dispatch, and the previous mesh comes back even when the dispatch
raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.streaming import tree_map
from repro_torch.sharding import context

__all__ = ["LocalMesh", "make_mesh", "make_mesh2d", "replica_submesh",
           "shard_forward"]


@dataclasses.dataclass(frozen=True, eq=False)
class LocalMesh:
    """Devices of this process on named axes, with the attribute names of
    ``jax.sharding.Mesh``: ``devices`` is a numpy object array of
    ``torch.device`` with one dimension per axis of ``axis_names``.

    A device may appear more than once (several shards on one card, or
    on the CPU): a shard is a slice of the dispatch, not a device.
    ``repro_torch.sharding.context.use_mesh`` takes it as it takes a
    ``launch.mesh.Mesh``."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        grid = np.empty(np.shape(self.devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(self.devices, dtype=object)):
            grid[i] = _device(d)
        object.__setattr__(self, "devices", grid)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if grid.ndim != len(self.axis_names) or \
                len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} do not name the "
                             f"{grid.ndim} dimensions of its devices "
                             f"{grid.shape}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices, each once, in mesh order."""
        out: List[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index is the
    current one."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _devices(need: int, devices: Optional[Sequence], what: str
             ) -> List[torch.device]:
    """``devices`` (exactly ``need`` of them), or the first ``need`` CUDA
    devices, raising ``ValueError`` with the explicit-devices recipe."""
    if devices is not None:
        devices = [_device(d) for d in devices]
        if len(devices) != need:
            raise ValueError(f"{what} takes {need} devices, got "
                             f"{len(devices)}")
        return devices
    have = torch.cuda.device_count()
    if need > have:
        raise ValueError(
            f"{what} needs {need} CUDA devices but only {have} are "
            f"available; pass devices= to place the shards yourself, e.g. "
            f"devices=('cpu',) * {need} on the CPU or "
            f"devices=('cuda:0',) * {need} for every shard on one card")
    return [torch.device("cuda", i) for i in range(need)]


def make_mesh(data_shards: int, devices: Optional[Sequence] = None
              ) -> LocalMesh:
    """A 1-D ``("data",)`` mesh over the first ``data_shards`` CUDA
    devices, or over ``devices``.

    Raises ``ValueError`` when the host has fewer CUDA devices, with the
    recipe in the message.  ``devices`` may name one device more than
    once: it is the port's counterpart of the JAX package's forced host
    devices (torch has one CPU device, and a one-card machine one card),
    so ``devices=("cpu",) * n`` runs an n-way split on the CPU."""
    return LocalMesh(np.array(_devices(
        data_shards, devices, f"data_shards={data_shards}"), dtype=object),
        ("data",))


def make_mesh2d(n_replicas: int, data_shards: int,
                devices: Optional[Sequence] = None) -> LocalMesh:
    """A 2-D ``("replica", "data")`` mesh over the first ``n_replicas *
    data_shards`` CUDA devices (or ``devices``, row by row), the fleet
    generalization of :func:`make_mesh`.

    Row ``r`` is replica ``r``'s device set: each pool pipeline is built
    over its own row (:func:`replica_submesh`), so replicas never
    contend for a device unless ``devices`` repeats one."""
    need = n_replicas * data_shards
    grid = np.array(_devices(
        need, devices, f"a {n_replicas} x {data_shards} replica x data "
                       f"mesh"), dtype=object)
    return LocalMesh(grid.reshape(n_replicas, data_shards),
                     ("replica", "data"))


def replica_submesh(mesh: LocalMesh, replica: int) -> LocalMesh:
    """Row ``replica`` of a 2-D ``("replica", "data")`` mesh as the 1-D
    ``("data",)`` mesh that replica's pipeline dispatches over."""
    if tuple(mesh.axis_names) != ("replica", "data"):
        raise ValueError(
            f"replica_submesh takes a ('replica', 'data') mesh, got "
            f"axes {tuple(mesh.axis_names)}")
    n_replicas = mesh.devices.shape[0]
    if not 0 <= replica < n_replicas:
        raise ValueError(f"replica {replica} out of range for a "
                         f"{n_replicas}-replica mesh")
    return LocalMesh(mesh.devices[replica], ("data",))


def _dispatch_scaled_int8(spec) -> bool:
    """Whether an int8 region of ``spec`` quantizes its activations with
    one scale over the whole dispatch (W8A8 without per-lane scales)."""
    from repro_torch.api.plan import _KERNEL_BACKENDS, resolve_stage_fields
    if spec.shared_urs and spec.per_sample_norm:
        return False
    prec, back = resolve_stage_fields(spec)
    regions = list(zip(prec, back)) + [(spec.precision, spec.backend)]
    return any(p == "int8" and b in _KERNEL_BACKENDS for p, b in regions)


def shard_forward(fwd: Callable, spec, mesh: Optional[LocalMesh] = None,
                  cache_in: bool = False, cache_out: bool = False
                  ) -> Tuple[Callable, LocalMesh]:
    """Wrap a built ``fwd(params, pts, lfsr[, cache])`` in a data-parallel
    dispatch over ``spec.data_shards`` devices.

    Returns ``(dispatch, mesh)``.  ``dispatch(params_by_device, pts,
    lfsr[, cache])`` takes the params as a mapping from each of the
    mesh's devices to its copy, and gives what ``fwd`` gives, bit for
    bit, with the logits (and a collected cache) on the mesh's first
    device and the advanced state on the CPU.  It raises ``ValueError``
    when ``data_shards`` does not divide the batch, and, for per-lane
    URS, unless there is exactly one stream per lane.  Wrapping raises
    ``ValueError`` for a spec whose lanes a split would couple: RPA020,
    and per-lane URS with W8A8 regions (see the module docstring).

    Args:
      mesh: a 1-D ``("data",)`` mesh of ``spec.data_shards`` devices
        (fleet placement passes a :func:`replica_submesh` row); None
        builds the default first-CUDA-devices mesh.
      cache_in: ``fwd`` takes a trailing stream cache of batch-leading
        tensors, split with the lanes, each shard's rows on its device.
      cache_out: ``fwd`` returns a trailing collected cache, likewise
        batch-leading, concatenated on the first device.
    """
    # One enforcement path with validate()/build(): RPA020 for a sharded
    # spec without per_sample_norm.
    from repro_torch.analysis.passes import enforce_spec
    enforce_spec(spec, scopes=("placement",))
    if _dispatch_scaled_int8(spec):
        raise ValueError(
            f"data_shards={spec.data_shards} with per-lane URS "
            f"(shared_urs=False) and W8A8 int8 regions on the "
            f"{spec.backend!r} backend: those activations are quantized "
            f"with one scale per dispatch, which a split would make one "
            f"per shard; serve with spec.serving() (per-lane scales) or "
            f"data_shards=1")
    if mesh is None:
        mesh = make_mesh(spec.data_shards)
    elif (tuple(mesh.axis_names) != ("data",)
            or mesh.devices.shape != (spec.data_shards,)):
        raise ValueError(
            f"shard_forward needs a 1-D ('data',) mesh of exactly "
            f"data_shards={spec.data_shards} devices; got axes "
            f"{tuple(mesh.axis_names)} shape {mesh.devices.shape} "
            f"(build replica rows with replica_submesh(make_mesh2d(...)))")
    n = spec.data_shards
    devices = list(mesh.devices.flat)
    gather = devices[0]

    def dispatch(params, pts, lfsr, *extra):
        with context.use_mesh(mesh):
            batch = pts.shape[0]
            if batch % n:
                raise ValueError(
                    f"data_shards={n} must divide the dispatch batch "
                    f"evenly: got batch {batch} (the engines pad to "
                    f"max_batch: pick a max_batch that is a multiple of "
                    f"data_shards)")
            if (lfsr is not None and not spec.shared_urs
                    and lfsr.shape[0] != batch):
                raise ValueError(
                    f"per-lane URS under data_shards={n} splits the LFSR "
                    f"streams with the lanes and needs exactly one stream "
                    f"per lane: got {lfsr.shape[0]} streams for batch "
                    f"{batch}")
            per = batch // n
            outs = []
            for i, dev in enumerate(devices):
                lanes = slice(i * per, (i + 1) * per)
                state = (lfsr if lfsr is None or spec.shared_urs
                         else lfsr[lanes])
                cache = [tree_map(lambda a: a[lanes].to(dev), extra[0])
                         ] if cache_in else []
                outs.append(fwd(params[dev], pts[lanes].to(dev), state,
                                *cache))
            logits = torch.cat([o[0].to(gather) for o in outs])
            if outs[0][1] is None or spec.shared_urs:
                state = outs[0][1]
            else:
                state = torch.cat([o[1] for o in outs])
            if cache_out:
                return logits, state, tree_map(
                    lambda *rows: torch.cat([r.to(gather) for r in rows]),
                    *(o[2] for o in outs))
            return logits, state

    return dispatch, mesh
