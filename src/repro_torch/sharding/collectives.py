"""Collectives over a mesh's process groups, with the gradients a sharded step needs.

GSPMD places JAX's collectives itself; the port's model code computes on
each rank's local blocks and calls these where GSPMD puts one.  Each is
an autograd function, so a step's backward moves what its forward
moved, transposed (Megatron-LM's ``f`` and ``g``):

* :func:`copy_to` -- identity forward, sum backward: the replicated input
  of a column-parallel product (each rank's gradient covers its columns
  only);
* :func:`reduce_from` -- sum forward, identity backward: the partial
  outputs of a row-parallel product, of a vocab-sharded lookup or of the
  local MoE combine (every rank's loss downstream is the same);
* :func:`sum_both` -- sum forward and backward: a mean over the data
  group that every rank's loss then reads (the MoE aux loss);
* :func:`gather_from` -- all-gather forward, this rank's block backward:
  vocab blocks of the logits, expert blocks of the MoE outputs;
* :func:`split_to` -- this rank's block forward, all-gather backward
  (the transpose of :func:`gather_from`): ``seq_parallel``'s residual
  stream cut to the rank's sequence block from a tensor every rank holds
  whole, or a replicated layer's output cut to the rows of a row-parallel
  product (the sLSTM's ``wo``);
* :func:`gather_shards` -- all-gather forward, reduce-scatter backward:
  an ``fsdp`` parameter gathered where a layer uses it (every rank's
  gradient of the whole leaf differs, since each saw its own batch block),
  the rows of a batch block gathered where a layer routes them whole
  (the ``moe_local`` dispatch under ``fsdp``), or a column block of an
  activation gathered for products that each rank reads in part (the
  mLSTM's convolved input); it is :func:`copy_to` of :func:`gather_from`;
* :func:`scatter_sum` -- reduce-scatter forward, all-gather backward:
  the partial outputs of such a layer summed, each rank keeping its rows.

``seq_parallel`` gathers a layer's input from the ranks' sequence blocks
with :func:`gather_from`, whose backward and the layer's own
:func:`copy_to` make Megatron-SP's reduce-scatter of the gradient, and
cuts the layer's summed output back to the block with :func:`split_to`
(:func:`reduce_from` then :func:`split_to` is :func:`scatter_sum`).

Serving moves values with no gradient: :func:`all_to_all` (a tensor
split by one dim into a block a rank, received blocks joined along
another: the new tokens' k/v from a split by heads to the cache's split
by rows or positions) and :func:`softmax_combine` (the partial softmaxes
of key blocks held by different ranks, ``cache_seq``'s attention read).

A ``group`` of None is no group: each function is then the identity.
Gathers order the blocks by group rank, which runs row-major over the
group's mesh axes (:func:`process_group`), as JAX lays a dim sharded
over a tuple of axes.  The reduce-scatter is an all-reduce and a slice:
gloo reduces CUDA tensors only by all-reduce (its ranks share one card
in ``chip_smoke.py``).

gloo's list form of the all-to-all raises on the CPU and on the card
("does not support alltoall"), and its ``all_to_all_single`` takes CUDA
tensors, bf16 and int8 included, with uneven splits (a probe of two
ranks on one H100): :func:`all_to_all` is that one call.

Every value that moves between processes moves here: the training
loop's gradient and metric means and the clip's norm go through
:func:`all_reduce_`, which the functions above use too.  The groups come
from a ``launch.mesh.Mesh`` over a process group (:func:`process_group`,
:func:`block_index`), so the model code reads them without the launch
layer.

**Counting.**  :func:`record` logs one :class:`Collective` for each
collective a primitive issues (``all_reduce_``, ``_gather``,
``_all_to_all``): the op in JAX's HLO names, its bytes by JAX's
convention, the dtype that moves (a bf16 sum moves f32; the
reduce-scatter is the all-reduce it runs as) and the mesh axes of its
group (``repro_torch.analysis.trace`` reads them: RPA204).  A counting
mesh (``launch.mesh.counting_mesh``: an abstract mesh acting as rank 0
of its process group) gives :class:`CountingGroup` groups, on which each
primitive logs the same entry as on a real group and returns a tensor
of the right shape and dtype, moving nothing; so rank 0's program runs
on fake tensors with no process group, and its log is what each rank of
a real group sends (the programs are SPMD).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


_HALF = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class CountingGroup:
    """Rank 0's process group on a counting mesh: the global ranks of its
    members in group-rank order (this process is the first) and the mesh
    axes it spans.  No ``torch.distributed`` group stands behind it."""
    ranks: Tuple[int, ...]
    axes: Tuple[str, ...] = dataclasses.field(default=(), compare=False)


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a rank issued.  ``op`` is JAX's HLO name
    (``all-reduce``, ``all-gather``, ``all-to-all``); ``bytes`` JAX's
    size (an all-reduce's or all-to-all's operand, an all-gather's
    result) in ``dtype``, the dtype that moves; ``group_size`` the ranks
    of the group.  ``ranks`` (the group's global ranks, which say whether
    it spans nodes) and ``seconds`` (the host time of the call, with the
    device synchronized around it where :func:`record` was given a
    ``sync``) differ between ranks and runs, so equality leaves them
    out, and so does ``axes``, the mesh axes the group spans
    (:func:`group_axes`; the trace pass reads it)."""
    op: str
    bytes: int
    dtype: str
    group_size: int
    ranks: Tuple[int, ...] = dataclasses.field(default=(), compare=False)
    seconds: float = dataclasses.field(default=0.0, compare=False)
    axes: Tuple[str, ...] = dataclasses.field(default=(), compare=False)


_LOGS: List[Tuple[list, Optional[Callable[[], Any]]]] = []


@contextlib.contextmanager
def record(sync: Optional[Callable[[], Any]] = None):
    """A list that gets one :class:`Collective` for every collective
    issued inside the block, in order (nested blocks each get every
    entry).  ``sync`` (``torch.cuda.synchronize``) runs before and after
    each call, so its ``seconds`` are the call's own."""
    entry = ([], sync)
    _LOGS.append(entry)
    try:
        yield entry[0]
    finally:
        _LOGS[:] = [e for e in _LOGS if e is not entry]


def _ranks(group) -> Tuple[int, ...]:
    if isinstance(group, CountingGroup):
        return group.ranks
    return tuple(dist.get_process_group_ranks(group))


def _issue(op: str, x: torch.Tensor, nbytes: int, group,
           move: Callable[[], Any]) -> None:
    """Runs ``move`` (the collective; nothing on a counting group) and
    logs it to every open :func:`record`."""
    sync = next((s for _, s in _LOGS if s is not None), None)
    if sync is not None:
        sync()
    t0 = time.perf_counter()
    if not isinstance(group, CountingGroup):
        move()
    if sync is not None:
        sync()
    if _LOGS:
        entry = Collective(op, int(nbytes),
                           str(x.dtype).replace("torch.", ""),
                           group_size(group), _ranks(group),
                           time.perf_counter() - t0, group_axes(group))
        for log, _ in _LOGS:
            log.append(entry)


def all_reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` in place, in its own dtype (``op``
    ``"sum"`` or ``"max"``), no gradient; ``x`` itself.  For a tensor
    the caller owns (a step's gradients, metrics, norms), none aliased."""
    if group is not None:
        _issue("all-reduce", x, x.numel() * x.element_size(), group,
               lambda: dist.all_reduce(
                   x, op=getattr(dist.ReduceOp, op.upper()), group=group))
    return x


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """Summed in f32 for a 16-bit float (then rounded once), in place on
    a copy."""
    y = x.float().contiguous().clone() if x.dtype in _HALF else \
        x.contiguous().clone()
    return all_reduce_(y, group).to(x.dtype)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Blocks concatenated in group-rank order, in ``x``'s own dtype (a
    gather copies bits; gloo refuses int16, so a 16-bit float is not
    moved as an int16 view)."""
    y = x.contiguous()
    parts = [torch.empty_like(y) for _ in range(group_size(group))]
    _issue("all-gather", y, len(parts) * y.numel() * y.element_size(),
           group, lambda: dist.all_gather(parts, y, group=group))
    return torch.cat(parts, dim=dim)


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(_sum(g, ctx.group), ctx.dim, ctx.group), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(_sum(x, group), dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def sum_both(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumBoth.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, dim % x.ndim, group)


def split_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``dim`` of a tensor every rank of ``group``
    holds whole and alike; the gradient all-gathered back."""
    return x if group is None else _SplitTo.apply(x, dim % x.ndim, group)


def gather_shards(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherShards.apply(x, dim % x.ndim,
                                                        group)


def scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over ``group`` (in f32 for a 16-bit float), this
    rank's block of ``dim`` kept; the gradient all-gathered back."""
    return x if group is None else _ScatterSum.apply(x, dim % x.ndim, group)


def _all_to_all(x: torch.Tensor, out_rows: int, in_splits, out_splits,
                group) -> torch.Tensor:
    """``dist.all_to_all_single`` over dim 0 of a contiguous ``x``."""
    out = x.new_empty((out_rows,) + tuple(x.shape[1:]))
    _issue("all-to-all", x, x.numel() * x.element_size(), group,
           lambda: dist.all_to_all_single(out, x, out_splits, in_splits,
                                          group=group))
    return out


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group,
               splits=None) -> torch.Tensor:
    """``x`` cut along ``split_dim`` into one block a rank of ``group``
    (in group-rank order; ``splits`` their sizes, the same list on every
    rank, equal blocks by default), each block sent to its rank, and the
    blocks this rank receives joined along ``cat_dim`` in group-rank
    order (every rank's other dims alike).  No gradient (serving).  One
    ``all_to_all_single``: each byte crosses once."""
    if group is None:
        return x
    n, me = group_size(group), group_rank(group)
    split_dim, cat_dim = split_dim % x.ndim, cat_dim % x.ndim
    if splits is None:
        if x.shape[split_dim] % n:
            raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                             f"split over {n} ranks")
        splits = [x.shape[split_dim] // n] * n
    if len(splits) != n or sum(splits) != x.shape[split_dim]:
        raise ValueError(f"splits {list(splits)} of dim {split_dim} of "
                         f"{tuple(x.shape)} over {n} ranks")
    size = splits[me]
    if any(splits):
        y = x.movedim(split_dim, 0).contiguous()
        got = _all_to_all(y, n * size, list(splits), [size] * n, group)
    else:           # nothing to send: every rank skips the call alike
        got = x.movedim(split_dim, 0)[:0]
    return torch.cat([got.narrow(0, i * size, size).movedim(0, split_dim)
                      for i in range(n)], dim=cat_dim)


def softmax_combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                    group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial softmaxes over key blocks held by the ranks of ``group``,
    combined: ``m`` each row's block max of the logits ([..., 1]), ``l``
    the sum of ``p = exp(logits - m)`` over the block's valid keys
    ([..., 1]) and ``acc`` that of ``p * v`` ([..., D]), all f32.  With
    ``M`` the max of ``m`` over the group, returns ``(l, acc)`` as the
    sums over the group of ``l * exp(m - M)`` and ``acc * exp(m - M)``:
    one all-reduce of the max, one of the sums.  A block with no valid key
    (``m`` = -1e30, ``l`` = ``acc`` = 0) adds exactly zero.  No
    gradient."""
    if group is None:
        return l, acc
    big = all_reduce_(m.clone(), group, "max")
    w = torch.exp(m - big)
    both = all_reduce_(torch.cat([l * w, acc * w], dim=-1).contiguous(),
                       group)
    return both[..., :1], both[..., 1:]


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole of a tensor sharded along ``dim`` over ``group``, no
    gradient (checkpoints, tests)."""
    return x if group is None else _gather(x, dim % x.ndim, group)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor), no gradient."""
    return x if group is None else _sum(x, group)


def group_size(group) -> int:
    """Processes in ``group`` (1 for no group)."""
    if group is None:
        return 1
    if isinstance(group, CountingGroup):
        return len(group.ranks)
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 for no group and on a counting
    group, whose process is rank 0)."""
    if group is None or isinstance(group, CountingGroup):
        return 0
    return dist.get_rank(group)


_FLAT_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Any] = {}
# id of each process group :func:`process_group` handed out -> its axes
_GROUP_AXES: Dict[int, Tuple[str, ...]] = {}


def group_axes(group) -> Tuple[str, ...]:
    """The mesh axes ``group`` spans, as :func:`process_group` made it
    (``()`` for no group or a group made elsewhere)."""
    if isinstance(group, CountingGroup):
        return group.axes
    return _GROUP_AXES.get(id(group), ())


def process_group(mesh, axis):
    """The process group along ``axis`` (a name, or a tuple of names whose
    group ranks run row-major over them) of a ``launch.mesh.Mesh`` over
    ``torch.distributed``, or None where no value moves between
    processes: no mesh, an abstract one, a mesh of another kind
    (``serve.sharding.LocalMesh``), or no axis (``()``).  On a counting
    mesh (``launch.mesh.counting_mesh``), rank 0's
    :class:`CountingGroup`."""
    device_mesh = getattr(mesh, "device_mesh", None)
    if device_mesh is None:
        return None
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if not axes:
        return None
    counting = getattr(device_mesh, "counting_group", None)
    if counting is not None:
        return counting(axes)
    if len(axes) == 1:
        group = device_mesh.get_group(axes[0])
    else:
        key = (id(device_mesh), axes)
        if key not in _FLAT_GROUPS:     # made once: a new group is collective
            sub = device_mesh if axes == tuple(mesh.axis_names) else \
                device_mesh[axes]
            _FLAT_GROUPS[key] = sub._flatten("_".join(axes)).get_group()
        group = _FLAT_GROUPS[key]
    _GROUP_AXES[id(group)] = axes
    return group


def block_index(mesh, axes) -> int:
    """This process's row-major coordinate over ``axes`` (a name or a
    tuple): the index of its block of a dim sharded over them."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    out = 0
    for a in axes:
        out = out * mesh.shape[a] + mesh.coordinate(a)
    return out


def axes_size(mesh, axes) -> int:
    """Processes along ``axes`` (a name or a tuple) of ``mesh``: 1 where
    :func:`process_group` has no group."""
    if process_group(mesh, axes) is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(mesh.shape[a] for a in axes)


def mesh_group(axis):
    """The current mesh's (``sharding.context``) process group along
    ``axis``, or None: no mesh, an abstract one, or no such axis."""
    from repro_torch.sharding.context import current_mesh
    mesh = current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return None
    return process_group(mesh, axis)


def split_group(local: int, whole: int, what: str):
    """The ``model`` group a dim of ``whole`` is split over when a rank
    holds ``local`` of it, None where it holds the whole dim (no model
    axis, or the rules left the leaf whole because the dim does not
    divide).  A block without a current process-group mesh raises."""
    if local == whole:
        return None
    group = mesh_group("model")
    if group is None or whole != local * group_size(group):
        raise ValueError(f"{what}: this rank holds {local} of {whole}, and "
                         f"the current mesh has no 'model' process group "
                         f"of {whole // max(local, 1)} ranks to split it "
                         f"over (sharding.context.use_mesh)")
    return group
