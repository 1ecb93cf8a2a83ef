"""Logical-axis -> mesh-axis sharding rules (the TPU analogue of HLS4PC's
per-layer PE-count parametrization), as ``repro.sharding.rules``.

Parameter shardings come from param-tree key paths; activations are
constrained only at step boundaries (inputs, caches).  ``profile``
selects a ruleset: ``default``, ``replicated``, ``fsdp``, ``infer2d``,
``cache_seq*`` and ``moe_local*`` (the last places like ``default``;
its dispatch is what differs, ``models/moe.py``).  Dims are matched
from the END of the shape so stacked layer dims ([L, ...] or [ng,
mper, ...]) pass through unsharded.

:class:`P` is ``jax.sharding.PartitionSpec``'s counterpart (a tuple, one
entry a dim: None, an axis name or a tuple of names) and
:class:`NamedSharding` pairs it with a ``launch.mesh.Mesh`` and gives a
leaf's per-device ``shard_shape``.  Paths are ``repro_torch.tree``
paths (dict keys and list indices); an element with a ``.key`` (a
``jax.tree_util.DictKey``) is read through it, so one rule serves both
packages' paths.

On a mesh over a process group (``launch.mesh.make_group_mesh`` or
``make_host_mesh`` under ``init_distributed``) these specs move values,
under every profile (:func:`moves_values`).
:func:`place` is ``jax.device_put(tree, shardings)``: each rank keeps
its block of every leaf (``NamedSharding.shard_shape``; a leaf whose
axis ``_spec`` dropped stays whole on every rank, as in JAX), and
:func:`gather` is its inverse, the whole tree on every rank.
:func:`constrain_batch` gives each rank its block of a batch: every rank
of a ``model`` group keeps the same ``(pod, data)`` block, and under
``fsdp`` the batch splits over all axes, as :func:`batch_shardings`
says.  :class:`Placement` carries a step's mesh, profile and parameter
shardings to the model code (``sharding.context.use_placement``), which
computes on local blocks with the collectives of
``sharding.collectives``.  A real tensor on an abstract mesh has no
process to hold a block: :func:`constrain_batch` and :func:`place`
raise ``ValueError`` there.  :func:`relayout` moves a block from one
spec to another (an all-to-all where an axis changes dims), and
:func:`cache_views` gives a serve step's cache leaves the layouts its
layers compute on where the rules place them otherwise (xLSTM's and
Hymba's recurrent states); :func:`check_placed` refuses a cache leaf
that is not its placed block.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.sharding import collectives as C
from repro_torch.sharding.collectives import block_index, process_group
from repro_torch.tree import tree_map, tree_map_with_path


class P(tuple):
    """PartitionSpec: ``P(None, "model")`` shards dim 1 over ``model``;
    dims past its length are unsharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: P

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """Each device's block of a ``shape`` array (``ValueError`` where
        a sharded dim does not divide)."""
        out = list(shape)
        for d, axis in enumerate(self.spec):
            n = _axis_size(self.mesh, axis)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {axis} ({n})")
            out[d] //= n
        return tuple(out)


def is_abstract(x: torch.Tensor) -> bool:
    """A fake (``FakeTensorMode``) or meta tensor: a shape and no values,
    so a sharding constraint on it moves nothing."""
    return x.device.type == "meta" or is_fake(x)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def _spec(ndim: int, assign: Dict[int, Any], shape, mesh) -> P:
    """assign: {dim (negative ok): axis or tuple}; drops non-divisible."""
    out = [None] * ndim
    for dim, axis in assign.items():
        d = dim % ndim
        if axis is None:
            continue
        if shape[d] % _axis_size(mesh, axis) == 0:
            if isinstance(axis, tuple) and len(axis) == 1:
                axis = axis[0]
            out[d] = axis
    return P(*out)


# Weight-name classification: which logical dim is "model-sharded".
_OUT_SHARDED = {"wq", "wk", "wv", "gate", "up", "wz", "wu", "fc1",
                "wb", "wc", "unembed"}
_IN_SHARDED = {"wo", "down", "fc2"}
_EXPERT_SHARDED = {"gate_w", "up_w", "down_w"}
_REPLICATED = {"router", "wdt", "wgate", "conv", "r", "dskip", "bn",
               "alpha", "beta"}


def path_keys(path) -> list:
    """A path's elements as strings (a ``DictKey`` through its key)."""
    return [str(getattr(p, "key", p)) for p in path]


def param_pspec(path: Tuple, shape: Tuple[int, ...], mesh,
                profile: str = "default") -> P:
    keys = path_keys(path)
    ndim = len(shape)
    model = "model" if "model" in mesh.axis_names else None
    if model is None or ndim == 0:
        return P()
    name = keys[-1]
    if name in ("q", "scale") and len(keys) >= 2:
        # int8 export dict {q, scale} replaces the weight array: derive
        # the spec from the enclosing weight name ("w"/"*_w")
        keys = keys[:-1]
        name = keys[-1]
    parents = set(keys[:-1])

    if profile == "replicated":
        return P()

    if profile in ("fsdp", "infer2d"):
        # ZeRO-3 / 2D inference: every big tensor fully sharded over all
        # mesh axes on its largest-divisible dim, the penultimate (input/
        # vocab/expert) dim first, then the last
        axes = full_axes(mesh)
        if ndim >= 2:
            for dim in (-2, -1):
                sp = _spec(ndim, {dim: axes}, shape, mesh)
                if any(a is not None for a in sp):
                    return sp
            return P()
        return _spec(ndim, {-1: axes}, shape, mesh)

    # embedding / unembedding: shard the vocab dim
    if name == "table":
        return _spec(ndim, {-2: model}, shape, mesh)
    if parents & _EXPERT_SHARDED or name in _EXPERT_SHARDED:
        return _spec(ndim, {-3: model}, shape, mesh)    # [.., E, in, out]
    if parents & _REPLICATED or name in _REPLICATED:
        return P()
    if name in ("w", "b") or name.endswith("_w"):
        owner = keys[-2] if len(keys) >= 2 else ""
        if owner in _OUT_SHARDED:
            return _spec(ndim, {-1: model}, shape, mesh)
        if owner in _IN_SHARDED:
            if name == "b":
                return P()
            return _spec(ndim, {-2: model}, shape, mesh)
    return P()


def params_shardings(params_or_shapes: Any, mesh,
                     profile: str = "default") -> Any:
    """Tree of NamedSharding matching a param (shape) tree."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, param_pspec(path, tuple(leaf.shape), mesh, profile)),
        params_or_shapes)


def batch_pspec(mesh) -> Tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def full_axes(mesh) -> Tuple:
    return tuple(a for a in ("pod", "data", "model")
                 if a in mesh.axis_names)


def moves_values(profile: str) -> bool:
    """Whether the port places real tensors under ``profile`` on a
    process-group mesh: every known profile does (``default``,
    ``replicated``, ``fsdp``, ``infer2d``, ``cache_seq*`` and
    ``moe_local*``).  An unknown name raises ``ValueError``."""
    if profile in ("default", "replicated", "fsdp", "infer2d") or \
            profile.startswith("moe_local") or "cache_seq" in profile:
        return True
    raise ValueError(f"unknown sharding profile {profile!r}")


def refuse_unmoved(profile: str, what: str = "") -> None:
    """``NotImplementedError`` citing ROADMAP.md Queue 1 item 4 where
    :func:`moves_values` says no (``what`` names the caller's part); an
    unknown profile raises ``ValueError``.  What waits there is not a
    profile: serving xLSTM, Hymba and Whisper over ``model``
    (``launch/steps.py``) and the dry-run's ``moe_local`` programs raise
    where they are computed."""
    if not moves_values(profile):
        raise NotImplementedError(
            f"{what or f'sharding profile {profile!r}'} on real tensors "
            f"waits for Queue 1 item 4 (the sharded part) in ROADMAP.md")


def _batch_axes(mesh, profile: str) -> Tuple:
    return full_axes(mesh) if profile in ("fsdp", "infer2d") \
        else batch_pspec(mesh)


def batch_shardings(batch_specs: Any, mesh, profile: str = "default"
                    ) -> Any:
    """Shard the leading (global-batch) dim of every input leaf; drop the
    assignment when not divisible (e.g. long_500k batch=1)."""
    baxes = _batch_axes(mesh, profile)

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, _spec(len(shape), {0: baxes}, shape,
                                         mesh))
    return tree_map(one, batch_specs)


def cache_pspec(path: Tuple, shape: Tuple[int, ...], mesh,
                profile: str = "default") -> P:
    """KV caches [L, B, S, Hkv, D]; recurrent states [L(, g), B, ...].
    Shard batch over (pod, data) and the head dim over model when
    divisible.  ``cache_seq`` profiles shard the SEQUENCE dim over model
    instead (distributed-softmax attention reads)."""
    ndim = len(shape)
    assign: Dict[int, Any] = {}
    baxes = batch_pspec(mesh)
    if ndim >= 4:
        assign[-4] = baxes           # batch dim of [L,B,S,H,D]
        if "cache_seq" in profile:
            assign[-3] = "model"     # sequence dim
        else:
            assign[-2] = "model"     # kv heads
    elif ndim >= 2:
        assign[1] = baxes
    return _spec(ndim, assign, shape, mesh)


def cache_shardings(cache_tree: Any, mesh, profile: str = "default"
                    ) -> Any:
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, cache_pspec(path, tuple(leaf.shape), mesh, profile)),
        cache_tree)


def shard_bytes(tree: Any, shardings: Any) -> int:
    """Per-device bytes of a tree of tensors (or ``TensorSpec``s) under a
    matching tree of :class:`NamedSharding`."""
    total = 0

    def add(leaf, sh):
        nonlocal total
        total += math.prod(sh.shard_shape(tuple(leaf.shape))) * \
            leaf.dtype.itemsize
        return leaf
    tree_map(add, tree, shardings)
    return total


def _sharded_dims(sharding):
    """(dim, axis) of each dim the spec shards over more than one
    device."""
    return [(d, a) for d, a in enumerate(sharding.spec)
            if a is not None and _axis_size(sharding.mesh, a) > 1]


def _need_group(mesh, axis, what: str) -> None:
    if process_group(mesh, axis) is None:
        raise ValueError(
            f"{what}: mesh {mesh.shape} is abstract, so no process holds "
            f"a block over {axis}; make the mesh over a process group "
            f"(launch.mesh.make_group_mesh under init_distributed)")


def shard(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This process's block of the whole tensor ``x``: a copy of its own,
    so the whole can be freed, that remembers the whole shape
    (:func:`whole_shape`, as a ``jax.Array`` knows its global shape);
    ``x`` itself where nothing is split."""
    dims = _sharded_dims(sharding)
    whole = tuple(x.shape)
    for d, axis in dims:
        _need_group(sharding.mesh, axis, "place")
        n = _axis_size(sharding.mesh, axis)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"over {axis} ({n})")
        size = x.shape[d] // n
        x = x.narrow(d, block_index(sharding.mesh, axis) * size, size)
    if not dims:
        return x
    x = x.clone()
    x.whole_shape = whole
    return x


def whole_shape(x: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the tensor :func:`place` cut the block ``x`` from
    (the block is updated in place, so a cache keeps it across steps);
    ``x``'s own shape for a tensor it did not cut."""
    return getattr(x, "whole_shape", tuple(x.shape))


def unshard(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The whole tensor of which ``x`` is this process's block (every
    rank of the mesh calls it)."""
    for d, axis in _sharded_dims(sharding):
        x = C.gather(x, d, process_group(sharding.mesh, axis))
    return x


def place(tree: Any, shardings: Any) -> Any:
    """``jax.device_put(tree, shardings)`` on a process-group mesh: each
    leaf of ``tree`` (whole, as ``convert.from_numpy_tree`` or an init
    gives it) cut to this process's block."""
    return tree_map(shard, tree, shardings)


def gather(tree: Any, shardings: Any) -> Any:
    """The inverse of :func:`place`: every leaf whole on every rank (a
    collective: every rank of the mesh calls it)."""
    return tree_map(unshard, tree, shardings)


def spec_of(shape, assign: Dict[int, Any], mesh) -> P:
    """The spec of a ``shape`` tensor that splits each dim of ``assign``
    (``{dim: axis or tuple}``) over its axes, a dim that does not divide
    left whole, as :func:`cache_pspec` builds its specs."""
    return _spec(len(shape), assign, tuple(shape), mesh)


def _axes(mesh, entry) -> list:
    """A spec entry as its axes of more than one device, major first."""
    axes = () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)
    return [a for a in axes if mesh.shape[a] > 1]


def relayout(x: torch.Tensor, src: P, dst: P, mesh) -> torch.Tensor:
    """``x``, this rank's block of a whole tensor under spec ``src``, as
    its block under ``dst`` (no gradient; serving).  Per mesh axis: an
    axis that leaves one dim for another moves by one all-to-all
    (``collectives.all_to_all``: each byte crosses once), one that only
    leaves is all-gathered, one that only arrives is a slice.  A dim's
    axes leave minor first and arrive major first (its blocks run
    row-major over a tuple of axes); an axis whose new dim still waits
    for another axis is gathered, then sliced.  ``x`` itself where the
    two specs agree; every rank of the mesh calls it alike."""
    s = [_axes(mesh, src[d] if d < len(src) else None)
         for d in range(x.ndim)]
    t = [_axes(mesh, dst[d] if d < len(dst) else None)
         for d in range(x.ndim)]
    if s == t:
        return x
    for a in {a for ax in s + t for a in ax}:
        _need_group(mesh, a, "relayout")
    leaving = [d for d in range(x.ndim) if s[d] != t[d][:len(s[d])]]
    for d in leaving:
        while s[d] != t[d][:len(s[d])]:
            a = s[d].pop()
            group = process_group(mesh, a)
            to = [j for j in range(x.ndim) if j not in leaving and
                  len(t[j]) > len(s[j]) and t[j][len(s[j])] == a]
            if to:
                x = C.all_to_all(x, to[0], d, group)
                s[to[0]].append(a)
            else:
                x = C.gather(x, d, group)
    whole = x
    for d in range(x.ndim):
        for a in t[d][len(s[d]):]:
            size = x.shape[d] // mesh.shape[a]
            x = x.narrow(d, mesh.coordinate(a) * size, size)
    # a block of its own, never a view of the caller's tensor
    return x.contiguous() if x is whole else \
        x.clone(memory_format=torch.contiguous_format)


def held_like(x: torch.Tensor, whole) -> torch.Tensor:
    """``x`` tagged as a block of a ``whole``-shaped tensor (as
    :func:`place` tags its blocks, :func:`whole_shape`) where it is one:
    a serve step's cache leaf made anew in its placed layout."""
    if tuple(x.shape) != tuple(whole):
        x.whole_shape = tuple(whole)
    return x


@contextlib.contextmanager
def cache_views(cache: Any, views: Dict[Tuple[str, ...], Dict[int, Any]],
                placement: "Placement"):
    """A serve step's cache as its layers compute on it: each leaf whose
    path ``views`` names (a tuple of keys) relayouted (:func:`relayout`)
    from its held block (:func:`cache_pspec` of its whole shape under
    ``placement.profile``) to the spec ``views`` assigns it
    (:func:`spec_of`); every other leaf is its held block itself.  When
    the block ends, each relayouted leaf is moved back into its held
    block in place.  ``cache`` itself without a placement."""
    if placement is None or not views:
        yield cache
        return
    mesh, moved = placement.mesh, []

    def one(path, leaf):
        assign = views.get(tuple(map(str, path)))
        if assign is None:
            return leaf
        whole = whole_shape(leaf)
        held = cache_pspec(path, whole, mesh, placement.profile)
        spec = spec_of(whole, assign, mesh)
        view = relayout(leaf, held, spec, mesh)
        if view is not leaf:
            moved.append((leaf, view, spec, held))
        return view
    yield tree_map_with_path(one, cache)
    for leaf, view, spec, held in moved:
        leaf.copy_(relayout(view, spec, held, mesh))


def check_placed(tree: Any, mesh, profile: str) -> None:
    """``ValueError`` unless every leaf of ``tree`` (a cache) is the
    block :func:`cache_pspec` gives this rank of the whole tensor it
    remembers (:func:`whole_shape`): a leaf made another way reads as
    whole, and one whose rules split it is refused."""
    def one(path, leaf):
        whole = whole_shape(leaf)
        block = NamedSharding(mesh, cache_pspec(path, whole, mesh, profile)
                              ).shard_shape(whole)
        if block != tuple(leaf.shape):
            raise ValueError(
                f"cache leaf {'/'.join(map(str, path))} {tuple(leaf.shape)} "
                f"is not its block {block} under {profile!r} on {mesh.shape}"
                f"; place it with rules.place(cache, rules.cache_shardings("
                f"cache, mesh, {profile!r}))")
        return leaf
    tree_map_with_path(one, tree)


def gather_shards(x: torch.Tensor, sharding: NamedSharding
                  ) -> torch.Tensor:
    """An ``fsdp`` block gathered whole where a layer uses it; its
    gradient is reduce-scattered back to the block."""
    for d, axis in _sharded_dims(sharding):
        x = C.gather_shards(x, d, process_group(sharding.mesh, axis))
    return x


@dataclasses.dataclass(frozen=True)
class Placement:
    """A step's placement on a process-group mesh: ``profile``'s rules
    applied to the parameter (``params``) and optimizer (``opt``) trees
    of the whole model, as trees of :class:`NamedSharding`; None where
    every leaf stays whole (a mesh without ``model``).  A serve step
    adds ``rows`` (:attr:`batch_axes`) and ``cache_len``: the whole slot
    count of a self-attention cache whose blocks split its slots over
    ``model`` (``cache_seq``; 0 where each rank holds every slot)."""
    mesh: Any
    profile: str = "default"
    params: Any = None
    opt: Any = None
    rows: Any = None
    cache_len: int = 0

    @property
    def fsdp(self) -> bool:
        """Blocks gathered where a layer uses them (``fsdp``,
        ``infer2d``)."""
        return self.profile in ("fsdp", "infer2d") and self.params is not None

    @property
    def batch_axes(self) -> Tuple:
        """The axes the step's batch rows split over: ``rows`` where the
        step set them (a serve step: a decode step's token block is the
        ``(pod, data)`` block under every profile), else the profile's."""
        return self.rows if self.rows is not None else \
            _batch_axes(self.mesh, self.profile)

    def sharded_axes(self, sharding: NamedSharding) -> Tuple[str, ...]:
        """The mesh axes a leaf's spec splits it over (several devices
        only), in mesh order."""
        used = set()
        for _, a in _sharded_dims(sharding):
            used.update((a,) if isinstance(a, str) else a)
        return tuple(a for a in self.mesh.axis_names if a in used)


def constrain_batch(x: torch.Tensor, mesh, profile: str = "default",
                    axes: Tuple = None) -> torch.Tensor:
    """JAX's ``with_sharding_constraint`` of a batch leaf.  ``x`` itself
    where the constraint moves no value: a fake or meta tensor, batch
    axes of one device, or a dim 0 that does not divide over them (JAX's
    spec then drops the axis).  On a process-group mesh, this rank's
    contiguous block of dim 0: block ``i`` at the row-major coordinate
    ``i`` over the batch axes (``(pod, data)``; every axis under
    ``fsdp``/``infer2d``), so every rank of a ``model`` group holds the
    same block; ``axes`` names other batch axes (a serve step's rows).
    A real tensor an abstract mesh would split raises ``ValueError``."""
    baxes = _batch_axes(mesh, profile) if axes is None else tuple(axes)
    n = _axis_size(mesh, baxes)
    if n == 1 or is_abstract(x) or x.ndim == 0 or x.shape[0] % n:
        return x
    _need_group(mesh, baxes, "constrain_batch")
    block = x.shape[0] // n
    i = block_index(mesh, baxes)
    return x[i * block:(i + 1) * block]
