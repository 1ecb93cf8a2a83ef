"""Mixture-of-Experts FFN: sort-based capacity dispatch (``repro.models.moe``).

The JAX design, on one device: router top-k -> flatten the (token, slot)
entries -> stable argsort by expert id -> rank within the expert from
its start offset -> scatter into an ``[E, C, d]`` buffer -> batched
expert SwiGLU (one product per expert) -> gather back, weighted combine.
Entries past an expert's capacity are dropped (the residual carries the
token).

``moe_apply`` takes JAX's route: ``moe_apply_global`` unless the
``sharding_profile`` is ``moe_local*`` and the current mesh
(``sharding.context``) has a ``model`` axis, where it takes
:func:`moe_apply_local`.  On a mesh over processes:

* **The global route over a split batch** (JAX's ``moe_apply_global``,
  which GSPMD partitions as one program).  The step's batch splits over
  its batch axes (the placement's ``batch_axes``, else the mesh's
  ``(pod, data)``) into ``R`` blocks in batch order; the rank at block
  ``r`` (``collectives.block_index``) routes its own ``n`` tokens,
  counts each expert's entries and all-gathers the ``[R, E]`` counts
  over the batch group (``collectives.gather``: one small collective,
  no tokens move, since the expert SwiGLU works row by row).  An
  entry's position in its expert is ``off[e]`` (the entries of blocks
  ``0..r-1``) plus its rank within the expert in stable token order;
  it is kept below the global capacity ``capacity(cfg, n * R)``, so the
  last blocks drop first, as JAX's one stable sort over the batch.  A
  rank keeps at most ``n`` entries of an expert (a token picks an
  expert once), so its buffer holds ``min(C, n)`` slots an expert,
  filled at the local rank: a static shape that drops nothing extra.
  The aux loss takes the gathered counts and the probabilities summed
  over the batch group.  One rank is the trivial case: no prefix, the
  buffer JAX's ``[E, C, d]``.  Expert parallel: a rank holding ``E/m``
  experts (``gate_w``/``up_w``/``down_w`` split on their expert dim
  over ``model``) computes the products of its experts' slots,
  all-gathers the expert outputs over ``model`` and runs the
  ordered combine below; the routing, replicated over ``model``, takes
  its input's gradient summed once (``copy_to``).  Under ``fsdp`` and
  ``infer2d`` a step's rows split over ``model`` too and each layer's
  experts are gathered whole, so ``model`` is one more batch axis of
  the prefix: each rank routes and computes its own rows (the placement
  says which axes split them; a batch that does not divide is whole on
  every rank, one block).
* **:func:`moe_apply_local`** (JAX's ``shard_map`` MoE).  Routing stays
  on each data block, with a capacity of its own that truncates first
  (``int(t_loc * k / E * cf)``, unlike the global ``ceil``); a rank keeps
  only its own experts' entries, in a stable order by local expert; the
  combine adds each entry's ``y * w`` in f32, sums the ranks' partial
  outputs over ``model`` and casts to ``x.dtype``.  Tokens never move.
  The aux loss is the product of two global means: the data group
  all-reduces ``frac`` and ``mean(probs)`` before the product.  Under a
  step profile whose rows split over ``model`` too (``fsdp``,
  ``infer2d``) a rank gathers its data block's rows over ``model``, cuts
  its experts from the gathered layer, and keeps its own rows of the
  summed outputs (a reduce-scatter).
* **Under ``seq_parallel``** the caller gathers the sequence whole
  before the layer and cuts the output back to its block
  (``transformer._block_apply``), so routing, capacity and aux see every
  token of the data block, as JAX's.
* On an abstract mesh (the dry-run's production meshes, or any mesh
  with a ``model`` axis and no process group) the ``moe_local*`` route
  is :func:`moe_apply_whole`: JAX's ``moe_apply_local`` computed whole
  in one process, every data block dispatched in one pass, on real or
  fake tensors.

What holds the layer to JAX's results (ROADMAP.md Queue 3):

* **Static shapes, no host syncs.**  The capacity comes from the Python
  token count, dropped entries go to a spare slot ``E*C`` and ``keep``
  masks with ``where``; expert start offsets come from ``searchsorted``
  on the sorted ids.  Nothing here calls ``.item()``, ``nonzero``,
  boolean-mask indexing, ``bincount`` or ``one_hot`` (the last two read
  the data's range back to the host).
* **Top-k ties go to the lower expert index**, as ``jax.lax.top_k``
  documents: a stable descending sort, then a slice (``torch.topk``
  promises no tie order on CUDA).
* **The argsort by expert id is stable**, so an expert's entries keep
  token order: the last tokens of a call drop first.
* **The combine adds in ``x.dtype`` in a fixed order.**  JAX scatter-adds
  each entry's ``y * w`` (``w`` cast to ``x.dtype``) into zeros in
  ``x.dtype``, entry by entry in expert order.  The port gathers each
  token's k weighted outputs, ordered by ascending expert, and adds them
  one slot at a time from zero: the same roundings, on both devices, and
  no ``index_add_`` (whose CUDA atomics add in no fixed order).
* **The router product is f32 x f32**, summed in f32 with TF32 off (the
  LM entry points turn it off, ``layers.f32_sums``).  An ulp between
  XLA, the CPU and the card can still flip a near-tied top-k choice, and
  then that token's output differs by a whole expert: tests accept a
  flip only below a stated gap between the k-th and (k+1)-th router
  probabilities, and report it.
* **Capacity couples the tokens of a call**: a token's output depends on
  how many earlier tokens chose its expert.  So a lane's logits are not
  the same at every dispatch width, and a decode step (capacity 8 for a
  few tokens) and a forward over the same prefix disagree wherever the
  forward drops an entry.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import matmul
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import batch_pspec
from repro_torch.sharding.context import current_mesh, current_placement


def moe_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """JAX's tree: ``router.w`` [d, E] f32; ``gate_w``/``up_w`` [E, d, f]
    and ``down_w`` [E, f, d] in ``cfg.dtype``, drawn in f32 and cast."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    std = 1.0 / math.sqrt(d)
    return {
        "router": {"w": L._normal(generator, (d, e), std)},
        "gate_w": L._normal(generator, (e, d, f), std).to(dt),
        "up_w": L._normal(generator, (e, d, f), std).to(dt),
        "down_w": L._normal(generator, (e, f, d),
                            1.0 / math.sqrt(f)).to(dt),
    }


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert holds for ``n_tokens`` tokens: the capacity
    factor's share, at least 8 and padded to a multiple of 8."""
    c = int(math.ceil(n_tokens * cfg.experts_per_token *
                      cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, ties to the lower index (as
    ``jax.lax.top_k``): (values, indices), both [N, k]."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(p: Dict, cfg: ModelConfig, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf [N, d] -> (router probs [N, E] f32, renormalized top-k weights
    [N, k] f32, their experts [N, k] int64)."""
    logits = matmul(xf.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, cfg.experts_per_token)
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e


class Dispatch(NamedTuple):
    hb: torch.Tensor        # [E, S, d] expert inputs, zeros where unused
    order: torch.Tensor     # [N*k] sorted position -> entry
    dest: torch.Tensor      # [N*k] sorted position -> slot (E*S: dropped)
    keep: torch.Tensor      # [N*k] bool, sorted position kept
    counts: torch.Tensor    # [E] entries routed to each expert


def dispatch(cfg: ModelConfig, xf: torch.Tensor, top_e: torch.Tensor,
             c: int, off: torch.Tensor = None) -> Dispatch:
    """Sort the (token, slot) entries by expert and scatter each kept
    entry's token into its expert's next free slot.  An entry's position
    in its expert is ``off[e]`` (the entries of the batch's earlier
    blocks, ``[E]``; None: ``xf`` is the whole batch) plus its rank among
    this block's entries of the expert; it is kept below the capacity
    ``c``.  The buffer holds ``S = c`` slots an expert for the whole
    batch, ``min(c, N)`` for a block, each entry at its local rank."""
    n, d = xf.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    s = c if off is None else min(c, n)
    flat_e = top_e.reshape(n * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=xf.device, dtype=sorted_e.dtype))
    counts = torch.diff(starts, append=starts.new_full((1,), n * k))
    rank = torch.arange(n * k, device=xf.device) - starts[sorted_e]
    keep = rank < c if off is None else off[sorted_e] + rank < c
    dest = torch.where(keep, sorted_e * s + rank, e * s)
    buf = xf.new_zeros((e * s + 1, d))
    # every dropped entry writes zeros into the spare last slot
    buf[dest] = xf[order // k] * keep[:, None].to(xf.dtype)
    return Dispatch(buf[:-1].reshape(e, s, d), order, dest, keep, counts)


def experts(p: Dict, hb: torch.Tensor) -> torch.Tensor:
    """The batched expert SwiGLU: [E, C, d] -> [E, C, d]."""
    g = torch.bmm(hb, p["gate_w"])
    u = torch.bmm(hb, p["up_w"])
    return torch.bmm(L.silu(g) * u, p["down_w"])


def combine(yb: torch.Tensor, disp: Dispatch, top_p: torch.Tensor
            ) -> torch.Tensor:
    """Each token's kept outputs times their weights (both in the
    outputs' dtype), added slot by slot from zero in ascending expert
    order: [E, C, d] -> [N, d]."""
    e, c, d = yb.shape
    n, k = top_p.shape
    y_flat = yb.reshape(e * c, d)
    w = top_p.reshape(n * k).to(yb.dtype)[disp.order]
    y_sorted = torch.where(disp.keep[:, None],
                           y_flat[disp.dest.clamp(max=e * c - 1)],
                           0.0) * w[:, None]
    # sorted position of each (token, slot) entry; a token's positions in
    # ascending order are its entries in ascending expert id
    pos = torch.empty_like(disp.order)
    pos[disp.order] = torch.arange(n * k, device=yb.device)
    vals = y_sorted[pos.reshape(n, k).sort(dim=-1).values]       # [N, k, d]
    out = yb.new_zeros((n, d))
    for j in range(k):
        out = out + vals[:, j]
    return out


def _aux(cfg: ModelConfig, counts: torch.Tensor, n_entries: int,
         probs: torch.Tensor, data_group) -> torch.Tensor:
    """``E * sum(frac * mean(probs))``, both over the whole batch:
    ``counts`` are its entries per expert and ``n_entries`` their number;
    over a data group the probability sums are summed across it (their
    gradient summed back)."""
    n = probs.shape[0]
    if data_group is not None:
        n = n * C.group_size(data_group)
        prob_sum = C.sum_both(probs.sum(dim=0), data_group)
        mean_prob = prob_sum / prob_sum.new_full((), n)
    else:
        mean_prob = probs.mean(dim=0)
    frac = counts.float() / probs.new_full((), n_entries)
    return cfg.n_experts * torch.sum(frac * mean_prob)


def _counts(top_e: torch.Tensor, e: int) -> torch.Tensor:
    """Entries routed to each of ``e`` experts (no host sync)."""
    s = top_e.reshape(-1).sort().values
    starts = torch.searchsorted(
        s, torch.arange(e, device=s.device, dtype=s.dtype))
    return torch.diff(starts, append=starts.new_full((1,), s.numel()))


def _routes_locally(cfg: ModelConfig, mesh) -> bool:
    return cfg.sharding_profile.startswith("moe_local") and \
        mesh is not None and "model" in mesh.axis_names


def moe_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (out [B, T, d], aux loss, f32 scalar).

    aux is the Switch load-balancing loss: E * sum over experts of the
    fraction of entries routed there times the mean router probability.
    """
    mesh = current_mesh()
    if _routes_locally(cfg, mesh):
        if C.process_group(mesh, "model") is None:
            return moe_apply_whole(p, cfg, x, mesh)
        return moe_apply_local(p, cfg, x, mesh)
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    n = b * t
    xf = x.reshape(n, d)
    probs, top_p, top_e = route(p, cfg, xf)
    # the batch's blocks: this rank's is block r of R (module docstring)
    pl = current_placement()
    axes = tuple(pl.batch_axes) if pl is not None else \
        batch_pspec(mesh) if mesh is not None else ()
    data_group = C.process_group(mesh, axes) \
        if C.axes_size(mesh, axes) > 1 else None
    if data_group is None:
        off, counts, ranks = None, None, 1
    else:
        ranks = C.group_size(data_group)
        every = C.gather(_counts(top_e, e)[None], 0, data_group)   # [R, E]
        off = every[:C.block_index(mesh, axes)].sum(dim=0)
        counts = every.sum(dim=0)
    group = C.split_group(p["gate_w"].shape[-3], e, "MoE experts")
    disp = dispatch(cfg, C.copy_to(xf, group), top_e,
                    capacity(cfg, n * ranks), off)
    aux = _aux(cfg, disp.counts if counts is None else counts,
               n * ranks * k, probs, data_group)
    hb = disp.hb
    if group is not None:
        e_loc = p["gate_w"].shape[-3]
        hb = hb.narrow(0, C.group_rank(group) * e_loc, e_loc)
    yb = C.gather_from(experts(p, hb), 0, group)
    out = combine(yb, disp, top_p)
    return out.reshape(b, t, d), aux


def local_capacity(cfg: ModelConfig, t_loc: int) -> int:
    """JAX's ``moe_apply_local`` capacity: the share truncated by
    ``int()`` first, then padded to a multiple of 8, at least 8."""
    c = int(t_loc * cfg.experts_per_token / cfg.n_experts *
            cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


class LocalDispatch(NamedTuple):
    buf: torch.Tensor       # [E_loc, cap, d] this rank's expert inputs
    order: torch.Tensor     # [T_loc*k] sorted position -> entry
    dest: torch.Tensor      # [T_loc*k] sorted position -> slot (E_loc*cap)
    keep: torch.Tensor      # [T_loc*k] bool: this rank's expert, in capacity


def dispatch_local(xf: torch.Tensor, top_e: torch.Tensor, e_lo: int,
                   e_local: int, cap: int) -> LocalDispatch:
    """JAX's ``_dispatch_local``: the entries routed to experts
    ``[e_lo, e_lo + e_local)`` sorted stably by local expert (the others
    after them, dropped), each kept one scattered into its expert's next
    free slot of ``cap``."""
    t_loc, d = xf.shape
    k = top_e.shape[-1]
    flat_e = top_e.reshape(t_loc * k)
    mine = (flat_e >= e_lo) & (flat_e < e_lo + e_local)
    e_loc = torch.where(mine, flat_e - e_lo, e_local)
    order = torch.argsort(e_loc, stable=True)
    sorted_e = e_loc[order]
    starts = torch.searchsorted(sorted_e, torch.arange(
        e_local + 1, device=xf.device, dtype=sorted_e.dtype))
    rank = torch.arange(t_loc * k, device=xf.device) - starts[sorted_e]
    keep = (sorted_e < e_local) & (rank < cap)
    dest = torch.where(keep, sorted_e * cap + rank, e_local * cap)
    buf = xf.new_zeros((e_local * cap + 1, d))
    buf[dest] = xf[order // k] * keep[:, None].to(xf.dtype)
    return LocalDispatch(buf[:-1].reshape(e_local, cap, d), order, dest,
                         keep)


def _entries_local(y_buf: torch.Tensor, disp: LocalDispatch,
                   top_p: torch.Tensor) -> torch.Tensor:
    """Each token's k entries' ``y * w`` in f32 (``w`` the f32 router
    weight; zero for an entry not kept), in ascending expert order:
    [E_loc, cap, d] -> [T_loc, k, d]."""
    e_local, cap, d = y_buf.shape
    t_loc, k = top_p.shape
    y_flat = y_buf.reshape(e_local * cap, d)
    w = top_p.reshape(t_loc * k).float()[disp.order]
    y_sorted = torch.where(
        disp.keep[:, None],
        y_flat[disp.dest.clamp(max=e_local * cap - 1)].float() *
        (w * disp.keep.float())[:, None], 0.0)
    pos = torch.empty_like(disp.order)
    pos[disp.order] = torch.arange(t_loc * k, device=y_buf.device)
    return y_sorted[pos.reshape(t_loc, k).sort(dim=-1).values]


def combine_local(y_buf: torch.Tensor, disp: LocalDispatch,
                  top_p: torch.Tensor) -> torch.Tensor:
    """JAX's ``_combine_local`` before its ``psum``: each kept entry's
    ``y * w`` in f32 (``w`` the f32 router weight), added into its token
    from zero in ascending expert order: [E_loc, cap, d] -> [T_loc, d]
    f32."""
    vals = _entries_local(y_buf, disp, top_p)
    out = vals.new_zeros(vals[:, 0].shape)
    for j in range(vals.shape[1]):
        out = out + vals[:, j]
    return out


def moe_apply_local(p: Dict, cfg: ModelConfig, x: torch.Tensor, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``moe_apply_local`` on this rank: ``x`` is its data block
    (or, where the step's rows split over ``model`` too, its rows of it,
    gathered here and given back), and ``gate_w``/``up_w``/``down_w``
    hold its ``E / m`` experts (``m`` the ``model`` axis's size; all
    ``E`` where it is 1), or all ``E`` of an ``fsdp`` layer gathered
    whole, which it cuts."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    m = mesh.shape["model"]
    if e % m:
        raise ValueError(f"{cfg.name}: {e} experts do not divide over the "
                         f"'model' axis ({m})")
    e_local = e // m
    group = C.process_group(mesh, "model") if m > 1 else None
    held = p["gate_w"].shape[-3]
    if held == e and m > 1:
        # an fsdp layer gathered whole: this rank cuts its experts
        lo = C.block_index(mesh, "model") * e_local
        p = dict(p, **{name: p[name].narrow(-3, lo, e_local)
                       for name in ("gate_w", "up_w", "down_w")})
    elif held != e_local:
        raise ValueError(f"{cfg.name}: moe_local needs this rank's "
                         f"{e_local} experts; it holds {held}")
    pl = current_placement()
    rows = group is not None and pl is not None and \
        "model" in pl.batch_axes
    if rows:
        # JAX's shard_map takes each data block whole: its rows gathered
        # over model (the gradient reduce-scattered back)
        x = C.gather_shards(x, 0, group)
        b = x.shape[0]
    data = batch_pspec(mesh)
    data_group = C.process_group(mesh, data) if math.prod(
        mesh.shape[a] for a in data) > 1 else None
    t_loc = b * t
    xf = x.reshape(t_loc, d)
    probs, top_p, top_e = route(p, cfg, xf)
    aux = _aux(cfg, C.all_sum(_counts(top_e, e), data_group),
               t_loc * k * C.group_size(data_group), probs, data_group)
    # the replicated routing's gradient: summed by copy_to where x is the
    # same on every model rank, by the rows' gather where it was gathered
    rep = None if rows else group
    disp = dispatch_local(C.copy_to(xf, rep), top_e,
                          C.block_index(mesh, "model") * e_local, e_local,
                          local_capacity(cfg, t_loc))
    y = combine_local(experts(p, disp.buf), disp, C.copy_to(top_p, rep))
    y = C.scatter_sum(y.reshape(b, t, d), 0, group) if rows else \
        C.reduce_from(y, group).reshape(b, t, d)
    return y.to(x.dtype), aux


def moe_apply_whole(p: Dict, cfg: ModelConfig, x: torch.Tensor, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``moe_apply_local`` on an abstract ``mesh`` (a ``model``
    axis, no process group), whole in one process, with every expert's
    weights (``[E, d, f]``).  ``x`` [B, T, d] splits into ``n_dp`` data
    blocks of ``t_loc = B*T/n_dp`` tokens (``n_dp`` the product of the
    ``pod``/``data`` axes: JAX's ``in_specs=P(dp, None)``); every token
    is routed, the capacity is :func:`local_capacity` of ``t_loc`` and
    the aux loss is the whole batch's, as JAX computes them before its
    ``shard_map``.  Each entry's expert becomes the virtual expert
    ``block * E + e``, so one stable sort and one scatter
    (:func:`dispatch_local` over ``n_dp * E`` experts) give every block's
    dispatch at once, each entry in the slot the per-rank dispatch gives
    it, laid out as JAX's ``[E, n_dp * cap, d]``
    (``out_specs=P("model", dp, None)``).  The combine is
    ``_combine_local``'s: ``y * w`` in f32, each ``model`` rank's experts
    summed in ascending order, those partial outputs summed over the
    ranks, one cast to ``x.dtype``."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    m = mesh.shape["model"]
    n_dp = math.prod(mesh.shape[a] for a in batch_pspec(mesh))
    n = b * t
    if e % m or n % n_dp:
        raise ValueError(f"{cfg.name}: {e} experts over 'model' ({m}) or "
                         f"{n} tokens over the data blocks ({n_dp}) do not "
                         f"divide")
    t_loc, e_local = n // n_dp, e // m
    cap = local_capacity(cfg, t_loc)
    xf = x.reshape(n, d)
    probs, top_p, top_e = route(p, cfg, xf)
    aux = _aux(cfg, _counts(top_e, e), n * k, probs, None)
    block = torch.arange(n, device=x.device) // t_loc
    disp = dispatch_local(xf, top_e + (block * e)[:, None], 0, n_dp * e,
                          cap)
    hb = disp.buf.reshape(n_dp, e, cap, d).transpose(0, 1).reshape(
        e, n_dp * cap, d)
    yb = experts(p, hb).reshape(e, n_dp, cap, d).transpose(0, 1).reshape(
        n_dp * e, cap, d)
    vals = _entries_local(yb, disp, top_p)              # [N, k, d] f32
    owner = top_e.sort(dim=-1).values // e_local        # [N, k] model rank
    mine = owner[None] == torch.arange(m, device=x.device)[:, None, None]
    parts = vals.new_zeros((m, n, d))                   # each rank's partial
    for j in range(k):
        parts = parts + torch.where(mine[:, :, j, None], vals[None, :, j],
                                    0.0)
    return parts.sum(dim=0).reshape(b, t, d).to(x.dtype), aux
