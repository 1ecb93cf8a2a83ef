"""Mixture-of-Experts FFN: sort-based capacity dispatch (``repro.models.moe``).

The JAX design, on one device: router top-k -> flatten the (token, slot)
entries -> stable argsort by expert id -> rank within the expert from
its start offset -> scatter into an ``[E, C, d]`` buffer -> batched
expert SwiGLU (one product per expert) -> gather back, weighted combine.
Entries past an expert's capacity are dropped (the residual carries the
token).

``moe_apply`` is JAX's ``moe_apply_global``, the route JAX takes unless
the ``sharding_profile`` is ``moe_local*`` and the current mesh
(``sharding.context``) has a ``model`` axis.  That pair takes JAX's
``moe_apply_local`` (the shard_map dispatch and combine: a per-shard
capacity and an f32 scatter-add), which waits for the sharded part of
ROADMAP.md Queue 1 item 4: it raises ``NotImplementedError``, on fake
tensors too (the dry-run), since its program differs.

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
from repro_torch.sharding.context import current_mesh


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
    hb: torch.Tensor        # [E, C, d] expert inputs, zeros where unused
    order: torch.Tensor     # [N*k] sorted position -> entry
    dest: torch.Tensor      # [N*k] sorted position -> slot (E*C: dropped)
    keep: torch.Tensor      # [N*k] bool, sorted position kept
    counts: torch.Tensor    # [E] entries routed to each expert


def dispatch(cfg: ModelConfig, xf: torch.Tensor, top_e: torch.Tensor,
             c: int) -> Dispatch:
    """Sort the (token, slot) entries by expert and scatter each kept
    entry's token into its expert's next free slot of ``c``."""
    n, d = xf.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    flat_e = top_e.reshape(n * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=xf.device, dtype=sorted_e.dtype))
    counts = torch.diff(starts, append=starts.new_full((1,), n * k))
    rank = torch.arange(n * k, device=xf.device) - starts[sorted_e]
    keep = rank < c
    dest = torch.where(keep, sorted_e * c + rank, e * c)
    buf = xf.new_zeros((e * c + 1, d))
    # every dropped entry writes zeros into the spare last slot
    buf[dest] = xf[order // k] * keep[:, None].to(xf.dtype)
    return Dispatch(buf[:-1].reshape(e, c, d), order, dest, keep, counts)


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


def moe_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (out [B, T, d], aux loss, f32 scalar).

    aux is the Switch load-balancing loss: E * sum over experts of the
    fraction of entries routed there times the mean router probability.
    """
    mesh = current_mesh()
    if cfg.sharding_profile.startswith("moe_local") and mesh is not None \
            and "model" in mesh.axis_names:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.sharding_profile!r} dispatch over a mesh "
            f"with a 'model' axis (JAX's moe_apply_local) waits for Queue "
            f"1 item 4 (the sharded part) in ROADMAP.md")
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    n = b * t
    xf = x.reshape(n, d)
    probs, top_p, top_e = route(p, cfg, xf)
    disp = dispatch(cfg, xf, top_e, capacity(cfg, n))
    frac_routed = disp.counts.float() / probs.new_full((), n * k)
    aux = e * torch.sum(frac_routed * probs.mean(dim=0))
    out = combine(experts(p, disp.hb), disp, top_p)
    return out.reshape(b, t, d), aux
