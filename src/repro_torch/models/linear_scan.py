"""Chunkwise scalar-decay linear attention: the recurrence engine that
xLSTM's mLSTM (``models/xlstm.py``) and Hymba's SSD heads
(``models/hymba.py``) share (``repro.models.linear_scan``'s port).

Recurrence (per head, t over time):
    S_t = f_t · S_{t-1} + i_t · k_t v_tᵀ          (state  [dk, dv])
    n_t = f_t · n_{t-1} + i_t · k_t               (normalizer [dk])
    h_t = (q_tᵀ S_t) / max(|q_tᵀ n_t|, 1)

Forms:
  * :func:`chunked_scan`: within-chunk products, and a loop over chunks
    (JAX's ``lax.scan``) carrying the f32 state; O(T·L), not O(T²).
  * :func:`recurrent_step`: the O(1) decode update.
  * :func:`reference_scan`: the O(T) sequential oracle (tests).

Under autograd the masked upper triangle's ``exp`` sees 0, never its
own log ratio (the inner ``where``): at a forget gate near exp(-80) that
ratio overflows to ``inf``, and ``where``'s backward would multiply
its zero by it into ``NaN``.

Types follow JAX's promotion: where JAX multiplies a bf16 operand by an
f32 one inside an ``einsum`` (the decayed scores against v, the f32 decay
``g`` against q and the bf16 chunk states), the product is f32, so the
port casts the bf16 operand up to f32, never the f32 one down.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules
from repro_torch.sharding.context import current_placement


def chunked_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_f: torch.Tensor, i_gate: torch.Tensor,
                 chunk: int = 256, normalize: bool = True) -> torch.Tensor:
    """q, k [B,H,T,dk], v [B,H,T,dv], log_f, i_gate [B,H,T] (f32) ->
    [B,H,T,dv] in q's dtype.  T must be a multiple of ``chunk`` (callers
    pad)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    nc = t // chunk

    def resh(x):
        return x.reshape(b, h, nc, chunk, *x.shape[3:])
    q_, k_, v_ = resh(q), resh(k), resh(v)
    lf, ig = resh(log_f), resh(i_gate)

    # within-chunk cumulative decay g_t = exp(cumsum log f)
    csum = torch.cumsum(lf, dim=-1)                      # [B,H,nc,L]
    g = torch.exp(csum)
    g_total = torch.exp(csum[..., -1:])
    decay_out = torch.exp(csum[..., -1:] - csum)         # to chunk end

    # intra-chunk masked scores: q_t·k_s (g_t/g_s) i_s for s < t, and
    # q_t·k_t i_t on the diagonal
    qk = torch.einsum("bhnld,bhnmd->bhnlm", q_, k_)      # q's dtype
    lm = csum[..., :, None] - csum[..., None, :]
    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device)
    strict = torch.tril(ones, diagonal=-1)
    diag = torch.eye(chunk, dtype=torch.bool, device=q.device)
    zero = lm.new_zeros(())
    ratio = torch.where(strict, torch.exp(torch.where(strict, lm, zero)),
                        zero)
    ratio = ratio + torch.where(diag, lm.new_ones(()), zero)
    scores = qk * ratio * ig[..., None, :]               # f32
    intra = torch.einsum("bhnlm,bhnmv->bhnlv", scores, v_.to(scores.dtype))
    intra_den = scores.sum(dim=-1)

    # inter-chunk: each chunk's contribution to the chunk-end state, f32
    w = (decay_out * ig).float()
    kf, vf = k_.float(), v_.float()
    kv_chunk = torch.einsum("bhnld,bhnlv->bhndv", w[..., None] * kf, vf)
    kn_chunk = torch.einsum("bhnl,bhnld->bhnd", w, kf)
    del kf, vf
    gt = g_total.float()                                 # [B,H,nc,1]
    # each chunk's start state, stacked once (no in-place writes: their
    # backward would copy the whole history's gradient a chunk)
    s_prev = q.new_zeros((b, h, dk, dv), dtype=torch.float32)
    n_prev = q.new_zeros((b, h, dk), dtype=torch.float32)
    s_list, n_list = [], []
    for n in range(nc):
        s_list.append(s_prev)
        n_list.append(n_prev)
        s_prev = gt[:, :, n, :, None] * s_prev + kv_chunk[:, :, n]
        n_prev = gt[:, :, n] * n_prev + kn_chunk[:, :, n]
    del kv_chunk, kn_chunk
    s_hist = torch.stack(s_list, dim=2).to(q.dtype)      # q's dtype
    n_hist = torch.stack(n_list, dim=2).to(q.dtype)
    del s_list, n_list

    gq = g[..., None] * q_.to(g.dtype)                   # f32
    inter = gq @ s_hist.to(gq.dtype)
    inter_den = (gq @ n_hist.to(gq.dtype)[..., None])[..., 0]

    num = intra + inter
    if normalize:
        den = torch.clamp_min((intra_den + inter_den).abs(), 1.0)
        num = num / den[..., None]
    return num.reshape(b, h, t, dv).to(q.dtype)


def recurrent_step(state: Tuple[torch.Tensor, torch.Tensor],
                   q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   f: torch.Tensor, i: torch.Tensor, normalize: bool = True,
                   heads: Optional[Tuple[int, int, int]] = None, group=None
                   ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                              torch.Tensor]:
    """One decode step.  state = (S [B,H,dk,dv], n [B,H,dk]); q, k
    [B,H,dk], v [B,H,dv], f, i [B,H] -> (new state, h [B,H,dv]).

    Over a ``model`` group (``group``; a serve step's cache placed by
    ``sharding.rules.cache_pspec``) the state may be this rank's block of
    its heads ([B, H/m, dk, dv]) or of its key dim ([B, H, dk/m, dv]),
    ``n`` split alike, and q, k, v, f, i are the heads ``heads`` =
    ``(lo, count, total)`` this rank computes (its own block or every
    head).  The inputs (one dtype) are gathered over the group where the
    state holds heads this rank does not compute; the state's block is updated in
    place of the whole (its own rows of ``k vᵀ``); a key-dim block reads
    its partial ``qᵀS`` and ``qᵀn``, summed over the group in one
    all-reduce, so the whole state never crosses ranks; h comes back for
    ``heads``."""
    s, nrm = state
    lo0, n0 = (0, q.shape[1]) if heads is None else heads[:2]
    total = n0 if heads is None else heads[2]
    m, r = C.group_size(group), C.group_rank(group)
    hs, dks, dk = s.shape[1], s.shape[2], q.shape[-1]
    s_lo = r * hs if hs < total else 0
    if (s_lo, hs) != (lo0, n0):
        lo = lo0
        if s_lo < lo0 or s_lo + hs > lo0 + n0:
            # every head's inputs, in one gather
            dv = v.shape[-1]
            q, k, v, f, i = C.gather(torch.cat(
                [q, k, v, f[..., None], i[..., None]], dim=-1), 1,
                group).split([dk, dk, dv, 1, 1], dim=-1)
            f, i = f[..., 0], i[..., 0]
            lo = 0
        q, k, v, f, i = (t.narrow(1, s_lo - lo, hs) for t in (q, k, v, f, i))
    if dks < dk:
        q, k = (t.narrow(-1, r * dks, dks) for t in (q, k))
    s_new = f[..., None, None] * s + \
        i[..., None, None] * (k[..., :, None] * v[..., None, :])
    n_new = f[..., None] * nrm + i[..., None] * k
    num = (q[..., None, :] @ s_new)[..., 0, :]
    den = (q * n_new).sum(dim=-1) if normalize else None
    if dks < dk and m > 1:
        if normalize:
            both = C.all_sum(torch.cat([num, den[..., None]], dim=-1), group)
            num, den = both[..., :-1], both[..., -1]
        else:
            num = C.all_sum(num, group)
    if normalize:
        num = num / torch.clamp_min(den.abs(), 1.0)[..., None]
    if (s_lo, hs) != (lo0, n0):
        if hs < total:
            num = C.gather(num, 1, group)
        num = num.narrow(1, lo0, n0)
    return (s_new, n_new), num


def end_state(state: Dict, wk: torch.Tensor, v: torch.Tensor,
              g: torch.Tensor, to_state: Optional[Callable] = None) -> Dict:
    """The (S, n) state after a chunk of T steps, the chunk's keys
    weighted by their decay to its end and their gate (``wk`` [B,H,T,dk],
    f32), its values ``v`` [B,H,T,dv] and its whole decay ``g`` [B,H]:
    ``S' = g S + wkᵀ v`` and ``n' = g n + Σ_t wk``.  ``to_state`` moves
    ``g`` and the new terms from the layout the layer computes them in
    to the state's block (:func:`serve_views`)."""
    move = to_state or (lambda t: t)
    g = move(g)
    return {"S": g[..., None, None] * state["S"] +
            move(wk.transpose(-1, -2) @ v.float()),
            "n": g[..., None] * state["n"] + move(wk.sum(dim=2))}


def serve_views(state: Dict, key: str, lead: int, heads_split: bool):
    """How a serve step on the current placement holds a recurrent state
    ``cache[key]`` = {``S`` [*layers, B, H, dk, dv], ``n`` [*layers, B,
    H, dk], ``conv`` [*layers, B, w-1, C]} (``lead`` stacked layer dims),
    each leaf placed by ``sharding.rules.cache_pspec``: (views,
    to_state).

    ``S`` stays its held block (batch rows over ``(pod, data)``, and its
    heads or its key dim over ``model``), read in place by
    :func:`recurrent_step`.  ``views`` (``rules.cache_views``) gives
    ``n`` the split of ``S`` and ``conv`` the step's rows and, where the
    rank computes a block of the heads (``heads_split``), their columns:
    the rules place those two oddly (the batch axes on a layer dim,
    ``model`` on a head or the batch dim), so the step gathers them to
    these layouts and writes its block back.  ``to_state`` moves a
    tensor led by [B, H, dk, dv] from the layer's layout (the step's
    rows, the rank's heads) to the state's block (:func:`end_state`).
    None, None without a placement or a ``model`` axis (the rules place
    caches on one)."""
    pl = current_placement()
    if pl is None or "model" not in pl.mesh.axis_names:
        return None, None
    mesh = pl.mesh
    whole = rules.whole_shape(state["S"])
    held = rules.cache_pspec((key, "S"), whole, mesh, pl.profile)
    rows = tuple(pl.batch_axes)
    model = "model" if heads_split else None
    views = {(key, "n"): dict(enumerate(held[:-1])),
             (key, "conv"): {lead: rows, lead + 2: model}}
    comp = rules.spec_of(whole[lead:], {0: rows, 1: model}, mesh)
    st = held[lead:]

    def to_state(t):
        return rules.relayout(t, comp[:t.ndim], st[:t.ndim], mesh)
    return views, to_state


def reference_scan(q, k, v, log_f, i_gate, normalize: bool = True
                   ) -> torch.Tensor:
    """O(T) sequential oracle for :func:`chunked_scan` (tests): the
    state starts at zeros in q's dtype."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    state = (q.new_zeros((b, h, dk, dv)), q.new_zeros((b, h, dk)))
    f = torch.exp(log_f)
    out = []
    for s in range(t):
        state, hs = recurrent_step(state, q[:, :, s], k[:, :, s],
                                   v[:, :, s], f[:, :, s], i_gate[:, :, s],
                                   normalize)
        out.append(hs)
    return torch.stack(out, dim=2)
