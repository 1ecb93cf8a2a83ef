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

from typing import Tuple

import torch


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
                   f: torch.Tensor, i: torch.Tensor, normalize: bool = True
                   ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                              torch.Tensor]:
    """One decode step.  state = (S [B,H,dk,dv], n [B,H,dk]); q, k
    [B,H,dk], v [B,H,dv], f, i [B,H] -> (new state, h [B,H,dv])."""
    s, nrm = state
    s_new = f[..., None, None] * s + \
        i[..., None, None] * (k[..., :, None] * v[..., None, :])
    n_new = f[..., None] * nrm + i[..., None] * k
    num = (q[..., None, :] @ s_new)[..., 0, :]
    if normalize:
        den = torch.clamp_min((q * n_new).sum(dim=-1).abs(), 1.0)
        num = num / den[..., None]
    return (s_new, n_new), num


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
