"""xLSTM (Beck et al. 2024): mLSTM + sLSTM blocks, arch ``xlstm-1.3b``
(``repro.models.xlstm``'s port).

Layer plan: groups of ``slstm_every - 1`` mLSTM blocks and one sLSTM
block (the paper's xLSTM[7:1]).  The params keep JAX's nested stacking:
``mblocks`` leaves are ``[n_groups, mlstm_per_group, ...]`` (JAX's
nested scan), ``sblocks`` leaves ``[n_groups, ...]``; the caches stack
the same way and are updated in place.

mLSTM: matrix memory per head on the shared chunkwise engine
(``models/linear_scan.py``), sigmoid input gate.  sLSTM: scalar memory
with block-diagonal recurrent weights, sequential over time (a Python
loop, JAX's time ``lax.scan``): it has no parallel form, so a forward
runs ``T`` small steps per sLSTM block.

JAX's quirks are kept: prefill runs each sLSTM from a zero state and
ignores ``cache["s"]``; the gates are f32 (``log_sigmoid``,
``sigmoid(f + 2.0)``); the sLSTM normalizer is floored at 1e-6.  The
key scale ``k / sqrt(dk)`` divides by a tensor (PyTorch's CUDA division
by a Python scalar multiplies by its rounded reciprocal, the CPU's
divides).  The serve entry points run under ``layers.f32_sums``.

Training (JAX's ``xlstm_forward`` under ``jax.value_and_grad``): with
``cfg.remat`` each mLSTM layer of a forward under grad runs under
``transformer.checkpointed``, and only those: JAX checkpoints the
mLSTM scan body, not the sLSTM in its group body.  The stacks reach
autograd through one ``unbind`` a leaf (``transformer.unstack_layers``;
``mblocks`` merged to ``[n_groups * per_group, ...]`` by a view first),
and the sLSTM's time steps through one ``unbind`` of its input
projection: an index a layer or a step would send back a zero gradient
the size of the whole stack or sequence for each.

Over a ``model`` axis of processes (``sharding.rules``' ``default``
profile) the mLSTM splits by heads (``layers.HeadSplit``): ``wz``/``wu``
are column blocks (``v = u`` by heads, so the rank's ``di`` block is its
heads' values), the depthwise conv is cut to those columns, the
convolved ``c`` is gathered over ``di`` for ``wq``/``wk`` (its heads'
columns) and the whole ``wgate`` (its heads' gates), the chunk scan,
``headnorm`` and the ``silu(z)`` gate run on its heads, and ``wo``'s row
blocks are summed; where the heads do not divide (2 over 4) every rank
gathers and runs every head.  The sLSTM's ``wx``, ``r`` and ``ln`` are
whole: every rank runs the whole time loop and feeds ``wo``'s row block
its columns of ``y`` (``collectives.split_to``, whose backward gathers
the gradient whole).  The embedding and unembedding split by vocab as
the decoder's.  Under ``fsdp`` each layer's leaves are gathered where
the layer runs (``mblocks`` with its two layer dims).

Serving over ``model`` (``launch/steps.py``'s steps, the cache placed by
``sharding.rules.cache_pspec``): the layers split as in training, each
rank on its rows; the mLSTM state ``S`` stays the rank's block (of
``dk`` under ``default``, ``fsdp`` and ``infer2d``, of the heads under
``cache_seq``) and is read in place (``linear_scan.recurrent_step``: a
``dk`` block's partial reads summed over the group), a prefill moving
its new terms to that block (``linear_scan.end_state``); ``n``, the
conv's trailing inputs and the sLSTM's states, which the rules place
oddly, are gathered to the layout the layers compute on for the step and
written back to their blocks (``linear_scan.serve_views``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.attention import torch_dtype
from repro_torch.models.linear_scan import (chunked_scan, end_state,
                                           recurrent_step, serve_views)
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules
from repro_torch.sharding.context import current_placement
from repro_torch.tree import tree_map

_CHUNK = 256


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(inner dim, heads, dk, dv). proj_factor 2, qk at half width."""
    di = 2 * cfg.d_model
    h = cfg.n_heads
    dv = di // h
    dk = dv // 2
    return di, h, dk, dv


# ------------------------------------------------------------ mLSTM -----

def mlstm_block_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    di, h, dk, dv = _dims(cfg)
    d = cfg.d_model
    dt = torch_dtype(cfg)
    dev = generator.device
    p = {
        "ln": L.rmsnorm_init(d, dt, dev),
        "wz": L.dense_init(generator, d, di, bias=False, dtype=dt),
        "wu": L.dense_init(generator, d, di, bias=False, dtype=dt),
        "conv": {"w": L._normal(generator, (cfg.conv_width, di),
                                1.0 / math.sqrt(cfg.conv_width)).to(dt)},
        "wq": L.dense_init(generator, di, h * dk, bias=False, dtype=dt),
        "wk": L.dense_init(generator, di, h * dk, bias=False, dtype=dt),
        "wgate": L.dense_init(generator, di, 2 * h, bias=True, dtype=dt),
        "headnorm": L.rmsnorm_init(dv, dt, dev),
        "wo": L.dense_init(generator, di, d, bias=False, dtype=dt),
    }
    # forget-gate bias init +3: long memory at init
    p["wgate"]["b"][h:] = 3.0
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time, then SiLU.  x [B,T,C], w [W,C]
    -> (out [B,T,C], new state [B,W-1,C] = the trailing inputs).  Each
    tap is a product in x's dtype, summed in order, as JAX's."""
    wd = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], wd - 1, x.shape[-1]))
    xp = torch.cat([state, x], dim=1)
    t = x.shape[1]
    out = sum(xp[:, i:i + t] * w[i] for i in range(wd))
    return L.silu(out), xp[:, -(wd - 1):]


def _mlstm_split(p: Dict, cfg: ModelConfig) -> L.HeadSplit:
    di, h, dk, _ = _dims(cfg)
    return L.HeadSplit(h, L.layer_group(
        (L.out_features(p["wz"]), di), (L.out_features(p["wq"]), h * dk),
        (L.in_features(p["wo"]), di), what="mLSTM"))


def _mlstm_qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor, conv_state=None,
               hs: L.HeadSplit = None):
    """(z, q, k, v, input gate, log forget gate, conv state) of this
    rank's heads (``hs``; every head on one process)."""
    di, h, dk, dv = _dims(cfg)
    hs = hs or L.HeadSplit(h, None)
    n = hs.n
    b, t, _ = x.shape
    hn = L.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
    hc = hs.input(hn)
    z = hs.cols(p["wz"], hn, hc, dv)                  # output gate branch
    u = hs.cols(p["wu"], hn, hc, dv)                  # value branch
    c, conv_state = _causal_conv(u, hs.take(p["conv"]["w"], -1, dv),
                                 conv_state)
    if hs.even:
        # wq, wk and wgate read every column of c: the rank's block
        # gathered, their partial gradients summed (hs.input) back to it
        c = C.gather_from(c, -1, hs.group)
    cc = hs.input(c)
    q = hs.cols(p["wq"], c, cc, dk).reshape(b, t, n, dk).transpose(1, 2)
    k = hs.cols(p["wk"], c, cc, dk).reshape(b, t, n, dk).transpose(1, 2)
    k = k / k.new_full((), math.sqrt(dk))
    v = u.reshape(b, t, n, dv).transpose(1, 2)
    gates = (L.dense_apply(L.whole_grad(p["wgate"], hs.group), cc)
             if hs.even else L.dense_apply(p["wgate"], c)).float()
    # gates [B,T,2H]: this rank's heads' input and forget gates
    i_g = torch.sigmoid(gates[..., hs.lo:hs.lo + n]).transpose(1, 2)
    logf = torch.nn.functional.logsigmoid(
        gates[..., h + hs.lo:h + hs.lo + n]).transpose(1, 2)  # [B,n,T]
    return z, q, k, v, i_g, logf, conv_state


def _pad_time(q, k, v, *gates):
    """Zero-pad the time axis (dim 2) of q, k, v [B,H,T,.] and the gates
    [B,H,T] to a multiple of ``_CHUNK``: a padded step has log f = 0 and
    gate 0, so it leaves the state alone."""
    pad = -q.shape[2] % _CHUNK
    if not pad:
        return (q, k, v) + gates
    f = torch.nn.functional.pad
    return tuple(f(a, (0, 0, 0, pad)) for a in (q, k, v)) + tuple(
        f(g, (0, pad)) for g in gates)


def mlstm_block_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                      shardings=None) -> torch.Tensor:
    """Full-sequence (prefill, scoring) form. x [B,T,d]; the layer's
    leaves gathered first under ``fsdp`` (``shardings``)."""
    p = T.gather_layer(p, shardings)
    di, h, dk, dv = _dims(cfg)
    b, t, _ = x.shape
    hs = _mlstm_split(p, cfg)
    z, q, k, v, i_g, logf, _ = _mlstm_qkv(p, cfg, x, hs=hs)
    q, k, v, logf, i_g = _pad_time(q, k, v, logf, i_g)
    y = chunked_scan(q, k, v, logf, i_g, chunk=min(_CHUNK, q.shape[2]))
    y = y[:, :, :t].transpose(1, 2)                   # [B,T,n,dv]
    y = L.rmsnorm_apply(L.whole_grad(p["headnorm"], hs.group) if hs.even
                        else p["headnorm"], y, cfg.norm_eps)
    y = y.reshape(b, t, hs.n * dv) * L.silu(z)
    return x + hs.out(p["wo"], y.to(x.dtype))


def mlstm_state_init(cfg: ModelConfig, batch: int, device=None) -> Dict:
    di, h, dk, dv = _dims(cfg)
    return {
        "S": torch.zeros((batch, h, dk, dv), device=device),
        "n": torch.zeros((batch, h, dk), device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, di),
                            dtype=torch_dtype(cfg), device=device),
    }


def mlstm_block_step(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                     state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decode step. x [B,1,d].  Over a ``model`` axis the rank runs
    its heads (``_mlstm_split``) and its block of the state
    (``linear_scan.recurrent_step``: a block of the heads or of ``dk``);
    ``state["n"]`` is split as ``S`` and ``state["conv"]`` holds the
    rank's heads' columns (``serve_views``)."""
    di, h, dk, dv = _dims(cfg)
    b = x.shape[0]
    hs = _mlstm_split(p, cfg)
    z, q, k, v, i_g, logf, conv_state = _mlstm_qkv(p, cfg, x,
                                                   state["conv"], hs)
    qs, ks, vs = (a[:, :, 0].float() for a in (q, k, v))
    (s, n), y = recurrent_step((state["S"], state["n"]), qs, ks, vs,
                               torch.exp(logf[..., 0]), i_g[..., 0],
                               heads=(hs.lo, hs.n, h),
                               group=C.mesh_group("model"))
    y = L.rmsnorm_apply(p["headnorm"], y.to(x.dtype)[:, :, None, :]
                        .transpose(1, 2), cfg.norm_eps)
    y = y.reshape(b, 1, hs.n * dv) * L.silu(z)
    out = x + hs.out(p["wo"], y)
    return out, {"S": s, "n": n, "conv": conv_state}


def _mlstm_final_state(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                       st: Dict, to_state=None) -> Dict:
    """The exact end-of-sequence (S, n, conv) state from the whole
    sequence at once (no O(T^2) work), of the rank's heads
    (``_mlstm_split``) and rows; ``to_state`` moves the new terms to the
    state's block (``linear_scan.end_state``)."""
    z, q, k, v, i_g, logf, conv_state = _mlstm_qkv(p, cfg, x, st["conv"],
                                                   _mlstm_split(p, cfg))
    csum = torch.cumsum(logf, dim=-1)
    decay_out = torch.exp(csum[..., -1:] - csum)
    wk = (decay_out * i_g).float()[..., None] * k.float()
    g_tot = torch.exp(csum[..., -1])
    return {**end_state(st, wk, v, g_tot, to_state), "conv": conv_state}


# ------------------------------------------------------------ sLSTM -----

def slstm_block_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    dt = torch_dtype(cfg)
    return {
        "ln": L.rmsnorm_init(d, dt, generator.device),
        "wx": L.dense_init(generator, d, 4 * d, bias=True, dtype=dt),
        # block-diagonal recurrent weights: per head [dh, 4*dh]
        "r": L._normal(generator, (h, dh, 4 * dh),
                       1.0 / math.sqrt(dh)).to(dt),
        "wo": L.dense_init(generator, d, d, bias=False, dtype=dt),
    }


def slstm_state_init(cfg: ModelConfig, batch: int, device=None) -> Dict:
    d = cfg.d_model
    return {key: torch.zeros((batch, d), device=device)
            for key in ("c", "n", "h")}


def _slstm_cell(p: Dict, cfg: ModelConfig, xt: torch.Tensor, st: Dict
                ) -> Tuple[Dict, torch.Tensor]:
    """xt [B, 4d] (the pre-projected input), state {c, n, h [B, d]} f32."""
    h_, d = cfg.n_heads, cfg.d_model
    b = xt.shape[0]
    hprev = st["h"].to(torch_dtype(cfg)).reshape(b, h_, d // h_)
    rec = torch.einsum("bhd,hdf->bhf", hprev, p["r"]).reshape(b, 4 * d)
    g = (xt + rec).float()
    z, i, f, o = g.chunk(4, dim=-1)
    z, i = torch.tanh(z), torch.sigmoid(i)
    f, o = torch.sigmoid(f + 2.0), torch.sigmoid(o)
    c = f * st["c"] + i * z
    n = f * st["n"] + i
    hh = o * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": hh}, hh


def slstm_block_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                      state: Optional[Dict] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """Sequential over T (no parallel form). x [B,T,d]."""
    b, t, _ = x.shape
    hn = L.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
    xproj = L.dense_apply(p["wx"], hn)                # [B,T,4d]
    st = state or slstm_state_init(cfg, b, x.device)
    hs = []
    for xt in xproj.unbind(1):
        st, hh = _slstm_cell(p, cfg, xt, st)
        hs.append(hh)
    y = torch.stack(hs, dim=1).to(x.dtype)
    return x + _slstm_out(p["wo"], cfg, y), st


def _slstm_out(p: Dict, cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    """``y @ wo``: a row block's product of this rank's columns of the
    whole ``y`` every rank computed, summed over the group."""
    group = C.split_group(L.in_features(p), cfg.d_model, "sLSTM wo")
    return L.row_apply(p, C.split_to(y, -1, group), None, group)


# ---------------------------------------------------------- full LM -----

def group_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, mlstm_per_group). slstm_every == 0: one group, all
    mLSTM."""
    if cfg.slstm_every <= 0:
        return 1, cfg.n_layers
    if cfg.n_layers % cfg.slstm_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of slstm_every {cfg.slstm_every}")
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def xlstm_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random params on the generator's device, in ``cfg.dtype``."""
    dt = torch_dtype(cfg)
    ng, mper = group_layout(cfg)
    flat = T.stack_inits(lambda: mlstm_block_init(generator, cfg),
                         ng * mper)
    params = {
        "embed": L.embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                  dt),
        "mblocks": tree_map(lambda t: t.reshape((ng, mper) + t.shape[1:]),
                            flat),
        "ln_f": L.rmsnorm_init(cfg.d_model, dt, generator.device),
        "unembed": L.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                bias=False, dtype=dt),
    }
    if cfg.slstm_every > 0:
        params["sblocks"] = T.stack_inits(
            lambda: slstm_block_init(generator, cfg), ng)
    return params


def _at(tree: Dict, *idx) -> Dict:
    """The view of every leaf at ``tree[idx]`` (a layer of a stack)."""
    return tree_map(lambda t: t[idx], tree)


def _store(dst: Dict, src: Dict) -> None:
    """Copy a new state into its cache views."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _logits(params: Dict, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = L.rmsnorm_apply(T.whole(params, "ln_f"), x, cfg.norm_eps)
    return T.unembed(params, cfg, x)


@L.f32_sums()
def xlstm_forward(params: Dict, cfg: ModelConfig, inputs: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs [B,T] ids (or [B,T,d] floats) -> (logits [B,T,V] f32, a
    zero aux loss).  Under grad with ``cfg.remat`` each mLSTM layer is
    checkpointed."""
    x = T._embed_in(params, cfg, inputs)
    ng, mper = group_layout(cfg)
    remat = T.remat_wanted(cfg.remat, params)
    mblocks, msh = T.fsdp_blocks(params, "mblocks", ndim=2)
    mblocks = T.unstack_layers(mblocks, ndim=2)
    sblocks = None
    if "sblocks" in params:
        sblocks, ssh = T.fsdp_blocks(params, "sblocks")
        sblocks = T.unstack_layers(sblocks)
    for gi in range(ng):
        for blk in mblocks[gi * mper:(gi + 1) * mper]:
            if remat:
                x = T.checkpointed(functools.partial(
                    mlstm_block_apply, blk, cfg, shardings=msh), x)
            else:
                x = mlstm_block_apply(blk, cfg, x, msh)
        if sblocks is not None:
            x, _ = slstm_block_apply(T.gather_layer(sblocks[gi], ssh), cfg,
                                     x)
    return _logits(params, cfg, x), x.new_zeros((), dtype=torch.float32)


def xlstm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device=None) -> Dict:
    """O(1) recurrent state, whatever ``max_len``: ``m`` leaves [G, M, B,
    ...] (S, n f32, the conv's trailing inputs), ``s`` leaves [G, B, d]
    f32."""
    ng, mper = group_layout(cfg)
    m1 = mlstm_state_init(cfg, batch, device)
    cache = {"m": tree_map(lambda a: a.expand((ng, mper) + a.shape)
                           .clone(), m1)}
    if cfg.slstm_every > 0:
        s1 = slstm_state_init(cfg, batch, device)
        cache["s"] = tree_map(lambda a: a.expand((ng,) + a.shape).clone(),
                              s1)
    return cache


def _serve_layout(cfg: ModelConfig, cache: Dict, mblocks: Dict, msh):
    """(the cache's views, the state mover) of a serve step on the
    current placement (``linear_scan.serve_views``): ``m.n`` split as
    ``m.S``, ``m.conv`` the rank's rows and its heads' columns (every
    head under ``fsdp``: ``msh``, whose layers are gathered whole), the
    sLSTM's states its rows."""
    even = msh is None and _mlstm_split(_at(mblocks, 0, 0), cfg).even
    views, to_state = serve_views(cache["m"], "m", 2, even)
    if views is not None:
        rows = tuple(current_placement().batch_axes)
        views.update({("s", k): {1: rows} for k in cache.get("s", {})})
    return views, to_state


@L.f32_sums()
def xlstm_prefill(params: Dict, cfg: ModelConfig, inputs: torch.Tensor,
                  cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """The full-sequence forward, writing each block's final state into
    the cache -> (last-position logits [B, V], the cache).  Each sLSTM
    starts from a zero state, as in JAX.  On a serve step's placement
    the layers run on the rank's heads and rows (under ``fsdp`` each
    layer gathered first) and the states go to their placed blocks
    (``_serve_layout``)."""
    x = T._embed_in(params, cfg, inputs)
    ng, mper = group_layout(cfg)
    mblocks, msh = T.fsdp_blocks(params, "mblocks", ndim=2)
    sblocks, ssh = T.fsdp_blocks(params, "sblocks") if "sblocks" in params \
        else (None, None)
    views, to_state = _serve_layout(cfg, cache, mblocks, msh)
    with rules.cache_views(cache, views, current_placement()) as view:
        for gi in range(ng):
            for j in range(mper):
                blk = T.gather_layer(_at(mblocks, gi, j), msh)
                st = _at(view["m"], gi, j)
                new = _mlstm_final_state(blk, cfg, x, st, to_state)
                x = mlstm_block_apply(blk, cfg, x)
                _store(st, new)
            if sblocks is not None:
                x, new = slstm_block_apply(
                    T.gather_layer(_at(sblocks, gi), ssh), cfg, x)
                _store(_at(view["s"], gi), new)
    return T._data_block_rows(_logits(params, cfg, x[:, -1:])[:, 0]), cache


@L.f32_sums()
def xlstm_decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                      pos: int, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token [B] -> (logits [B, V], the cache).  ``pos`` is not read:
    the state carries the position."""
    inp = token[:, None] if token.ndim == 1 else token[:, None, :]
    x = T._embed_in(params, cfg, inp)
    ng, mper = group_layout(cfg)
    mblocks, msh = T.fsdp_blocks(params, "mblocks", ndim=2)
    sblocks, ssh = T.fsdp_blocks(params, "sblocks") if "sblocks" in params \
        else (None, None)
    views, _ = _serve_layout(cfg, cache, mblocks, msh)
    with rules.cache_views(cache, views, current_placement()) as view:
        for gi in range(ng):
            for j in range(mper):
                st = _at(view["m"], gi, j)
                x, new = mlstm_block_step(
                    T.gather_layer(_at(mblocks, gi, j), msh), cfg, x, st)
                _store(st, new)
            if sblocks is not None:
                sp = T.gather_layer(_at(sblocks, gi), ssh)
                st = _at(view["s"], gi)
                hn = L.rmsnorm_apply(sp["ln"], x, cfg.norm_eps)
                xproj = L.dense_apply(sp["wx"], hn)[:, 0]
                new, hh = _slstm_cell(sp, cfg, xproj, st)
                x = x + _slstm_out(sp["wo"], cfg, hh.to(x.dtype))[:, None]
                _store(st, new)
    return _logits(params, cfg, x)[:, 0], cache
