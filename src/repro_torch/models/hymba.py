"""Hymba (NVIDIA 2024): parallel attention + SSM heads in every layer,
arch ``hymba-1.5b`` (``repro.models.hymba``'s port).

Each layer splits into two branches over the same normalized input: GQA
attention heads with a sliding window (``cfg.sliding_window``; on the
flash route the flash kernel with that window), and mamba/SSD heads
(scalar-per-head decay linear attention, state size ``cfg.ssm_state``,
on the shared chunkwise engine without the normalizer, plus the f32
D-skip).  The two outputs are RMS-normalized and averaged, then the
SwiGLU FFN follows.

Decode state per layer: the rolling window cache (``window`` slots,
written at absolute position % window) and the SSM state (S, n, the
conv's trailing inputs), independent of the context length.  Params and
caches are stacked ``[L, ...]``; caches are updated in place.  As in
JAX, prefill and decode apply the FFN without ``cfg.quant``.  The key
scale ``kb / sqrt(s)`` divides by a tensor (see ``models/xlstm.py``).

Training: with ``cfg.remat`` each layer of a forward under grad runs
under ``transformer.checkpointed`` (JAX's ``jax.checkpoint`` of the
layer), and the stacked params reach autograd through one ``unbind`` a
leaf.  It trains on ``attn_impl="xla"`` (the config's default): flash
has no backward and raises under grad before any launch.

Over a ``model`` axis of processes (``sharding.rules``' ``default``
profile) the attention splits as the decoder's (``attn_apply``, the
window on the rank's heads; Hymba's 25 query and 5 kv heads over 2 take
its uneven branch), the SSM by heads (``layers.HeadSplit``: ``wv``,
``wb``, ``wc`` column blocks, the whole ``wdt``, ``conv`` and ``dskip``
read in the rank's heads, ``wo``'s row blocks summed; where the heads do
not divide, every rank runs every head) and the FFN as the decoder's
SwiGLU.  Under ``fsdp`` each layer's leaves are gathered where the layer
runs.

Serving over ``model`` (``launch/steps.py``'s steps, the cache placed by
``sharding.rules.cache_pspec``): the SSM state ``S`` stays the rank's
block (of the state dim ``s`` under ``default``, ``fsdp`` and
``infer2d``, of the heads under ``cache_seq`` where 25 heads do not
divide over 2 and it stays whole), read in place
(``linear_scan.recurrent_step``); ``n`` and the conv state are gathered
to the layout the layers compute on and written back
(``linear_scan.serve_views``); the rolling window cache splits its kv
heads (``default``) or its slots (``cache_seq``: a write goes to the
rank holding slot ``pos % window``, ``attention._seq_block_attn``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.linear_scan import (chunked_scan, end_state,
                                           recurrent_step, serve_views)
from repro_torch.models.xlstm import (_CHUNK, _causal_conv, _logits,
                                      _pad_time, _store)
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules
from repro_torch.sharding.context import current_placement
from repro_torch.tree import tree_map


def _ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    h = cfg.n_heads
    return h, cfg.ssm_state, cfg.d_model // h


def hymba_block_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    h, s, dv = _ssm_dims(cfg)
    dt = A.torch_dtype(cfg)
    dev = generator.device
    return {
        "ln1": L.rmsnorm_init(d, dt, dev),
        "attn": A.attn_init(generator, cfg),
        "ssm": {
            "wv": L.dense_init(generator, d, h * dv, bias=False, dtype=dt),
            "conv": {"w": L._normal(generator, (cfg.conv_width, h * dv),
                                    1.0 / math.sqrt(cfg.conv_width))
                     .to(dt)},
            "wb": L.dense_init(generator, d, h * s, bias=False, dtype=dt),
            "wc": L.dense_init(generator, d, h * s, bias=False, dtype=dt),
            "wdt": L.dense_init(generator, d, h, bias=True, dtype=dt),
            "dskip": torch.full((h, 1, 1), 0.5, device=dev),
            "wo": L.dense_init(generator, h * dv, d, bias=False, dtype=dt),
        },
        "norm_attn": L.rmsnorm_init(d, dt, dev),
        "norm_ssm": L.rmsnorm_init(d, dt, dev),
        "ln2": L.rmsnorm_init(d, dt, dev),
        "mlp": L.swiglu_init(generator, d, cfg.d_ff, dt),
    }


def _ssm_split(p: Dict, cfg: ModelConfig) -> L.HeadSplit:
    h, s, dv = _ssm_dims(cfg)
    return L.HeadSplit(h, L.layer_group(
        (L.out_features(p["wv"]), h * dv), (L.out_features(p["wb"]), h * s),
        (L.in_features(p["wo"]), h * dv), what="Hymba SSM"))


def _ssm_proj(p: Dict, cfg: ModelConfig, hn: torch.Tensor, conv_state=None,
              hs: L.HeadSplit = None):
    """(q, k / sqrt(s), v, the decay f, conv state) of this rank's heads
    (``hs``; every head on one process)."""
    h, s, dv = _ssm_dims(cfg)
    hs = hs or L.HeadSplit(h, None)
    n = hs.n
    b, t, _ = hn.shape
    hc = hs.input(hn)
    v = hs.cols(p["wv"], hn, hc, dv)
    v, conv_state = _causal_conv(v, hs.take(p["conv"]["w"], -1, dv),
                                 conv_state)
    vh = v.reshape(b, t, n, dv).transpose(1, 2)                # [B,n,T,dv]
    kb = hs.cols(p["wb"], hn, hc, s).reshape(b, t, n, s).transpose(1, 2)
    qc = hs.cols(p["wc"], hn, hc, s).reshape(b, t, n, s).transpose(1, 2)
    dt_pre = hs.cols(p["wdt"], hn, hc, 1).float()              # [B,T,n]
    f = torch.sigmoid(dt_pre + 3.0).transpose(1, 2)            # [B,n,T]
    return qc, kb / kb.new_full((), math.sqrt(s)), vh, f, conv_state


def _ssm_apply(p: Dict, cfg: ModelConfig, hn: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD branch. hn [B,T,d] -> [B,T,d]."""
    h, s, dv = _ssm_dims(cfg)
    b, t, _ = hn.shape
    hs = _ssm_split(p, cfg)
    q, k, v, f, _ = _ssm_proj(p, cfg, hn, hs=hs)
    logf = torch.log(f)
    ig = 1.0 - f                                               # leaky pair
    q, k, v, logf, ig = _pad_time(q, k, v, logf, ig)
    y = chunked_scan(q, k, v, logf, ig, chunk=min(_CHUNK, q.shape[2]),
                     normalize=False)[:, :, :t]
    y = y + hs.take(p["dskip"], 0, 1) * v[:, :, :t]            # D-skip, f32
    y = y.transpose(1, 2).reshape(b, t, hs.n * dv)
    return hs.out(p["wo"], y.to(hn.dtype))


def _fuse(blk: Dict, cfg: ModelConfig, a: torch.Tensor, m: torch.Tensor
          ) -> torch.Tensor:
    return 0.5 * (L.rmsnorm_apply(blk["norm_attn"], a, cfg.norm_eps) +
                  L.rmsnorm_apply(blk["norm_ssm"], m, cfg.norm_eps))


def _mlp(blk: Dict, cfg: ModelConfig, hn: torch.Tensor, quant=None
         ) -> torch.Tensor:
    mlp = blk["mlp"]
    return L.swiglu_apply(mlp, hn, quant, C.split_group(
        L.out_features(mlp["gate"]), cfg.d_ff, "mlp"))


def hymba_block_apply(blk: Dict, cfg: ModelConfig, x: torch.Tensor,
                      shardings=None) -> torch.Tensor:
    """The full-sequence form (no cache); the layer's leaves gathered
    first under ``fsdp`` (``shardings``)."""
    blk = T.gather_layer(blk, shardings)
    hn = L.rmsnorm_apply(blk["ln1"], x, cfg.norm_eps)
    a, _ = A.attn_apply(blk["attn"], cfg, hn, causal=True,
                        window=cfg.sliding_window)
    x = x + _fuse(blk, cfg, a, _ssm_apply(blk["ssm"], cfg, hn))
    hn = L.rmsnorm_apply(blk["ln2"], x, cfg.norm_eps)
    return x + _mlp(blk, cfg, hn, cfg.quant if cfg.quant.enabled else None)



# Stateful (prefill/decode) paths -----------------------------------------

def ssm_state_init(cfg: ModelConfig, batch: int, device=None) -> Dict:
    h, s, dv = _ssm_dims(cfg)
    return {
        "S": torch.zeros((batch, h, s, dv), device=device),
        "n": torch.zeros((batch, h, s), device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, h * dv),
                            dtype=A.torch_dtype(cfg), device=device),
    }


def hymba_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                     device=None) -> Dict:
    """Per layer, stacked [L, ...]: the attention cache (rolling, of
    ``cfg.sliding_window`` slots, when the window is set) and the SSM
    state."""
    one = {"attn": A.init_cache(cfg, batch, max_len,
                                window=cfg.sliding_window, device=device),
           "ssm": ssm_state_init(cfg, batch, device)}
    return tree_map(lambda a: a.expand((cfg.n_layers,) + a.shape).clone(),
                    one)


def _ssm_state_update(p: Dict, cfg: ModelConfig, hn: torch.Tensor,
                      prev: Dict, to_state=None) -> Dict:
    """The exact end-of-sequence state from a full-sequence input
    (prefill), of the rank's heads (``_ssm_split``) and rows;
    ``to_state`` moves the new terms to the state's block
    (``linear_scan.end_state``)."""
    q, k, v, f, conv_state = _ssm_proj(p, cfg, hn, prev["conv"],
                                       _ssm_split(p, cfg))
    logf = torch.log(f)
    ig = (1.0 - f).float()
    csum = torch.cumsum(logf, dim=-1)
    decay_out = torch.exp(csum[..., -1:] - csum)
    wk = (decay_out * ig)[..., None] * k.float()
    g_tot = torch.exp(csum[..., -1])
    return {**end_state(prev, wk, v, g_tot, to_state), "conv": conv_state}


def hymba_block_prefill(blk: Dict, cfg: ModelConfig, x: torch.Tensor,
                        cache: Dict, to_state=None) -> torch.Tensor:
    """The full-sequence form, writing the layer's cache in place."""
    hn = L.rmsnorm_apply(blk["ln1"], x, cfg.norm_eps)
    a, _ = A.attn_apply(blk["attn"], cfg, hn, causal=True,
                        cache=cache["attn"], cache_pos=0,
                        window=cfg.sliding_window)
    m = _ssm_apply(blk["ssm"], cfg, hn)
    new = _ssm_state_update(blk["ssm"], cfg, hn, cache["ssm"], to_state)
    _store(cache["ssm"], new)
    x = x + _fuse(blk, cfg, a, m)
    hn2 = L.rmsnorm_apply(blk["ln2"], x, cfg.norm_eps)
    return x + _mlp(blk, cfg, hn2)


def hymba_block_step(blk: Dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict, pos: int) -> torch.Tensor:
    """One decode step, x [B,1,d], writing the layer's cache in place.
    Over a ``model`` axis the SSM runs the rank's heads on its block of
    the state (``linear_scan.recurrent_step``)."""
    h, s, dv = _ssm_dims(cfg)
    b = x.shape[0]
    hn = L.rmsnorm_apply(blk["ln1"], x, cfg.norm_eps)
    a, _ = A.attn_apply(blk["attn"], cfg, hn, causal=True,
                        cache=cache["attn"], cache_pos=pos,
                        window=cfg.sliding_window)
    st = cache["ssm"]
    hs = _ssm_split(blk["ssm"], cfg)
    q, k, v, f, conv_state = _ssm_proj(blk["ssm"], cfg, hn, st["conv"], hs)
    qs, ks, vs = (t[:, :, 0].float() for t in (q, k, v))
    fs = f[..., 0]
    (s_new, n_new), y = recurrent_step((st["S"], st["n"]), qs, ks, vs, fs,
                                       1.0 - fs, normalize=False,
                                       heads=(hs.lo, hs.n, h),
                                       group=C.mesh_group("model"))
    y = y + hs.take(blk["ssm"]["dskip"], 0, 1)[:, 0] * vs
    _store(st, {"S": s_new, "n": n_new, "conv": conv_state})
    m = hs.out(blk["ssm"]["wo"], y.reshape(b, 1, hs.n * dv).to(x.dtype))
    x = x + _fuse(blk, cfg, a, m)
    hn2 = L.rmsnorm_apply(blk["ln2"], x, cfg.norm_eps)
    return x + _mlp(blk, cfg, hn2)


def _serve_layout(cfg: ModelConfig, cache: Dict, blocks: Dict, sh):
    """(the cache's views, the state mover) of a serve step on the
    current placement (``linear_scan.serve_views``): ``ssm.n`` split as
    ``ssm.S``, ``ssm.conv`` the rank's rows and its heads' columns (every
    head under ``fsdp``: ``sh``, whose layers are gathered whole).  The
    attention's rolling cache stays its held block (``attn_apply``)."""
    even = sh is None and _ssm_split(
        T.layer_params(blocks, 0)["ssm"], cfg).even
    return serve_views(cache["ssm"], "ssm", 1, even)


# ---------------------------------------------------------- full LM -----

def hymba_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random params on the generator's device, in ``cfg.dtype`` (the
    D-skip in f32, as JAX's)."""
    dt = A.torch_dtype(cfg)
    return {
        "embed": L.embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                  dt),
        "blocks": T.stack_inits(lambda: hymba_block_init(generator, cfg),
                                cfg.n_layers),
        "ln_f": L.rmsnorm_init(cfg.d_model, dt, generator.device),
        "unembed": L.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                bias=False, dtype=dt),
    }


@L.f32_sums()
def hymba_forward(params: Dict, cfg: ModelConfig, inputs: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs [B,T] ids (or [B,T,d] floats) -> (logits [B,T,V] f32, a
    zero aux loss).  On ``attn_impl="flash"`` the flash kernel runs once
    a layer.  Under grad with ``cfg.remat`` each layer is
    checkpointed."""
    x = T._embed_in(params, cfg, inputs)
    remat = T.remat_wanted(cfg.remat, params)
    blocks, sh = T.fsdp_blocks(params)
    for blk in T.unstack_layers(blocks):
        if remat:
            x = T.checkpointed(functools.partial(
                hymba_block_apply, blk, cfg, shardings=sh), x)
        else:
            x = hymba_block_apply(blk, cfg, x, sh)
    return _logits(params, cfg, x), x.new_zeros((), dtype=torch.float32)


@L.f32_sums()
def hymba_prefill(params: Dict, cfg: ModelConfig, inputs: torch.Tensor,
                  cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """The full-sequence forward writing each layer's cache -> (the
    last-position logits [B, V], the cache).  On a serve step's placement
    each layer runs on the rank's heads and rows (gathered first under
    ``fsdp``) and its states go to their placed blocks
    (``_serve_layout``)."""
    x = T._embed_in(params, cfg, inputs)
    blocks, sh = T.fsdp_blocks(params)
    views, to_state = _serve_layout(cfg, cache, blocks, sh)
    with rules.cache_views(cache, views, current_placement()) as view:
        for i in range(cfg.n_layers):
            x = hymba_block_prefill(
                T.gather_layer(T.layer_params(blocks, i), sh), cfg, x,
                T.layer_params(view, i), to_state)
    return T._data_block_rows(_logits(params, cfg, x[:, -1:])[:, 0]), cache


@L.f32_sums()
def hymba_decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                      pos: int, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    inp = token[:, None] if token.ndim == 1 else token[:, None, :]
    x = T._embed_in(params, cfg, inp)
    blocks, sh = T.fsdp_blocks(params)
    views, _ = _serve_layout(cfg, cache, blocks, sh)
    with rules.cache_views(cache, views, current_placement()) as view:
        for i in range(cfg.n_layers):
            x = hymba_block_step(
                T.gather_layer(T.layer_params(blocks, i), sh), cfg, x,
                T.layer_params(view, i), int(pos))
    return _logits(params, cfg, x)[:, 0], cache
