"""GQA attention with KV caches (full, causal, sliding-window, cross).

The port of ``repro.models.attention``:

* full sequence, no cache (the scoring forward): ``impl="flash"`` runs
  the flash-attention CUDA kernel (``kernels.ops.flash_attention``),
  ``impl="xla"`` the plain einsum form ``_sdpa_xla``, and
  ``impl="xla_chunked"`` the online-softmax form over key chunks,
  ``_sdpa_xla_chunked`` (no [T, S] score matrix; plain torch ops, as
  JAX's is plain XLA);
* prefill and decode, with a cache: ``_sdpa_xla`` over the dense cache
  (``xla_chunked`` too: JAX takes its chunked form only where no cache
  length applies), or ``_rolling_sdpa`` over a rolling sliding-window
  cache, as in JAX (the flash route is taken exactly where JAX takes it:
  ``impl == "flash"`` and no cache);
* cross-attention over given encoder K/V (``cross_kv``, Whisper's
  decoder): ``_sdpa_xla``, non-causal, no RoPE and no cache, on every
  route, as in JAX.

Layouts are JAX's: q [B, T, H, D], k/v and caches [B, S, Hkv, D].  The
cache is updated in place (JAX's engine donates it), and the updated
cache is returned as JAX returns it.

Tensor parallelism (``sharding.rules``' ``default`` profile over a
``model`` axis of processes): a rank holding column blocks of
``wq``/``wk``/``wv`` computes its own heads, attends over them (the flash
kernel too) and its cache holds its ``Hkv`` block; ``wo`` is a row block
whose partial products one all-reduce sums.  Where ``H`` divides over
``model`` and ``Hkv`` does not, the rules still split ``wk``/``wv`` by
columns when ``Hkv * D`` divides (cutting a head) and leave them whole
when it does not; either way every rank then holds the whole k/v (its
column blocks all-gathered), the cache stays whole on every rank, as
``cache_pspec`` leaves it, and each rank's query head ``h`` reads kv
head ``h // (H / Hkv)``.  Where ``H`` itself does not divide but ``H *
D`` does, every rank gathers every query head and feeds ``wo`` its own
column block.  The layer finds its split from its weights' shapes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C

NEG = -1e30


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def attn_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.kv_head_dim
    dt = torch_dtype(cfg)
    return {
        "wq": L.dense_init(generator, d, h * hd, bias=False, dtype=dt),
        "wk": L.dense_init(generator, d, cfg.n_kv_heads * hd, bias=False,
                           dtype=dt),
        "wv": L.dense_init(generator, d, cfg.n_kv_heads * hd, bias=False,
                           dtype=dt),
        "wo": L.dense_init(generator, h * hd, d, bias=False, dtype=dt),
    }


def _out_features(p: Dict) -> int:
    w = p["w"]
    return (w["q"] if isinstance(w, dict) else w).shape[-1]


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n_heads, -1)


def _masked_softmax_av(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor, out_shape, dtype) -> torch.Tensor:
    """softmax(where(mask, qg.k / sqrt(D), -1e30)) @ v, all in f32, for
    qg [B, T, Hkv, G, D] and k, v [B, S, Hkv, D]."""
    d = qg.shape[-1]
    logits = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float())
    logits = logits / logits.new_full((), math.sqrt(d))
    logits = torch.where(mask, logits, logits.new_full((), NEG))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return out.reshape(out_shape).to(dtype)


def _sdpa_xla(q, k, v, causal: bool, window: int, q_offset: int,
              kv_len: Optional[int] = None) -> torch.Tensor:
    """q [B,T,H,D], k/v [B,S,Hkv,D]; GQA by reshape (query head h reads
    KV head h // (H // Hkv)).  q_offset: absolute position of q[:, 0];
    kv_len: count of valid cache entries (prefill/decode)."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, t, hkv, h // hkv, d)
    qpos = q_offset + torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    return _masked_softmax_av(qg, k, v, mask, (b, t, h, d), q.dtype)


def _sdpa_xla_chunked(q, k, v, causal: bool, window: int, q_offset: int,
                      chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over key chunks of ``chunk`` (keys padded
    to a multiple, the padding masked), all in f32: JAX's
    ``_sdpa_xla_chunked``, op for op, its ``lax.scan`` a loop."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    pad = -s % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // chunk
    g = h // hkv
    qg = q.reshape(b, t, hkv, g, d).float()
    qg = qg / qg.new_full((), math.sqrt(d))
    qpos = q_offset + torch.arange(t, device=q.device)[:, None]
    neg = qg.new_full((), NEG)
    m = torch.full((b, hkv, g, t, 1), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, t, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, t, d), dtype=torch.float32,
                      device=q.device)
    for j in range(nc):
        kj = k[:, j * chunk:(j + 1) * chunk].float()
        vj = v[:, j * chunk:(j + 1) * chunk].float()
        logits = torch.einsum("bthgd,bchd->bhgtc", qg, kj)
        kpos = j * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = kpos < s                              # hide the padding
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        logits = torch.where(mask, logits, neg)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        p = torch.where(mask, p, p.new_zeros(()))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhgtc,bchd->bhgtd", p, vj)
        m = m_new
    l = torch.where(l == 0.0, l.new_ones(()), l)
    out = acc / l
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)


def _rolling_sdpa(q, k, v, slot_pos: torch.Tensor, window: int,
                  q_offset: int) -> torch.Tensor:
    """Attention over a rolling window cache; slot_pos [W] absolute
    positions, valid iff 0 <= slot_pos <= qpos and slot_pos > qpos -
    window."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, h // hkv, d)
    qpos = q_offset + torch.arange(t, device=q.device)[:, None]
    sp = slot_pos[None, :]
    mask = (sp >= 0) & (sp <= qpos) & (sp > qpos - window)
    return _masked_softmax_av(qg, k, v, mask, (b, t, h, d), q.dtype)


def attn_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
               causal: bool = True, q_offset: int = 0,
               cache: Optional[Dict] = None,
               cache_pos: Optional[int] = None,
               cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               rope: bool = True, window: int = 0,
               impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (out [B,T,d], updated cache or None).

    cache: {"k","v": [B, S_max, Hkv, D]}, dense, or rolling when
    ``window > 0`` and ``S_max == window`` (slot = absolute_pos % window).
    cache_pos: absolute position (int) of x[:, 0] when caching.
    cross_kv: precomputed encoder (k, v) [B, S_enc, Hkv, D] for
    cross-attention.
    """
    impl = impl or cfg.attn_impl
    if impl not in ("xla", "xla_chunked", "flash"):
        raise ValueError(f"unknown attn_impl {impl!r}; the port serves "
                         f"'xla', 'xla_chunked' and 'flash'")
    hd = cfg.kv_head_dim
    q_cols = _out_features(p["wq"])
    group = C.split_group(q_cols, cfg.n_heads * hd, "attention queries")
    m, rank = C.group_size(group), C.group_rank(group)
    heads_split = group is not None and cfg.n_heads % m == 0
    quant = cfg.quant if cfg.quant.enabled else None
    b, t, _ = x.shape
    if cache is not None and cache_pos is not None:
        q_offset = cache_pos          # absolute positions for RoPE/masks
    xq = C.copy_to(x, group)
    q = L.dense_apply(p["wq"], xq, quant)
    if group is not None and not heads_split:
        # a column block that cuts a head: every rank takes every head
        q = C.gather_shards(q, -1, group)
    h = q.shape[-1] // hd
    q = _split_heads(q, h)

    def out_proj(out):
        out = out.reshape(b, t, -1)
        if group is not None and not heads_split:
            out = out.narrow(-1, rank * q_cols, q_cols)
        return L.row_apply(p["wo"], out, quant, group)

    if cross_kv is not None:
        k, v = cross_kv
        out = _sdpa_xla(q, k, v, causal=False, window=0, q_offset=0)
        return out_proj(out), None

    kv_cols, kv_whole = _out_features(p["wk"]), cfg.n_kv_heads * hd
    if heads_split and kv_cols < kv_whole and cfg.n_kv_heads % m == 0:
        # this rank's kv heads, the ones its query heads read
        k = L.dense_apply(p["wk"], xq, quant)
        v = L.dense_apply(p["wv"], xq, quant)

        def pick(t):
            return t
    else:
        if kv_cols < kv_whole:
            # a column block that cuts a head: whole k/v on every rank
            C.split_group(kv_cols, kv_whole, "attention kv columns")
            k = C.gather_shards(L.dense_apply(p["wk"], xq, quant), -1, group)
            v = C.gather_shards(L.dense_apply(p["wv"], xq, quant), -1, group)
        else:
            # whole weights: every rank computes the whole k/v, whose
            # gradient its query heads' share of is summed over the group
            k = C.copy_to(L.dense_apply(p["wk"], x, quant), group)
            v = C.copy_to(L.dense_apply(p["wv"], x, quant), group)
        kv_of = None
        if heads_split:
            kv_of = (rank * h + torch.arange(h, device=x.device)) // (
                cfg.n_heads // cfg.n_kv_heads)

        def pick(t):
            return t if kv_of is None else t.index_select(2, kv_of)
    k = _split_heads(k, k.shape[-1] // hd)
    v = _split_heads(v, v.shape[-1] // hd)
    if rope:
        pos = q_offset + torch.arange(t, device=x.device)
        q = L.apply_rope(q.transpose(1, 2), pos,
                         cfg.rope_theta).transpose(1, 2)
        k = L.apply_rope(k.transpose(1, 2), pos,
                         cfg.rope_theta).transpose(1, 2)

    new_cache = None
    kv_len = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        s_max = ck.shape[1]
        if window > 0 and s_max == window:
            # rolling cache: only the last min(t, window) tokens survive a
            # multi-token (prefill) write, so slots never collide
            w_eff = min(t, window)
            slots = (cache_pos + t - w_eff
                     + torch.arange(w_eff, device=x.device)) % window
            ck[:, slots] = k[:, t - w_eff:].to(ck.dtype)
            cv[:, slots] = v[:, t - w_eff:].to(cv.dtype)
            if t > 1:
                # prefill: windowed attention over the in-sequence keys
                out = _sdpa_xla(q, pick(k), pick(v), causal=True,
                                window=window, q_offset=0)
            else:
                # decode: the rolling cache with reconstructed absolute
                # slot positions
                pos_now = cache_pos + t - 1
                slot_ids = torch.arange(window, device=x.device)
                slot_pos = pos_now - ((pos_now - slot_ids) % window)
                out = _rolling_sdpa(q, pick(ck), pick(cv), slot_pos, window,
                                    q_offset=cache_pos)
            return out_proj(out), {"k": ck, "v": cv}
        if cache_pos < 0 or cache_pos + t > s_max:
            # JAX's dynamic_update_slice would clamp the start silently
            raise ValueError(f"cache write of {t} tokens at position "
                             f"{cache_pos} does not fit a cache of {s_max}")
        ck[:, cache_pos:cache_pos + t] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + t] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        k, v = ck, cv
        kv_len = cache_pos + t
        q_offset = cache_pos
    k, v = pick(k), pick(v)

    if impl == "flash" and cache is None:
        from repro_torch.kernels import ops
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window).transpose(1, 2)
    elif impl == "xla_chunked" and t > 1 and kv_len is None:
        out = _sdpa_xla_chunked(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
    else:
        out = _sdpa_xla(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, kv_len=kv_len)
    return out_proj(out), new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
               device=None) -> Dict:
    """Dense cache [B, S, Hkv, D] or rolling [B, W, Hkv, D] of one layer."""
    s = window if window > 0 else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.kv_head_dim)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
