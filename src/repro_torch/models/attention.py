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
D`` does, every rank gathers every query head, computes every head
alike and feeds ``wo`` its own column block, the k/v then gathered
whole with no sum of their gradient (``layers.HeadSplit``, the one rule
of both splits).  The layer finds its split from its weights' shapes.
:func:`cross_kv` computes a cross-attention's encoder k/v by the same
split (Whisper).  Under ``seq_parallel`` the caller gathers the sequence
before the layer (``transformer._block_apply``), so a prefill writes
the cache it writes without it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C
from repro_torch.sharding.context import current_placement

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


def _cache_write(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                 cache_pos: int, window: int) -> bool:
    """k/v [B, t, Hkv, D] of positions ``cache_pos``.. written into the
    cache in place; True for a rolling cache (``window > 0`` and ``S_max
    == window``: only the last min(t, window) tokens survive a multi-token
    write, so slots never collide)."""
    ck, cv = cache["k"], cache["v"]
    t, s_max = k.shape[1], ck.shape[1]
    if window > 0 and s_max == window:
        w_eff = min(t, window)
        slots = (cache_pos + t - w_eff
                 + torch.arange(w_eff, device=k.device)) % window
        ck[:, slots] = k[:, t - w_eff:].to(ck.dtype)
        cv[:, slots] = v[:, t - w_eff:].to(cv.dtype)
        return True
    if cache_pos < 0 or cache_pos + t > s_max:
        # JAX's dynamic_update_slice would clamp the start silently
        raise ValueError(f"cache write of {t} tokens at position "
                         f"{cache_pos} does not fit a cache of {s_max}")
    ck[:, cache_pos:cache_pos + t] = k.to(ck.dtype)
    cv[:, cache_pos:cache_pos + t] = v.to(cv.dtype)
    return False


def _kv(p: Dict, cfg: ModelConfig, x: torch.Tensor, xq: torch.Tensor,
        hs: L.HeadSplit, n_cache_heads: Optional[int]):
    """(k, v [B, S, d_kv] as this rank computes them, ``pick``: the kv
    heads of its query heads out of them).  ``hs`` is the query heads'
    split; ``xq`` is ``x`` as the column blocks read it (``copy_to``);
    ``n_cache_heads`` the kv heads a cache holds (None: no cache)."""
    hd = cfg.kv_head_dim
    m = C.group_size(hs.group)
    quant = cfg.quant if cfg.quant.enabled else None
    kv_cols, kv_whole = L.out_features(p["wk"]), cfg.n_kv_heads * hd
    if hs.even and kv_cols < kv_whole and cfg.n_kv_heads % m == 0 and (
            n_cache_heads is None or n_cache_heads * hd == kv_cols):
        # this rank's kv heads, the ones its query heads read
        return (L.dense_apply(p["wk"], xq, quant),
                L.dense_apply(p["wv"], xq, quant), lambda t: t)
    # whole k/v on every rank.  Where the query heads split evenly its
    # heads' share of their gradient is summed over the group; where
    # every rank computes every head alike it is whole already.
    part = hs.group if hs.even else None
    if kv_cols < kv_whole:
        # a column block that cuts a head, or a cache that holds every
        # head: the blocks gathered
        C.split_group(kv_cols, kv_whole, "attention kv columns")
        k = C.gather_from(L.dense_apply(p["wk"], xq, quant), -1, hs.group)
        v = C.gather_from(L.dense_apply(p["wv"], xq, quant), -1, hs.group)
    else:
        k = L.dense_apply(p["wk"], x, quant)
        v = L.dense_apply(p["wv"], x, quant)
    k, v = C.copy_to(k, part), C.copy_to(v, part)
    if not hs.even:
        return k, v, lambda t: t
    kv_of = (hs.lo + torch.arange(hs.n, device=x.device)) // (
        cfg.n_heads // cfg.n_kv_heads)
    return k, v, lambda t: t.index_select(2, kv_of)


def _head_split(p: Dict, cfg: ModelConfig) -> L.HeadSplit:
    """The query heads' split, found from ``wq``'s columns."""
    return L.HeadSplit(cfg.n_heads, C.split_group(
        L.out_features(p["wq"]), cfg.n_heads * cfg.kv_head_dim,
        "attention queries"))


def cross_kv(p: Dict, cfg: ModelConfig, enc: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder states' k/v [B, S_enc, Hkv', D] for :func:`attn_apply`'s
    ``cross_kv``: the kv heads this rank's query heads read, by the
    split :func:`attn_apply` takes for its own k/v (every head on one
    process)."""
    hd = cfg.kv_head_dim
    hs = _head_split(p, cfg)
    k, v, pick = _kv(p, cfg, enc, hs.input(enc), hs, None)
    return (pick(_split_heads(k, k.shape[-1] // hd)),
            pick(_split_heads(v, v.shape[-1] // hd)))


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
    cross-attention (:func:`cross_kv` on a model axis).
    """
    impl = impl or cfg.attn_impl
    if impl not in ("xla", "xla_chunked", "flash"):
        raise ValueError(f"unknown attn_impl {impl!r}; the port serves "
                         f"'xla', 'xla_chunked' and 'flash'")
    pl = current_placement()
    if cache is not None and pl is not None and cross_kv is None:
        if pl.cache_len:
            return _seq_block_attn(p, cfg, x, cache, cache_pos, rope,
                                   window, pl.cache_len)
        group = C.mesh_group("model")
        if pl.fsdp and group is not None:
            if x.shape[0] != cache["k"].shape[0]:
                return _rows_prefill(p, cfg, x, cache, cache_pos, rope,
                                     window, group)
            p = _head_blocks(p, cfg, cache, group)
    hd = cfg.kv_head_dim
    hs = _head_split(p, cfg)
    quant = cfg.quant if cfg.quant.enabled else None
    b, t, _ = x.shape
    if cache is not None and cache_pos is not None:
        q_offset = cache_pos          # absolute positions for RoPE/masks
    xq = hs.input(x)
    q = _split_heads(hs.cols(p["wq"], x, xq, hd, quant), hs.n)

    def out_proj(out):
        return hs.out(p["wo"], out.reshape(b, t, -1), quant)

    if cross_kv is not None:
        k, v = cross_kv
        out = _sdpa_xla(q, k, v, causal=False, window=0, q_offset=0)
        return out_proj(out), None

    k, v, pick = _kv(p, cfg, x, xq, hs,
                     None if cache is None else cache["k"].shape[2])
    k = _split_heads(k, k.shape[-1] // hd)
    v = _split_heads(v, v.shape[-1] // hd)
    if rope:
        q, k = _rope(q, k, q_offset, cfg)

    new_cache = None
    kv_len = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        new_cache = {"k": ck, "v": cv}
        if _cache_write(cache, k, v, cache_pos, window):
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
            return out_proj(out), new_cache
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


def _rope(q: torch.Tensor, k: torch.Tensor, offset: int, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE on q and k [B, T, H, D] at absolute positions ``offset``.."""
    pos = offset + torch.arange(q.shape[1], device=q.device)
    return (L.apply_rope(q.transpose(1, 2), pos,
                         cfg.rope_theta).transpose(1, 2),
            L.apply_rope(k.transpose(1, 2), pos,
                         cfg.rope_theta).transpose(1, 2))


# ------------------------------------------- serving over a model axis --

def _seq_block_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lo: int, q_offset: int, kv_len: int, window: int,
                    group) -> torch.Tensor:
    """Causal attention of q [B, T, H, D] over a cache split by position
    over ``group``: this rank holds slots [lo, lo + S_loc) (k/v [B, S_loc,
    Hkv, D]).  Its partial softmax in f32 over its valid slots (the row
    max ``m``, ``l = sum(p)`` and ``acc = p . v`` with ``p = where(mask,
    exp(logits - m), 0)``, so a block with no valid slot adds exactly
    zero), combined over the group (``collectives.softmax_combine``),
    then ``acc / l`` with ``l == 0 -> 1`` as ``_sdpa_xla_chunked``."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, t, hkv, h // hkv, d)
    logits = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float())
    logits = logits / logits.new_full((), math.sqrt(d))
    qpos = q_offset + torch.arange(t, device=q.device)[:, None]
    kpos = lo + torch.arange(s, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos < kv_len)
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, logits.new_full((), NEG))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), logits.new_zeros(()))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgts,bshd->bhgtd", p, v.float())
    l, acc = C.softmax_combine(m, l, acc, group)
    l = torch.where(l == 0.0, l.new_ones(()), l)
    out = acc / l
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)


def _seq_block_attn(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                    cache: Dict, cache_pos: int, rope: bool, window: int,
                    cache_len: int) -> Tuple[torch.Tensor, Dict]:
    """``cache_seq``: the cache's positions split over ``model`` (this
    rank's block [B, S/m, Hkv, D], every kv head, slots [r S/m, (r+1)
    S/m)), the weights by ``default``'s rules.  The new tokens' k/v go to
    the blocks that hold their positions: a rank computing its own kv
    heads sends each block its share by one all-to-all (split by
    position, joined by heads); whole k/v (a kv column block that cuts a
    head, gathered, or whole weights) are written where they fall.  The
    read is a distributed softmax (:func:`_seq_block_sdpa`) over every
    query head (q's heads gathered over ``model``); each rank then feeds
    ``wo`` its own heads' columns.  No rank gathers the cache: only q,
    the partials and the new tokens' k/v cross ranks."""
    group = C.mesh_group("model")
    m, r = C.group_size(group), C.group_rank(group)
    hd = cfg.kv_head_dim
    b, t, _ = x.shape
    ck, cv = cache["k"], cache["v"]
    s_loc = ck.shape[1]
    lo = r * s_loc
    if window > 0 and cache_len == window:
        raise NotImplementedError(
            f"{cfg.name}: a rolling (sliding-window) cache split by "
            f"position over 'model' waits for Queue 1 item 4 (Hymba's "
            f"split, part 3) in ROADMAP.md")
    if cache_pos < 0 or cache_pos + t > cache_len:
        raise ValueError(f"cache write of {t} tokens at position "
                         f"{cache_pos} does not fit a cache of {cache_len}")
    quant = cfg.quant if cfg.quant.enabled else None
    q_cols = L.out_features(p["wq"])
    wgroup = C.split_group(q_cols, cfg.n_heads * hd, "attention queries")
    xq = C.copy_to(x, wgroup)
    q = C.gather_shards(L.dense_apply(p["wq"], xq, quant), -1, wgroup)
    k = L.dense_apply(p["wk"], xq, quant)
    v = L.dense_apply(p["wv"], xq, quant)
    kv_cols, kv_whole = k.shape[-1], cfg.n_kv_heads * hd
    kv_block = kv_cols < kv_whole and cfg.n_kv_heads % m == 0
    if kv_cols < kv_whole and not kv_block:
        kgroup = C.split_group(kv_cols, kv_whole, "attention kv columns")
        k = C.gather_shards(k, -1, kgroup)
        v = C.gather_shards(v, -1, kgroup)
    q = _split_heads(q, cfg.n_heads)
    k = _split_heads(k, k.shape[-1] // hd)
    v = _split_heads(v, v.shape[-1] // hd)
    if rope:
        q, k = _rope(q, k, cache_pos, cfg)
    # each block's share of positions [cache_pos, cache_pos + t)
    share = [max(0, min(cache_pos + t, (j + 1) * s_loc) -
                 max(cache_pos, j * s_loc)) for j in range(m)]
    start = max(cache_pos, lo)
    if kv_block:
        k = C.all_to_all(k, 1, 2, group, share)
        v = C.all_to_all(v, 1, 2, group, share)
    else:
        k = k[:, start - cache_pos:start - cache_pos + share[r]]
        v = v[:, start - cache_pos:start - cache_pos + share[r]]
    if share[r]:
        ck[:, start - lo:start - lo + share[r]] = k.to(ck.dtype)
        cv[:, start - lo:start - lo + share[r]] = v.to(cv.dtype)
    out = _seq_block_sdpa(q, ck, cv, lo, cache_pos, cache_pos + t, window,
                          group).reshape(b, t, -1)
    if wgroup is not None:
        out = out.narrow(-1, C.group_rank(wgroup) * q_cols, q_cols)
    return L.row_apply(p["wo"], out, quant, wgroup), {"k": ck, "v": cv}


def _head_blocks(p: Dict, cfg: ModelConfig, cache: Dict, group) -> Dict:
    """An ``fsdp``/``infer2d`` layer (gathered whole) cut to the
    ``default`` blocks of the rank's cache heads (``wq``/``wk``/``wv``
    columns, ``wo`` rows), where its cache holds a block of the kv heads:
    the tensor-parallel layer that serves a decode step's token block;
    the layer itself where the cache holds every head."""
    hk = cache["k"].shape[2]
    if hk == cfg.n_kv_heads:
        return p
    m, r = C.group_size(group), C.group_rank(group)
    hd = cfg.kv_head_dim
    qn, kn = cfg.n_heads * hd // m, hk * hd
    return {**p, "wq": L.dense_block(p["wq"], -1, r * qn, qn),
            "wk": L.dense_block(p["wk"], -1, r * kn, kn),
            "wv": L.dense_block(p["wv"], -1, r * kn, kn),
            "wo": L.dense_block(p["wo"], -2, r * qn, qn)}


def _rows_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                  cache_pos: int, rope: bool, window: int, group
                  ) -> Tuple[torch.Tensor, Dict]:
    """An ``fsdp``/``infer2d`` prefill whose rows split over ``model``
    (the layer gathered whole; this rank's rows of the ``(pod, data)``
    block): every head of its rows, attention over the in-sequence keys
    local to them, and their k/v carried to the cache's layout (every row
    of the data block, this rank's kv heads) by one all-to-all over
    ``model`` (an all-gather of rows where the cache holds every
    head)."""
    b, t, _ = x.shape
    if cache_pos != 0:
        raise ValueError(f"{cfg.name}: a step whose rows split over 'model' "
                         f"is a prefill from position 0; this one writes at "
                         f"{cache_pos}")
    hd = cfg.kv_head_dim
    quant = cfg.quant if cfg.quant.enabled else None
    q = _split_heads(L.dense_apply(p["wq"], x, quant), cfg.n_heads)
    k = _split_heads(L.dense_apply(p["wk"], x, quant), cfg.n_kv_heads)
    v = _split_heads(L.dense_apply(p["wv"], x, quant), cfg.n_kv_heads)
    if rope:
        q, k = _rope(q, k, 0, cfg)
    if cache["k"].shape[2] < cfg.n_kv_heads:
        kc, vc = (C.all_to_all(y, 2, 0, group) for y in (k, v))
    else:
        kc, vc = (C.gather(y, 0, group) for y in (k, v))
    _cache_write(cache, kc, vc, 0, window)
    out = _sdpa_xla(q, k, v, causal=True, window=window, q_offset=0)
    return (L.dense_apply(p["wo"], out.reshape(b, t, -1), quant),
            {"k": cache["k"], "v": cache["v"]})


def init_cache(cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
               device=None) -> Dict:
    """Dense cache [B, S, Hkv, D] or rolling [B, W, Hkv, D] of one layer."""
    s = window if window > 0 else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.kv_head_dim)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
