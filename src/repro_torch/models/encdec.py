"""Whisper-style encoder-decoder, arch ``whisper-tiny``
(``repro.models.encdec``'s port).

The conv audio frontend is a stub, as in JAX: ``forward`` and
``prefill`` take precomputed frame embeddings ``[B, enc_seq, d_model]``
(what the two-conv mel frontend would produce).  The frontend itself,
``audio_frontend_{init,apply}`` (two k = 3 convs, the second at stride
2, tanh-GELU), is ported but off the main path, as in JAX.

Encoder: bidirectional MHA (no RoPE; on the flash route the non-causal
flash kernel) + GELU MLP, sinusoidal positions, pre-LayerNorm.
Decoder: causal self-attention with a dense KV cache (flash on the
flash route without a cache) + cross-attention over the encoder output;
the cross K/V are computed once at prefill and carried in the cache.
The unembedding is tied to the token table (f32).  Params are stacked
``[L, ...]`` and the self-attention cache is updated in place.

Training: with ``cfg.remat`` each encoder layer and each decoder layer
of a forward under grad runs under ``transformer.checkpointed``, as JAX
checkpoints both scans' bodies; a decoder layer takes the encoder output
as a checkpoint input, so the encoder's gradient comes back through
every layer's cross K/V.  The stacks reach autograd through one
``unbind`` a leaf.  The tied table takes its gradient from the gather
and from the f32 unembedding.  It trains on ``attn_impl="xla"``: flash
has no backward and raises under grad before any launch.

Over a ``model`` axis of processes (``sharding.rules``' ``default``
profile) the encoder's and decoder's self-attention and the
cross-attention split by heads as the decoder's (``attention.attn_apply``
and ``attention.cross_kv``), the MLP's ``fc1`` by columns (its bias
too) and ``fc2`` by rows (its bias added once); the layernorms stay
whole, and the tied ``tok_embed`` splits by vocab where the vocabulary
divides (whisper-tiny's 51865 over 2 does not: the table stays whole
and the logits need no gather).  Under ``fsdp`` each layer's leaves are
gathered where the layer runs.  Serving over ``model`` waits for
ROADMAP.md Queue 1 item 4b part 3b.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import collectives as C
from repro_torch.tree import tree_map


def _inv_timescales(channels: int, device=None) -> torch.Tensor:
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    i = torch.arange(channels // 2, dtype=torch.float32, device=device)
    return torch.exp(i * i.new_full((), -log_timescale))


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embedding [length, channels], f32."""
    inv = _inv_timescales(channels, device)
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        * inv[None]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def sinusoid_at(pos: int, channels: int, device=None) -> torch.Tensor:
    """The sinusoid row [channels] of one absolute position."""
    inv = _inv_timescales(channels, device)
    t = inv.new_full((), float(pos)) * inv
    return torch.cat([torch.sin(t), torch.cos(t)])


def _mlp_init(generator: torch.Generator, d: int, d_ff: int, dt) -> Dict:
    return {"fc1": L.dense_init(generator, d, d_ff, dtype=dt),
            "fc2": L.dense_init(generator, d_ff, d, dtype=dt)}


def _mlp_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor, quant=None
               ) -> torch.Tensor:
    """fc2(gelu(fc1(x))); ``fc1`` a column block (with its bias's) and
    ``fc2`` a row block over the model group, or both whole."""
    group = C.split_group(L.out_features(p["fc1"]), cfg.d_ff, "mlp")
    h = L.gelu(L.dense_apply(p["fc1"], C.copy_to(x, group), quant))
    return L.row_apply(p["fc2"], h, quant, group)


# ---------------------------------------------------------- frontend ----

def audio_frontend_init(generator: torch.Generator, cfg: ModelConfig,
                        n_mels: int = 80) -> Dict:
    dt = A.torch_dtype(cfg)
    return {"conv1": L.conv1d_init(generator, n_mels, cfg.d_model, ksize=3,
                                   dtype=dt),
            "conv2": L.conv1d_init(generator, cfg.d_model, cfg.d_model,
                                   ksize=3, dtype=dt)}


def audio_frontend_apply(p: Dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T_frames, n_mels] -> [B, ceil(T_frames / 2), d_model]."""
    x = L.gelu(L.conv1d_apply(p["conv1"], mel))
    return L.gelu(L.conv1d_apply(p["conv2"], x, stride=2))


# ------------------------------------------------------------- init -----

def _enc_block_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    dt, dev = A.torch_dtype(cfg), generator.device
    return {"ln1": L.layernorm_init(cfg.d_model, dt, dev),
            "attn": A.attn_init(generator, cfg),
            "ln2": L.layernorm_init(cfg.d_model, dt, dev),
            "mlp": _mlp_init(generator, cfg.d_model, cfg.d_ff, dt)}


def _dec_block_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    dt, dev = A.torch_dtype(cfg), generator.device
    return {"ln1": L.layernorm_init(cfg.d_model, dt, dev),
            "self_attn": A.attn_init(generator, cfg),
            "ln_x": L.layernorm_init(cfg.d_model, dt, dev),
            "cross_attn": A.attn_init(generator, cfg),
            "ln2": L.layernorm_init(cfg.d_model, dt, dev),
            "mlp": _mlp_init(generator, cfg.d_model, cfg.d_ff, dt)}


def encdec_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random params on the generator's device, in ``cfg.dtype``."""
    dt, dev = A.torch_dtype(cfg), generator.device
    return {
        "enc_blocks": T.stack_inits(lambda: _enc_block_init(generator, cfg),
                                    cfg.n_enc_layers),
        "enc_ln": L.layernorm_init(cfg.d_model, dt, dev),
        "tok_embed": L.embedding_init(generator, cfg.vocab_size,
                                      cfg.d_model, dt),
        "dec_blocks": T.stack_inits(lambda: _dec_block_init(generator, cfg),
                                    cfg.n_layers),
        "dec_ln": L.layernorm_init(cfg.d_model, dt, dev),
    }


# ------------------------------------------------------------ apply -----

def encode(params: Dict, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames [B, S_enc, d] (stub embeddings) -> the encoder states."""
    x = frames.to(A.torch_dtype(cfg))
    x = x + sinusoids(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    remat = T.remat_wanted(cfg.remat, params)
    blocks, sh = T.fsdp_blocks(params, "enc_blocks")
    for blk in T.unstack_layers(blocks):
        if remat:
            x = T.checkpointed(functools.partial(_enc_layer, blk, cfg,
                                                 shardings=sh), x)
        else:
            x = _enc_layer(blk, cfg, x, sh)
    return L.layernorm_apply(T.whole(params, "enc_ln"), x, cfg.norm_eps)


def _enc_layer(blk: Dict, cfg: ModelConfig, x: torch.Tensor,
               shardings=None) -> torch.Tensor:
    """An encoder layer (its leaves gathered under ``fsdp``)."""
    blk = T.gather_layer(blk, shardings)
    h = L.layernorm_apply(blk["ln1"], x, cfg.norm_eps)
    a, _ = A.attn_apply(blk["attn"], cfg, h, causal=False, rope=False)
    x = x + a
    h = L.layernorm_apply(blk["ln2"], x, cfg.norm_eps)
    return x + _mlp_apply(blk["mlp"], cfg, h)


def _dec_block(blk: Dict, cfg: ModelConfig, x: torch.Tensor,
               enc_out: Optional[torch.Tensor], *,
               cache: Optional[Dict] = None, cache_pos: Optional[int] = None,
               cross_kv=None) -> Tuple[torch.Tensor, tuple]:
    """-> (x, the cross (k, v): computed from ``enc_out`` unless given)."""
    quant = cfg.quant if cfg.quant.enabled else None
    h = L.layernorm_apply(blk["ln1"], x, cfg.norm_eps)
    a, _ = A.attn_apply(blk["self_attn"], cfg, h, causal=True, rope=False,
                        cache=cache, cache_pos=cache_pos)
    x = x + a
    h = L.layernorm_apply(blk["ln_x"], x, cfg.norm_eps)
    if cross_kv is None:
        cross_kv = A.cross_kv(blk["cross_attn"], cfg, enc_out)
    c, _ = A.attn_apply(blk["cross_attn"], cfg, h, cross_kv=cross_kv)
    x = x + c
    h = L.layernorm_apply(blk["ln2"], x, cfg.norm_eps)
    return x + _mlp_apply(blk["mlp"], cfg, h, quant), cross_kv


def _dec_layer(blk: Dict, cfg: ModelConfig, x: torch.Tensor,
               enc_out: torch.Tensor, shardings=None) -> torch.Tensor:
    """A decoder layer of the training forward (cross K/V from
    ``enc_out``; its leaves gathered under ``fsdp``)."""
    return _dec_block(T.gather_layer(blk, shardings), cfg, x, enc_out)[0]


def _embed_tokens(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
                  ) -> torch.Tensor:
    x = L.embedding_apply(T.whole(params, "tok_embed"), tokens,
                          cfg.vocab_size)
    return x + sinusoids(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]


@L.f32_sums()
def encdec_forward(params: Dict, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(frames [B,S_enc,d], tokens [B,T]) -> (logits [B,T,V] f32, a zero
    aux loss).  On ``attn_impl="flash"`` the flash kernel runs once an
    encoder layer (non-causal) and once a decoder layer (causal
    self-attention).  Under grad with ``cfg.remat`` each encoder and
    decoder layer is checkpointed."""
    enc_out = encode(params, cfg, frames)
    x = _embed_tokens(params, cfg, tokens)
    remat = T.remat_wanted(cfg.remat, params)
    blocks, sh = T.fsdp_blocks(params, "dec_blocks")
    for blk in T.unstack_layers(blocks):
        if remat:
            x = T.checkpointed(functools.partial(_dec_layer, blk, cfg,
                                                 shardings=sh), x, enc_out)
        else:
            x = _dec_layer(blk, cfg, x, enc_out, sh)
    x = L.layernorm_apply(T.whole(params, "dec_ln"), x, cfg.norm_eps)
    return (T.unembed(params, cfg, x, "tok_embed"),
            x.new_zeros((), dtype=torch.float32))


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> Dict:
    """``self``: the decoder's dense caches [L, B, max_len, Hkv, D];
    ``cross_k``/``cross_v``: [L, B, enc_seq, Hkv, D], filled at
    prefill."""
    one = A.init_cache(cfg, batch, max_len, device=device)
    shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads,
             cfg.kv_head_dim)
    dt = A.torch_dtype(cfg)
    return {"self": tree_map(lambda a: a.expand((cfg.n_layers,) + a.shape)
                             .clone(), one),
            "cross_k": torch.zeros(shape, dtype=dt, device=device),
            "cross_v": torch.zeros(shape, dtype=dt, device=device)}


@L.f32_sums()
def encdec_prefill(params: Dict, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor, cache: Dict
                   ) -> Tuple[torch.Tensor, Dict]:
    """Encode, run the decoder over the prompt writing its self cache,
    and carry each layer's cross K/V -> (last-position logits [B, V],
    the cache; its cross K/V as long as the frames)."""
    enc_out = encode(params, cfg, frames)
    x = _embed_tokens(params, cfg, tokens)
    cks, cvs = [], []
    for i in range(cfg.n_layers):
        x, (ck, cv) = _dec_block(T.layer_params(params["dec_blocks"], i),
                                 cfg, x, enc_out,
                                 cache=T.layer_params(cache["self"], i),
                                 cache_pos=0)
        cks.append(ck)
        cvs.append(cv)
    x = L.layernorm_apply(params["dec_ln"], x, cfg.norm_eps)
    logits = L.unembed_apply(params["tok_embed"], x[:, -1:])[:, 0]
    return logits, {"self": cache["self"], "cross_k": torch.stack(cks),
                    "cross_v": torch.stack(cvs)}


@L.f32_sums()
def encdec_decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                       pos: int, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    pos = int(pos)
    x = L.embedding_apply(params["tok_embed"], token[:, None])
    x = x + sinusoid_at(pos, cfg.d_model, x.device).to(x.dtype)[None, None]
    for i in range(cfg.n_layers):
        x, _ = _dec_block(T.layer_params(params["dec_blocks"], i), cfg, x,
                          None, cache=T.layer_params(cache["self"], i),
                          cache_pos=pos,
                          cross_kv=(cache["cross_k"][i],
                                    cache["cross_v"][i]))
    x = L.layernorm_apply(params["dec_ln"], x, cfg.norm_eps)
    return L.unembed_apply(params["tok_embed"], x)[:, 0], cache
