"""Decoder-only LM, dense family (``repro.models.transformer``'s port).

Parameters keep the JAX layout: per-layer leaves stacked ``[L, ...]`` (as
the JAX ``lm_init`` makes them with ``vmap``), and the layer loop indexes
them, where JAX scans.  Caches are stacked ``[L, B, S, Hkv, D]`` and
updated in place.

The scoring forward and the serve steps run under ``layers.f32_sums``:
their bf16 products are summed in f32 on the card, as in XLA, whatever
PyTorch's process-wide cuBLAS setting.

Not ported: MoE blocks (``n_experts > 0``) and the sequence-parallel
residual stream (``seq_parallel``) raise ``NotImplementedError``.  JAX's
``_seq_parallel``/``_gather_seq`` are sharding constraints, no-ops on one
device, so the one-device port has nothing to carry over for them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.tree import tree_map_with_path


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks wait for Queue 1 item 7 (MoE) in "
            f"ROADMAP.md")
    if cfg.seq_parallel:
        raise NotImplementedError(
            f"{cfg.name}: seq_parallel waits for Queue 1 item 7 "
            f"(sharding/*) in ROADMAP.md")


def _stack(trees) -> Any:
    """Stack a list of same-shaped dict trees leaf by leaf into [L, ...]."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def layer_params(blocks: Dict, layer: int) -> Dict:
    """Layer ``layer``'s view of the stacked block params."""
    return tree_map_with_path(lambda _path, t: t[layer], blocks)


# ------------------------------------------------------------- init -----

def _block_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    dt = A.torch_dtype(cfg)
    dev = generator.device
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dt, dev),
        "attn": A.attn_init(generator, cfg),
        "ln2": L.rmsnorm_init(cfg.d_model, dt, dev),
        "mlp": L.swiglu_init(generator, cfg.d_model, cfg.d_ff, dt),
    }


def lm_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random params on the generator's device, in ``cfg.dtype``."""
    _check_dense(cfg)
    dt = A.torch_dtype(cfg)
    params = {
        "embed": L.embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                  dt),
        "blocks": _stack([_block_init(generator, cfg)
                          for _ in range(cfg.n_layers)]),
        "ln_f": L.rmsnorm_init(cfg.d_model, dt, generator.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, bias=False,
                                         dtype=dt)
    return params


# ------------------------------------------------------------ apply -----

def _block_apply(blk: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                 cache: Optional[Dict] = None,
                 cache_pos: Optional[int] = None, impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h = L.rmsnorm_apply(blk["ln1"], x, cfg.norm_eps)
    a, new_cache = A.attn_apply(
        blk["attn"], cfg, h, causal=True, cache=cache, cache_pos=cache_pos,
        window=cfg.sliding_window, impl=impl)
    x = x + a
    h = L.rmsnorm_apply(blk["ln2"], x, cfg.norm_eps)
    f = L.swiglu_apply(blk["mlp"], h,
                       cfg.quant if cfg.quant.enabled else None)
    return x + f, new_cache


def _layers(params: Dict, cfg: ModelConfig, x: torch.Tensor,
            cache: Optional[Dict] = None, cache_pos: Optional[int] = None,
            impl: Optional[str] = None) -> torch.Tensor:
    """The layer loop (JAX's scan), then the final norm."""
    _check_dense(cfg)
    for i in range(cfg.n_layers):
        cache_l = None if cache is None else layer_params(cache, i)
        x, _ = _block_apply(layer_params(params["blocks"], i), cfg, x,
                            cache=cache_l, cache_pos=cache_pos, impl=impl)
    return L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)


def _embed_in(params: Dict, cfg: ModelConfig, inputs: torch.Tensor
              ) -> torch.Tensor:
    """Token ids [B,T] -> embeddings; float [B,T,d] (stub embeddings)
    pass straight through, cast to ``cfg.dtype``."""
    if inputs.dtype.is_floating_point:
        return inputs.to(A.torch_dtype(cfg))
    return L.embedding_apply(params["embed"], inputs)


def _unembed(params: Dict, cfg: ModelConfig, x: torch.Tensor
             ) -> torch.Tensor:
    """Tied: an f32 product with the embedding table.  Untied: the dense
    product in ``cfg.dtype``, rounded there, then cast to f32."""
    if cfg.tie_embeddings or "unembed" not in params:
        return L.unembed_apply(params["embed"], x)
    return L.dense_apply(params["unembed"], x).float()


@L.f32_sums()
def lm_forward(params: Dict, cfg: ModelConfig, inputs: torch.Tensor,
               impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scoring forward: inputs [B,T] ids (or [B,T,d] stub embeddings) ->
    (logits [B,T,V] f32, aux 0).  The aux term is the MoE loss of the
    JAX forward, always 0 for a dense model."""
    x = _layers(params, cfg, _embed_in(params, cfg, inputs), impl=impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _unembed(params, cfg, x), aux


# ------------------------------------------------------ serve steps -----

def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device=None) -> Dict:
    """Stacked caches [L, B, S, Hkv, D] (S = the window when
    ``cfg.sliding_window > 0``), zeros in ``cfg.dtype``."""
    one = A.init_cache(cfg, batch, max_len, window=cfg.sliding_window,
                       device=device)
    return {k: v.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * v.ndim)
            for k, v in one.items()}


@L.f32_sums()
def lm_prefill(params: Dict, cfg: ModelConfig, inputs: torch.Tensor,
               cache: Dict, impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """Prefill: write the cache, return last-position logits [B, V]."""
    x = _layers(params, cfg, _embed_in(params, cfg, inputs), cache=cache,
                cache_pos=0, impl=impl)
    return _unembed(params, cfg, x[:, -1:])[:, 0], cache


@L.f32_sums()
def lm_decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                   pos: int, cache: Dict, impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Dict]:
    """One token [B] (or stub embedding [B, d]) at absolute position
    ``pos`` -> (logits [B, V], the updated cache)."""
    inp = token[:, None] if token.ndim == 1 else token[:, None, :]
    x = _layers(params, cfg, _embed_in(params, cfg, inp), cache=cache,
                cache_pos=int(pos), impl=impl)
    return _unembed(params, cfg, x)[:, 0], cache


def param_count(params: Any) -> int:
    total = 0

    def add(_path, t):
        nonlocal total
        total += t.numel()
        return t
    tree_map_with_path(add, params)
    return total
