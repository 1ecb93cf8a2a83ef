"""Decoder-only LM: dense GQA and MoE blocks, and float [B, T, d] inputs
for the VLM patch stub (``repro.models.transformer``'s port).

Families served: yi-9b, tinyllama-1.1b, minitron-8b, llama3.2-1b (dense),
moonshot-v1-16b-a3b, llama4-maverick-400b-a17b (moe), internvl2-26b
(vlm: its patch embeddings enter the same backbone as floats).

Parameters keep the JAX layout: per-layer leaves stacked ``[L, ...]`` (as
the JAX ``lm_init`` makes them with ``vmap``; an MoE layer's experts are
``[L, E, d, f]``).  The layer loop, where JAX scans, unbinds each stacked
leaf once a call (:func:`unstack_layers`): under autograd the L slices'
gradients come back as one ``[L, ...]`` stack, where indexing the stack
layer by layer would send back L stack-sized gradients to be added.
``lm_init`` fills the stacks layer by layer, so a full-width model never
holds two copies.  Caches are stacked ``[L, B, S, Hkv, D]`` and updated
in place.

Training: :func:`lm_loss` is JAX's (cross-entropy plus ``aux_weight``
times the MoE aux loss).  With ``cfg.remat`` a training forward runs
each layer under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``):
the backward recomputes the layer from its input in place of keeping
its activations.  :func:`checkpointed`, :func:`remat_wanted` and
:func:`unstack_layers` are the family-neutral forms that xLSTM, Hymba
and the enc-dec call too.  ``cfg.unroll_layers`` has no counterpart: it unrolls
JAX's scan for the dry-run's cost analysis, and the port's loop is a
Python loop already.

The scoring forward, the serve steps and each recomputed layer run under
``layers.f32_sums``: their bf16 products are summed in f32 on the card,
and f32 products in f32 (no TF32), as in XLA, whatever PyTorch's
process-wide settings.  The training step runs its backward under it too
(``train.train_loop.value_and_grad``).

``cfg.seq_parallel`` is JAX's ``_seq_parallel``/``_gather_seq``
constraints (Megatron-SP, :func:`seq_group`): on a ``model`` axis of
processes the residual stream between blocks is each rank's block of
the sequence, the norms run on it, each layer gathers it before its
column products and its row products' sum is cut back to it (an
all-reduce and a slice: ``collectives.reduce_from`` then ``split_to``),
and the stream is gathered whole after the last layer (before
``ln_f``).  A remat layer keeps only the rank's block.  The constraint
moves no value where no mesh is current, ``model`` spans one device,
the tensor is fake or meta on an abstract mesh (the dry-run's ideal
partition; on its counting mesh rank 0's block moves), ``T`` does not
divide over ``model`` (a decode step, an odd prompt: JAX's constraint
then leaves it whole) or the step's rows split over ``model`` already (``fsdp``,
``infer2d``), so those forwards are the same bits as without it; a real
tensor on an abstract mesh raises ``ValueError``.  The norm gains (whole
leaves read on a block) take their gradient summed over the group.

On a mesh over processes the params are each rank's blocks
(``sharding.rules.place``).  Under the ``default`` profile the layers
split themselves by their weights' shapes: attention by heads and the
MLP by ``d_ff`` (``models/attention.py``, ``layers.swiglu_apply``), the
MoE by experts (``models/moe.py``), the embedding by vocab rows, and the
unembedding gives vocab blocks of the logits, gathered over ``model``
before they leave (JAX's logits are global).  Under ``fsdp`` (the
current ``rules.Placement``) each block is all-gathered where a layer
uses it and its gradient reduce-scattered back: a layer's leaves inside
the layer (so a remat layer frees them and gathers again in its
recompute), a stack split along its layer dim before the loop, the
embedding, final norm and unembedding where they are read.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules
from repro_torch.sharding.context import current_mesh, current_placement
from repro_torch.tree import (leaves_with_paths, tree_leaves, tree_map,
                              tree_map_with_path)


def layer_params(blocks: Dict, layer: int) -> Dict:
    """Layer ``layer``'s view of the stacked block params."""
    return tree_map_with_path(lambda _path, t: t[layer], blocks)


def unstack_layers(blocks: Dict, ndim: int = 1) -> List[Dict]:
    """Every layer's view of the stacked block params, each leaf unbound
    once (``torch.unbind``, whose backward stacks the layers' gradients
    into one tensor).  ``ndim`` leading axes index the layers (xLSTM's
    ``[n_groups, per_group, ...]`` stacks take 2): they are merged by a
    view first, and the layers come in row-major order."""
    def unbind(t):
        return (t.flatten(0, ndim - 1) if ndim > 1 else t).unbind(0)
    slices = {path: unbind(t) for path, t in leaves_with_paths(blocks)}
    n = len(next(iter(slices.values())))
    return [tree_map_with_path(lambda path, _: slices[path][i], blocks)
            for i in range(n)]


def remat_wanted(remat: bool, params: Any) -> bool:
    """Whether a forward checkpoints its layers: ``cfg.remat`` asked,
    grad mode on and some param taking a gradient (a scoring or serving
    forward keeps nothing, so it has nothing to trade)."""
    return (remat and torch.is_grad_enabled()
            and any(t.requires_grad for t in tree_leaves(params)))


def checkpointed(layer: Callable, x: torch.Tensor, *rest: Any) -> Any:
    """``layer(x, *rest)`` under ``torch.utils.checkpoint`` (JAX's
    ``jax.checkpoint``): only the inputs are kept, and the backward runs
    the layer again.  Bind a layer's params with ``functools.partial``
    (a closure over a loop variable would recompute the last layer's).
    The layer runs under ``f32_sums`` itself, so the recompute sums (and
    routes) as the first pass did whatever the caller's flags; it draws
    nothing random, so no RNG state is stashed."""
    def run(*args):
        with L.f32_sums():
            return layer(*args)
    return torch.utils.checkpoint.checkpoint(
        run, x, *rest, use_reentrant=False, preserve_rng_state=False)


# ------------------------------------------------------------- init -----

def _block_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    dt = A.torch_dtype(cfg)
    dev = generator.device
    blk = {
        "ln1": L.rmsnorm_init(cfg.d_model, dt, dev),
        "attn": A.attn_init(generator, cfg),
        "ln2": L.rmsnorm_init(cfg.d_model, dt, dev),
    }
    if cfg.n_experts > 0:
        blk["moe"] = M.moe_init(generator, cfg)
    else:
        blk["mlp"] = L.swiglu_init(generator, cfg.d_model, cfg.d_ff, dt)
    return blk


def stack_inits(make: Callable[[], Dict], n: int) -> Dict:
    """``n`` draws of ``make()`` stacked leaf by leaf into [n, ...], each
    copied into place as it is drawn (so a full-width model never holds
    two copies)."""
    first = make()
    stacks = tree_map(lambda t: t.new_empty((n,) + t.shape), first)
    tree_map(lambda s, t: s[0].copy_(t), stacks, first)
    del first
    for i in range(1, n):
        tree_map(lambda s, t: s[i].copy_(t), stacks, make())
    return stacks


def lm_init(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random params on the generator's device, in ``cfg.dtype`` (an MoE
    router in f32, as JAX's)."""
    dt = A.torch_dtype(cfg)
    params = {
        "embed": L.embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                  dt),
        "blocks": stack_inits(lambda: _block_init(generator, cfg),
                              cfg.n_layers),
        "ln_f": L.rmsnorm_init(cfg.d_model, dt, generator.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, bias=False,
                                         dtype=dt)
    return params


# ------------------------------------------------------------ apply -----

def seq_group(cfg: ModelConfig, x: torch.Tensor):
    """The ``model`` group the [B, T, d] stream ``x``'s T splits over
    under ``cfg.seq_parallel`` (JAX's ``_seq_parallel``), or None where
    the constraint moves no value (module docstring)."""
    if not cfg.seq_parallel or x.ndim != 3:
        return None
    mesh = current_mesh()
    m = 1 if mesh is None else mesh.shape.get("model", 1)
    if m == 1 or x.shape[1] % m:
        return None
    pl = current_placement()
    if pl is not None and "model" in pl.batch_axes:
        return None             # the rows split over model: nothing moves
    group = C.process_group(mesh, "model")
    if group is None and rules.is_abstract(x):
        return None
    if group is None:
        raise ValueError(
            f"{cfg.name}: seq_parallel splits T={x.shape[1]} over the "
            f"'model' axis of the abstract mesh {mesh.shape}, where no "
            f"process holds a block; make the mesh over a process group "
            f"(launch.mesh.make_group_mesh under init_distributed)")
    return group


def _block_apply(blk: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                 cache: Optional[Dict] = None,
                 cache_pos: Optional[int] = None, impl: Optional[str] = None,
                 seq=None
                 ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """-> (x [B, T, d], the updated cache or None, the MoE aux loss: an
    f32 scalar, 0 for a dense block).  ``seq``: the ``seq_parallel``
    group whose sequence block ``x`` (and the result) is: the norms run
    on the block, attention and the MLP read it gathered whole, and each
    one's summed output is cut back to it."""
    h = C.gather_from(L.rmsnorm_apply(L.whole_grad(blk["ln1"], seq), x,
                                      cfg.norm_eps), 1, seq)
    a, new_cache = A.attn_apply(
        blk["attn"], cfg, h, causal=True, cache=cache, cache_pos=cache_pos,
        window=cfg.sliding_window, impl=impl)
    x = x + C.split_to(a, 1, seq)
    h = C.gather_from(L.rmsnorm_apply(L.whole_grad(blk["ln2"], seq), x,
                                      cfg.norm_eps), 1, seq)
    if "moe" in blk:
        f, aux = M.moe_apply(blk["moe"], cfg, h)
    else:
        mlp = blk["mlp"]
        f = L.swiglu_apply(mlp, h, cfg.quant if cfg.quant.enabled else None,
                           C.split_group(L.out_features(mlp["gate"]),
                                         cfg.d_ff, "mlp"))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + C.split_to(f, 1, seq), new_cache, aux


def _fsdp_shardings(key: str):
    """The current ``fsdp`` placement's shardings of ``params[key]``, or
    None (no placement, or one that gathers nothing)."""
    pl = current_placement()
    return pl.params[key] if pl is not None and pl.fsdp else None


def whole(params: Dict, key: str) -> Any:
    """``params[key]`` as a layer reads it: under ``fsdp`` gathered from
    its blocks (the gradient reduce-scattered back), else itself."""
    sh = _fsdp_shardings(key)
    if sh is None:
        return params[key]
    return tree_map(rules.gather_shards, params[key], sh)


def fsdp_blocks(params: Dict, key: str = "blocks", ndim: int = 1
                ) -> Tuple[Dict, Any]:
    """(``params[key]``, each layer's shardings or None).  Under ``fsdp``
    a stack split along one of its ``ndim`` layer dims (a leaf whose
    trailing dims do not divide) is gathered whole here; the other
    leaves keep their blocks, and each layer's shardings are theirs less
    the layer dims."""
    blocks = params[key]
    sh = _fsdp_shardings(key)
    if sh is None:
        return blocks, None

    def by_layer(s):
        return any(a is not None for a in s.spec[:ndim])
    blocks = tree_map(lambda t, s: rules.gather_shards(t, s) if by_layer(s)
                      else t, blocks, sh)
    return blocks, tree_map(lambda s: rules.NamedSharding(
        s.mesh, rules.P() if by_layer(s) else rules.P(*s.spec[ndim:])), sh)


def gather_layer(blk: Dict, shardings: Any) -> Dict:
    """A layer's leaves gathered whole under ``fsdp`` (``shardings`` from
    :func:`fsdp_blocks`; None: ``blk`` itself)."""
    if shardings is None:
        return blk
    return tree_map(rules.gather_shards, blk, shardings)


def _remat_block(blk: Dict, cfg: ModelConfig, impl: Optional[str],
                 shardings: Any, seq, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer as :func:`checkpointed` runs it: (x, aux)."""
    y, _, aux = _block_apply(gather_layer(blk, shardings), cfg, x,
                             impl=impl, seq=seq)
    return y, aux


def _layers(params: Dict, cfg: ModelConfig, x: torch.Tensor,
            cache: Optional[Dict] = None, cache_pos: Optional[int] = None,
            impl: Optional[str] = None, remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer loop (JAX's scan), then the final norm: (x, the aux
    losses summed over layers in layer order).  ``remat`` checkpoints
    each layer of a forward without a cache whose params take a
    gradient.  Under ``seq_parallel`` the loop runs on this rank's
    sequence block (:func:`seq_group`), gathered whole after it."""
    auxs = []
    remat_on = cache is None and remat_wanted(remat, params)
    blocks, layer_sh = fsdp_blocks(params)
    seq = seq_group(cfg, x)
    x = C.split_to(x, 1, seq)
    for i, blk in enumerate(unstack_layers(blocks)):
        if remat_on:
            x, aux = checkpointed(functools.partial(
                _remat_block, blk, cfg, impl, layer_sh, seq), x)
        else:
            cache_l = None if cache is None else layer_params(cache, i)
            x, _, aux = _block_apply(gather_layer(blk, layer_sh), cfg, x,
                                     cache=cache_l, cache_pos=cache_pos,
                                     impl=impl, seq=seq)
        auxs.append(aux)
    x = C.gather_from(x, 1, seq)
    return (L.rmsnorm_apply(whole(params, "ln_f"), x, cfg.norm_eps),
            torch.stack(auxs).sum())


def _embed_in(params: Dict, cfg: ModelConfig, inputs: torch.Tensor
              ) -> torch.Tensor:
    """Token ids [B,T] -> embeddings; float [B,T,d] (stub embeddings)
    pass straight through, cast to ``cfg.dtype``."""
    if inputs.dtype.is_floating_point:
        return inputs.to(A.torch_dtype(cfg))
    return L.embedding_apply(whole(params, "embed"), inputs,
                             cfg.vocab_size)


def unembed(params: Dict, cfg: ModelConfig, x: torch.Tensor,
            table: str = "embed") -> torch.Tensor:
    """Tied (to ``params[table]``): an f32 product with the embedding
    table.  Untied: the dense product in ``cfg.dtype``, rounded there,
    then cast to f32.  A rank holding a vocab block computes that block
    of the logits, and the blocks are gathered over the model group."""
    tied = cfg.tie_embeddings or "unembed" not in params
    p = whole(params, table if tied else "unembed")
    group = C.split_group(p["table"].shape[0] if tied
                          else L.out_features(p), cfg.vocab_size,
                          "unembedding")
    x = C.copy_to(x, group)
    logits = L.unembed_apply(p, x) if tied else L.dense_apply(p, x).float()
    return C.gather_from(logits, -1, group)


@L.f32_sums()
def lm_forward(params: Dict, cfg: ModelConfig, inputs: torch.Tensor,
               impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scoring and training forward: inputs [B,T] ids (or [B,T,d] stub
    embeddings) -> (logits [B,T,V] f32, the MoE aux loss summed over
    layers; 0 for a dense model).  Under grad with ``cfg.remat`` each
    layer is checkpointed."""
    x, aux = _layers(params, cfg, _embed_in(params, cfg, inputs), impl=impl,
                     remat=cfg.remat)
    return unembed(params, cfg, x), aux


def lm_loss(params: Dict, cfg: ModelConfig, batch: Dict,
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, Dict]:
    """batch {"tokens": [B,T] ids or [B,T,d] stub embeddings, "labels":
    [B,T] ids} -> (loss, {"loss", "ce", "moe_aux"}): the mean
    cross-entropy plus ``aux_weight`` times the summed aux loss, as JAX's
    ``lm_loss``."""
    logits, aux = lm_forward(params, cfg, batch["tokens"])
    ce = L.softmax_cross_entropy(logits, batch["labels"])
    loss = ce + aux_weight * aux
    return loss, {"loss": loss, "ce": ce, "moe_aux": aux}


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
    x, _ = _layers(params, cfg, _embed_in(params, cfg, inputs), cache=cache,
                   cache_pos=0, impl=impl)
    return _data_block_rows(unembed(params, cfg, x[:, -1:])[:, 0]), cache


def _data_block_rows(logits: torch.Tensor) -> torch.Tensor:
    """A prefill's logits whose rows split over ``model`` too (``fsdp``,
    ``infer2d``) gathered to the ``(pod, data)`` block's, the rows a
    decode step takes; the logits themselves otherwise."""
    pl = current_placement()
    if pl is None or "model" not in pl.batch_axes:
        return logits
    return C.gather(logits, 0, C.process_group(pl.mesh, "model"))


@L.f32_sums()
def lm_decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                   pos: int, cache: Dict, impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Dict]:
    """One token [B] (or stub embedding [B, d]) at absolute position
    ``pos`` -> (logits [B, V], the updated cache)."""
    inp = token[:, None] if token.ndim == 1 else token[:, None, :]
    x, _ = _layers(params, cfg, _embed_in(params, cfg, inp), cache=cache,
                   cache_pos=int(pos), impl=impl)
    return unembed(params, cfg, x)[:, 0], cache


def param_count(params: Any) -> int:
    total = 0

    def add(_path, t):
        nonlocal total
        total += t.numel()
        return t
    tree_map_with_path(add, params)
    return total


def active_param_count(params: Any, cfg: ModelConfig) -> int:
    """MoE-aware: expert weights count k/E of their size (the 6 * N_active
    * D model-FLOPs convention), each leaf truncated as in JAX."""
    if cfg.n_experts == 0:
        return param_count(params)
    total = 0
    frac = cfg.experts_per_token / cfg.n_experts

    def add(path, t):
        nonlocal total
        if any(k in ("gate_w", "up_w", "down_w") for k in path):
            total += int(t.numel() * frac)
        else:
            total += t.numel()
        return t
    tree_map_with_path(add, params)
    return total
