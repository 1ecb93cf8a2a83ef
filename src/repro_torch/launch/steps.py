"""The train, prefill and decode steps of a model API, and the dry-run's trees.

The port of ``repro.launch.steps``.  JAX's step functions take a mesh and
pass every batch leaf through ``rules.constrain_batch``; the port's read
the current mesh (``sharding.context``) at each call and do the same
where one is set: on fake tensors on an abstract mesh, or batch axes of
one device, that moves nothing; on a process-group mesh
(``launch.mesh.make_host_mesh`` or ``make_group_mesh`` under
``init_distributed``; or a counting mesh, ``launch.mesh.counting_mesh``,
where rank 0's blocks of fake tensors are cut and its collectives
logged, moving nothing) each rank keeps its block of the batch and computes on its blocks of the params and caches
(``rules.place`` by ``params_shardings``/``cache_shardings``); the train
step reduces the gradients as ``fit`` does (``train.train_loop.
build_accumulating_step``).  A real batch that an abstract mesh would
split raises ``ValueError``.  Every profile runs on real tensors (the
``moe_local*`` dispatch is ``cfg.sharding_profile``'s, as in JAX): a
serve step runs under its :func:`serve_placement`, which tells the
model code how its cache and its rows are split (``cache_seq``'s
positions over ``model``; ``fsdp``/``infer2d``'s prefill rows over every
axis, its cache's rows over ``(pod, data)`` and kv heads over
``model``).  The dry-run's ideal partition runs these steps with
``"default"`` on the abstract mesh, where a profile changes only the
placements; its count of rank 0 runs them under the cell's profile on
the counting mesh.  Every step takes every family, over a ``model`` axis
too: the decoders, xLSTM, Hymba and Whisper (whose batches carry ``"frames"`` beside
``"tokens"`` and ``"labels"``).  The serve steps of the last three read
their recurrent states in place where they split (``models/
linear_scan.py``: a block of the heads or of the key dim), move the
small leaves the rules place oddly to the layout the layers compute on
and back (``rules.cache_views``), write Hymba's rolling window cache by
slot under ``cache_seq`` and read Whisper's cross cache by heads or by
encoder position.

:func:`shape_trees` builds a cell's abstract operands (params, inputs,
and the optimizer state or the cache) under ``FakeTensorMode``, with no
allocation, at full size; :func:`cell_shardings` places them with the
rules.  The fake tensors lie on the ``meta`` device: a fake ``cuda``
tensor cannot take a backward under a PyTorch built without CUDA (the
autograd engine aborts the process), and the port's one device-dependent
choice in a step (``layers.silu``) takes the card's form on ``meta``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.quant import quantize_tree
from repro_torch.sharding import rules
from repro_torch.sharding.context import current_mesh, use_placement
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_loop import build_accumulating_step, placement
from repro_torch.tree import leaves_with_paths

#: The device of the dry-run's fake tensors (see the module docstring).
FAKE_DEVICE = "meta"


def fake_mode() -> FakeTensorMode:
    """The dry-run's mode.  It takes non-fake inputs: ``Tensor.new_tensor``
    on a fake ``meta`` tensor makes a plain meta tensor, which the mode
    then wraps."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def _constrain(batch: Dict[str, torch.Tensor], profile: str = "default",
               axes=None) -> Dict[str, torch.Tensor]:
    mesh = current_mesh()
    if mesh is None:
        return batch
    return {k: rules.constrain_batch(v, mesh, profile, axes)
            if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


def build_train_step(api, train_cfg: TrainConfig, profile: str = "default"):
    """(train_step, init_opt).  ``train_step(params, opt_state, batch,
    step)`` -> (params, opt_state, metrics): the loss and its gradient
    (``api.loss_fn``), the gradients clipped to global norm 1, then the
    optimizer's update at ``cosine_lr(step)``; the metrics are the
    loss's plus ``grad_norm`` and ``lr``.  It is
    ``train.train_loop.build_accumulating_step`` without microbatches,
    under the mesh current at the call, with ``params`` and
    ``opt_state`` placed by ``profile``'s rules there, and takes every
    family ``models.api.get_model`` serves."""
    rules.moves_values(profile)       # an unknown name raises
    step, init_opt = build_accumulating_step(
        api, dataclasses.replace(train_cfg, microbatch=0), profile=profile)

    def train_step(params, opt_state, batch, step_no):
        return step(params, opt_state, batch, step_no, mesh=current_mesh())
    return train_step, init_opt


def _quantized(params) -> frozenset:
    """The paths of the weights ``params`` holds as int8 exports (``{q,
    scale}``; ``core.quant.quantize_tree``), empty for a float tree."""
    return frozenset(tuple(map(str, path[:-1]))
                     for path, _ in leaves_with_paths(params)
                     if str(path[-1]) == "q")


def serve_placement(base, batch, cache, decode: bool):
    """A serve step's ``rules.Placement``: ``base``, the step's
    ``train.train_loop.placement`` (None without a process group, and
    then so is this), with the rows its batch splits over (``rows``: the
    profile's batch axes for a prefill whose batch divides over them,
    else ``(pod, data)``: a decode step's token block is the cache's;
    none where it divides over neither, and each rank holds it whole)
    and, under ``cache_seq*``, the whole slot count of a self-attention
    cache (a leaf ``k``; a cross cache is ``cross_k``) whose blocks split
    its positions over ``model`` (``cache_len``).  On a mesh with a
    ``model`` axis every leaf of the cache tree (any family's) must be
    the block ``rules.cache_pspec`` gives this rank of the whole tensor
    it remembers (``rules.check_placed``: ``rules.place``'s blocks
    remember their whole shape; a leaf made another way reads as whole,
    and one whose rules split it raises); without one the rules place
    no cache (as JAX's), and a step takes the cache of its rows as
    given."""
    if base is None:
        return None
    mesh, profile = base.mesh, base.profile
    rows = rules.batch_pspec(mesh)
    lead = [v for v in batch.values()
            if isinstance(v, torch.Tensor) and v.ndim]
    if not decode and lead and not lead[0].shape[0] % math.prod(
            mesh.shape[a] for a in base.batch_axes):
        rows = base.batch_axes
    if "model" in mesh.axis_names:      # the rules place caches on one
        rules.check_placed(cache, mesh, profile)
    cache_len = 0
    if "cache_seq" in profile and mesh.shape.get("model", 1) > 1:
        k = next((leaf for path, leaf in leaves_with_paths(cache)
                  if str(path[-1]) == "k"), None)
        if k is not None and rules.whole_shape(k)[-3] != k.shape[-3]:
            cache_len = rules.whole_shape(k)[-3]
    pl = dataclasses.replace(base, rows=tuple(rows), cache_len=cache_len)
    return pl.for_batch(lead[0]) if lead else pl


def _serve_step(api, profile: str, fn, decode: bool):
    placed = {}         # the parameter shardings, once a mesh and tree kind

    def serve_step(params, batch, cache):
        mesh = current_mesh()
        key = (id(mesh), _quantized(params))
        if key not in placed:
            placed[key] = (mesh, placement(api, mesh, profile,
                                           quantized=key[1]))
        pl = serve_placement(placed[key][1], batch, cache, decode)
        with use_placement(pl):
            return fn(params, _constrain(batch, profile,
                                         None if pl is None else pl.rows),
                      cache)
    return serve_step


def build_prefill_step(api, profile: str = "default"):
    """``prefill_step(params, batch, cache)`` -> (last-position logits,
    cache): ``api.prefill`` under the current mesh, on this rank's blocks
    of the params, the batch and the cache (``rules.cache_shardings``)
    where it spans processes (:func:`serve_placement`); the logits are
    the ``(pod, data)`` block's, whole over ``model``."""
    rules.moves_values(profile)       # an unknown name raises
    return _serve_step(api, profile, api.prefill, decode=False)


def build_decode_step(api):
    """``serve_step(params, batch, cache)`` -> (logits, cache):
    ``api.decode_step``, placed as :func:`build_prefill_step` places it,
    under ``api.cfg.sharding_profile`` (JAX's decode step takes no
    profile; its dry-run places by the config's), the token's batch
    block the cache's ``(pod, data)`` block."""
    rules.moves_values(api.cfg.sharding_profile)   # an unknown name raises
    return _serve_step(api, api.cfg.sharding_profile, api.decode_step,
                       decode=True)


def _fake_inputs(specs: Dict[str, Any], shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Tensors of ``api.input_specs(shape)`` (call under a
    ``FakeTensorMode``).  A decode step's ``pos`` is a 0-dim value the
    step reads on the host: the cache's last slot (``seq_len - 1``); no
    cost of the step depends on it."""
    out = {}
    for k, spec in specs.items():
        if k == "pos":
            out[k] = torch.tensor(shape.seq_len - 1, dtype=spec.dtype)
        else:
            out[k] = torch.empty(spec.shape, dtype=spec.dtype,
                                 device=FAKE_DEVICE)
    return out


def shape_trees(api, shape: ShapeConfig, train_cfg: TrainConfig,
                mode: FakeTensorMode = None) -> Dict[str, Any]:
    """A cell's operands as fake tensors, no allocation: ``params``
    (``api.init``; the int8 export of ``core.quant.quantize_tree`` for a
    non-train cell of a W8 config, as JAX), ``inputs``
    (``api.input_specs``), and ``opt`` (the optimizer's ``init``) to
    train or ``cache`` (``api.init_cache`` at the global batch and
    ``seq_len``) to serve.  Built in ``mode`` (a new :func:`fake_mode`
    if None): run the step under the same mode."""
    mode = mode or fake_mode()
    cfg = api.cfg
    with mode:
        params = api.init(torch.Generator(), device=FAKE_DEVICE)
        if (shape.kind != "train" and cfg.quant.enabled
                and cfg.quant.w_bits <= 8):
            params = quantize_tree(params, cfg.quant)
        out: Dict[str, Any] = {
            "inputs": _fake_inputs(api.input_specs(shape), shape),
            "params": params}
        if shape.kind == "train":
            init_opt, _ = opt_lib.get_optimizer(train_cfg)
            out["opt"] = init_opt(params)
        else:
            out["cache"] = api.init_cache(shape.global_batch, shape.seq_len,
                                          device=FAKE_DEVICE)
    return out


def cell_shardings(api, shape: ShapeConfig, mesh, trees: Dict[str, Any],
                   profile: str = "default") -> Dict[str, Any]:
    """``rules.NamedSharding`` trees for every operand of the step."""
    out = {
        "params": rules.params_shardings(trees["params"], mesh, profile),
        "inputs": rules.batch_shardings(trees["inputs"], mesh, profile),
    }
    if "opt" in trees:
        out["opt"] = rules.params_shardings(trees["opt"], mesh, profile)
    if "cache" in trees:
        out["cache"] = rules.cache_shardings(trees["cache"], mesh, profile)
    return out
