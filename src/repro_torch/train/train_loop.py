"""Training loop: checkpoint and resume, straggler monitor, gradient accumulation.

The port of ``repro.train.train_loop``, on one device or over a process
group (``mesh``: ``launch.mesh.make_host_mesh`` or ``make_group_mesh``
under ``init_distributed``):

* resume = :func:`~repro_torch.train.checkpoint.latest_step` plus
  deterministic data: a data factory ``data(start_step)`` is realigned
  to the restored step, so a resumed run sees the batches an
  uninterrupted one saw;
* each step's wall time feeds a :class:`StragglerMonitor`, which flags a
  step slower than ``factor`` times the running median;
* ``TrainConfig.microbatch`` accumulates gradients over microbatches in
  a Python loop and averages them;
* on a process-group mesh every rank reads the same global batch and
  keeps its block (``rules.constrain_batch``; a microbatch's block, as
  JAX reshapes the constrained batch into global microbatches), the
  gradients are averaged over the group once a step, before the clip
  (JAX's are global there), and the loss metrics too; rank 0 writes the
  checkpoints and every rank restores them.  At one rank the step is
  bitwise the step without a mesh.
* with a ``model`` axis the sharding profile (``api.cfg.
  sharding_profile``, or the step's ``profile``) places the parameters
  and the optimizer state by ``sharding.rules`` (:func:`placement`; each
  rank holds its blocks) and the model computes on them
  (``models/transformer.py``).  A leaf's gradient is averaged over the
  ranks holding the same block: the data group under ``default``, while
  under ``fsdp`` the backward's reduce-scatter has summed it over every
  rank already.  The clip's norm sums a split leaf over its ranks and
  counts a whole one once (``optimizer.global_norm``).  Checkpoints stay
  in JAX's format: gathered to whole leaves on save, placed again on
  restore.  Every family trains and serves over ``model``
  (``launch/steps.py``).  Under
  ``seq_parallel`` a whole leaf that each rank reads on its sequence
  block only (the norm gains) takes its gradient summed over the
  ``model`` group inside the backward (``layers.whole_grad``), before
  this loop's mean, so the ranks' copies stay equal.

An ``api`` is anything with ``init(generator, device=None) -> params``
and ``loss_fn(params, batch) -> (loss, metrics)``, with ``batch`` a dict
of tensors whose leading axis is the batch: PointMLP's trainer, or
``models.api.get_model(cfg)`` of any LM family (decoder, MoE, VLM,
xLSTM, Hymba, Whisper) with batches that carry what its ``loss_fn``
reads: ``data.lm_data.stream`` for the token families; Whisper also
reads ``"frames"``, which that stream does not carry, as JAX's does
not.

The loss and its backward both run under ``models.layers.f32_sums``, so
the backward's bf16 products (and a remat layer's recompute) are summed
in f32 and its f32 products take no TF32, as the forward's are.
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.api.build import resolve_device
from repro_torch.configs.base import TrainConfig
from repro_torch.models.layers import f32_sums
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules
from repro_torch.sharding.context import use_placement
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import tree_leaves, tree_map, unflatten_like


class StragglerMonitor:
    """Flags slow steps from their wall times."""

    def __init__(self, window: int = 50, factor: float = 2.0):
        self.times = collections.deque(maxlen=window)
        self.factor = factor
        self.flagged = []

    def record(self, step: int, dt: float) -> bool:
        slow = False
        if len(self.times) >= 10:
            med = statistics.median(self.times)
            slow = dt > self.factor * med
            if slow:
                self.flagged.append((step, dt, med))
        self.times.append(dt)
        return slow


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, metrics), grads): ``loss_fn`` on leaves that require grad,
    then ``torch.autograd.grad`` over every leaf (a leaf that the loss
    does not reach gets zeros, as ``jax.grad`` gives), both under
    ``f32_sums``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with f32_sums():
        loss, metrics = loss_fn(unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return ((loss.detach(), tree_map(torch.Tensor.detach, metrics)),
            unflatten_like(params, grads))


def group_mean(grads, mesh, placement=None):
    """Each gradient leaf averaged over the ranks that hold the same block
    (a tensor divisor); ``grads`` itself without a group.  Without a
    ``placement`` that is ``mesh``'s ``data`` group; with one, its batch
    axes' group, where under ``fsdp`` a split leaf's backward summed it
    already and only the division is left.  The sums run in place: the
    leaves are a step's own tensors, none aliased."""
    axes = "data" if placement is None else placement.batch_axes
    group = C.process_group(mesh, axes)
    if group is None:
        return grads
    n = C.group_size(group)
    fsdp = placement is not None and placement.fsdp

    def mean(x, sh=None):
        if not (fsdp and placement.sharded_axes(sh)):
            C.all_reduce_(x, group)
        return x / x.new_tensor(float(n))
    if fsdp:
        return tree_map(mean, grads, placement.params)
    return tree_map(mean, grads)


def _metrics_mean(metrics, mesh, placement=None):
    """The 0-dim metrics averaged over the batch group in one collective
    (a family's metrics may alias one tensor: ``{"loss": ce, "ce":
    ce}``)."""
    group = C.process_group(mesh, "data" if placement is None
                            else placement.batch_axes)
    if group is None:
        return metrics
    keys = sorted(metrics)
    vals = C.all_reduce_(torch.stack([metrics[k].float() for k in keys]),
                         group)
    vals = vals / vals.new_tensor(float(C.group_size(group)))
    return {k: vals[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def _profile(api, profile=None) -> str:
    cfg = getattr(api, "cfg", None)
    return profile or (cfg.sharding_profile if cfg is not None
                       else "default")


def placement(api, mesh, profile=None, init_opt=None,
              quantized=frozenset()):
    """The :class:`sharding.rules.Placement` of a step of ``api`` on
    ``mesh`` under ``profile`` (``api.cfg.sharding_profile`` by default):
    None without a process group; on a mesh with a ``model`` axis, the
    rules' shardings of the whole parameter tree (its int8 export,
    ``core.quant.quantize_tree``, of the weights whose paths
    ``quantized`` holds; ``launch.steps._quantized``) and of
    ``init_opt``'s state, built from shapes on fake tensors (no
    allocation)."""
    if getattr(mesh, "device_mesh", None) is None:
        return None
    profile = _profile(api, profile)
    if "model" not in mesh.axis_names:
        return rules.Placement(mesh, profile)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        shapes = api.init(torch.Generator(), device="meta")
        if quantized:
            from repro_torch.core.quant import quantize_tree
            shapes = quantize_tree(
                shapes, api.cfg.quant,
                lambda path, _: tuple(map(str, path)) in quantized)
        opt = init_opt(shapes) if init_opt is not None else None
    return rules.Placement(
        mesh, profile, rules.params_shardings(shapes, mesh, profile),
        None if opt is None else rules.params_shardings(opt, mesh, profile))


def build_accumulating_step(api, tc: TrainConfig, mesh=None, profile=None):
    """(train_step, init_opt).  ``train_step(params, opt_state, batch,
    step)`` returns (params, opt_state, metrics): gradients (averaged
    over ``tc.batch_size // tc.microbatch`` microbatches when
    ``tc.microbatch`` divides the batch more finely), clipped to global
    norm 1, then the optimizer's update at ``cosine_lr(step)``.  On a
    process-group ``mesh`` each (micro)batch is this rank's block of the
    global one, ``params`` and ``opt_state`` are this rank's blocks
    (``train_step.placement(mesh)``'s, placed by ``rules.place``), and
    the gradients and metrics are averaged over the ranks that hold the
    same block before the clip (module docstring); the metrics are the
    last microbatch's, as JAX's.  ``train_step``'s keyword ``mesh``
    (default the one given here) lets one step serve the mesh current at
    a call (``launch.steps.build_train_step``)."""
    init_opt, update = opt_lib.get_optimizer(tc)
    placed = {}

    def placement_of(m):
        if m is None:
            return None
        if id(m) not in placed:
            placed[id(m)] = (m, placement(api, m, profile, init_opt))
        return placed[id(m)][1]
    placement_of(mesh)

    def train_step(params, opt_state, batch, step, mesh=mesh):
        pl = placement_of(mesh)
        prof = _profile(api, profile)

        def constrain(b):
            if mesh is None:
                return b
            return {k: rules.constrain_batch(v, mesh, prof)
                    for k, v in b.items()}

        def grad(b):
            # the model reads the rows this (micro)batch splits over
            lead = next((v for v in b.values() if v.ndim), None)
            with use_placement(pl if pl is None or lead is None
                               else pl.for_batch(lead)):
                return value_and_grad(api.loss_fn, params, constrain(b))

        if tc.microbatch and tc.microbatch < tc.batch_size:
            n_micro = tc.batch_size // tc.microbatch
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(n_micro):
                (_, metrics), g = grad({k: v[i * tc.microbatch:
                                             (i + 1) * tc.microbatch]
                                        for k, v in batch.items()})
                grads = tree_map(torch.add, grads, g)
            # a tensor divisor: CUDA multiplies by a rounded 1/n for a
            # Python one
            grads = tree_map(lambda g: g / g.new_tensor(float(n_micro)),
                             grads)
        else:
            (_, metrics), grads = grad(batch)
        grads = group_mean(grads, mesh, pl)
        metrics = _metrics_mean(metrics, mesh, pl)
        grads, gnorm = opt_lib.clip_by_global_norm(grads, 1.0, pl)
        lr = opt_lib.cosine_lr(step, tc)
        params, opt_state = update(grads, opt_state, params, lr, tc)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    train_step.placement = placement_of
    return train_step, init_opt


def _barrier(mesh) -> None:
    if getattr(mesh, "device_mesh", None) is not None:
        from torch import distributed as dist
        dist.barrier()


def _whole(tree, shardings):
    """``tree`` gathered to whole leaves (every rank calls it)."""
    return tree if shardings is None else rules.gather(tree, shardings)


def _blocks(tree, shardings):
    return tree if shardings is None else rules.place(tree, shardings)


def fit(api, tc: TrainConfig, data,
        hooks: Optional[Dict[str, Callable]] = None, log_every: int = 10,
        device=None, mesh=None) -> Dict[str, Any]:
    """Run (or resume) training on ``device`` (default ``cuda``; raises
    without a GPU).  ``data`` is an iterator of batches or a factory
    ``data(start_step) -> iterator``; the factory gives a bit-exact
    resume.  Saves params (and the optimizer state under ``/opt``)
    every ``tc.checkpoint_every`` steps.  On a process-group ``mesh``
    every rank draws the same global batches and trains on its block
    (:func:`build_accumulating_step`), holding its blocks of the params
    and optimizer state where the mesh has a ``model`` axis; rank 0 logs
    and writes the checkpoints (gathered to whole leaves, JAX's format),
    and no rank leaves before its writes are done (a barrier), so every
    rank restores the same steps from ``tc.checkpoint_dir`` and places
    its blocks again.  The returned params and optimizer state are this
    rank's blocks.
    Returns the final params and optimizer state, the logged history
    and the flagged stragglers."""
    dev = resolve_device(device)
    hooks = hooks or {}
    train_step, init_opt = build_accumulating_step(api, tc, mesh)
    pl = train_step.placement(mesh)
    p_sh, o_sh = (None, None) if pl is None else (pl.params, pl.opt)
    if pl is None:
        lead = True
    else:
        from torch import distributed as dist
        lead = dist.get_rank() == 0
    start = ckpt_lib.latest_step(tc.checkpoint_dir)
    params = _blocks(api.init(torch.Generator().manual_seed(tc.seed),
                              device=dev), p_sh)
    opt_state = init_opt(params)
    start_step = 0
    if start is not None:
        params = _blocks(ckpt_lib.restore(tc.checkpoint_dir, start,
                                          params)[0], p_sh)
        opt_dir = tc.checkpoint_dir + "/opt"
        if ckpt_lib.latest_step(opt_dir) == start:
            opt_state = _blocks(ckpt_lib.restore(opt_dir, start,
                                                 opt_state)[0], o_sh)
        else:
            opt_state = init_opt(params)
        start_step = start
    if callable(data) and not hasattr(data, "__next__"):
        data = data(start_step)

    monitor = StragglerMonitor()
    saver = ckpt_lib.AsyncCheckpointer(tc.checkpoint_dir)
    opt_saver = ckpt_lib.AsyncCheckpointer(tc.checkpoint_dir + "/opt")
    history = []
    for step in range(start_step, tc.steps):
        batch = next(data)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                step)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        slow = monitor.record(step, dt)
        if step % log_every == 0 or slow:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, "dt": dt, **m})
            flag = " STRAGGLER" if slow else ""
            if lead:
                print(f"step {step:6d} loss {m['loss']:.4f} "
                      f"lr {m['lr']:.4f} {dt * 1e3:.0f}ms{flag}", flush=True)
        if "on_step" in hooks:
            hooks["on_step"](step, params, metrics)
        if tc.checkpoint_every and (step + 1) % tc.checkpoint_every == 0:
            whole_p, whole_o = _whole(params, p_sh), _whole(opt_state, o_sh)
            if lead:
                saver.save(step + 1, whole_p, extra={"step": step + 1})
                opt_saver.save(step + 1, whole_o)
            del whole_p, whole_o
    saver.wait()
    opt_saver.wait()
    _barrier(mesh)
    return {"params": params, "opt_state": opt_state, "history": history,
            "stragglers": monitor.flagged}
