"""Training loop: checkpoint and resume, straggler monitor, gradient accumulation.

The port of ``repro.train.train_loop``, on one device or data-parallel
over a process group (``mesh``, a ``launch.mesh.make_host_mesh`` under
``init_distributed``):

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
from repro_torch.launch.mesh import process_group
from repro_torch.models.layers import f32_sums
from repro_torch.sharding import rules
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


def group_mean(grads, mesh):
    """Each gradient leaf summed over ``mesh``'s group and divided by its
    size (a tensor divisor); ``grads`` itself without a group.  The sums
    run in place: the leaves are a step's own tensors, none aliased."""
    group = process_group(mesh, "data")
    if group is None:
        return grads
    from torch import distributed as dist
    n = dist.get_world_size(group)

    def mean(x):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x / x.new_tensor(float(n))
    return tree_map(mean, grads)


def _metrics_mean(metrics, mesh):
    """The 0-dim metrics averaged over the group in one collective (a
    family's metrics may alias one tensor: ``{"loss": ce, "ce": ce}``)."""
    group = process_group(mesh, "data")
    if group is None:
        return metrics
    from torch import distributed as dist
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=group)
    vals = vals / vals.new_tensor(float(dist.get_world_size(group)))
    return {k: vals[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def refuse_coupled_batches(api, mesh) -> None:
    """An MoE step over several ranks raises (its batch is coupled)."""
    group = process_group(mesh, "data")
    cfg = getattr(api, "cfg", None)
    if group is None or not getattr(cfg, "n_experts", 0):
        return
    from torch import distributed as dist
    if dist.get_world_size(group) > 1:
        raise NotImplementedError(
            f"{cfg.name}: an MoE layer's capacity and aux loss couple the "
            f"tokens of a batch, so a rank's block does not compute its "
            f"share of JAX's global step; data-parallel MoE training (JAX's "
            f"moe_apply_local) waits for Queue 1 item 4 (the sharded part, "
            f"4b) in ROADMAP.md")


def build_accumulating_step(api, tc: TrainConfig, mesh=None):
    """(train_step, init_opt).  ``train_step(params, opt_state, batch,
    step)`` returns (params, opt_state, metrics): gradients (averaged
    over ``tc.batch_size // tc.microbatch`` microbatches when
    ``tc.microbatch`` divides the batch more finely), clipped to global
    norm 1, then the optimizer's update at ``cosine_lr(step)``.  On a
    process-group ``mesh`` each (micro)batch is this rank's block of the
    global one, and the gradients and metrics are averaged over the
    group before the clip (module docstring); the metrics are the last
    microbatch's, as JAX's.  ``train_step``'s keyword ``mesh`` (default
    the one given here) lets one step serve the mesh current at a call
    (``launch.steps.build_train_step``)."""
    init_opt, update = opt_lib.get_optimizer(tc)
    refuse_coupled_batches(api, mesh)

    def train_step(params, opt_state, batch, step, mesh=mesh):
        def constrain(b):
            if mesh is None:
                return b
            return {k: rules.constrain_batch(v, mesh) for k, v in b.items()}

        if tc.microbatch and tc.microbatch < tc.batch_size:
            n_micro = tc.batch_size // tc.microbatch
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(n_micro):
                mb = constrain({k: v[i * tc.microbatch:
                                     (i + 1) * tc.microbatch]
                                for k, v in batch.items()})
                (_, metrics), g = value_and_grad(api.loss_fn, params, mb)
                grads = tree_map(torch.add, grads, g)
            # a tensor divisor: CUDA multiplies by a rounded 1/n for a
            # Python one
            grads = tree_map(lambda g: g / g.new_tensor(float(n_micro)),
                             grads)
        else:
            (_, metrics), grads = value_and_grad(api.loss_fn, params,
                                                 constrain(batch))
        grads = group_mean(grads, mesh)
        metrics = _metrics_mean(metrics, mesh)
        grads, gnorm = opt_lib.clip_by_global_norm(grads, 1.0)
        lr = opt_lib.cosine_lr(step, tc)
        params, opt_state = update(grads, opt_state, params, lr, tc)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step, init_opt


def _barrier(mesh) -> None:
    group = process_group(mesh, "data")
    if group is not None:
        from torch import distributed as dist
        dist.barrier(group=group)


def fit(api, tc: TrainConfig, data,
        hooks: Optional[Dict[str, Callable]] = None, log_every: int = 10,
        device=None, mesh=None) -> Dict[str, Any]:
    """Run (or resume) training on ``device`` (default ``cuda``; raises
    without a GPU).  ``data`` is an iterator of batches or a factory
    ``data(start_step) -> iterator``; the factory gives a bit-exact
    resume.  Saves params (and the optimizer state under ``/opt``)
    every ``tc.checkpoint_every`` steps.  On a process-group ``mesh``
    every rank draws the same global batches and trains on its block
    (:func:`build_accumulating_step`); rank 0 logs and writes the
    checkpoints, and no rank leaves before its writes are done (a
    barrier), so every rank restores the same steps from
    ``tc.checkpoint_dir``.
    Returns the final params and optimizer state, the logged history
    and the flagged stragglers."""
    dev = resolve_device(device)
    hooks = hooks or {}
    train_step, init_opt = build_accumulating_step(api, tc, mesh)
    lead = process_group(mesh, "data") is None or \
        mesh.coordinate("data") == 0
    start = ckpt_lib.latest_step(tc.checkpoint_dir)
    params = api.init(torch.Generator().manual_seed(tc.seed), device=dev)
    opt_state = init_opt(params)
    start_step = 0
    if start is not None:
        params, _ = ckpt_lib.restore(tc.checkpoint_dir, start, params)
        opt_dir = tc.checkpoint_dir + "/opt"
        if ckpt_lib.latest_step(opt_dir) == start:
            opt_state, _ = ckpt_lib.restore(opt_dir, start, opt_state)
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
        if lead and tc.checkpoint_every and \
                (step + 1) % tc.checkpoint_every == 0:
            saver.save(step + 1, params, extra={"step": step + 1})
            opt_saver.save(step + 1, opt_state)
    saver.wait()
    opt_saver.wait()
    _barrier(mesh)
    return {"params": params, "opt_state": opt_state, "history": history,
            "stragglers": monitor.flagged}
