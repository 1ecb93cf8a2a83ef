"""Training launcher for the LMs: one device, or data-parallel under ``torchrun``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 1000 [--smoke] [--batch 8] [--seq 128] [--microbatch 4] \\
        [--grad-compress-bits 8] [--ckpt-dir ...] [--device cpu]
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train ... [--device cpu]

The port of ``repro.launch.train``: AdamW with a cosine schedule from
``--lr`` to a tenth of it, a checkpoint every tenth of the run, on the
synthetic token stream (``data.lm_data``).  It runs on ``cuda`` unless
``--device`` names another device, and raises without a GPU.  Under
``torch.distributed.run`` it joins the process group
(``launch.mesh.init_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``), makes ``make_host_mesh()`` (``("data", world_size)``)
the current mesh and trains data-parallel: every rank draws the node's
global batch (``host_id`` is ``GROUP_RANK``, the node's index, as JAX's
is ``jax.process_index()``; 0 on one host) and keeps its block, and
rank 0 writes the checkpoints and prints the ``done:`` line.  Run the
same command again after a crash: it resumes from the latest checkpoint
with the data stream realigned.  ``--grad-compress-bits`` reaches
``TrainConfig`` as JAX's does, and, as in JAX, ``fit`` does not read it.
``--profile`` sets ``cfg.sharding_profile`` as JAX's does: every
profile trains (``default``, ``replicated``, ``fsdp``, ``infer2d``,
``cache_seq*``, ``moe_local*``; on the host mesh, which has no ``model``
axis, all of them place every leaf whole and split the batch over
``data``; ``infer2d`` places as ``fsdp`` and ``cache_seq`` as
``default`` does, so their steps are those bitwise); an unknown name
raises ``ValueError``.
``--production-mesh`` trains on ``make_production_mesh()`` under
``torchrun`` with 256 ranks (``(data=16, model=16)``, the profile's
placements) and raises ``ValueError`` with any other world size.  Every
token arch trains, xLSTM and Hymba included (not split over ``model``);
the MoE archs on one rank, or over several under ``moe_local`` with a
``model`` axis (``fit`` refuses the global route over more).  ``--arch whisper-tiny`` raises ``ValueError`` before the
device is resolved: its ``loss_fn`` reads ``"frames"`` (stub encoder
inputs), which the token stream does not carry (nor does JAX's, whose
launcher fails at the first step); train it with
``train.train_loop.fit`` on batches that hold them.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import lm_data
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.api import get_model
from repro_torch.sharding import rules
from repro_torch.sharding.context import use_mesh
from repro_torch.train.train_loop import fit


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (CPU-scale)")
    ap.add_argument("--profile", default="default",
                    help="sharding profile: default|replicated|fsdp|"
                         "infer2d|cache_seq|moe_local")
    ap.add_argument("--grad-compress-bits", type=int, default=0,
                    help="recorded in TrainConfig, as JAX's launcher does; "
                         "neither package's fit reads it, so the gradients "
                         "are all-reduced uncompressed")
    ap.add_argument("--ckpt-dir", default="checkpoints/launch")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (data=16, model=16) mesh over 256 torchrun "
                         "ranks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cuda:LOCAL_RANK "
                         "under torchrun)")
    return ap.parse_args(argv)


def _mesh(args, dev):
    """The run's mesh: None without a process group; the production mesh
    (256 ranks, else ``ValueError``) or the host's ``("data", n)``."""
    import torch.distributed as dist
    if args.production_mesh:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != 256:
            raise ValueError(f"--production-mesh spans 256 devices (data=16, "
                             f"model=16); this run has {world} rank(s): "
                             f"launch 256 with torch.distributed.run")
        return make_production_mesh(device=dev)
    return make_host_mesh(dev) if dist.is_initialized() else None


def main(argv: Optional[List[str]] = None) -> dict:
    """Train (or resume) as the command line says; returns ``fit``'s
    result.  Under ``torchrun`` it joins the process group and leaves it
    when training ends."""
    import torch.distributed as dist

    args = parse_args(argv)
    rules.moves_values(args.profile)      # an unknown name raises
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.replace(sharding_profile=args.profile)
    api = get_model(cfg)
    if cfg.family == "audio":
        raise ValueError(
            f"--arch {args.arch}: its loss reads batch['frames'] (the stub "
            f"encoder's inputs), and the synthetic token stream "
            f"(data.lm_data) carries no 'frames'; train it with "
            f"train.train_loop.fit on batches holding 'frames', 'tokens' "
            f"and 'labels'")
    joined = not dist.is_initialized()
    dev = init_distributed(args.device)
    joined = joined and dist.is_initialized()
    try:
        mesh = _mesh(args, dev)
        with use_mesh(mesh):
            return _train(args, cfg, api, dev, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, cfg, api, dev, mesh) -> dict:
    tc = TrainConfig(optimizer="adamw", lr=args.lr, lr_min=args.lr / 10,
                     steps=args.steps, batch_size=args.batch,
                     microbatch=args.microbatch,
                     grad_compress_bits=args.grad_compress_bits,
                     checkpoint_every=max(args.steps // 10, 1),
                     checkpoint_dir=args.ckpt_dir)
    host_id = int(os.environ.get("GROUP_RANK", 0))
    lead = mesh is None or all(mesh.coordinate(a) == 0
                               for a in mesh.axis_names)
    if tc.grad_compress_bits and lead:
        print(f"note: --grad-compress-bits {tc.grad_compress_bits} is "
              f"recorded in TrainConfig; fit does not read it (nor does "
              f"JAX's): the gradients are all-reduced uncompressed",
              file=sys.stderr, flush=True)

    def data(start):
        return lm_data.stream(seed=tc.seed, batch=args.batch,
                              seq_len=args.seq, vocab=cfg.vocab_size,
                              start_step=start, host_id=host_id, device=dev)

    losses = {}

    def on_step(step, _params, metrics):
        losses[step] = float(metrics["loss"])
    result = fit(api, tc, data, hooks={"on_step": on_step}, device=dev,
                 mesh=mesh)
    if not lead:
        return result
    if losses:
        first, last = min(losses), max(losses)
        print(f"done: loss {losses[first]:.4f} (step {first}) -> "
              f"{losses[last]:.4f} (step {last}); stragglers: "
              f"{len(result['stragglers'])}", flush=True)
    else:
        print(f"done: {args.ckpt_dir} is at step {args.steps} already",
              flush=True)
    return result


if __name__ == "__main__":
    main()
