"""Training launcher for the LMs, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 1000 [--smoke] [--batch 8] [--seq 128] [--microbatch 4] \\
        [--ckpt-dir ...] [--device cpu]

The port of ``repro.launch.train``: AdamW with a cosine schedule from
``--lr`` to a tenth of it, a checkpoint every tenth of the run, on the
synthetic token stream (``data.lm_data``).  It runs on ``cuda`` unless
``--device`` names another device, and raises without a GPU.  Run the
same command again after a crash: it resumes from the latest checkpoint
with the data stream realigned.  ``--production-mesh``, a ``--profile``
other than ``default`` and ``--grad-compress-bits`` above 0 wait for
the sharded part of ROADMAP.md Queue 1 item 4.  Every token arch
trains, xLSTM and Hymba included.  ``--arch whisper-tiny`` raises
``ValueError`` before the device is resolved: its ``loss_fn`` reads
``"frames"`` (stub encoder inputs), which the token stream does not
carry (nor does JAX's, whose launcher fails at the first step); train
it with ``train.train_loop.fit`` on batches that hold them.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.api.build import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import lm_data
from repro_torch.models.api import get_model
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
                    help="sharding profile; one device takes 'default'")
    ap.add_argument("--grad-compress-bits", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints/launch")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 256-device mesh (not on one device)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def _refuse_sharded(args: argparse.Namespace) -> None:
    for flag, asked in (("--production-mesh", args.production_mesh),
                        (f"--profile {args.profile}",
                         args.profile != "default"),
                        (f"--grad-compress-bits {args.grad_compress_bits}",
                         args.grad_compress_bits > 0)):
        if asked:
            raise NotImplementedError(
                f"{flag} waits for Queue 1 item 4 (the sharded part) in "
                f"ROADMAP.md; the port trains on one device")


def main(argv: Optional[List[str]] = None) -> dict:
    """Train (or resume) as the command line says; returns ``fit``'s
    result."""
    args = parse_args(argv)
    _refuse_sharded(args)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    api = get_model(cfg)
    if cfg.family == "audio":
        raise ValueError(
            f"--arch {args.arch}: its loss reads batch['frames'] (the stub "
            f"encoder's inputs), and the synthetic token stream "
            f"(data.lm_data) carries no 'frames'; train it with "
            f"train.train_loop.fit on batches holding 'frames', 'tokens' "
            f"and 'labels'")
    dev = resolve_device(args.device)
    tc = TrainConfig(optimizer="adamw", lr=args.lr, lr_min=args.lr / 10,
                     steps=args.steps, batch_size=args.batch,
                     microbatch=args.microbatch,
                     checkpoint_every=max(args.steps // 10, 1),
                     checkpoint_dir=args.ckpt_dir)

    def data(start):
        return lm_data.stream(seed=tc.seed, batch=args.batch,
                              seq_len=args.seq, vocab=cfg.vocab_size,
                              start_step=start, device=dev)

    losses = {}

    def on_step(step, _params, metrics):
        losses[step] = float(metrics["loss"])
    result = fit(api, tc, data, hooks={"on_step": on_step}, device=dev)
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
