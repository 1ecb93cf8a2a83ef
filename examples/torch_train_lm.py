"""Train an LM end to end on the PyTorch/CUDA port: checkpoints, restart,
straggler monitor, cosine schedule, synthetic deterministic data.  The
twin of ``examples/train_lm.py``; it runs on ``cuda`` unless told
otherwise.

    PYTHONPATH=src python examples/torch_train_lm.py --arch llama3.2-1b \\
        --steps 100 [--device cpu]

The default is the reduced smoke config (about 5M params, CPU-friendly);
``--full`` selects the published config.  Kill it mid-run and run it
again: it resumes from the last checkpoint, bit for bit on the CPU (on
the card under ``torch.use_deterministic_algorithms(True)``: the
embedding's backward adds with atomics otherwise).
"""
import argparse

from repro_torch.api.build import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import lm_data
from repro_torch.models.api import get_model
from repro_torch.train.train_loop import fit


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_train_lm")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    api = get_model(cfg)
    tc = TrainConfig(optimizer="adamw", lr=1e-3, lr_min=1e-4,
                     steps=args.steps, batch_size=args.batch,
                     checkpoint_every=20, checkpoint_dir=args.ckpt_dir)

    def data(start):
        return lm_data.stream(seed=0, batch=args.batch, seq_len=args.seq,
                              vocab=cfg.vocab_size, start_step=start,
                              device=dev)

    losses = {}

    def on_step(step, _params, metrics):
        losses[step] = float(metrics["loss"])
    result = fit(api, tc, data, hooks={"on_step": on_step}, device=dev)
    if not losses:
        print(f"nothing left to train: {args.ckpt_dir} is at step "
              f"{args.steps}")
        return
    first, last = min(losses), max(losses)
    print(f"loss {losses[first]:.3f} (step {first}) -> {losses[last]:.3f} "
          f"(step {last}); stragglers flagged: {len(result['stragglers'])}")


if __name__ == "__main__":
    main()
