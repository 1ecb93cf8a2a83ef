"""LM serving on the PyTorch/CUDA port: batched requests through prefill
and token-by-token decode against a persistent KV cache, with optional
int8 weights.  The twin of ``examples/serve_lm.py``; it runs on ``cuda``
unless told otherwise.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch tinyllama-1.1b \\
        --batch 4 --prompt-len 64 --gen 32 [--w8] [--device cpu]

Any of the port's archs (``--arch moonshot-v1-16b-a3b`` serves the MoE).
The reduced smoke config by default; ``--full`` takes the published
config (a card's worth of memory).  Weights are random, from a seed.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.quant import QuantConfig, quantize_tree
from repro_torch.models.api import get_model
from repro_torch.serve.engine import Engine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--w8", action="store_true",
                    help="deploy int8 weights (W8A16 decode)")
    ap.add_argument("--full", action="store_true",
                    help="full published config")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device=args.device)
    if args.w8:
        qcfg = QuantConfig(w_bits=8, a_bits=16, backend="int8_ref")
        params = quantize_tree(params, qcfg)
        cfg = cfg.replace(quant=qcfg)
        api = get_model(cfg)
        print("deployed int8 weights (W8A16)")
    eng = Engine(api, params, max_len=args.prompt_len + args.gen + 1,
                 batch_size=args.batch, temperature=args.temperature,
                 device=args.device)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(eng.device)
    out = eng.generate({"tokens": prompts}, args.gen)
    st = out["stats"]
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"prefill {st.prefill_s*1e3:.0f} ms | decode "
          f"{st.decode_s*1e3:.0f} ms | {st.decode_tok_per_s:.1f} tok/s")
    print("first request ids:", out["ids"][0][:16].tolist())


if __name__ == "__main__":
    main()
