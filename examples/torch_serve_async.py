"""Async point-cloud serving on the PyTorch/CUDA port: bursty clients,
SLO-aware batching.  The twin of ``examples/serve_async.py``; it runs on
``cuda`` (the hand kernels) unless told otherwise.

Clients submit single clouds at random (exponential) inter-arrival
times; a background ``serve_loop`` pumps the engine, whose batching
policy arbitrates throughput (full fixed-shape batches) against the
per-request latency SLO.

    PYTHONPATH=src python examples/torch_serve_async.py \\
        --requests 12 --batch 4 --policy deadline --slo-ms 20 \\
        [--int8] [--gap-ms 5] [--device cpu]
"""
import argparse
import asyncio
import time

import numpy as np
import torch

from repro_torch.api import lite_spec
from repro_torch.data import pointclouds
from repro_torch.models import pointmlp as PM
from repro_torch.serve.async_engine import AsyncPointCloudEngine
from repro_torch.serve.policy import POLICIES


async def serve(args) -> None:
    spec = lite_spec(pointclouds.N_CLASSES).replace(
        precision="int8" if args.int8 else "fp32",
        backend=args.backend).serving(policy=args.policy,
                                      slo_ms=args.slo_ms)
    params = PM.pointmlp_init(spec.to_model_config(),
                              torch.Generator().manual_seed(args.seed))
    print("serving random-init weights (see examples/"
          "torch_serve_pointcloud.py for the trained flow)")
    engine = AsyncPointCloudEngine.from_params(
        params, spec, device=args.device, max_batch=args.batch,
        seed=args.seed)
    print(engine.describe())
    print(f"warmup/compile: {engine.warmup():.2f}s")

    pts, labels = pointclouds.make_batch(args.seed + 1, 0, spec.n_points,
                                         args.requests, args.device)
    names = pointclouds.CLASS_NAMES
    server = asyncio.create_task(engine.serve_loop(tick_s=1e-3))

    async def client(i: int) -> None:
        t0 = time.monotonic()
        logits = await engine.classify_async(pts[i])
        lat_ms = (time.monotonic() - t0) * 1e3
        print(f"  request {i:2d}: predicted "
              f"{names[int(torch.argmax(logits))]:<9} "
              f"(true {names[int(labels[i])]})  latency {lat_ms:6.1f} ms")

    rng = np.random.default_rng(args.seed)
    clients = []
    for i in range(args.requests):
        clients.append(asyncio.create_task(client(i)))
        await asyncio.sleep(float(rng.exponential(args.gap_ms / 1e3)))
    # Close only after every client has submitted, and *before* awaiting
    # them: a throughput-greedy policy (fixed) holds the partial tail
    # until the serve_loop's shutdown flush, so gathering first would
    # deadlock on the tail's futures.
    await asyncio.sleep(0)
    engine.close()
    await server
    await asyncio.gather(*clients)

    s = engine.stats
    line = (f"{s.requests} requests in {s.batches} fixed-shape batches "
            f"({s.padded} pad lanes) — {s.samples_per_s:.1f} samples/s")
    if engine.latencies_ms:
        lat = np.asarray(engine.latencies_ms)
        line += (f", p50/p95 queue latency "
                 f"{np.percentile(lat, 50):.1f}/"
                 f"{np.percentile(lat, 95):.1f} ms")
    print(line)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed dispatch shape of the engine")
    ap.add_argument("--policy", choices=sorted(POLICIES.names()),
                    default="deadline")
    ap.add_argument("--slo-ms", type=float, default=20.0,
                    help="per-request latency objective (deadline policy)")
    ap.add_argument("--gap-ms", type=float, default=5.0,
                    help="mean client inter-arrival time")
    ap.add_argument("--int8", action="store_true",
                    help="serve the int8 deployment instead of fused fp32")
    ap.add_argument("--backend", choices=("cuda", "ref"), default="cuda",
                    help="cuda: the hand kernels (their plain versions "
                         "on the CPU); ref: plain torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    asyncio.run(serve(ap.parse_args()))


if __name__ == "__main__":
    main()
