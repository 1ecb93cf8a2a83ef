"""Streaming LiDAR on the PyTorch/CUDA port: one sensor, a temporal
cache, one hard cut.  The twin of ``examples/serve_stream.py``; it runs
on ``cuda`` (the hand kernels) unless told otherwise.

``spec.replace(stream=True)`` makes a nearly unchanged cloud a serving
mode of its own: a ``StreamSession`` caches the mapping ops (FPS/URS
sample indices, kNN neighbour lists, the seg head's upsample index)
against a key frame and replays them while per-point drift stays under
``stream_drift_threshold``; every replayed frame is bit-identical to the
cold recompute.  Three phases over a synthetic drifting sequence: smooth
drift (cache hits), a scene cut (a miss and a new key) and an explicit
``reset()``; then a segmentation variant returns per-point logits
through the same session API.

    PYTHONPATH=src python examples/torch_serve_stream.py \\
        [--frames 24] [--n-points 256] [--threshold 0.05] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.api import lite_spec
from repro_torch.data import pointclouds
from repro_torch.models import pointmlp as PM
from repro_torch.serve.pointcloud import PointCloudEngine


def main() -> None:
    ap = argparse.ArgumentParser(description="streaming LiDAR demo")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--n-points", type=int, default=256)
    ap.add_argument("--threshold", type=float, default=0.05,
                    help="per-point drift (max L2) that invalidates "
                         "the temporal cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    spec = lite_spec(pointclouds.N_CLASSES).replace(
        n_points=args.n_points, embed_dim=16, k_neighbors=8,
        sampler="fps", stream=True, backend="cuda",
        stream_drift_threshold=args.threshold).serving()
    params = PM.pointmlp_init(spec.to_model_config(),
                              torch.Generator().manual_seed(args.seed))
    print("serving random-init weights (see examples/"
          "torch_serve_pointcloud.py for the trained flow)")
    engine = PointCloudEngine(params, spec, max_batch=1, device=args.device)
    print(f"warmup/compile: {engine.warmup():.2f}s")
    sess = engine.open_stream()

    # A drifting sequence: frame-to-frame motion well under the
    # threshold, so steady scanning replays the cached mapping.
    frames, _ = pointclouds.make_stream(1, args.n_points, args.frames,
                                        drift=0.01, device=args.device)

    # Phase 1: steady scan; frame 0 is the cold key, the rest hit.
    t0 = time.perf_counter()
    for frame in frames:
        sess.infer(frame)
    dt = time.perf_counter() - t0
    s = sess.stats
    print(f"\nsteady scan: {s.frames} frames, {s.hits} hits "
          f"({s.hit_rate:.0%}), {len(frames) / dt:.1f} frames/s")

    # Phase 2: a scene cut past the threshold makes a new key (one
    # miss), then hits resume on the new scene.
    cut = frames[-1] + frames.new_tensor([1.0, 0.0, 0.0])
    print(f"\nscene cut: drift {sess.drift(cut):.2f} > "
          f"{args.threshold:g} -> miss + re-key")
    sess.infer(cut)
    sess.infer(cut + 0.001)
    s = sess.stats
    print(f"  now {s.misses} misses total, hits resumed "
          f"(hit rate {s.hit_rate:.0%})")

    # Phase 3: an explicit reset (sensor re-mounted); the next frame is
    # cold by decree, and the replay is still bit-identical to a cold
    # dispatch.
    sess.reset()
    cached = sess.infer(frames[3])
    cold = PointCloudEngine(params, spec, max_batch=1,
                            device=args.device).classify(frames[3][None])[0]
    print(f"\nafter reset(): resets={sess.stats.resets}, "
          f"cold-vs-stream bitwise equal: {bool(torch.equal(cached, cold))}")

    # The segmentation head: the same session API, per-point logits.
    seg_spec = spec.replace(head="seg")
    seg_engine = PointCloudEngine(
        PM.pointmlp_init(seg_spec.to_model_config(),
                         torch.Generator().manual_seed(args.seed)),
        seg_spec, max_batch=1, device=args.device)
    seg = seg_engine.open_stream()
    logits = seg.infer(frames[0])
    print(f"\nseg head: per-point logits {tuple(logits.shape)}, "
          f"{int(logits.argmax(-1).max()) + 1} classes seen")


if __name__ == "__main__":
    main()
