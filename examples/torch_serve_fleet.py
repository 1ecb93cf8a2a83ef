"""Fleet serving on the PyTorch/CUDA port: two tenants, a lite+elite
pool, one shed burst.  The twin of ``examples/serve_fleet.py``; it runs
on ``cuda`` (the hand kernels) unless told otherwise.

A ``PipelineFleet`` serves an int8 Lite tier for the real-time "lidar"
tenant (tight SLO, small in-flight bulkhead) and an fp32 tier for the
patient "analytics" tenant, two replicas each.  The demo drives a steady
mixed phase, then a burst that overruns the lidar tenant's
``max_inflight`` so admission control sheds: a typed ``Overloaded`` the
client sees at once, not a request that hangs.

    PYTHONPATH=src python examples/torch_serve_fleet.py \\
        [--replicas 2] [--batch 4] [--router least-loaded] \\
        [--max-inflight 3] [--burst 8] [--device cpu]
"""
import argparse

import torch

from repro_torch.api import FleetSpec, TenantSpec, lite_spec
from repro_torch.data import pointclouds
from repro_torch.models import pointmlp as PM
from repro_torch.serve.fleet import Overloaded, PipelineFleet
from repro_torch.serve.router import ROUTERS


def main() -> None:
    ap = argparse.ArgumentParser(
        description="multi-tenant fleet serving demo")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--router", default="least-loaded",
                    choices=sorted(ROUTERS.names()))
    ap.add_argument("--max-inflight", type=int, default=3,
                    help="the lidar tenant's in-flight bulkhead")
    ap.add_argument("--burst", type=int, default=8,
                    help="burst size fired at the lidar tenant")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    # The pool: the same tiny model served at two precisions, on the
    # hand kernels' backend.
    base = lite_spec(pointclouds.N_CLASSES).replace(
        n_points=128, embed_dim=16, k_neighbors=8, backend="cuda").serving()
    tiers = (base.replace(name="lite-int8"),
             base.replace(name="elite-fp32", precision="fp32"))
    fleet_spec = FleetSpec(
        pipelines=tiers,
        tenants=(TenantSpec("lidar", "lite-int8", slo_ms=50.0,
                            max_inflight=args.max_inflight),
                 TenantSpec("analytics", "elite-fp32", slo_ms=0.0)),
        replicas=args.replicas, router=args.router,
        max_batch=args.batch)
    params = {s.name: PM.pointmlp_init(
        s.to_model_config(), torch.Generator().manual_seed(args.seed))
        for s in tiers}
    print("serving random-init weights (see examples/"
          "torch_serve_pointcloud.py for the trained flow)")
    fleet = PipelineFleet.from_specs(fleet_spec, params, seed=args.seed,
                                     device=args.device)
    print(fleet.describe())
    print(f"warmup/compile: {fleet.warmup():.2f}s\n")

    clouds, _ = pointclouds.make_batch(1, 0, base.n_points, 12, args.device)

    # Phase 1: steady mixed traffic inside both tenants' bounds; nothing
    # sheds (fixed-batch replicas hold partial batches, so lidar stays at
    # 3 in flight, exactly its bulkhead).
    futures = []
    for i, cloud in enumerate(clouds[:6]):
        tenant = "lidar" if i % 2 == 0 else "analytics"
        futures.append((tenant, fleet.submit(tenant, cloud)))
        fleet.pump(block=False)
    fleet.flush()
    for tenant, fut in futures:
        print(f"  {tenant}: request {fut.request_id} -> "
              f"class {int(fut.result().argmax())} "
              f"({fut.latency_ms:.1f} ms)")

    # Phase 2: the lidar tenant bursts past its bulkhead with no pumping
    # in between; admission control sheds the excess, typed.
    print(f"\nburst: {args.burst} lidar submits, max_inflight="
          f"{args.max_inflight}")
    admitted = 0
    for cloud in clouds[:args.burst]:
        try:
            fleet.submit("lidar", cloud)
            admitted += 1
        except Overloaded as exc:
            print(f"  shed: {exc}")
    fleet.flush()
    print(f"  admitted {admitted}/{args.burst}; every admitted request "
          f"resolved ({fleet.pending} pending)")

    print("\nper-tenant stats:")
    for name, row in sorted(fleet.tenant_stats().items()):
        p50 = f"{row['p50_ms']:.1f}" if row["p50_ms"] is not None else "-"
        p99 = f"{row['p99_ms']:.1f}" if row["p99_ms"] is not None else "-"
        print(f"  {name:<10} tier={row['tier']:<10} "
              f"submitted={row['submitted']:<3} shed={row['shed']:<3} "
              f"shed_rate={row['shed_rate']:.2f} "
              f"p50={p50}ms p99={p99}ms")
    agg = fleet.stats()
    print(f"aggregate: {agg['requests']} served, {agg['shed']} shed, "
          f"{agg['samples_per_s']:.1f} samples/s")


if __name__ == "__main__":
    main()
