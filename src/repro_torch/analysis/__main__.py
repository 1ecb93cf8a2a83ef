"""``python -m repro_torch.analysis``: the port's static plan-verification CLI.

The twin of ``python -m repro.analysis``.  It sweeps the variant helpers
(elite, m2, lite; with ``--all-variants`` also the compression ladder, a
stream and a seg variant, README.md's ``FleetSpec`` and the plan-space
product around each base) through

  1. the spec passes (``repro_torch.analysis.passes``, every scope);
  2. the registry contracts (``repro_torch.analysis.contracts``, every
     entry run twice on CPU tensors);
  3. the op traces (``repro_torch.analysis.trace``, per variant whose
     spec passes found no error; ``--no-trace`` skips them): every
     distinct stage callable run once on small CPU tensors under the op
     recorder;
  4. the plan-space sweep: every analyzer-clean candidate must lower
     (RPA298 if not); pruned candidates are counted per code.

The exit status is 1 iff an error finding was produced.  ``--spec-json``
checks one spec, given as field overrides on ``--base``::

    python -m repro_torch.analysis --spec-json '{"data_shards": 2}'  # RPA020
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import warnings
from collections import Counter
from typing import List

from repro_torch.analysis import findings as F


def _analyze_one(spec, args, out: List[F.Finding]) -> None:
    from repro_torch.analysis.passes import analyze_spec
    found = analyze_spec(spec)
    _report(f"spec {spec.name}", found, args)
    out.extend(found)
    if not args.no_trace and not F.has_errors(found):
        from repro_torch.analysis.trace import analyze_plan_trace
        traced = analyze_plan_trace(spec)
        _report(f"trace {spec.name}", traced, args)
        out.extend(traced)


def _report(title: str, found: List[F.Finding], args) -> None:
    errs = sum(f.severity == F.ERROR for f in found)
    warns = sum(f.severity == F.WARNING for f in found)
    if not args.quiet or errs:
        status = "ok" if not errs else f"{errs} error(s)"
        extra = f", {warns} warning(s)" if warns else ""
        print(f"== {title}: {status}{extra}")
    for f in found:
        if f.severity == F.ERROR or not args.quiet:
            print(f"   {f}")


def _sweep(base, args, out: List[F.Finding]) -> None:
    """The raw product of the quick search axes around ``base``: clean
    candidates must lower (RPA298 if not); pruned ones are counted per
    code, the tuner's drop list made visible."""
    from repro_torch.analysis.passes import analyze_spec
    from repro_torch.api import plan as plan_mod
    axes = itertools.product(
        plan_mod.DEFAULT_STAGE_PRECISIONS,
        (("ref",) * 4, ("cuda",) * 4),
        ("none", "grouped_transfer"))
    n_clean, pruned = 0, Counter()
    for sp, sb, fg in axes:
        spec = base.replace(stage_precision=sp, stage_backend=sb,
                            fused_group=fg)
        found = analyze_spec(spec, scopes=("lowering",))
        if found:
            for f in found:
                pruned[f.code] += 1
            continue
        n_clean += 1
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                plan_mod.lower(spec, spec.to_model_config())
        except Exception as e:  # noqa: BLE001 — drift is the finding
            out.append(F.finding(
                "RPA298", f"sweep[{base.name}]",
                f"analyzer-clean candidate failed to lower: "
                f"{type(e).__name__}: {e} (stage_precision={sp}, "
                f"stage_backend={sb[0]}, fused_group={fg})"))
    codes = ", ".join(f"{c} x{n}" for c, n in sorted(pruned.items()))
    if not args.quiet:
        print(f"== sweep around {base.name}: {n_clean} candidates lower "
              f"clean; pruned by code: {codes or 'none'}")


def readme_fleet_spec():
    """README.md's fleet: a Lite and an Elite tier, two replicas each."""
    from repro_torch.api.spec import (FleetSpec, TenantSpec, elite_spec,
                                      lite_spec)
    return FleetSpec(
        pipelines=(lite_spec(40).serving(), elite_spec(40).serving()),
        tenants=(TenantSpec("lidar", "pointmlp-lite", slo_ms=20.0,
                            max_inflight=8),
                 TenantSpec("analytics", "pointmlp-elite", slo_ms=0.0)),
        replicas=2, router="least-loaded", max_batch=8)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static plan verification of the PyTorch port: prove "
                    "pipeline invariants before build.")
    parser.add_argument("--all-variants", action="store_true",
                        help="sweep every variant helper (ladder, stream, "
                             "seg, fleet) and the plan-space product, not "
                             "just elite/m2/lite")
    parser.add_argument("--base", default="lite",
                        choices=("elite", "m2", "lite"),
                        help="base variant --spec-json overrides apply to "
                             "(default: lite)")
    parser.add_argument("--spec-json", default=None, metavar="JSON",
                        help="analyze one spec: JSON field overrides on "
                             "--base (e.g. '{\"data_shards\": 2}')")
    parser.add_argument("--no-trace", action="store_true",
                        help="skip the op trace passes")
    parser.add_argument("--no-contracts", action="store_true",
                        help="skip the registry contract checks")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="errors only")
    args = parser.parse_args(argv)

    from repro_torch.api.spec import elite_spec, lite_spec, m2_spec
    bases = {"elite": elite_spec, "m2": m2_spec, "lite": lite_spec}
    out: List[F.Finding] = []

    if args.spec_json is not None:
        overrides = json.loads(args.spec_json)
        overrides = {k: tuple(v) if isinstance(v, list) else v
                     for k, v in overrides.items()}
        try:
            spec = bases[args.base]().replace(**overrides)
        except (TypeError, ValueError) as e:
            # Shapes the frozen dataclass itself rejects come before any
            # pass; report and fail without a code.
            print(f"spec construction failed: {e}")
            return 1
        _analyze_one(spec, args, out)
    else:
        variants = [fn() for fn in bases.values()]
        if args.all_variants:
            from repro_torch.api.spec import compression_ladder_specs
            seen = {s.name for s in variants}
            variants += [s for s in compression_ladder_specs()
                         if s.name not in seen]
            variants.append(lite_spec(name="pointmlp-lite-stream").replace(
                stream=True, stream_drift_threshold=0.05))
            variants.append(m2_spec(name="pointmlp-m2-seg").replace(
                head="seg"))
        for spec in variants:
            _analyze_one(spec, args, out)
        if not args.no_contracts:
            from repro_torch.analysis.contracts import (
                check_registry_contracts)
            found = check_registry_contracts()
            _report("registry contracts", found, args)
            out.extend(found)
        if args.all_variants:
            from repro_torch.analysis.passes import (analyze_fleet_spec,
                                                     skip_list_findings)
            found = analyze_fleet_spec(readme_fleet_spec())
            _report("fleet spec", found, args)
            out.extend(found)
            for fn in bases.values():
                _sweep(fn().serving(), args, out)
            skips = skip_list_findings()
            out.extend(skips)
            if not args.quiet:
                print(f"== RPA-skip list: {len(skips)} LM config modules "
                      f"excluded (RPA900)")

    errs = [f for f in out if f.severity == F.ERROR]
    codes = ", ".join(F.error_codes(out)) or "none"
    print(f"SUMMARY: {len(out)} finding(s), {len(errs)} error(s) "
          f"[codes: {codes}]")
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
