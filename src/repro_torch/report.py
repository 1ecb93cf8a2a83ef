"""Render the dry-run records as markdown tables.

Usage::

  PYTHONPATH=src python -m repro_torch.report [--dir artifacts/dryrun_torch]

prints the dry-run tables of both production meshes and the roofline
table and dominant-term notes of the single pod, from the records
``python -m repro_torch.launch.dryrun`` writes; no GPU is needed.

The port of ``repro.report``: :func:`roofline_table` and
:func:`dryrun_table` print JAX's tables byte for byte from the same
records; the collective term is rank 0's count priced on an H100 node
(``launch/dryrun.py``).  Records JAX's tables cannot take
print a row of "—" in the roofline table: ``--fast`` ones (no roofline)
and ``deferred`` ones (``status`` in the dry-run table).  The notes
name what moves each dominant term on an H100.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

from repro_torch.configs import LM_SHAPES, list_archs
from repro_torch.launch.mesh import make_production_mesh

_IMPROVE = {
    # one sentence per dominant term: what would move it down
    "compute": "increase per-device work via larger per-device batch, or "
               "int8 tensor-core products (2x the bf16 peak)",
    "memory": "cut activation materialization: chunked attention, "
              "sequence-parallel sharding of the residual stream, int8 "
              "weights for the weight-read term",
    "collective": "re-shard to convert all-reduce to reduce-scatter "
                  "(sequence parallel), localize MoE dispatch, keep the "
                  "model axis within a node's NVLink, compress gradients "
                  "to int8",
}


def load(dir_: str, mesh: str) -> List[Dict]:
    out = []
    for arch in list_archs():
        for shape in LM_SHAPES:
            f = pathlib.Path(dir_) / mesh / arch / f"{shape}.json"
            if f.exists():
                out.append(json.loads(f.read_text()))
    return out


def fmt_t(x: float) -> str:
    return f"{x:.3e}"


def roofline_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | kind | bytes/dev | t_compute | t_memory | "
        "t_collective | bound | useful FLOPs ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | — | "
                f"N/A (skip) | — | — |")
            continue
        rl = r.get("roofline")
        ur = r.get("useful_flops_ratio")
        fr = r.get("roofline_fraction")
        if rl is None:
            ur = None
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} | "
            f"{r['bytes_per_device']/2**30:.2f} GiB | "
            f"{fmt_t(rl['t_compute'])} | {fmt_t(rl['t_memory'])} | "
            f"{fmt_t(rl['t_collective'])} | **{rl['bottleneck']}** | "
            f"{ur:.3f} | {fr:.5f} |" if ur is not None else
            f"| {r['arch']} | {r['shape']} | {r['kind']} | — | — | — | "
            f"— | — | — | — |")
    return "\n".join(lines)


def dryrun_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | status | compile s | bytes/dev | params | "
        "collective mix (top) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") in ("skipped", "deferred"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']} | — "
                         f"| — | — | — |")
            continue
        mix = r.get("roofline", {}).get("coll_by_type") or \
            r.get("scan_cost_raw", {}).get("coll_by_type", {})
        top = sorted(mix.items(), key=lambda kv: -kv[1])[:2]
        mixs = ", ".join(f"{k} {v/1e9:.1f}GB" for k, v in top) or "none"
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']} | "
            f"{r['bytes_per_device']/2**30:.2f} GiB | "
            f"{r.get('params_total', 0)/1e9:.2f}B | {mixs} |")
    return "\n".join(lines)


def bottleneck_summary(recs: List[Dict]) -> str:
    lines = []
    for r in recs:
        if r.get("status") != "ok" or "roofline" not in r:
            continue
        rl = r["roofline"]
        lines.append(f"- **{r['arch']} × {r['shape']}** — bound: "
                     f"{rl['bottleneck']}; to improve: "
                     f"{_IMPROVE[rl['bottleneck']]}.")
    return "\n".join(lines)


def _mesh_label(kind: str) -> str:
    mesh = make_production_mesh(multi_pod=(kind == "multipod"))
    axes = "x".join(str(n) for n in mesh.axis_sizes)
    names = ", ".join(f"{a}={n}" for a, n in mesh.shape.items())
    return f"mesh {kind}, {axes} ({names}) = {mesh.size} devices"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.report")
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    pod = load(args.dir, "pod")
    mp = load(args.dir, "multipod")
    print(f"## §Dry-run — {_mesh_label('pod')}\n")
    print(dryrun_table(pod))
    print(f"\n## §Dry-run — {_mesh_label('multipod')}\n")
    print(dryrun_table(mp))
    print(f"\n## §Roofline — {_mesh_label('pod')}, per (arch × shape), "
          f"ideal partition, rank 0's collectives\n")
    print(roofline_table(pod))
    print("\n### Dominant-term notes\n")
    print(bottleneck_summary(pod))


if __name__ == "__main__":
    main()
