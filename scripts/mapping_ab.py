#!/usr/bin/env python3
"""Time mapping kernel sources (``knn``, ``fps``) on one GPU.

    python3 scripts/mapping_ab.py [--ptxas] [--ptxas-dir DIR] [--kernel NAME]
                                  [NAME=OTHER.cu ...]

Builds ``src/repro_torch/csrc/knn.cu`` and ``fps.cu`` (as ``shipped``) and
each other source given as ``NAME=PATH`` (NAME is ``knn`` or ``fps``: a
parent commit's copy, whose launch function may lack the scratch
arguments, or an edited variant) with the port's ``nvcc`` flags
(``scripts/ab_build.py``).  ``--ptxas`` adds ``-Xptxas -v`` and prints
each kernel's registers and spills; ``--ptxas-dir DIR`` also keeps each
whole report there as ``ptxas-<kernel>-<source>.txt``.

At every kNN and FPS launch of one 32-cloud dispatch (kNN at k = 16 at
Lite's and M-2's four stages, which are the same shapes, on URS-sampled
centroids of synthetic 512-point clouds; kNN and FPS at Elite's four
stages on the FPS geometry of 1024-point clouds) it holds each source
bitwise against the plain version, then times them in turns (shipped,
others, others reversed, shipped) as the device time of one call
(``chip_smoke.graph_ms``: a CUDA graph of back-to-back launches, replayed).
As context only it times ``torch.cdist`` + ``torch.topk`` at each kNN
shape: two calls with other rounding, not the same function.  Prints the
card line, one JSON line a (kernel, shape) and one a dispatch with each
source's sum (launches x ms) beside the summed bound.  Exits non-zero
without a CUDA device, or if a source fails to build, launch or agree.

To hold a change against its parent on one card::

    mkdir -p build/ab/knn build/ab/fps
    git show HEAD~1:src/repro_torch/csrc/knn.cu > build/ab/knn/parent.cu
    git show HEAD~1:src/repro_torch/csrc/fps.cu > build/ab/fps/parent.cu
    python3 scripts/mapping_ab.py knn=build/ab/knn/parent.cu \\
        fps=build/ab/fps/parent.cu

Sources of one file name (both ``parent.cu`` here) are also summed over
both kernels in each dispatch line (``all_kernels_ms``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from ab_build import build  # noqa: E402
from chip_smoke import (fps_work, graph_ms, knn_work,  # noqa: E402
                        make_clouds, work_bound_ms)
KERNELS = ("knn", "fps")
LANES, K = 32, 16
# (S, N) of the kNN stages and (N, S) of the FPS stages, one launch each
# in a dispatch.
LITE_KNN = ((256, 512), (128, 256), (64, 128), (32, 64))
ELITE_FPS = ((1024, 512), (512, 256), (256, 128), (128, 64))


def knn_caller(torch, fn, has_scratch, smp, pts, out, k):
    from repro_torch.kernels import _build
    b, s, c = smp.shape
    n = pts.shape[1]
    scratch = (() if not has_scratch else (None, 0))
    # the shipped launch function takes the ball's r2 (+inf: plain kNN)
    # and then the query tile (0: its own rule)
    r2 = (float("inf"),) if ctypes.c_float in fn.argtypes else ()
    qpw = (0,) if r2 and fn.argtypes[-2] is ctypes.c_int else ()

    def call():
        _build.check("knn", fn(smp.data_ptr(), pts.data_ptr(),
                               out.data_ptr(), *scratch, b, s, n, c, k, *r2,
                               *qpw, torch.cuda.current_stream().cuda_stream))
    return call


def fps_caller(torch, fn, has_scratch, pts, out):
    from repro_torch.kernels import _build
    b, n, _ = pts.shape
    s = out.shape[1]
    scratch = (() if not has_scratch else (None, 0))
    # the shipped launch function takes the block's threads (0: its own
    # rule) after S
    threads = (0,) if len(fn.argtypes) == 9 else ()

    def call():
        _build.check("fps", fn(pts.data_ptr(), out.data_ptr(), *scratch, b,
                               n, s, *threads,
                               torch.cuda.current_stream().cuda_stream))
    return call


def geometry(torch, np):
    """The kNN and FPS inputs of one Lite (= M-2) and one Elite dispatch:
    {("lite"|"elite", kernel, stage): (inputs...)}."""
    from repro_torch.core import sampling
    from repro_torch.kernels import ref
    rng = np.random.default_rng(0)
    cases = {}
    cur = torch.from_numpy(make_clouds(np, rng, LANES, 512)).cuda()
    for st, (s, n) in enumerate(LITE_KNN):
        idx = torch.from_numpy(rng.permutation(n)[:s]).cuda()
        new = sampling.gather_points(cur, idx[None].expand(LANES, -1))
        cases[("lite", "knn", st + 1)] = (new.contiguous(), cur)
        cur = new.contiguous()
    cur = torch.from_numpy(make_clouds(np, rng, LANES, 1024)).cuda()
    for st, (n, s) in enumerate(ELITE_FPS):
        cases[("elite", "fps", st + 1)] = (cur, s)
        new = sampling.gather_points(cur, ref.fps_ref(cur, s)).contiguous()
        cases[("elite", "knn", st + 1)] = (new, cur)
        cur = new
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--ptxas-dir", metavar="DIR")
    ap.add_argument("--kernel", choices=KERNELS, action="append")
    ap.add_argument("others", nargs="*", metavar="NAME=OTHER.cu")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("mapping_ab.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    kernels = args.kernel or list(KERNELS)
    sources = {kn: {"shipped": _build.CSRC / f"{kn}.cu"} for kn in kernels}
    for arg in args.others:
        kn, _, path = arg.partition("=")
        if kn not in sources:
            raise SystemExit(f"mapping_ab.py: {arg}: NAME must be one of "
                             f"{kernels}")
        sources[kn][pathlib.Path(path).stem] = pathlib.Path(path).resolve()
    cases = geometry(torch, np)
    sums = {}
    with tempfile.TemporaryDirectory() as tmp:
        built = {}
        for kn, srcs in sources.items():
            fns = build(kn, srcs, tmp,
                        _build.NVCC_FLAGS + _build.EXTRA_FLAGS[kn],
                        args.ptxas or bool(args.ptxas_dir), args.ptxas_dir)
            # the shipped launch functions take (scratch, its length) after
            # the outputs; earlier ones did not
            built[kn] = {name: (fn, ctypes.c_longlong in fn.argtypes)
                         for name, fn in fns.items()}
        for (model, kn, st), inputs in cases.items():
            if kn not in built:
                continue
            fns = built[kn]
            if kn == "knn":
                smp, pts = inputs
                b, s, c = smp.shape
                n = pts.shape[1]
                out = torch.empty(b, s, K, dtype=torch.int64, device="cuda")
                want = ref.knn_ref(smp, pts, K)
                calls = {name: knn_caller(torch, fn, hs, smp, pts, out, K)
                         for name, (fn, hs) in fns.items()}
                shape = f"B={b} S={s} N={n} C={c} k={K}"
                nbytes, nops = knn_work(b, s, n, c, K)
            else:
                pts, s = inputs
                b, n, c = pts.shape
                out = torch.empty(b, s, dtype=torch.int64, device="cuda")
                want = ref.fps_ref(pts, s)
                calls = {name: fps_caller(torch, fn, hs, pts, out)
                         for name, (fn, hs) in fns.items()}
                shape = f"B={b} N={n} S={s}"
                nbytes, nops = fps_work(b, n, s, c)
            row = {"model": model, "kernel": kn, "stage": st, "shape": shape,
                   "bound_ms": work_bound_ms(nbytes, nops)}
            for name, call in calls.items():
                out.fill_(-1)
                call()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{kn} {name} at {model} stage {st}: "
                                       f"not bitwise equal to the plain "
                                       f"version")
            names = list(calls)
            for name in names + names[::-1]:
                row.setdefault(f"{name}_ms", []).append(
                    graph_ms(torch, calls[name]))
            if kn == "knn":
                row["cdist_topk_ms"] = graph_ms(torch, lambda: torch.topk(
                    torch.cdist(smp, pts), K, dim=-1, largest=False))
            print(json.dumps(row), flush=True)
            # Lite's kNN shapes are M-2's too: one launch each in both
            for disp in (("lite", "m2") if model == "lite" else (model,)):
                tot = sums.setdefault(disp, {}).setdefault(
                    kn, {"launches": 0, "bound_ms": 0.0, "ms": {}})
                tot["launches"] += 1
                tot["bound_ms"] += row["bound_ms"]
                for name in names:
                    tot["ms"][name] = tot["ms"].get(name, 0.0) + \
                        statistics.mean(row[f"{name}_ms"])
                if kn == "knn":
                    tot["ms"]["cdist_topk"] = tot["ms"].get(
                        "cdist_topk", 0.0) + row["cdist_topk_ms"]
    for disp, per_kernel in sums.items():
        # sources of one label (e.g. both parents saved as parent.cu) are
        # added over the kernels
        both = {}
        for kn, tot in per_kernel.items():
            for name, ms in tot["ms"].items():
                if name != "cdist_topk":
                    both.setdefault(name, {})[kn] = ms
        print(json.dumps({
            "dispatch": disp, "per_kernel": per_kernel,
            "cdist_topk_note": "context only: other rounding, two calls",
            "all_kernels_ms": {name: sum(v.values()) for name, v in
                               both.items() if len(v) == len(per_kernel)},
            "all_kernels_bound_ms": sum(t["bound_ms"] for t in
                                        per_kernel.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
