#!/usr/bin/env python3
"""Time GEMM kernel sources (``int8_matmul``, ``fused_linear``) on one GPU.

    python3 scripts/gemm_ab.py [--ptxas] [--ptxas-dir DIR] [--kernel NAME]
                               [NAME=OTHER.cu ...]

Builds ``src/repro_torch/csrc/int8_matmul.cu`` and ``fused_linear.cu``
(as ``shipped``) and each other source given as ``NAME=PATH`` (NAME is
``int8_matmul`` or ``fused_linear``: a parent commit's copy, whose launch
function may lack the template argument, or an edited variant) with the
port's ``nvcc`` flags.  ``--ptxas`` adds ``-Xptxas -v`` and prints each
template's registers and spills; ``--ptxas-dir DIR`` also keeps each
whole report there as ``ptxas-<kernel>-<source>.txt``.

At every GEMM shape of one 32-cloud dispatch (Lite's for ``int8_matmul``,
M-2's for ``fused_linear``) it holds each source against the plain
version (int8 bitwise; ``fused_linear`` within rtol = atol = 1e-5, and
bit for bit against the shipped source, since both keep one in-order
fmaf chain an output).  Then it times each in turns (shipped, others,
others reversed, shipped) beside ``torch._int_mm`` or ``torch.addmm``,
and the shipped ``fused_linear`` at both of its tile families (wide and
small).  A time is the device time of one call (``chip_smoke.graph_ms``:
a CUDA graph of back-to-back launches, replayed), so no host time enters
the figure of a short kernel.  Prints the card line, one JSON line a
(kernel, shape) and one a kernel with each source's sum over the dispatch
(launches x ms) beside the summed bound.  Exits non-zero without a CUDA
device, or if a source fails to build, launch or agree.

To hold a change against its parent on one card::

    git show HEAD~1:src/repro_torch/csrc/int8_matmul.cu > build/parent_i8.cu
    python3 scripts/gemm_ab.py int8_matmul=build/parent_i8.cu
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import HBM_BYTES_PER_S, gemm_work, graph_ms  # noqa: E402

LANES = 32
# (M, K, N): launches in one 32-cloud dispatch (tests/test_torch_gemm.py
# records the same lists through the pipeline).
M2_SHAPES = {
    (16384, 3, 32): 1, (131072, 64, 64): 1, (131072, 64, 16): 1,
    (131072, 16, 64): 1, (8192, 64, 16): 1, (8192, 16, 64): 1,
    (65536, 128, 128): 1, (65536, 128, 32): 1, (65536, 32, 128): 1,
    (4096, 128, 32): 1, (4096, 32, 128): 1, (32768, 256, 256): 1,
    (32768, 256, 64): 2, (32768, 64, 256): 2, (2048, 256, 64): 2,
    (2048, 64, 256): 2, (16384, 512, 512): 1, (16384, 512, 128): 1,
    (16384, 128, 512): 1, (1024, 512, 128): 1, (1024, 128, 512): 1,
    (32, 512, 512): 1, (32, 512, 256): 1}
LITE_SHAPES = {**M2_SHAPES, (32, 256, 40): 1}


def build(kernel, sources, build_dir, flags, ptxas: bool, ptxas_dir=None):
    """Compile each source in parallel; -> {name: (launch fn, has_tmpl)}."""
    from repro_torch.kernels import _build
    symbol = f"{kernel}_launch"
    n_ptrs = 5 if kernel == "int8_matmul" else 4
    procs = {}
    for name, src in sources.items():
        so = build_dir / f"{kernel}-{name}.so"
        cmd = ["/usr/local/cuda/bin/nvcc", *flags,
               *(["-Xptxas", "-v"] if ptxas else []), "-o", str(so),
               str(src)]
        procs[name] = (src, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (src, so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{log}")
        if ptxas:
            if ptxas_dir:
                out_dir = pathlib.Path(ptxas_dir)
                out_dir.mkdir(parents=True, exist_ok=True)
                (out_dir / f"ptxas-{kernel}-{name}.txt").write_text(log)
            # one line a kernel template: registers, and spills where any
            lines = [ln.split("ptxas info    : ")[-1] for ln in
                     log.splitlines() if "registers" in ln
                     or ("spill" in ln and " 0 bytes spill stores" not in ln)]
            print(json.dumps({"ptxas": f"{kernel} {name}", "info": lines}),
                  flush=True)
        params = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)",
                           pathlib.Path(src).read_text()).group(1)
        n_args = len(params.split(","))
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        # pointers, ints, the stream; the shipped launch function ends its
        # ints with the template code, an older one does not
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_int] * (n_args - n_ptrs - 1)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = (fn, n_args == len(_build.SIGNATURES[kernel][1]))
    return fns


def bound_ms(kernel, m, k, n) -> float:
    nbytes, nops, peak = gemm_work(kernel, m, k, n, LANES)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / peak)


def run_kernel(torch, kernel, fns):
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import fused_linear as fl_mod
    from repro_torch.kernels import int8_matmul as i8_mod
    shapes = LITE_SHAPES if kernel == "int8_matmul" else M2_SHAPES
    gen = torch.Generator(device="cuda").manual_seed(7)
    dev = "cuda"
    sums = {name: 0.0 for name in fns}
    sums["library"] = 0.0
    total_bound = 0.0
    for (m, k, n), count in shapes.items():
        out = torch.empty(m, n, device=dev)
        if kernel == "int8_matmul":
            x = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                              dtype=torch.int8)
            w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8)
            a_s = torch.rand(LANES, generator=gen, device=dev) / 127 + 1e-4
            w_s = torch.rand(n, generator=gen, device=dev) / 127 + 1e-4
            tmpl = i8_mod.template(k, n, _build.aligned16(x, w))
            rpl = m // LANES
            want = ref.int8_matmul_ref(x, w, a_s, w_s, rpl)

            def call(fn, has_tmpl):
                extra = (tmpl.code,) if has_tmpl else ()
                _build.check(kernel, fn(
                    x.data_ptr(), w.data_ptr(), a_s.data_ptr(),
                    w_s.data_ptr(), out.data_ptr(), m, k, n, rpl, *extra,
                    torch.cuda.current_stream().cuda_stream))
            library = ((lambda: torch._int_mm(x, w))
                       if m > 16 and k % 8 == 0 and n % 8 == 0 else None)
        else:
            x = torch.randn(m, k, generator=gen, device=dev)
            w = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
            b = 0.1 * torch.randn(n, generator=gen, device=dev)
            tmpl = fl_mod.template(m, k, n, _build.aligned16(x, w))
            want = ref.fused_linear_ref(x, w, b, "relu")

            def call(fn, has_tmpl):
                extra = (tmpl.code,) if has_tmpl else ()
                _build.check(kernel, fn(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(),
                    out.data_ptr(), m, k, n, 1, *extra,
                    torch.cuda.current_stream().cuda_stream))

            def library():
                return torch.addmm(b, x, w)
        row = {"kernel": kernel, "shape": f"M={m} K={k} N={n}",
               "launches": count, "template": tmpl.name,
               "bound_ms": bound_ms(kernel, m, k, n)}
        shipped = None
        for name, (fn, has_tmpl) in fns.items():
            out.fill_(float("nan"))
            call(fn, has_tmpl)
            torch.cuda.synchronize()
            if kernel == "int8_matmul":
                ok = torch.equal(out, want)
            else:
                ok = torch.allclose(out, want, rtol=1e-5, atol=1e-5)
                if shipped is None:
                    shipped = out.clone()
                else:
                    row[f"{name}_bitwise_vs_shipped"] = bool(
                        torch.equal(out, shipped))
            if not ok:
                raise RuntimeError(f"{kernel} {name} at {row['shape']}: "
                                   f"disagrees with the plain version")
        names = list(fns)
        for name in names + names[::-1]:
            row.setdefault(f"{name}_ms", []).append(
                graph_ms(torch, lambda: call(*fns[name])))
        row["library_ms"] = graph_ms(torch, library) if library else None
        if kernel == "fused_linear":
            # the shipped source at both of its tile families
            fn, _ = fns["shipped"]
            for other in (fl_mod.template(m, k, n, tmpl.vec, sms=0),
                          fl_mod.template(m, k, n, tmpl.vec, sms=1 << 30)):
                tmpl = other
                row[f"template_{other.name}_ms"] = graph_ms(
                    torch, lambda: call(fn, True))
        for name in names:
            sums[name] += count * statistics.mean(row[f"{name}_ms"])
        if row["library_ms"] is not None:
            sums["library"] += count * row["library_ms"]
        total_bound += count * row["bound_ms"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"kernel": kernel, "dispatch_ms": sums,
                      "library_note": "shapes where the library call "
                                      "exists",
                      "dispatch_bound_ms": total_bound}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--ptxas-dir", metavar="DIR")
    ap.add_argument("--kernel", choices=("int8_matmul", "fused_linear"),
                    action="append")
    ap.add_argument("others", nargs="*", metavar="NAME=OTHER.cu")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("gemm_ab.py: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    kernels = args.kernel or ["int8_matmul", "fused_linear"]
    sources = {kn: {"shipped": _build.CSRC / f"{kn}.cu"} for kn in kernels}
    for arg in args.others:
        kn, _, path = arg.partition("=")
        if kn not in sources:
            raise SystemExit(f"gemm_ab.py: {arg}: NAME must be one of "
                             f"{kernels}")
        sources[kn][pathlib.Path(path).stem] = pathlib.Path(path).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        built = {kn: build(kn, srcs, pathlib.Path(tmp),
                           _build.NVCC_FLAGS + _build.EXTRA_FLAGS.get(kn, []),
                           args.ptxas or bool(args.ptxas_dir),
                           args.ptxas_dir)
                 for kn, srcs in sources.items()}
        for kn, fns in built.items():
            run_kernel(torch, kn, fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
