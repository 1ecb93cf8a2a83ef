#!/usr/bin/env python3
"""Time GEMM kernel sources (``int8_matmul``, ``fused_linear``, ``grouped_transfer``, ``w8_matmul``) on one GPU.

    python3 scripts/gemm_ab.py [--ptxas] [--ptxas-dir DIR] [--kernel NAME]
                               [NAME=OTHER.cu ...]

Builds ``src/repro_torch/csrc/int8_matmul.cu``, ``fused_linear.cu``,
``grouped_transfer.cu`` and ``w8_matmul.cu`` (as ``shipped``) and each
other source given as ``NAME=PATH`` (NAME is one of those four kernels: a
parent commit's copy, whose launch function may lack the template or
route arguments, or an edited variant; ``-I csrc`` finds the shared
headers) with the port's ``nvcc`` flags.  ``--ptxas`` adds ``-Xptxas
-v`` and prints each template's registers and spills; ``--ptxas-dir
DIR`` also keeps each whole report there as
``ptxas-<kernel>-<source>.txt``.

At every GEMM shape of one 32-cloud dispatch (Lite's for ``int8_matmul``,
M-2's for ``fused_linear``; ``int8_matmul`` also at three K = 2048
products, outside the dispatch's sums) it holds each source against the plain
version (int8 bitwise; ``fused_linear`` within rtol = atol = 1e-5, and
bit for bit against the shipped source, since both keep one in-order
fmaf chain an output).  ``grouped_transfer`` runs at Elite's four
stages (B32 k16, C 32 -> 64 up to 256 -> 512, random neighbour indices),
both variants (sigma computed, sigma given), each within rtol = atol =
1e-5 of the plain version, the sigma-given one bit for bit against the
shipped source.  Then it times each in turns (shipped, others, others
reversed, shipped) beside ``torch._int_mm`` or ``torch.addmm`` where one
computes the function, and the shipped ``fused_linear`` at both of its
tile families (wide and small).  ``w8_matmul`` runs at tinyllama's MLP
up- and down-projection (K2048 N5632, K5632 N2048) at decode (M 1 and
4), each side of the stream route's row limit and prefill (M 8192) in
bf16, and at decode in f32, each source within the per-row tolerance of
the plain version (2**-7 in bf16, 1e-5 in f32); its times rotate over
six weights that together exceed the L2 (cold, as a decode step over
many layers finds them), beside the shipped source with one weight
(warm), ``torch._weight_int8pack_mm`` (scale rounded to x's dtype) and
the pre-dequantized bf16 product (context only).  A time is the device
time of one call (``chip_smoke.graph_ms``: a CUDA graph of back-to-back
launches, replayed), so no host time enters the figure of a short
kernel.  Prints the card line, one JSON line a (kernel, shape) and, but
for ``w8_matmul``, one a kernel with each source's sum over the dispatch
(launches x ms) beside the summed bound.  Exits non-zero without a CUDA
device, or if a source fails to build, launch or agree.

To hold a change against its parent on one card::

    git show HEAD~1:src/repro_torch/csrc/int8_matmul.cu > build/parent_i8.cu
    python3 scripts/gemm_ab.py int8_matmul=build/parent_i8.cu
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from ab_build import build  # noqa: E402
from chip_smoke import (BF16_OPS_PER_S, FP32_OPS_PER_S,  # noqa: E402
                        HBM_BYTES_PER_S, W8_COPIES, gemm_work, graph_ms,
                        grouped_work, rotation, rowwise_close)
KERNELS = ("int8_matmul", "fused_linear", "grouped_transfer", "w8_matmul")
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
    (32, 512, 512): 1, (32, 512, 256): 1, (32, 256, 40): 1}
# fc3 runs on the head's backend, so both kernels take all 28 products.
LITE_SHAPES = M2_SHAPES
# int8 products deeper than one shared-memory slice of w (K > 1024):
# lite_spec(40, embed_dim=128)'s stage-4 transfers and the smoke's row.
# Not in Lite's dispatch: 0 launches there.
INT8_DEEP_SHAPES = {(16384, 2048, 2048): 0, (16384, 2048, 512): 0,
                    (4096, 2048, 512): 0}
# Elite's group->transfer stages: (N, S, C, C_out) at B32 k16, one launch
# each in a dispatch.
ELITE_STAGES = ((1024, 512, 32, 64), (512, 256, 64, 128),
                (256, 128, 128, 256), (128, 64, 256, 512))
# W8A16 rows: (M, K, N, x dtype name) at tinyllama's MLP shapes; 64 and 65
# straddle the stream route's row limit.
W8_SHAPES = ((1, 2048, 5632, "bf16"), (4, 2048, 5632, "bf16"),
             (4, 5632, 2048, "bf16"), (64, 2048, 5632, "bf16"),
             (65, 2048, 5632, "bf16"), (8192, 2048, 5632, "bf16"),
             (8192, 5632, 2048, "bf16"), (4, 2048, 5632, "f32"),
             (4, 5632, 2048, "f32"), (64, 2048, 5632, "f32"),
             (65, 2048, 5632, "f32"))


def bound_ms(kernel, m, k, n) -> float:
    nbytes, nops, peak = gemm_work(kernel, m, k, n, LANES)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / peak)


def run_kernel(torch, kernel, fns):
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import fused_linear as fl_mod
    from repro_torch.kernels import int8_matmul as i8_mod
    shapes = ({**LITE_SHAPES, **INT8_DEEP_SHAPES} if kernel == "int8_matmul"
              else M2_SHAPES)
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
                    ok = ok and row[f"{name}_bitwise_vs_shipped"]
            if not ok:
                raise RuntimeError(f"{kernel} {name} at {row['shape']}: "
                                   f"disagrees with the plain version or "
                                   f"the shipped source")
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


def run_grouped(torch, fns):
    """Both grouped_transfer variants of each source at Elite's four
    stages, checked, then timed in turns."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import grouped_transfer as gt_mod
    b, k = LANES, 16
    gen = torch.Generator(device="cuda").manual_seed(11)
    dev = "cuda"
    sums = {name: 0.0 for name in fns}
    total_bound = 0.0
    for n, s, c, c_out in ELITE_STAGES:
        feats = torch.randn(b, n, c, generator=gen, device=dev)
        nidx = torch.randint(0, n, (b, s, k), generator=gen, device=dev)
        centers = torch.randn(b, s, c, generator=gen, device=dev)
        alpha = 0.7 + 0.6 * torch.rand(c, generator=gen, device=dev)
        beta = 0.1 * torch.randn(c, generator=gen, device=dev)
        w = torch.randn(2 * c, c_out, generator=gen, device=dev) / (
            2 * c) ** 0.5
        bias = 0.1 * torch.randn(c_out, generator=gen, device=dev)
        sigma = 0.5 + torch.rand(b, generator=gen, device=dev)
        out = torch.empty(b, s, k, c_out, device=dev)
        partials = torch.empty(b, -(-s // 8), dtype=torch.float64,
                               device=dev)
        tmpl = gt_mod.template(b * s * k, c, c_out,
                               _build.aligned16(feats, centers, alpha, beta,
                                                w))
        for mode, sig in ((2, None), (1, sigma)):

            def call(fn, has_tmpl):
                extra = (tmpl.code,) if has_tmpl else ()
                _build.check("grouped_transfer", fn(
                    feats.data_ptr(), nidx.data_ptr(), centers.data_ptr(),
                    sigma.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                    w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                    partials.data_ptr(), b, n, s, k, c, c_out, mode, 1, 1,
                    *extra, torch.cuda.current_stream().cuda_stream))
            want = ref.grouped_transfer_ref(feats, nidx, centers, sig, alpha,
                                            beta, w, bias)
            nbytes, nops = grouped_work(b, n, s, k, c, c_out, mode == 1)
            row = {"kernel": "grouped_transfer",
                   "variant": "stats" if mode == 2 else "sigma_given",
                   "shape": f"B={b} N={n} S={s} k={k} C={c} C_out={c_out}",
                   "launches": 1, "template": tmpl.name,
                   "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                         nops / FP32_OPS_PER_S)}
            shipped = None
            for name, (fn, has_tmpl) in fns.items():
                out.fill_(float("nan"))
                call(fn, has_tmpl)
                torch.cuda.synchronize()
                ok = torch.allclose(out, want, rtol=1e-5, atol=1e-5)
                row.setdefault("max_abs_err", {})[name] = (
                    out - want).abs().max().item()
                if shipped is None:
                    shipped = out.clone()
                else:
                    same = bool(torch.equal(out, shipped))
                    row[f"{name}_bitwise_vs_shipped"] = same
                    # the sigma-given product is one fmaf chain an output
                    # in every source; a computed sigma may differ in its
                    # float64 sum order
                    ok = ok and (same or mode == 2)
                if not ok:
                    raise RuntimeError(
                        f"grouped_transfer {name} {row['variant']} at "
                        f"{row['shape']}: disagrees with the plain version "
                        f"or the shipped source")
            names = list(fns)
            for name in names + names[::-1]:
                row.setdefault(f"{name}_ms", []).append(
                    graph_ms(torch, lambda: call(*fns[name])))
            for name in names:
                sums[name] += statistics.mean(row[f"{name}_ms"])
            total_bound += row["bound_ms"]
            print(json.dumps(row), flush=True)
    print(json.dumps({"kernel": "grouped_transfer",
                      "sum_over_stages_and_variants_ms": sums,
                      "bound_ms": total_bound}), flush=True)


def run_w8(torch, fns):
    """Each w8_matmul source at W8_SHAPES, checked, then timed in turns
    as graph replays over W8_COPIES weights."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import int8_matmul as i8_mod
    from repro_torch.models.layers import f32_sums
    gen = torch.Generator(device="cuda").manual_seed(13)
    dev = "cuda"
    for m, k, n, dname in W8_SHAPES:
        dt = torch.bfloat16 if dname == "bf16" else torch.float32
        x = torch.randn(m, k, generator=gen, device=dev).to(dt)
        w_qs = [torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(W8_COPIES)]
        w_scale = torch.rand(n, generator=gen, device=dev) / 127 + 1e-4
        route = i8_mod.w8_route(m, k, n, dt,
                                _build.aligned16(x, w_qs[0], w_scale))
        scratch = torch.empty(route.splits(k), m, n, device=dev)
        out = torch.empty(m, n, dtype=dt, device=dev)

        def call(fn, new_sig, w):
            # a parent's launch function has no scratch, route or ks
            head = (x.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
                    out.data_ptr())
            args = ((*head, scratch.data_ptr(), m, k, n, int(dname == "bf16"),
                     route.code, route.ks) if new_sig else
                    (*head, m, k, n, int(dname == "bf16")))
            _build.check("w8_matmul", fn(
                *args, torch.cuda.current_stream().cuda_stream))
        nbytes = x.element_size() * (m * k + m * n) + k * n + 4 * n
        nops = 2 * m * k * n
        peak = BF16_OPS_PER_S if dname == "bf16" else FP32_OPS_PER_S
        row = {"kernel": "w8_matmul", "shape": f"M={m} K={k} N={n} {dname}",
               "route": route.name,
               "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / peak)}
        want = ref.w8_matmul_plain(x, w_qs[0], w_scale)
        tol = 2.0 ** -7 if dname == "bf16" else 1e-5
        for name, (fn, new_sig) in fns.items():
            out.fill_(float("nan"))
            call(fn, new_sig, w_qs[0])
            torch.cuda.synchronize()
            ok, err, _, _, worst = rowwise_close(torch, out, want, tol)
            row.setdefault("err_over_allowed", {})[name] = worst
            if not ok:
                raise RuntimeError(f"w8_matmul {name} at {row['shape']}: "
                                   f"{worst} x the allowance")
        launches = 20 if m <= i8_mod.STREAM_MAX_M else 5
        names = list(fns)
        for name in names + names[::-1]:
            row.setdefault(f"{name}_ms", []).append(graph_ms(
                torch, rotation([lambda w=w: call(*fns[name], w)
                                 for w in w_qs]), launches=launches))
        row["shipped_warm_l2_ms"] = graph_ms(
            torch, lambda: call(*fns["shipped"], w_qs[0]), launches=launches)
        if dname == "bf16":
            w_ts = [w.t().contiguous() for w in w_qs]
            scale_x = w_scale.to(dt)
            row["library_ms"] = graph_ms(torch, rotation([
                lambda w=w: torch._weight_int8pack_mm(x, w, scale_x)
                for w in w_ts]), launches=launches,
                reps=15 if m <= i8_mod.STREAM_MAX_M else 3)
            del w_ts
            w_deqs = [(w.float() * w_scale).to(dt) for w in w_qs]
            with f32_sums():
                row["dequantized_matmul_ms"] = graph_ms(
                    torch, rotation([lambda d=d: x @ d for d in w_deqs]),
                    launches=launches)
            del w_deqs
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--ptxas-dir", metavar="DIR")
    ap.add_argument("--kernel", choices=KERNELS, action="append")
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
    kernels = args.kernel or list(KERNELS)
    sources = {kn: {"shipped": _build.CSRC / f"{kn}.cu"} for kn in kernels}
    for arg in args.others:
        kn, _, path = arg.partition("=")
        if kn not in sources:
            raise SystemExit(f"gemm_ab.py: {arg}: NAME must be one of "
                             f"{kernels}")
        sources[kn][pathlib.Path(path).stem] = pathlib.Path(path).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        built = {}
        for kn, srcs in sources.items():
            fns = build(kn, srcs, tmp,
                        _build.NVCC_FLAGS + _build.EXTRA_FLAGS.get(kn, []),
                        args.ptxas or bool(args.ptxas_dir), args.ptxas_dir)
            # the shipped launch function ends its ints with the template
            # code (w8_matmul: takes scratch, route and ks), an older one
            # does not
            n_args = len(_build.SIGNATURES[kn][1])
            built[kn] = {name: (fn, len(fn.argtypes) == n_args)
                         for name, fn in fns.items()}
        for kn, fns in built.items():
            if kn == "grouped_transfer":
                run_grouped(torch, fns)
            elif kn == "w8_matmul":
                run_w8(torch, fns)
            else:
                run_kernel(torch, kn, fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
