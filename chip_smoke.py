#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/csrc``,
holds each one against its plain PyTorch version on the card at the
shapes the serving paths give it, then serves ragged queues through
``PointCloudEngine`` on the card and checks them against the same engines
on the CPU: PointMLP-Lite (int8 W8A8) and M-2 (fused fp32) at 512 points,
and PointMLP-Elite (FPS, learnable affine, fp32, 1024 points) with the
fused group->transfer kernel.  Elite also runs one dispatch unfused (held
against the fused one) and one under batch-global sigma (held against
the CPU).  Then the decoder LM, tinyllama-1.1b at full width and depth in
bf16 with random weights from a seed: the flash-attention and W8A16
kernels against their plain versions at its shapes, a scoring forward of
4 x 2048 tokens through the flash kernel held against the plain-attention
route, a 2-layer cut held against the CPU, and ``Engine.generate``
(prefill plus 32 greedy decode steps) whose last logits are held against
the forward.  Every path is driven with the kernels' launch counts set to
0 just before it and read just after.  Every phase prints one JSON line; a
failed check raises and the script exits non-zero.  The line before the
last lists every ported kernel with its numbers, and the last line is
``{"ok": true, "device": {...}}``.

It needs the repository's ``src/repro_torch`` beside it and a CUDA device;
without either it exits non-zero and prints no result.  It imports nothing
of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

MAX_BATCH = 32
N_QUEUE = 70
N_CLASSES = 40
SEED = 0

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# device-memory rate, fp32 on the CUDA cores (no TF32), bf16 and int8
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12

# The TPU kernel each CUDA kernel replaces (its pl.pallas_call line), and
# its source.
REPLACES = {
    "knn": "src/repro/kernels/knn.py:64",
    "int8_matmul": "src/repro/kernels/int8_matmul.py:60",
    "fused_linear": "src/repro/kernels/fused_linear.py:55",
    "fps": "src/repro/kernels/fps.py:41",
    "grouped_transfer_stats": "src/repro/kernels/grouped_transfer.py:149",
    "grouped_transfer": "src/repro/kernels/grouped_transfer.py:173",
    "w8_matmul": "src/repro/kernels/int8_matmul.py:102",
    "flash_attention": "src/repro/kernels/flash_attention.py:98",
}
SOURCES = {"knn": "knn.cu", "int8_matmul": "int8_matmul.cu",
           "fused_linear": "fused_linear.cu", "fps": "fps.cu",
           "grouped_transfer_stats": "grouped_transfer.cu",
           "grouped_transfer": "grouped_transfer.cu",
           "w8_matmul": "w8_matmul.cu",
           "flash_attention": "flash_attention.cu"}
# The row of each kernel that the final line reports.
MAIN_ROW = {"int8_matmul": "stage1_transfer",
            "fused_linear": "stage1_transfer", "w8_matmul": "decode",
            "flash_attention": "tinyllama_fwd"}
# No path of the JAX package or of the port calls w8_matmul_pallas.
NO_PATH = {"w8_matmul": "no model path calls w8_matmul, in the JAX package "
                        "(its W8 deployment dequantizes in layers.py) or in "
                        "the port; it is held against its plain version "
                        "only"}
ELITE_POINTS = 1024
LM_ARCH = "tinyllama-1.1b"
LM_BATCH, LM_SEQ = 4, 2048
# bf16 logits, held against max|logit|.  bf16 keeps 8 significant bits;
# two routes that round at other places move hidden values by a bf16 step
# (2**-8 relative) here and there, and that spreads through the residual
# stream.  On an H100 the card vs the CPU at 2 layers differed by 9.1e-3
# to 1.05e-2 of max|logit|, the flash vs the plain route at 22 layers by
# 1.7e-2: these bounds leave a factor of about 2 and 3.
LM_TOL_2_LAYERS = 2e-2
LM_TOL_FULL = 5e-2


class SmokeFailure(RuntimeError):
    """A check of the smoke test failed."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gemm_work(kind: str, m: int, k: int, n: int, lanes: int):
    """(bytes, operations, peak) the function of one GEMM launch needs:
    each input read once and the f32 output written once; int8_matmul
    reads int8 operands and f32 scales (one a lane and a column)."""
    if kind == "int8_matmul":
        return (m * k + k * n + 4 * (lanes + n) + 4 * m * n, 2 * m * n * k,
                INT8_OPS_PER_S)
    return 4 * (m * k + k * n + n + m * n), 2 * m * n * k, FP32_OPS_PER_S


def median_ms(torch, fn, reps: int = 25, inner: int = 5,
              warmup: int = 3) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(torch, fn, launches: int = 20, reps: int = 15) -> float:
    """Device ms a call: median over ``reps`` CUDA-event windows of one
    replay of a CUDA graph holding ``launches`` calls of ``fn``.  No host
    time enters it, where back-to-back calls of a short kernel would time
    the Python wrapper instead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def make_clouds(np, rng, n: int, n_points: int):
    """Synthetic clouds: noisy spheres, box surfaces and cylinders with a
    random scale and offset per cloud."""
    out = np.empty((n, n_points, 3), np.float32)
    for i in range(n):
        u = rng.standard_normal((n_points, 3))
        kind = i % 3
        if kind == 0:
            p = u / np.linalg.norm(u, axis=1, keepdims=True)
        elif kind == 1:
            p = rng.uniform(-1, 1, (n_points, 3))
            face = rng.integers(0, 3, n_points)
            p[np.arange(n_points), face] = np.sign(u[:, 0])
        else:
            ang = rng.uniform(0, 2 * np.pi, n_points)
            p = np.stack([np.cos(ang), np.sin(ang),
                          rng.uniform(-1, 1, n_points)], axis=1)
        p = p * rng.uniform(0.5, 1.5) + rng.uniform(-0.2, 0.2, 3)
        out[i] = p + 0.01 * rng.standard_normal((n_points, 3))
    return out


def perturb_bn(torch, tree, gen):
    """Draw non-trivial BN statistics and affine alpha/beta, so neither
    the BN fold nor the geometric affine is an identity."""
    if isinstance(tree, dict):
        if "bn" in tree:
            c = tree["bn"]["gamma"].shape[0]
            tree["bn"] = {
                "gamma": 1 + 0.2 * torch.randn(c, generator=gen),
                "beta": 0.1 * torch.randn(c, generator=gen),
                "mean": 0.1 * torch.randn(c, generator=gen),
                "var": 0.5 + torch.rand(c, generator=gen),
            }
        if "affine" in tree:
            c = tree["affine"]["alpha"].shape[0]
            tree["affine"] = {
                "alpha": 0.7 + 0.6 * torch.rand(c, generator=gen),
                "beta": 0.1 * torch.randn(c, generator=gen),
            }
        for v in tree.values():
            perturb_bn(torch, v, gen)
    elif isinstance(tree, list):
        for v in tree:
            perturb_bn(torch, v, gen)


# ----------------------------------------------------------- numerics --

def numerics_phase(torch):
    """The port's device-independent forms of the two float ops whose
    PyTorch CUDA and CPU kernels round differently, on 2**20 values:
    they must agree bitwise; the plain forms are counted for the record."""
    from repro_torch.core.quant import _div_qmax
    gen = torch.Generator().manual_seed(SEED)
    x = torch.rand(1 << 20, generator=gen) * 10 + 1e-3
    xc = x.cuda()
    forms = {
        "div_by_python_scalar": (lambda a: a / 127, False),
        "div_by_device_tensor": (lambda a: _div_qmax(a, 127), True),
        "sqrt_float32": (torch.sqrt, False),
        "sqrt_float64_rounded": (lambda a: torch.sqrt(a.double()).float(),
                                 True),
    }
    out = {}
    for name, (fn, must_match) in forms.items():
        ndiff = int((fn(x) != fn(xc).cpu()).sum())
        out[name] = ndiff
        check(not must_match or ndiff == 0,
              f"numerics: {name} differs between card and CPU in {ndiff} "
              f"of {x.numel()} values")
    emit({"phase": "numerics", "values": x.numel(), "card_vs_cpu_ndiff": out})


# ------------------------------------------------------------ kernels --

def kernel_phase(torch, clouds):
    """Each kernel against its plain version at serving-path shapes."""
    from repro_torch.core import sampling
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_linear as fl_mod
    from repro_torch.kernels import int8_matmul as i8_mod
    from repro_torch.kernels import knn as knn_mod
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    b = MAX_BATCH
    xyz = torch.from_numpy(clouds[:b]).to(dev)
    rows = {}

    # kNN at stage 1 (S=256 of N=512) and stage 4 (S=32 of N=64), k=16,
    # on the URS-sampled centroids of real clouds.
    state = sampling.seed_streams(SEED, b)
    cur = xyz
    stages = {}
    for s, n_samp in enumerate((256, 128, 64, 32)):
        state, idx = sampling.urs_indices(state, cur.shape[1], n_samp)
        new = sampling.gather_points(cur, idx.to(dev)[None].expand(b, -1))
        stages[s] = (new.contiguous(), cur.contiguous())
        cur = new
    for label, s in (("stage1", 0), ("stage4", 3)):
        q, p = stages[s]
        got = knn_mod.knn_cuda(q, p, 16)
        want = ref.knn_ref(q, p, 16)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"knn {label}: kernel indices differ from the plain version")
        ms = median_ms(torch, lambda: knn_mod.knn_cuda(q, p, 16))
        plain_ms = median_ms(torch, lambda: ref.knn_ref(q, p, 16), reps=5)
        bsz, n_s, c = q.shape
        n_p = p.shape[1]
        # what the function needs, not what this kernel does: each point
        # read once, int32 indices (as the TPU kernel returns), and per
        # (query, point) pair 2C+2 distance flops plus one compare of a
        # streaming top-k (the kernel's k rounds of argmin do k compares)
        nbytes = 4 * (q.numel() + p.numel()) + 4 * bsz * n_s * 16
        nops = bsz * n_s * n_p * (2 * c + 3)
        rows[("knn", label)] = dict(
            shape=f"B={bsz} S={n_s} N={n_p} C={c} k=16", ms=ms,
            plain_ms=plain_ms, library_ms=None, max_abs_err=0.0,
            bytes=nbytes, ops=nops, peak=FP32_OPS_PER_S)

    # The three GEMM shapes of the check: Lite/M-2 stage-1 transfer,
    # stage-4 transfer and head fc1, at a dispatch of MAX_BATCH clouds.
    gen = torch.Generator().manual_seed(SEED + 1)
    shapes = {"stage1_transfer": (b * 256 * 16, 64, 64),
              "stage4_transfer": (b * 32 * 16, 512, 512),
              "head_fc1": (b, 512, 512)}
    for label, (m, k, n) in shapes.items():
        rpl = m // b
        x = torch.randn(m, k, generator=gen).to(dev)
        w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(dev)
        bias = (0.1 * torch.randn(n, generator=gen)).to(dev)

        # int8: per-lane activation quantization stays plain torch ops, as
        # in the wrapper; the kernel gets the int8 operands and scales.
        w_q = torch.randint(-127, 128, (k, n), generator=gen,
                            dtype=torch.int8).to(dev)
        w_scale = (torch.rand(n, generator=gen) / 127 + 1e-4).to(dev)
        x_q, a_scale = ops.quantize_activations(x, 8, b)
        got = i8_mod.int8_matmul_cuda(x_q, w_q, a_scale, w_scale, rpl)
        want = ref.int8_matmul_ref(x_q, w_q, a_scale, w_scale, rpl)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"int8_matmul {label}: kernel is not bitwise equal to the "
              f"plain version")
        # the GEMM rows' ms and library_ms are device times (graph_ms);
        # *_events_ms are the back-to-back windows of earlier runs
        kernel = lambda: i8_mod.int8_matmul_cuda(  # noqa: E731
            x_q, w_q, a_scale, w_scale, rpl)
        ms, events_ms = graph_ms(torch, kernel), median_ms(torch, kernel)
        plain_ms = median_ms(torch, lambda: ref.int8_matmul_ref(
            x_q, w_q, a_scale, w_scale, rpl), reps=10)
        lib_ms = lib_events_ms = None
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            # torch._int_mm: int8 x int8 -> int32 only (no dequantize)
            lib_ms = graph_ms(torch, lambda: torch._int_mm(x_q, w_q))
            lib_events_ms = median_ms(torch, lambda: torch._int_mm(x_q, w_q))
        nbytes, nops, peak = gemm_work("int8_matmul", m, k, n, b)
        rows[("int8_matmul", label)] = dict(
            shape=f"M={m} K={k} N={n} lanes={b}",
            template=i8_mod.template(k, n, _build.aligned16(x_q, w_q)).name,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=0.0,
            events_ms=events_ms, library_events_ms=lib_events_ms,
            bytes=nbytes, ops=nops, peak=peak)

        got = fl_mod.fused_linear_cuda(x, w, bias, "relu")
        want = ref.fused_linear_ref(x, w, bias, "relu")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"fused_linear {label}: max abs err {err} beyond rtol=atol=1e-5")
        kernel = lambda: fl_mod.fused_linear_cuda(  # noqa: E731
            x, w, bias, "relu")
        ms, events_ms = graph_ms(torch, kernel), median_ms(torch, kernel)
        plain_ms = median_ms(torch, lambda: ref.fused_linear_ref(
            x, w, bias, "relu"))
        # torch.addmm: bias + x @ w in one call (no ReLU)
        lib_ms = graph_ms(torch, lambda: torch.addmm(bias, x, w))
        lib_events_ms = median_ms(torch, lambda: torch.addmm(bias, x, w))
        nbytes, nops, peak = gemm_work("fused_linear", m, k, n, b)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rows[("fused_linear", label)] = dict(
            shape=f"M={m} K={k} N={n}",
            template=fl_mod.template(m, k, n, _build.aligned16(x, w),
                                     sms).name,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
            events_ms=events_ms, library_events_ms=lib_events_ms,
            bytes=nbytes, ops=nops, peak=peak)

    return emit_rows(rows)


def emit_rows(rows):
    """Add each row's bound (bytes or operations at the published peaks)
    and print it."""
    for (name, label), r in rows.items():
        r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                  r["ops"] / r["peak"])
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["ops"] / r["peak"] else "operations")
        emit({"phase": "kernel", "name": name, "at": label,
              **{k: v for k, v in r.items() if k != "peak"}})
    return rows


def elite_kernel_phase(torch, clouds):
    """FPS and both grouped_transfer kernels against their plain versions
    at Elite's stage-1 and stage-4 shapes, on the FPS/kNN geometry of
    real 1024-point clouds."""
    from repro_torch.core import knn as knn_core
    from repro_torch.core import sampling
    from repro_torch.kernels import fps as fps_mod
    from repro_torch.kernels import grouped_transfer as gt_mod
    from repro_torch.kernels import knn as knn_mod
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    b = MAX_BATCH
    cur = torch.from_numpy(clouds[:b]).to(dev)
    rows, geo = {}, {}
    for s, n_samp in enumerate((512, 256, 128, 64)):
        idx = fps_mod.fps_cuda(cur, n_samp)
        want = ref.fps_ref(cur, n_samp)
        torch.cuda.synchronize()
        check(torch.equal(idx, want),
              f"fps stage {s + 1}: kernel indices differ from the plain "
              f"version")
        new = sampling.gather_points(cur, idx).contiguous()
        geo[s] = (cur, idx, knn_mod.knn_cuda(new, cur, 16))
        cur = new

    for label, s in (("stage1", 0), ("stage4", 3)):
        pts, idx, _ = geo[s]
        bsz, n, c = pts.shape
        n_samp = idx.shape[1]
        ms = median_ms(torch, lambda: fps_mod.fps_cuda(pts, n_samp))
        plain_ms = median_ms(torch, lambda: ref.fps_ref(pts, n_samp),
                             reps=3, inner=1, warmup=1)
        # what the function needs: each point read once, int32 indices
        # out, and per (point, step) 3C flops plus one compare
        rows[("fps", label)] = dict(
            shape=f"B={bsz} N={n} S={n_samp}", ms=ms, plain_ms=plain_ms,
            library_ms=None, max_abs_err=0.0, ms_per_step=ms / n_samp,
            bytes=4 * pts.numel() + 4 * bsz * n_samp,
            ops=bsz * n * (n_samp - 1) * (3 * c + 1), peak=FP32_OPS_PER_S)

    gen = torch.Generator().manual_seed(SEED + 2)
    for label, s, c, c_out in (("stage1", 0, 32, 64),
                               ("stage4", 3, 256, 512)):
        pts, idx, nbr = geo[s]
        n, n_samp, k = pts.shape[1], idx.shape[1], nbr.shape[2]
        feats = torch.randn(b, n, c, generator=gen).to(dev)
        centers = sampling.gather_points(feats, idx).contiguous()
        alpha = (0.7 + 0.6 * torch.rand(c, generator=gen)).to(dev)
        beta = (0.1 * torch.randn(c, generator=gen)).to(dev)
        w = (torch.randn(2 * c, c_out, generator=gen)
             / (2 * c) ** 0.5).to(dev)
        bias = (0.1 * torch.randn(c_out, generator=gen)).to(dev)
        off = knn_core.gather_neighbors(feats, nbr) - centers[:, :, None, :]
        sigma = knn_core.group_sigma(off, per_sample=True).reshape(-1)
        sigma = sigma.contiguous()
        aff = {"alpha": alpha, "beta": beta}

        def unfused():
            """The unfused path at this shape: torch gather and normalize
            ops, then the fused_linear kernel."""
            x = knn_core.normalize_group(knn_core.gather_neighbors(feats, nbr),
                                         centers, aff, "affine",
                                         per_sample=True)
            x = torch.cat([x, centers[:, :, None, :].expand_as(x)], dim=-1)
            return ops.fused_linear(x, w, bias, "relu")

        unfused_out = unfused()
        unfused_ms = median_ms(torch, unfused)
        variants = (
            ("grouped_transfer_stats",
             lambda: gt_mod.grouped_transfer_stats_cuda(
                 feats, nbr, centers, alpha, beta, w, bias),
             lambda: ref.grouped_transfer_ref(
                 feats, nbr, centers, None, alpha, beta, w, bias)),
            ("grouped_transfer",
             lambda: gt_mod.grouped_transfer_cuda(
                 feats, nbr, centers, sigma, alpha, beta, w, bias),
             lambda: ref.grouped_transfer_ref(
                 feats, nbr, centers, sigma, alpha, beta, w, bias)))
        for name, kernel, plain in variants:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                  f"{name} {label}: max abs err {err} beyond rtol=atol=1e-5")
            bitwise = bool(torch.equal(got, unfused_out))
            if name == "grouped_transfer":
                # the card's witness that both kernels keep fused_linear's
                # in-order fmaf chain
                check(bitwise, f"{name} {label}: not bitwise equal to the "
                               f"unfused path (fused_linear on the same "
                               f"rows)")
            ms = median_ms(torch, kernel)
            plain_ms = median_ms(torch, plain, reps=10)
            # feats, int32 indices, centres, alpha/beta, w, b and the
            # output once each; 2 * 2C * C_out flops per output row
            nbytes = 4 * (feats.numel() + nbr.numel() + centers.numel()
                          + 2 * c + w.numel() + c_out + got.numel())
            if name == "grouped_transfer":
                nbytes += 4 * b
            rows[(name, label)] = dict(
                shape=f"B={b} N={n} S={n_samp} k={k} C={c} C_out={c_out}",
                ms=ms, plain_ms=plain_ms, library_ms=None, max_abs_err=err,
                unfused_ms=unfused_ms,
                bitwise_vs_unfused=bitwise,
                bytes=nbytes, ops=2 * b * n_samp * k * 2 * c * c_out,
                peak=FP32_OPS_PER_S)
    return emit_rows(rows)


# ------------------------------------------------------------ serving --

def counters():
    from repro_torch.kernels import (flash_attention, fps, fused_linear,
                                     grouped_transfer, int8_matmul, knn)
    return {"knn": knn.knn_cuda, "int8_matmul": int8_matmul.int8_matmul_cuda,
            "fused_linear": fused_linear.fused_linear_cuda,
            "fps": fps.fps_cuda,
            "grouped_transfer_stats":
                grouped_transfer.grouped_transfer_stats_cuda,
            "grouped_transfer": grouped_transfer.grouped_transfer_cuda,
            "w8_matmul": int8_matmul.w8_matmul_cuda,
            "flash_attention": flash_attention.flash_attention_cuda}


def counted(torch, fn):
    """Run ``fn`` with every launch count set to 0 just before it; return
    (its result, the counts just after)."""
    fns = counters()
    for f in fns.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in fns.items()}


def expect_launches(name, launches, expect, dispatches=1):
    for kname, n in launches.items():
        per = expect.get(kname, 0)
        check(n == per * dispatches,
              f"{name}: {kname} launched {n} times over {dispatches} "
              f"dispatches, expected {per} per dispatch")


def mapping_chain(torch, clouds, state, device, spec, k: int = 16):
    """Sampler indices (URS or FPS) and per-stage kNN indices of one
    dispatch, through the port's core functions on ``device`` (geometry
    only)."""
    from repro_torch.core import knn, sampling
    cur = torch.from_numpy(clouds).to(device)
    b = cur.shape[0]
    out = []
    for n_samp in spec.to_model_config().stage_samples:
        if spec.sampler == "fps":
            idx = sampling.fps(cur, n_samp)
        else:
            state, idx = sampling.urs_indices(state, cur.shape[1], n_samp)
            idx = idx.to(device)[None].expand(b, -1)
        new = sampling.gather_points(cur, idx)
        out.append((idx.cpu(), knn.knn_batched(new, cur, k).cpu()))
        cur = new
    return out


def profile_call(torch, fn):
    """Run ``fn`` once to warm up, then once under torch.profiler: (host
    wall ms of the profiled call, device us per kernel name, device
    events: kernel launches and copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, events = {}, 0
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): the aten op rows
        # carry the same device time again
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0) + us
            events += ev.count
    return wall_ms, by_name, events


def profile_summary(wall_ms, by_name, events, **named):
    """Device ms, idle share, device events, the ms of each ``named`` group
    of kernel-name fragments, and the ten largest kernels."""
    dev_ms = sum(by_name.values()) / 1e3

    def kernel_ms(*names):
        return sum(us for name, us in by_name.items()
                   if any(k in name for k in names)) / 1e3
    out = {"wall_ms": wall_ms,
           "device_ms": dev_ms if by_name else "not measured",
           "idle_share": (1 - dev_ms / wall_ms) if by_name else
           "not measured",
           "device_events": events if by_name else "not measured"}
    for key, names in named.items():
        out[key] = kernel_ms(*names) if by_name else "not measured"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out["top"] = [[name[:70], us / 1e3] for name, us in top]
    return out


def gemm_bounds(torch, pipe, chunk, state):
    """The GEMM launches of one dispatch, recorded from the shapes the
    ``int8_matmul`` and ``fused_linear`` wrappers are given: per kernel,
    the launches and the sum of their bounds (ms)."""
    from repro_torch.kernels import ops
    shapes = []
    int8_cuda, fused_cuda = ops.int8_matmul_cuda, ops.fused_linear_cuda

    def int8_rec(x_q, w_q, a_scale, w_scale, rows_per_lane):
        shapes.append(("int8_matmul", *x_q.shape, w_q.shape[1],
                       a_scale.numel()))
        return int8_cuda(x_q, w_q, a_scale, w_scale, rows_per_lane)

    def fused_rec(x, w, b, activation="relu"):
        shapes.append(("fused_linear", *x.shape, w.shape[1], 0))
        return fused_cuda(x, w, b, activation)

    ops.int8_matmul_cuda, ops.fused_linear_cuda = int8_rec, fused_rec
    try:
        pipe.infer(chunk, state.clone())
        torch.cuda.synchronize()
    finally:
        ops.int8_matmul_cuda, ops.fused_linear_cuda = int8_cuda, fused_cuda
    out = {kind: {"launches": 0, "bound_ms": 0.0}
           for kind in ("int8_matmul", "fused_linear")}
    for kind, m, k, n, lanes in shapes:
        nbytes, nops, peak = gemm_work(kind, m, k, n, lanes)
        out[kind]["launches"] += 1
        out[kind]["bound_ms"] += 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                           nops / peak)
    return out


def profile_dispatch(torch, pipe, chunk, state):
    """Device time per kernel name over one dispatch (torch.profiler),
    with each GEMM kernel's ms beside the summed bound of its launches."""
    wall_ms, by_name, events = profile_call(
        torch, lambda: pipe.infer(chunk, state.clone()))
    out = profile_summary(
        wall_ms, by_name, events,
        port_kernels_ms=("knn_kernel", "int8_matmul_kernel",
                         "fused_linear_wide_kernel",
                         "fused_linear_small_kernel", "fps_kernel",
                         "grouped_transfer"),
        fps_ms=("fps_kernel",),
        int8_matmul_kernel_ms=("int8_matmul_kernel",),
        fused_linear_kernel_ms=("fused_linear_wide_kernel",
                                "fused_linear_small_kernel"))
    dev_ms = out["device_ms"]
    out["fps_share"] = (out["fps_ms"] / dev_ms if by_name
                        else "not measured")
    for kind, got in gemm_bounds(torch, pipe, chunk, state).items():
        out[f"{kind}_launches"] = got["launches"]
        out[f"{kind}_bound_ms"] = got["bound_ms"]
    return out


def serving_phase(torch, name, spec, params, clouds, expect,
                  atol_rel: float, why: str):
    from repro_torch.serve.batching import pad_to_batch
    from repro_torch.serve.pointcloud import PointCloudEngine

    eng = PointCloudEngine(params, spec, max_batch=MAX_BATCH, seed=SEED)
    cpu = PointCloudEngine(params, spec, max_batch=MAX_BATCH, seed=SEED,
                           device="cpu")
    check(eng.device.type == "cuda", f"{name}: engine is not on the card")
    warm_s = eng.warmup()
    state0 = eng.lfsr_state

    # The mapping chain of the first dispatch, card against CPU.
    on_card = mapping_chain(torch, clouds[:MAX_BATCH], state0, "cuda", spec)
    on_cpu = mapping_chain(torch, clouds[:MAX_BATCH], state0, "cpu", spec)
    for s, ((gi, gn), (ci, cn)) in enumerate(zip(on_card, on_cpu)):
        check(torch.equal(gi, ci),
              f"{name}: {spec.sampler} indices differ at stage {s}")
        check(torch.equal(gn, cn),
              f"{name}: kNN indices differ on the card at stage {s}")

    # The main path, counted: a ragged queue through the engine.
    logits, launches = counted(torch, lambda: eng.classify(clouds))
    dispatches = eng.stats.batches
    check(len(clouds) % MAX_BATCH != 0, f"{name}: the queue is not ragged")
    expect_launches(name, launches, expect, dispatches)

    ref_logits = cpu.classify(clouds)
    got = logits.cpu()
    check(got.shape == (len(clouds), N_CLASSES) and bool(
        torch.isfinite(got).all()), f"{name}: logits not finite "
          f"[{len(clouds)}, {N_CLASSES}]")
    err = (got - ref_logits).abs().max().item()
    scale = ref_logits.abs().max().item()
    check(err <= atol_rel * scale,
          f"{name}: card vs CPU max abs err {err} > {atol_rel} * {scale}")
    bitwise = bool(torch.equal(got, ref_logits))
    top1 = (got.argmax(-1) == ref_logits.argmax(-1)).float().mean().item()

    # A request alone (zero-padded dispatch) against the same request
    # inside a full dispatch, from the same LFSR state: bitwise.
    pipe = eng.pipeline
    full = torch.from_numpy(clouds[:MAX_BATCH]).cuda()
    alone, _ = pad_to_batch(full[3:4], MAX_BATCH)
    a, _ = pipe.infer(full, state0.clone())
    b, _ = pipe.infer(alone, state0.clone())
    torch.cuda.synchronize()
    check(torch.equal(a[3], b[0]),
          f"{name}: a lane's logits depend on the rest of its dispatch")

    # Throughput over repeated queues (the engine's own serve_s timer).
    eng.stats.reset()
    for _ in range(5):
        eng.classify(clouds)
    sps = eng.stats.samples_per_s
    prof = profile_dispatch(torch, pipe, full, state0)
    emit({"phase": "serve", "name": name, "warmup_s": warm_s,
          "dispatches": dispatches, "launches": launches,
          "per_dispatch": {k: v / dispatches for k, v in launches.items()},
          "max_abs_err_vs_cpu": err, "max_abs_logit": scale,
          "bitwise_vs_cpu": bitwise,
          "tolerance": f"{atol_rel} * max|logit|", "why": why,
          "top1_agree": top1, "samples_per_s": sps,
          "serve_s": eng.stats.serve_s, "host_s": eng.stats.host_s,
          "profile": prof})
    return launches


def elite_variants_phase(torch, fused_spec, params, clouds):
    """Elite's other two lowerings, one full dispatch each on the card:
    unfused (the grouper's torch ops + fused_linear for the transfer),
    held against the fused serving pipeline; and batch-global sigma (the
    spec without ``.serving()``), held against the CPU."""
    from repro_torch.api.build import build
    full = torch.from_numpy(clouds[:MAX_BATCH]).cuda()
    fused = build(fused_spec, params)
    state = fused.seed_state(SEED, MAX_BATCH)
    want, _ = fused.infer(full, state.clone())

    unfused = build(fused_spec.replace(fused_group="none"), params)
    (got, _), launches = counted(
        torch, lambda: unfused.infer(full, state.clone()))
    expect_launches("elite unfused", launches,
                    {"fps": 4, "knn": 4, "fused_linear": 27})
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= 1e-5 * scale, f"elite: unfused vs fused max abs err {err} "
          f"> 1e-5 * {scale}")
    emit({"phase": "elite_unfused", "launches": launches,
          "max_abs_err_vs_fused": err, "max_abs_logit": scale,
          "bitwise_fused_vs_unfused": bool(torch.equal(got, want)),
          "tolerance": "1e-5 * max|logit|",
          "why": "the same mapping, sigma from the same ops, and the fused "
                 "kernel's product in fused_linear's fmaf order: equal but "
                 "for sigma's float64 sum order (one rounding to f32)"})
    total = dict(launches)

    batch_spec = fused_spec.replace(shared_urs=False, per_sample_norm=False)
    pipe = build(batch_spec, params)
    (got, _), launches = counted(
        torch, lambda: pipe.infer(full, state.clone()))
    expect_launches("elite batch sigma", launches,
                    {"fps": 4, "knn": 4, "grouped_transfer": 4,
                     "fused_linear": 23})
    want, _ = build(batch_spec, params, device="cpu").infer(full.cpu(),
                                                            state.clone())
    got = got.cpu()
    check(bool(torch.isfinite(got).all()), "elite batch sigma: not finite")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= 1e-4 * scale, f"elite batch sigma: card vs CPU max abs err "
          f"{err} > 1e-4 * {scale}")
    emit({"phase": "elite_batch_sigma", "launches": launches,
          "max_abs_err_vs_cpu": err, "max_abs_logit": scale,
          "bitwise_vs_cpu": bool(torch.equal(got, want)),
          "tolerance": "1e-4 * max|logit|"})
    for k, v in launches.items():
        total[k] += v
    return total


# ---------------------------------------------------------------- LM ---

def attention_pairs(tq: int, tk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, per batch and head."""
    total = 0
    for i in range(tq):
        qpos = i + tk - tq
        hi = min(qpos, tk - 1) if causal else tk - 1
        lo = max(0, qpos - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def rowwise_close(torch, got, want, tol: float):
    """|got - want| <= tol * |want| + tol * (max |want| of its row), rows
    along the last axis: an output rounded to bf16 may land one step
    (2**-8 of its value) from the plain version's, and the absolute slack
    follows each row's own scale, not the tensor's largest value.
    -> (ok, max abs err, smallest and largest row atol, largest
    err / allowed)."""
    g, w = got.float(), want.float()
    atol = tol * w.abs().amax(dim=-1, keepdim=True)
    allowed = tol * w.abs() + atol
    diff = (g - w).abs()
    ratio = torch.where(allowed > 0, diff / allowed.clamp_min(1e-30),
                        torch.where(diff > 0, float("inf"), 0.0))
    worst = ratio.max().item()
    ok = bool(torch.isfinite(g).all()) and worst <= 1.0
    return (ok, diff.max().item(), atol.min().item(), atol.max().item(),
            worst)


def lm_kernel_phase(torch):
    """The flash-attention and W8A16 kernels against their plain versions
    at the LM's shapes (tinyllama: 32 query heads over 4 KV heads, head
    dim 64, 2048 tokens)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import int8_matmul as i8_mod
    from repro_torch.kernels import ref
    from repro_torch.models.layers import f32_sums

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = {}
    b, h, hkv, t = LM_BATCH, 32, 4, LM_SEQ
    cases = (("tinyllama_fwd", h, hkv, t, t, 64, torch.bfloat16, True, 0),
             ("d128", 16, 4, t, t, 128, torch.bfloat16, True, 0),
             ("window256", h, hkv, t, t, 64, torch.bfloat16, True, 256),
             ("decode_q1", h, hkv, 1, 200, 64, torch.bfloat16, True, 0),
             ("noncausal_200", h, hkv, 200, 200, 64, torch.bfloat16, False,
              0),
             ("fp32", h, hkv, 512, 512, 64, torch.float32, True, 0),
             ("d16_window8", 8, 2, 256, 256, 16, torch.bfloat16, True, 8))
    for label, nh, nkv, tq, tk, d, dt, causal, win in cases:
        q = torch.randn(b, nh, tq, d, generator=gen, device=dev).to(dt)
        k = torch.randn(b, nkv, tk, d, generator=gen, device=dev).to(dt)
        v = torch.randn(b, nkv, tk, d, generator=gen, device=dev).to(dt)
        got = fa_mod.flash_attention_cuda(q, k, v, causal, win)
        want = ref.attention_ref(q, k, v, causal, win)
        torch.cuda.synchronize()
        # bf16: the output is rounded to bf16, so a value near a rounding
        # boundary may land one bf16 step away; f32: the sums run in
        # another order (tile order of the rescale)
        tol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
        ok, err, atol_lo, atol_hi, worst = rowwise_close(torch, got, want,
                                                         tol)
        check(ok, f"flash_attention {label}: max abs err {err}, "
                  f"{worst} x its allowance (rtol={tol}, atol={tol} * "
                  f"max|out| of the row, {atol_lo}..{atol_hi})")
        ms = median_ms(torch, lambda: fa_mod.flash_attention_cuda(
            q, k, v, causal, win))
        plain_ms = median_ms(torch, lambda: ref.attention_ref(
            q, k, v, causal, win), reps=5)
        lib_ms = None
        if tq == tk and win == 0:
            # SDPA's is_causal is top-left aligned: the same function only
            # where Tq == Tk
            lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))
        pairs = b * nh * attention_pairs(tq, tk, causal, win)
        nops = 4 * pairs * d
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        rows[("flash_attention", label)] = dict(
            shape=f"B={b} H={nh} Hkv={nkv} Tq={tq} Tk={tk} D={d} "
                  f"{str(dt)[6:]} causal={causal} window={win}",
            kernel_route=fa_mod.route(dt, d), tflops=nops / ms / 1e9,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
            tolerance=f"rtol={tol}, atol={tol} * max|out| of the row",
            atol_range=[atol_lo, atol_hi], err_over_allowed=worst,
            bytes=nbytes,
            ops=nops, peak=BF16_OPS_PER_S if dt == torch.bfloat16
            else FP32_OPS_PER_S,
            bound_ms_fp32_peak=1e3 * max(nbytes / HBM_BYTES_PER_S,
                                         nops / FP32_OPS_PER_S))

    # W8A16 at tinyllama's MLP up-projection, decode (4 tokens) and
    # prefill (4 x 2048 tokens) shapes.
    for label, m in (("decode", LM_BATCH), ("prefill", LM_BATCH * LM_SEQ)):
        kk, n = 2048, 5632
        x = torch.randn(m, kk, generator=gen, device=dev).to(torch.bfloat16)
        w_q = torch.randint(-127, 128, (kk, n), generator=gen, device=dev,
                            dtype=torch.int8)
        w_scale = torch.rand(n, generator=gen, device=dev) / 127 + 1e-4
        got = i8_mod.w8_matmul_cuda(x, w_q, w_scale)
        want = ref.w8_matmul_plain(x, w_q, w_scale)
        torch.cuda.synchronize()
        tol = 2.0 ** -7
        ok, err, atol_lo, atol_hi, worst = rowwise_close(torch, got, want,
                                                         tol)
        check(ok, f"w8_matmul {label}: max abs err {err}, {worst} x its "
                  f"allowance (rtol={tol}, atol={tol} * max|out| of the "
                  f"row, {atol_lo}..{atol_hi})")
        ms = median_ms(torch, lambda: i8_mod.w8_matmul_cuda(x, w_q, w_scale))
        plain_ms = median_ms(torch, lambda: ref.w8_matmul_plain(
            x, w_q, w_scale))
        w_deq = (w_q.float() * w_scale).to(torch.bfloat16)
        with f32_sums():
            deq_ms = median_ms(torch, lambda: x @ w_deq)
        nbytes = 2 * m * kk + kk * n + 4 * n + 2 * m * n
        nops = 2 * m * kk * n
        rows[("w8_matmul", label)] = dict(
            shape=f"M={m} K={kk} N={n} bf16", ms=ms, plain_ms=plain_ms,
            library_ms=None, max_abs_err=err,
            tolerance=f"rtol={tol}, atol={tol} * max|out| of the row",
            atol_range=[atol_lo, atol_hi], err_over_allowed=worst,
            dequantized_matmul_ms=deq_ms,
            dequantized_matmul_note="x @ w_dequant (bf16, weight "
            "dequantized beforehand): not the same function, for "
            "comparison only",
            bytes=nbytes, ops=nops, peak=BF16_OPS_PER_S,
            bound_ms_fp32_peak=1e3 * max(nbytes / HBM_BYTES_PER_S,
                                         nops / FP32_OPS_PER_S))
    return emit_rows(rows)


def lm_tokens(np, vocab: int, b: int, t: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, t)).astype(np.int64)


def rel_err(a, b):
    """max|a - b| and max|b| of two logit tensors (on any device)."""
    return ((a.float() - b.float()).abs().max().item(),
            b.float().abs().max().item())


def lm_forward_phase(torch, np, params, cfg):
    """Score LM_BATCH x LM_SEQ random ids through the flash route (the
    kernel, once per layer) and the plain-attention route on the card."""
    import torch.nn.functional as F
    from repro_torch.models.api import get_model

    ids = torch.from_numpy(lm_tokens(np, cfg.vocab_size, LM_BATCH, LM_SEQ,
                                     SEED)).cuda()
    apis = {impl: get_model(cfg.replace(attn_impl=impl))
            for impl in ("flash", "xla")}
    out, launches, tok_s = {}, {}, {}
    for impl, api in apis.items():
        (logits, aux), launches[impl] = counted(
            torch, lambda: api.forward(params, ids))
        check(logits.shape == (LM_BATCH, LM_SEQ, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()) and aux.item() == 0,
              f"lm forward {impl}: logits not finite [{LM_BATCH}, "
              f"{LM_SEQ}, {cfg.vocab_size}]")
        out[impl] = logits
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.forward(params, ids)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        tok_s[impl] = LM_BATCH * LM_SEQ / statistics.median(times)
    expect_launches("lm forward flash", launches["flash"],
                    {"flash_attention": cfg.n_layers})
    expect_launches("lm forward xla", launches["xla"], {})
    err, scale = rel_err(out["flash"], out["xla"])
    check(err <= LM_TOL_FULL * scale,
          f"lm forward: flash vs xla max abs err {err} > {LM_TOL_FULL} * "
          f"{scale}")
    top1 = (out["flash"].argmax(-1) == out["xla"].argmax(-1)).float().mean()
    del out
    # The gate activation on the card is one F.silu; the CPU keeps XLA-CPU's
    # five-op expansion of logistic (bitwise parity).  What the expansion
    # would cost a forward here, at the gate's shape:
    gate = torch.randn(LM_BATCH * LM_SEQ, cfg.d_ff, device="cuda",
                       dtype=torch.bfloat16)
    silu_ms = {"f_silu": median_ms(torch, lambda: F.silu(gate)),
               "expanded": median_ms(
                   torch, lambda: gate * (1 / (1 + torch.exp(-gate))))}
    del gate
    prof = profile_summary(*profile_call(
        torch, lambda: apis["flash"].forward(params, ids)),
        flash_ms=("flash_attention_wgmma_kernel",
                  "flash_attention_ffma_kernel"))
    check(prof["flash_ms"] == "not measured" or prof["flash_ms"] > 0,
          "lm forward: the profile found no flash_attention kernel by name")
    emit({"phase": "lm_forward", "arch": cfg.name, "layers": cfg.n_layers,
          "batch": LM_BATCH, "seq": LM_SEQ, "dtype": cfg.dtype,
          "launches": launches["flash"],
          "max_abs_err_flash_vs_xla": err, "max_abs_logit": scale,
          "tolerance": f"{LM_TOL_FULL} * max|logit|",
          "top1_agree": top1.item(), "tokens_per_s": tok_s,
          "profile_flash": prof, "silu_ms_per_layer": silu_ms,
          "silu_expansion_ms_per_forward": cfg.n_layers * (
              silu_ms["expanded"] - silu_ms["f_silu"])})
    return launches["flash"]


def lm_cpu_phase(torch, np, cfg):
    """The LM cut to 2 layers at full width, B=2 T=128: the card (flash
    kernel) against the CPU (plain versions)."""
    from repro_torch.api.build import to_device
    from repro_torch.models.api import get_model

    cut = cfg.replace(n_layers=2, attn_impl="flash")
    api = get_model(cut)
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED + 5))
    ids = torch.from_numpy(lm_tokens(np, cut.vocab_size, 2, 128, SEED + 1))
    (got, _), launches = counted(torch, lambda: api.forward(params,
                                                            ids.cuda()))
    expect_launches("lm 2 layers", launches, {"flash_attention": 2})
    want, _ = api.forward(to_device(params, "cpu"), ids)
    got = got.cpu()
    check(bool(torch.isfinite(got).all()), "lm 2 layers: not finite")
    err, scale = rel_err(got, want)
    check(err <= LM_TOL_2_LAYERS * scale,
          f"lm 2 layers: card vs CPU max abs err {err} > "
          f"{LM_TOL_2_LAYERS} * {scale}")
    emit({"phase": "lm_card_vs_cpu", "layers": 2, "batch": 2, "seq": 128,
          "launches": launches, "max_abs_err_vs_cpu": err,
          "max_abs_logit": scale,
          "tolerance": f"{LM_TOL_2_LAYERS} * max|logit|",
          "top1_agree": (got.argmax(-1) == want.argmax(-1)).float().mean()
          .item()})
    return launches


def lm_generate_phase(torch, np, params, cfg):
    """Engine.generate: B=4, a 512-token prompt, 32 greedy tokens.  The
    last decode step's logits are held against the flash forward on the
    prompt extended by the generated ids."""
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import Engine

    prompt_len, n_gen = 512, 32
    api = get_model(cfg.replace(attn_impl="flash"))
    eng = Engine(api, params, max_len=prompt_len + n_gen,
                 batch_size=LM_BATCH)
    prompt = torch.from_numpy(lm_tokens(np, cfg.vocab_size, LM_BATCH,
                                        prompt_len, SEED + 2))
    eng.generate({"tokens": prompt}, n_gen)            # warm-up
    out, launches = counted(torch, lambda: eng.generate({"tokens": prompt},
                                                        n_gen))
    expect_launches("lm generate", launches, {})
    ids = out["ids"]
    check(ids.shape == (LM_BATCH, n_gen) and int(ids.min()) >= 0
          and int(ids.max()) < cfg.vocab_size, "lm generate: bad ids")
    full = torch.cat([prompt.cuda(), ids], dim=1)
    want, _ = api.forward(params, full)
    want = want[:, -1]
    err, scale = rel_err(out["logits"], want)
    check(err <= LM_TOL_FULL * scale,
          f"lm generate: last decode logits vs forward max abs err {err} > "
          f"{LM_TOL_FULL} * {scale}")
    # one decode step alone, under the profiler, at the prompt's end
    cache = api.init_cache(LM_BATCH, prompt_len + 1)
    _, cache = api.prefill(params, {"tokens": prompt.cuda()}, cache)
    step = {"token": ids[:, 0], "pos": prompt_len}
    prof = profile_summary(*profile_call(
        torch, lambda: api.decode_step(params, step, cache)))
    st = out["stats"]
    emit({"phase": "lm_generate", "batch": LM_BATCH, "prompt": prompt_len,
          "new_tokens": n_gen, "launches": launches,
          "prefill_ms": 1e3 * st.prefill_s,
          "decode_tokens_per_s": st.decode_tok_per_s,
          "decode_ms_per_step": 1e3 * st.decode_s / n_gen,
          "max_abs_err_last_logits_vs_forward": err, "max_abs_logit": scale,
          "tolerance": f"{LM_TOL_FULL} * max|logit|",
          "top1_agree": (out["logits"].argmax(-1) == want.argmax(-1))
          .float().mean().item(), "profile_decode_step": prof})
    return launches


def lm_phases(torch, np):
    """The LM phases on tinyllama-1.1b at full width and depth (bf16,
    random weights from a seed): (kernel rows, launches on main paths)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import param_count

    rows = lm_kernel_phase(torch)
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    emit({"phase": "lm_init", "arch": cfg.name,
          "params": param_count(params), "seconds": time.perf_counter() - t0})
    total = dict(lm_forward_phase(torch, np, params, cfg))
    for launches in (lm_cpu_phase(torch, np, cfg),
                     lm_generate_phase(torch, np, params, cfg)):
        for k, v in launches.items():
            total[k] += v
    return rows, total


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch is missing; run it from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.api.spec import elite_spec, lite_spec, m2_spec
    from repro_torch.kernels import _build
    from repro_torch.models.pointmlp import pointmlp_init

    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": sorted(_build.SIGNATURES), "card": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    numerics_phase(torch)
    rng = np.random.default_rng(SEED)
    clouds = make_clouds(np, rng, N_QUEUE, 512)
    elite_clouds = make_clouds(np, rng, N_QUEUE, ELITE_POINTS)
    rows = kernel_phase(torch, clouds)
    rows.update(elite_kernel_phase(torch, elite_clouds))

    gen = torch.Generator().manual_seed(SEED)
    lite = lite_spec(N_CLASSES).serving().replace(backend="cuda")
    params = pointmlp_init(lite.to_model_config(), gen)
    perturb_bn(torch, params, gen)
    total = {k: 0 for k in REPLACES}
    got = serving_phase(
        torch, "lite", lite, params, clouds,
        expect={"knn": 4, "int8_matmul": 28},
        atol_rel=0.0,
        why="bitwise: kNN and URS indices are checked identical; every "
            "int8 product is exact and dequantizes in the same f32 order on "
            "both devices; the other ops are IEEE-rounded alike, with "
            "sigma's mean and root taken in float64 and rounded once and "
            "every division by a device tensor")
    for k, v in got.items():
        total[k] += v

    m2 = m2_spec(N_CLASSES).serving().replace(backend="cuda")
    got = serving_phase(
        torch, "m2", m2, params, clouds,
        expect={"knn": 4, "fused_linear": 27},
        atol_rel=1e-4,
        why="indices are identical; each fp32 layer sums K <= 512 products "
            "in another order than the CPU (relative error ~sqrt(K) ulp, "
            "about 1e-6), compounded over 15 layers in sequence stays well "
            "under 1e-4 of the largest logit")
    for k, v in got.items():
        total[k] += v

    gen = torch.Generator().manual_seed(SEED + 3)
    elite = elite_spec(N_CLASSES).serving().replace(
        backend="cuda", fused_group="grouped_transfer")
    elite_params = pointmlp_init(elite.to_model_config(), gen)
    perturb_bn(torch, elite_params, gen)
    got = serving_phase(
        torch, "elite", elite, elite_params, elite_clouds,
        expect={"fps": 4, "knn": 4, "grouped_transfer_stats": 4,
                "fused_linear": 23},
        atol_rel=1e-4,
        why="FPS and kNN indices are identical; fp32 layers sum K <= 512 "
            "products in another order than the CPU, compounded over 15 "
            "layers, as for M-2")
    for k, v in got.items():
        total[k] += v
    got = elite_variants_phase(torch, elite, elite_params, elite_clouds)
    for k, v in got.items():
        total[k] += v
    del elite_params, params
    lm_rows, got = lm_phases(torch, np)
    rows.update(lm_rows)
    for k, v in got.items():
        total[k] += v

    kernels = []
    for name in REPLACES:
        r = rows[(name, MAIN_ROW.get(name, "stage1"))]
        if name in NO_PATH:
            check(total[name] == 0, f"{name} was launched on a main path")
        else:
            check(total[name] > 0, f"{name} was never launched on a main "
                                   f"path")
        extra = {k: r[k] for k in ("template", "events_ms",
                                   "library_events_ms", "kernel_route",
                                   "tflops",
                                   "unfused_ms", "ms_per_step",
                                   "bound_ms_fp32_peak",
                                   "dequantized_matmul_ms", "tolerance",
                                   "atol_range", "err_over_allowed")
                 if k in r}
        if name in NO_PATH:
            extra["no_main_path"] = NO_PATH[name]
        err, err_at = max((rows[(n, lb)]["max_abs_err"], lb)
                          for n, lb in rows if n == name)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCES[name]}",
            "replaces": REPLACES[name], "launches": total[name],
            "max_abs_err": err, "max_abs_err_at": err_at,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "at": r["shape"], **extra})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
