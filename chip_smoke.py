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
the CPU), and Lite at embed width 128 (stage depth up to 2048, past the
int8 kernel's one-slice K) serves one dispatch held bitwise against the
CPU.  The compression ladder and its neighbours each serve one dispatch
of 32 clouds on the card and on the CPU: Table 1's M-1, M-3 and M-4
(fused fp32; each rung's ``compress()`` report is printed), Fig. 4's
W/A sweep at w4a4, w6a6, w4a8 and w8a16 (int8, bitwise), M-2 with the
``ball`` grouper (the kNN kernel's radius fill) and the seg head on Lite
(bitwise) and on Elite fused (50 part labels, as ShapeNetPart).  Then
the decoder LM, tinyllama-1.1b at full width and depth in
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
# The seg head's classes: ShapeNetPart's 50 part labels (Yi et al. 2016).
SEG_CLASSES = 50
# The ball grouper's rows: the radius of repro_torch.api.registry's
# builtin entry.
BALL_RADIUS = 0.5
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
# Rows of a kernel that the final line reports beside its main row, and
# the launch count each reports (a count the wrapper keeps per variant).
EXTRA_ROWS = {("knn", "ball"): "knn_ball", ("knn", "seg_upsample"): "knn_k1"}
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
# Distinct W8A16 weights a timing rotates over: 6 x 11.5 MB exceeds the
# H100's 50 MB L2.
W8_COPIES = 6
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


def grouped_work(b: int, n: int, s: int, k: int, c: int, c_out: int,
                 sigma_given: bool):
    """(bytes, operations) the fused group->transfer function needs: feats,
    int32 indices, centres, alpha/beta, w, b (and sigma, given) read once,
    the f32 output written once; 2 * 2C * C_out flops a row."""
    nbytes = 4 * (b * n * c + b * s * k + b * s * c + 2 * c
                  + 2 * c * c_out + c_out + b * s * k * c_out)
    if sigma_given:
        nbytes += 4 * b
    return nbytes, 2 * b * s * k * 2 * c * c_out


def knn_work(b: int, s: int, n: int, c: int, k: int):
    """(bytes, fp32 operations) the kNN function needs: each sample and
    point read once, int32 indices (as the TPU kernel returns) written
    once, and per (query, point) pair 2C+2 distance flops plus one compare
    of a streaming top-k."""
    return 4 * b * (s + n) * c + 4 * b * s * k, b * s * n * (2 * c + 3)


def fps_work(b: int, n: int, s: int, c: int):
    """(bytes, fp32 operations) the FPS function needs: each point read
    once, int32 indices out, and per (point, step) 3C flops plus one
    compare."""
    return 4 * b * n * c + 4 * b * s, b * n * (s - 1) * (3 * c + 1)


def work_bound_ms(nbytes: int, nops: int, peak: float = FP32_OPS_PER_S
                  ) -> float:
    """The least time the card could take: bytes at the memory rate or
    operations at the peak, whichever is longer."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / peak)


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
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    b = MAX_BATCH
    xyz = torch.from_numpy(clouds[:b]).to(dev)
    rows = {}

    # kNN at Lite's and M-2's four stages (S=256 of N=512 down to S=32 of
    # N=64), k=16, on the URS-sampled centroids of real clouds.
    state = sampling.seed_streams(SEED, b)
    cur = xyz
    for s, n_samp in enumerate((256, 128, 64, 32)):
        state, idx = sampling.urs_indices(state, cur.shape[1], n_samp)
        new = sampling.gather_points(cur, idx.to(dev)[None].expand(b, -1))
        new = new.contiguous()
        rows[("knn", f"stage{s + 1}")] = knn_row(torch, new, cur.contiguous(),
                                                16)
        if s == 0:
            # the ball query at the same shape: the fill against the plain
            # version, and r2 = inf against the kNN indices
            rows[("knn", "ball")] = knn_row(torch, new, cur.contiguous(), 16,
                                            radius=BALL_RADIUS)
        cur = new

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

    # int8 past one shared-memory slice of w (K > 1024): the depth of
    # lite_spec(40, embed_dim=128)'s stage-4 transfer.
    m, k, n = 4096, 2048, 512
    x_q = torch.randint(-127, 128, (m, k), generator=gen,
                        dtype=torch.int8).to(dev)
    w_q = torch.randint(-127, 128, (k, n), generator=gen,
                        dtype=torch.int8).to(dev)
    a_scale = (torch.rand(b, generator=gen) / 127 + 1e-4).to(dev)
    w_scale = (torch.rand(n, generator=gen) / 127 + 1e-4).to(dev)
    rpl = m // b
    got = i8_mod.int8_matmul_cuda(x_q, w_q, a_scale, w_scale, rpl)
    want = ref.int8_matmul_ref(x_q, w_q, a_scale, w_scale, rpl)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "int8_matmul k2048: kernel is not bitwise "
                                  "equal to the plain version")
    kernel = lambda: i8_mod.int8_matmul_cuda(  # noqa: E731
        x_q, w_q, a_scale, w_scale, rpl)
    nbytes, nops, peak = gemm_work("int8_matmul", m, k, n, b)
    rows[("int8_matmul", "k2048")] = dict(
        shape=f"M={m} K={k} N={n} lanes={b}",
        template=i8_mod.template(k, n, _build.aligned16(x_q, w_q)).name,
        ms=graph_ms(torch, kernel), events_ms=median_ms(torch, kernel),
        plain_ms=median_ms(torch, lambda: ref.int8_matmul_ref(
            x_q, w_q, a_scale, w_scale, rpl), reps=10),
        library_ms=graph_ms(torch, lambda: torch._int_mm(x_q, w_q)),
        max_abs_err=0.0, bytes=nbytes, ops=nops, peak=peak)

    return emit_rows(rows)


def knn_row(torch, q, p, k: int, launches: int = 20, reps: int = 15,
            radius=None):
    """The kNN kernel against its plain version (bitwise), then its device
    time (``graph_ms``; ``events_ms``: back-to-back windows) beside the
    plain version's.  With ``radius``, the ball query: also the count of
    filled picks, and ``radius=inf`` held against the kNN indices."""
    from repro_torch.kernels import knn as knn_mod
    from repro_torch.kernels import ref
    bsz, n_s, c = q.shape
    n_p = p.shape[1]
    got = knn_mod.knn_cuda(q, p, k, radius)
    want = ref.knn_ref(q, p, k, radius)
    torch.cuda.synchronize()
    what = f"knn B={bsz} S={n_s} N={n_p} k={k} radius={radius}"
    check(torch.equal(got, want), f"{what}: kernel indices differ from the "
                                  f"plain version")
    del want
    extra = {}
    if radius is not None:
        plain_knn = knn_mod.knn_cuda(q, p, k)
        infinite = knn_mod.knn_cuda(q, p, k, float("inf"))
        torch.cuda.synchronize()
        check(torch.equal(infinite, plain_knn), f"{what}: radius=inf is not "
                                                f"the kNN indices")
        extra = dict(radius=radius, filled_picks=int((got != plain_knn).sum()),
                     picks=got.numel(), inf_radius_equals_knn=True)
    kernel = lambda: knn_mod.knn_cuda(q, p, k, radius)  # noqa: E731
    nbytes, nops = knn_work(bsz, n_s, n_p, c, k)
    return dict(shape=f"B={bsz} S={n_s} N={n_p} C={c} k={k}"
                + (f" radius={radius}" if radius is not None else ""),
                ms=graph_ms(torch, kernel, launches, reps),
                events_ms=median_ms(torch, kernel, reps=reps),
                plain_ms=median_ms(torch, lambda: ref.knn_ref(q, p, k, radius),
                                   reps=3, inner=1, warmup=0),
                library_ms=None, max_abs_err=0.0, bytes=nbytes, ops=nops,
                peak=FP32_OPS_PER_S, **extra)


def fps_row(torch, pts, n_samp: int, launches: int = 20, reps: int = 15):
    """The FPS kernel against its plain version (bitwise), then its device
    time beside the plain version's, as :func:`knn_row`."""
    from repro_torch.kernels import fps as fps_mod
    from repro_torch.kernels import ref
    bsz, n, c = pts.shape
    idx = fps_mod.fps_cuda(pts, n_samp)
    want = ref.fps_ref(pts, n_samp)
    torch.cuda.synchronize()
    check(torch.equal(idx, want), f"fps B={bsz} N={n} S={n_samp}: kernel "
                                  f"indices differ from the plain version")
    kernel = lambda: fps_mod.fps_cuda(pts, n_samp)  # noqa: E731
    ms = graph_ms(torch, kernel, launches, reps)
    nbytes, nops = fps_work(bsz, n, n_samp, c)
    return idx, dict(
        shape=f"B={bsz} N={n} S={n_samp}", ms=ms,
        events_ms=median_ms(torch, kernel, reps=reps, inner=1),
        plain_ms=median_ms(torch, lambda: ref.fps_ref(pts, n_samp),
                           reps=min(reps, 3), inner=1, warmup=0),
        library_ms=None, max_abs_err=0.0,
        ms_per_step=ms / n_samp, bytes=nbytes, ops=nops, peak=FP32_OPS_PER_S)


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
    """FPS and kNN at Elite's four stages (and once each past their old N
    limits) and both grouped_transfer kernels at all four of its stages
    against their plain versions, on the FPS/kNN geometry of real
    1024-point clouds.  The sigma-given
    kernel is also held bitwise against the unfused path, and a cloud
    alone against its lane in the dispatch; grouped_transfer times are
    device times of a graph replay (``graph_ms``), with the stats pass
    and the product apart by kernel name."""
    from repro_torch.core import knn as knn_core
    from repro_torch.core import sampling
    from repro_torch.kernels import _build
    from repro_torch.kernels import grouped_transfer as gt_mod
    from repro_torch.kernels import knn as knn_mod
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    b = MAX_BATCH
    cur = torch.from_numpy(clouds[:b]).to(dev)
    xyz = cur
    rows, geo = {}, {}
    for s, n_samp in enumerate((512, 256, 128, 64)):
        # FPS and kNN at Elite's four stages: each kernel held bitwise
        # against its plain version, then timed
        idx, rows[("fps", f"stage{s + 1}")] = fps_row(torch, cur, n_samp)
        new = sampling.gather_points(cur, idx).contiguous()
        rows[("knn", f"elite_stage{s + 1}")] = knn_row(torch, new, cur, 16)
        geo[s] = (cur, idx, knn_mod.knn_cuda(new, cur, 16))
        cur = new
    # the seg head's upsample: every input point's nearest stage-4 point
    rows[("knn", "seg_upsample")] = knn_row(torch, xyz, cur, 1)

    # Past the old limits (kNN N <= 4842, FPS N <= 8192): one case each.
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    big = torch.randn(2, 24000, 3, generator=gen, device=dev)
    _, rows[("fps", "n24000")] = fps_row(torch, big, 6000, launches=2,
                                         reps=3)
    q = big[:, torch.randperm(24000, generator=gen, device=dev)[:6000]]
    rows[("knn", "n24000")] = knn_row(torch, q.contiguous(), big, 32,
                                      launches=2, reps=3)
    del big, q

    gen = torch.Generator().manual_seed(SEED + 2)
    for label, s, c, c_out in (("stage1", 0, 32, 64),
                               ("stage2", 1, 64, 128),
                               ("stage3", 2, 128, 256),
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
        unfused_ms = graph_ms(torch, unfused)
        unfused_events_ms = median_ms(torch, unfused)
        variants = (
            ("grouped_transfer_stats",
             lambda f=feats, nb=nbr, ce=centers: gt_mod.
             grouped_transfer_stats_cuda(f, nb, ce, alpha, beta, w, bias),
             lambda: ref.grouped_transfer_ref(
                 feats, nbr, centers, None, alpha, beta, w, bias)),
            ("grouped_transfer",
             lambda f=feats, nb=nbr, ce=centers, sg=sigma: gt_mod.
             grouped_transfer_cuda(f, nb, ce, sg, alpha, beta, w, bias),
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
            # a cloud alone against its lane in the full dispatch
            lane = 5
            alone = kernel(feats[lane:lane + 1].contiguous(),
                           nbr[lane:lane + 1].contiguous(),
                           centers[lane:lane + 1].contiguous(),
                           *(() if name == "grouped_transfer_stats"
                             else (sigma[lane:lane + 1].contiguous(),)))
            torch.cuda.synchronize()
            check(torch.equal(alone[0], got[lane]),
                  f"{name} {label}: a cloud's output depends on the rest of "
                  f"its dispatch")
            ms, events_ms = graph_ms(torch, kernel), median_ms(torch, kernel)
            plain_ms = median_ms(torch, plain, reps=10)
            # device time by kernel name (the stats pass is its own launch)
            _, by_name, _ = profile_call(torch, kernel)
            by_kernel = {
                part: sum(us for key, us in by_name.items() if part in key)
                / 1e3 if by_name else "not measured"
                for part in ("grouped_transfer_stats_kernel",
                             "grouped_transfer_wide_kernel")}
            nbytes, nops = grouped_work(b, n, n_samp, k, c, c_out,
                                        name == "grouped_transfer")
            rows[(name, label)] = dict(
                shape=f"B={b} N={n} S={n_samp} k={k} C={c} C_out={c_out}",
                template=gt_mod.template(
                    b * n_samp * k, c, c_out,
                    _build.aligned16(feats, centers, alpha, beta, w)).name,
                ms=ms, events_ms=events_ms, plain_ms=plain_ms,
                library_ms=None, max_abs_err=err, unfused_ms=unfused_ms,
                unfused_events_ms=unfused_events_ms,
                bitwise_vs_unfused=bitwise, lone_cloud_bitwise=True,
                profile_ms_by_kernel=by_kernel,
                bytes=nbytes, ops=nops, peak=FP32_OPS_PER_S)
    return emit_rows(rows)


# ------------------------------------------------------------ serving --

def counters():
    """Each launch count: (wrapper, attribute).  ``knn_ball`` and
    ``knn_k1`` are the kNN launches with a radius and at k = 1 (the seg
    head's upsample), which the wrapper counts among its launches."""
    from repro_torch.kernels import (flash_attention, fps, fused_linear,
                                     grouped_transfer, int8_matmul, knn)
    fns = {"knn": knn.knn_cuda, "int8_matmul": int8_matmul.int8_matmul_cuda,
           "fused_linear": fused_linear.fused_linear_cuda,
           "fps": fps.fps_cuda,
           "grouped_transfer_stats":
               grouped_transfer.grouped_transfer_stats_cuda,
           "grouped_transfer": grouped_transfer.grouped_transfer_cuda,
           "w8_matmul": int8_matmul.w8_matmul_cuda,
           "flash_attention": flash_attention.flash_attention_cuda}
    return {**{k: (f, "launches") for k, f in fns.items()},
            "knn_ball": (knn.knn_cuda, "radius_launches"),
            "knn_k1": (knn.knn_cuda, "k1_launches")}


def counted(torch, fn):
    """Run ``fn`` with every launch count set to 0 just before it; return
    (its result, the counts just after)."""
    cs = counters()
    for f, attr in cs.values():
        setattr(f, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: getattr(f, attr) for k, (f, attr) in cs.items()}


def expect_launches(name, launches, expect, dispatches=1):
    for kname, n in launches.items():
        per = expect.get(kname, 0)
        check(n == per * dispatches,
              f"{name}: {kname} launched {n} times over {dispatches} "
              f"dispatches, expected {per} per dispatch")


def mapping_chain(torch, clouds, state, device, spec):
    """Sampler indices (URS or FPS) and per-stage neighbour indices (kNN,
    or the ``ball`` grouper's query within its radius) of one dispatch,
    and for the seg head the 1-NN upsample's, through the port's core
    functions on ``device`` (geometry only)."""
    from repro_torch.api import registry
    from repro_torch.core import knn, sampling
    radius = getattr(registry.GROUPERS.get(spec.grouper), "radius", None)
    xyz = cur = torch.from_numpy(clouds).to(device)
    b = cur.shape[0]
    out = []
    for n_samp in spec.to_model_config().stage_samples:
        if spec.sampler == "fps":
            idx = sampling.fps(cur, n_samp)
        else:
            state, idx = sampling.urs_indices(state, cur.shape[1], n_samp)
            idx = idx.to(device)[None].expand(b, -1)
        new = sampling.gather_points(cur, idx)
        out.append((idx.cpu(), knn.neighbor_index(new, cur, spec.k_neighbors,
                                                  radius).cpu()))
        cur = new
    if spec.head == "seg":
        out.append((torch.zeros(0), knn.knn_batched(xyz, cur, 1).cpu()))
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
    """The product launches of one dispatch, recorded from the shapes the
    ``int8_matmul``, ``fused_linear`` and ``grouped_transfer`` wrappers
    are given: per kernel, the launches and the sum of their bounds
    (ms)."""
    from repro_torch.kernels import grouped_transfer as gt_mod
    from repro_torch.kernels import ops
    shapes = []
    int8_cuda, fused_cuda = ops.int8_matmul_cuda, ops.fused_linear_cuda
    gt_launch = gt_mod._launch

    def int8_rec(x_q, w_q, a_scale, w_scale, rows_per_lane):
        shapes.append(("int8_matmul", *x_q.shape, w_q.shape[1],
                       a_scale.numel()))
        return int8_cuda(x_q, w_q, a_scale, w_scale, rows_per_lane)

    def fused_rec(x, w, b, activation="relu"):
        shapes.append(("fused_linear", *x.shape, w.shape[1], 0))
        return fused_cuda(x, w, b, activation)

    def grouped_rec(feats, nidx, centers, sigma, alpha, beta, w, b, **kw):
        # both wrappers launch through _launch; sigma is given or None
        shapes.append(("grouped_transfer", *feats.shape, *nidx.shape[1:],
                       w.shape[1], sigma is not None))
        return gt_launch(feats, nidx, centers, sigma, alpha, beta, w, b,
                         **kw)

    ops.int8_matmul_cuda, ops.fused_linear_cuda = int8_rec, fused_rec
    gt_mod._launch = grouped_rec
    try:
        pipe.infer(chunk, state.clone())
        torch.cuda.synchronize()
    finally:
        ops.int8_matmul_cuda, ops.fused_linear_cuda = int8_cuda, fused_cuda
        gt_mod._launch = gt_launch
    out = {kind: {"launches": 0, "bound_ms": 0.0}
           for kind in ("int8_matmul", "fused_linear", "grouped_transfer")}
    for kind, *dims in shapes:
        if kind == "grouped_transfer":
            b, n, c, s, k, c_out, given = dims
            nbytes, nops = grouped_work(b, n, s, k, c, c_out, given)
            peak = FP32_OPS_PER_S
        else:
            nbytes, nops, peak = gemm_work(kind, *dims)
        out[kind]["launches"] += 1
        out[kind]["bound_ms"] += 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                           nops / peak)
    return out


def mapping_bounds(torch, pipe, chunk, state):
    """The kNN and FPS launches of one dispatch, recorded from the shapes
    their wrappers are given: per kernel, the launches and the sum of their
    bounds (ms)."""
    from repro_torch.kernels import fps as fps_mod
    from repro_torch.kernels import knn as knn_mod
    out = {kind: {"launches": 0, "bound_ms": 0.0} for kind in ("knn", "fps")}
    knn, fps = knn_mod.knn, fps_mod.fps

    def add(kind, nbytes, nops):
        out[kind]["launches"] += 1
        out[kind]["bound_ms"] += work_bound_ms(nbytes, nops)

    def knn_rec(samples, points, k, radius=None):
        b, s, c = samples.shape
        add("knn", *knn_work(b, s, points.shape[1], c, k))
        return knn(samples, points, k, radius)

    def fps_rec(points, n_samples):
        b, n, c = points.shape
        add("fps", *fps_work(b, n, n_samples, c))
        return fps(points, n_samples)

    # the pipeline reaches both through these module attributes
    knn_mod.knn, fps_mod.fps = knn_rec, fps_rec
    try:
        pipe.infer(chunk, state.clone())
        torch.cuda.synchronize()
    finally:
        knn_mod.knn, fps_mod.fps = knn, fps
    return out


def profile_dispatch(torch, pipe, chunk, state):
    """Device time per kernel name over one dispatch (torch.profiler),
    with each product and mapping kernel's ms (``grouped_transfer``: both
    of its launches) beside the summed bound of its launches."""
    wall_ms, by_name, events = profile_call(
        torch, lambda: pipe.infer(chunk, state.clone()))
    out = profile_summary(
        wall_ms, by_name, events,
        port_kernels_ms=("knn_kernel", "knn_rounds_kernel",
                         "int8_matmul_kernel",
                         "fused_linear_wide_kernel",
                         "fused_linear_small_kernel", "fps_kernel",
                         "grouped_transfer"),
        fps_ms=("fps_kernel",),
        knn_ms=("knn_kernel", "knn_rounds_kernel"),
        int8_matmul_kernel_ms=("int8_matmul_kernel",),
        fused_linear_kernel_ms=("fused_linear_wide_kernel",
                                "fused_linear_small_kernel"),
        grouped_transfer_kernel_ms=("grouped_transfer",),
        grouped_transfer_stats_pass_ms=("grouped_transfer_stats_kernel",))
    dev_ms = out["device_ms"]
    out["fps_share"] = (out["fps_ms"] / dev_ms if by_name
                        else "not measured")
    for kind, got in {**gemm_bounds(torch, pipe, chunk, state),
                      **mapping_bounds(torch, pipe, chunk, state)}.items():
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


def lite_wide_phase(torch, clouds, gen):
    """One 32-cloud dispatch of ``lite_spec(40, embed_dim=128).serving()``
    (stage dims 256-2048, so int8 products up to K = 2048, past one
    shared-memory slice of w) on the card, held bitwise against the CPU:
    Lite's contract."""
    from repro_torch.api.build import build
    from repro_torch.api.spec import lite_spec
    from repro_torch.kernels import ops
    from repro_torch.models.pointmlp import pointmlp_init
    spec = lite_spec(N_CLASSES, embed_dim=128).serving().replace(
        backend="cuda")
    params = pointmlp_init(spec.to_model_config(), gen)
    perturb_bn(torch, params, gen)
    pipe = build(spec, params)
    state = pipe.seed_state(SEED, MAX_BATCH)
    full = torch.from_numpy(clouds[:MAX_BATCH])
    ks = []                         # the depth K of each int8 product
    int8_cuda = ops.int8_matmul_cuda

    def int8_rec(x_q, *rest):
        ks.append(x_q.shape[1])
        return int8_cuda(x_q, *rest)

    ops.int8_matmul_cuda = int8_rec
    try:
        (got, _), launches = counted(
            torch, lambda: pipe.infer(full.cuda(), state.clone()))
    finally:
        ops.int8_matmul_cuda = int8_cuda
    expect_launches("lite embed 128", launches,
                    {"knn": 4, "int8_matmul": 28})
    check(max(ks) > 1024, f"lite embed 128: no int8 product past K = 1024 "
                          f"(largest K {max(ks)})")
    want, _ = build(spec, params, device="cpu").infer(full, state.clone())
    got = got.cpu()
    check(got.shape == (MAX_BATCH, N_CLASSES)
          and bool(torch.isfinite(got).all()), "lite embed 128: logits not "
          "finite")
    err = (got - want).abs().max().item()
    check(torch.equal(got, want), f"lite embed 128: card vs CPU not bitwise "
                                  f"(max abs err {err})")
    emit({"phase": "lite_embed128", "launches": launches,
          "bitwise_vs_cpu": True, "max_abs_err_vs_cpu": err,
          "max_abs_logit": want.abs().max().item(),
          "int8_depths_past_1024": sorted(k for k in ks if k > 1024),
          "tolerance": "bitwise (Lite's contract)"})
    return launches


def dispatch_phase(torch, name, spec, params, clouds, expect,
                   atol_rel: float, why: str):
    """One dispatch of MAX_BATCH clouds through ``PointCloudEngine`` on
    the card, counted, held against the CPU engine (indices identical,
    logits within ``atol_rel`` of max|logit|; 0 means bitwise), then
    profiled.  Returns the launches."""
    from repro_torch.serve.pointcloud import PointCloudEngine
    clouds = clouds[:MAX_BATCH]
    eng = PointCloudEngine(params, spec, max_batch=MAX_BATCH, seed=SEED)
    cpu = PointCloudEngine(params, spec, max_batch=MAX_BATCH, seed=SEED,
                           device="cpu")
    check(eng.device.type == "cuda", f"{name}: engine is not on the card")
    state0 = eng.lfsr_state
    on_card = mapping_chain(torch, clouds, state0, "cuda", spec)
    on_cpu = mapping_chain(torch, clouds, state0, "cpu", spec)
    for s, ((gi, gn), (ci, cn)) in enumerate(zip(on_card, on_cpu)):
        check(torch.equal(gi, ci), f"{name}: sampler indices differ at "
                                   f"step {s}")
        check(torch.equal(gn, cn), f"{name}: neighbour indices differ on "
                                   f"the card at step {s}")
    fills = None
    if spec.grouper == "ball":
        knn_nbr = mapping_chain(torch, clouds, state0, "cuda",
                                spec.replace(grouper="knn"))
        fills = [int((a[1] != b[1]).sum()) for a, b in zip(on_card, knn_nbr)]

    logits, launches = counted(torch, lambda: eng.classify(clouds))
    expect_launches(name, launches, expect, eng.stats.batches)
    want = cpu.classify(clouds)
    got = logits.cpu()
    shape = ((len(clouds), spec.n_points, spec.n_classes)
             if spec.head == "seg" else (len(clouds), spec.n_classes))
    check(got.shape == shape and bool(torch.isfinite(got).all()),
          f"{name}: logits not finite {list(shape)}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    bitwise = bool(torch.equal(got, want))
    check(bitwise if atol_rel == 0 else err <= atol_rel * scale,
          f"{name}: card vs CPU max abs err {err} beyond "
          f"{atol_rel or 'bitwise'} * {scale}")
    full = torch.from_numpy(clouds).cuda()
    prof = profile_dispatch(torch, eng.pipeline, full, state0)
    emit({"phase": name, "spec": spec.name, "n_points": spec.n_points,
          "grouper": spec.grouper, "head": spec.head,
          "precision": f"{spec.precision} w{spec.w_bits}a{spec.a_bits}"
          if spec.precision == "int8" else "fp32",
          "dispatches": eng.stats.batches, "launches": launches,
          "max_abs_err_vs_cpu": err, "max_abs_logit": scale,
          "bitwise_vs_cpu": bitwise,
          "tolerance": f"{atol_rel} * max|logit|" if atol_rel else "bitwise",
          "why": why, "top1_agree": (got.argmax(-1) == want.argmax(-1))
          .float().mean().item(), "ball_fills_per_stage": fills,
          "serve_s": eng.stats.serve_s, "profile": prof})
    return launches


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] += v


def ladder_phases(torch, np, rng, lite_params):
    """Table 1's rungs M-1, M-3 and M-4 (fused fp32) and every rung's
    ``compress()`` report; Fig. 4's sweep at w4a4, w6a6, w4a8 and w8a16
    on Lite's topology (int8, bitwise); M-2 with the ``ball`` grouper;
    the seg head on Lite and on Elite fused.  One dispatch each, on the
    card and the CPU.  Returns the launches."""
    from repro_torch.api.spec import (PipelineSpec, compression_ladder_specs,
                                      elite_spec, lite_spec, m2_spec)
    from repro_torch.core import compress
    from repro_torch.models.pointmlp import pointmlp_init
    total = {k: 0 for k in counters()}
    gen = torch.Generator().manual_seed(SEED + 8)

    reports = []
    for cfg in compress.compression_ladder(N_CLASSES):
        params = pointmlp_init(cfg, gen)
        perturb_bn(torch, params, gen)
        _, dcfg, rep = compress.compress(params, cfg)
        reports.append({**rep.__dict__, "n_points": cfg.n_points,
                        "deploy_quant": f"w{dcfg.quant.w_bits}a"
                                        f"{dcfg.quant.a_bits}"
                        if dcfg.quant.enabled else "fp32"})
    emit({"phase": "ladder_compress", "reports": reports})

    why_fp32 = ("indices are identical; each fp32 layer sums K <= 512 "
                "products in another order than the CPU, compounded over 15 "
                "layers, as for M-2")
    ladder = {s.name: s for s in compression_ladder_specs(N_CLASSES)}
    m2_params = None
    for rung in ("M-1", "M-3", "M-4"):
        spec = ladder[rung].serving().replace(backend="cuda")
        params = pointmlp_init(spec.to_model_config(), gen)
        perturb_bn(torch, params, gen)
        m2_params = params
        add_launches(total, dispatch_phase(
            torch, f"ladder_{rung}", spec, params,
            make_clouds(np, rng, MAX_BATCH, spec.n_points),
            {"knn": 4, "fused_linear": 27}, 1e-4, why_fp32))

    clouds = make_clouds(np, rng, MAX_BATCH, 512)
    sweep = {c.name: c for c in compress.precision_sweep(N_CLASSES)}
    for rung in ("M-2-w4a4", "M-2-w6a6", "M-2-w4a8", "M-2-w8a16"):
        spec = PipelineSpec.from_model_config(sweep[rung]).serving().replace(
            backend="cuda")
        add_launches(total, dispatch_phase(
            torch, f"precision_sweep_{rung}", spec, lite_params, clouds,
            {"knn": 4, "int8_matmul": 28}, 0.0,
            "bitwise (Lite's contract): exact int8 products, activations "
            "quantized on each device alike (a_bits = 16 saturates into "
            "int8 as XLA's cast does)"))

    spec = m2_spec(N_CLASSES, grouper="ball").serving().replace(
        backend="cuda")
    add_launches(total, dispatch_phase(
        torch, "ball", spec, m2_params, clouds,
        {"knn": 4, "knn_ball": 4, "fused_linear": 27}, 1e-4,
        "ball-query indices identical; fp32 layers as for M-2"))

    spec = lite_spec(SEG_CLASSES, head="seg").serving().replace(
        backend="cuda")
    params = pointmlp_init(spec.to_model_config(), gen)
    perturb_bn(torch, params, gen)
    add_launches(total, dispatch_phase(
        torch, "seg_lite", spec, params, clouds,
        {"knn": 5, "knn_k1": 1, "int8_matmul": 28}, 0.0,
        "bitwise (Lite's contract), the 1-NN upsample's indices "
        "identical"))
    spec = elite_spec(SEG_CLASSES, head="seg").serving().replace(
        backend="cuda", fused_group="grouped_transfer")
    params = pointmlp_init(spec.to_model_config(), gen)
    perturb_bn(torch, params, gen)
    add_launches(total, dispatch_phase(
        torch, "seg_elite", spec, params,
        make_clouds(np, rng, MAX_BATCH, ELITE_POINTS),
        {"fps": 4, "knn": 5, "knn_k1": 1, "grouped_transfer_stats": 4,
         "fused_linear": 23}, 1e-4,
        "FPS, kNN and upsample indices identical; fp32 layers (fc1 at K = "
        "1056) sum in another order than the CPU, as for Elite"))
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
    from repro_torch.kernels import ref

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

    # W8A16 at tinyllama's MLP up- and down-projection, decode (4 tokens)
    # and prefill (4 x 2048 tokens).  ms is a CUDA-graph replay over
    # W8_COPIES distinct weights that together exceed the 50 MB L2, so each
    # launch finds its weight cold, as a decode step over 22 layers does;
    # warm_l2_ms replays one weight, events_ms times back-to-back calls.
    for label, m, kk, n in (("decode", LM_BATCH, 2048, 5632),
                            ("prefill", LM_BATCH * LM_SEQ, 2048, 5632),
                            ("decode_down", LM_BATCH, 5632, 2048),
                            ("prefill_down", LM_BATCH * LM_SEQ, 5632, 2048)):
        rows[("w8_matmul", label)] = w8_row(torch, gen, m, kk, n)
    return emit_rows(rows)


def rotation(fns):
    """One call that runs the next of ``fns`` each time (for graph_ms
    over several weights)."""
    turn = [0]

    def call():
        fns[turn[0] % len(fns)]()
        turn[0] += 1
    return call


def w8_row(torch, gen, m: int, kk: int, n: int):
    """One W8A16 row: held against the plain version (and bitwise against
    a second launch), timed cold and warm in L2, beside the plain version,
    the library call and the pre-dequantized product."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import int8_matmul as i8_mod
    from repro_torch.models.layers import f32_sums

    dev = torch.device("cuda")
    x = torch.randn(m, kk, generator=gen, device=dev).to(torch.bfloat16)
    w_qs = [torch.randint(-127, 128, (kk, n), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(W8_COPIES)]
    w_q = w_qs[0]
    w_scale = torch.rand(n, generator=gen, device=dev) / 127 + 1e-4
    route = i8_mod.w8_route(m, kk, n, x.dtype,
                            _build.aligned16(x, w_q, w_scale))
    got = i8_mod.w8_matmul_cuda(x, w_q, w_scale)
    again = i8_mod.w8_matmul_cuda(x, w_q, w_scale)
    want = ref.w8_matmul_plain(x, w_q, w_scale)
    torch.cuda.synchronize()
    tol = 2.0 ** -7
    ok, err, atol_lo, atol_hi, worst = rowwise_close(torch, got, want, tol)
    check(ok, f"w8_matmul M{m} K{kk} N{n}: max abs err {err}, {worst} x "
              f"its allowance (rtol={tol}, atol={tol} * max|out| of the "
              f"row, {atol_lo}..{atol_hi})")
    check(torch.equal(got, again), f"w8_matmul M{m} K{kk} N{n}: two "
                                   f"launches differ")
    # a prefill call allocates 92 MB of output: fewer launches a graph
    launches = 20 if m <= i8_mod.STREAM_MAX_M else 5
    ms = graph_ms(torch, rotation([
        lambda w=w: i8_mod.w8_matmul_cuda(x, w, w_scale) for w in w_qs]),
        launches=launches)
    warm_ms = graph_ms(torch, lambda: i8_mod.w8_matmul_cuda(x, w_q, w_scale),
                       launches=launches)
    w_deqs = [(w.float() * w_scale).to(torch.bfloat16) for w in w_qs]
    with f32_sums():
        deq_ms = graph_ms(torch, rotation([lambda d=d: x @ d
                                           for d in w_deqs]),
                          launches=launches)
    del w_deqs
    # torch._weight_int8pack_mm computes x @ w_q^T * scale with w_q [N, K]
    # and the scale in x's dtype (rounded to bf16 here).
    scale_x = w_scale.to(x.dtype)
    try:
        w_ts = [w.t().contiguous() for w in w_qs]
        torch._weight_int8pack_mm(x, w_ts[0], scale_x)
        torch.cuda.synchronize()
        # its kernel is slow at prefill rows: fewer replays there
        lib_ms = graph_ms(torch, rotation([
            lambda w=w: torch._weight_int8pack_mm(x, w, scale_x)
            for w in w_ts]), launches=launches,
            reps=15 if m <= i8_mod.STREAM_MAX_M else 3)
        lib_note = ("torch._weight_int8pack_mm(x, w_q.t(), w_scale.to(x."
                    "dtype)): the scale rounded to bf16, weights cold")
    except (RuntimeError, NotImplementedError) as exc:
        lib_ms = None
        lib_note = (f"torch._weight_int8pack_mm has no kernel here: "
                    f"{str(exc).splitlines()[0][:160]}")
    nbytes = 2 * m * kk + kk * n + 4 * n + 2 * m * n
    nops = 2 * m * kk * n
    return dict(
        shape=f"M={m} K={kk} N={n} bf16", kernel_route=route.name, ms=ms,
        warm_l2_ms=warm_ms,
        events_ms=median_ms(torch, lambda: i8_mod.w8_matmul_cuda(
            x, w_q, w_scale)),
        plain_ms=median_ms(torch, lambda: ref.w8_matmul_plain(
            x, w_q, w_scale), reps=5),
        library_ms=lib_ms, library_note=lib_note, max_abs_err=err,
        tolerance=f"rtol={tol}, atol={tol} * max|out| of the row",
        atol_range=[atol_lo, atol_hi], err_over_allowed=worst,
        dequantized_matmul_ms=deq_ms,
        dequantized_matmul_note="x @ w_dequant (bf16, weight dequantized "
        "beforehand, cold): not the same function, for comparison only",
        bytes=nbytes, ops=nops, peak=BF16_OPS_PER_S,
        bound_ms_fp32_peak=1e3 * max(nbytes / HBM_BYTES_PER_S,
                                     nops / FP32_OPS_PER_S))


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
    t_start = time.perf_counter()
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
    total = {k: 0 for k in counters()}
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
    got = lite_wide_phase(torch, clouds, torch.Generator().manual_seed(
        SEED + 6))
    for k, v in got.items():
        total[k] += v
    add_launches(total, ladder_phases(torch, np, rng, params))
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
                                   "warm_l2_ms", "library_note", "tflops",
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
    for (name, label), count in EXTRA_ROWS.items():
        r = rows[(name, label)]
        check(total[count] > 0, f"{name} {label} was never launched on a "
                                f"main path")
        kernels.append({
            "name": name, "row": label, "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCES[name]}",
            "replaces": REPLACES[name], "launches": total[count],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": r["shape"], "events_ms": r["events_ms"],
            **{k: r[k] for k in ("filled_picks", "picks",
                                 "inf_radius_equals_knn") if k in r}})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
