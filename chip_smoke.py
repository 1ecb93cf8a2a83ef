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
(bitwise) and on Elite fused (50 part labels, as ShapeNetPart).  The
serving engines follow: Lite through ``AsyncPointCloudEngine`` (the
deadline policy, clouds submitted one at a time; every future bitwise
against its cloud's solo dispatch and the CPU engine; the host syncs of
a dispatch; the idle share beside the sync engine's), three stream
sessions of drifting frames with a scene cut and a reset (Lite with FPS,
Lite's seg head, Elite unfused with an eviction age: bitwise against
``replay_reference``, hit decisions as on the CPU, no mapping kernel on a
hit, Lite bitwise again through the async engine), and README.md's fleet
of a Lite and an Elite tier (a burst that sheds, every admitted future
bitwise against its tier's solo dispatch, and a stream session through
the fleet).  The ``shard`` phase splits each dispatch over a
``("data",)`` mesh that repeats the card (``serve.sharding``): Lite at
2 and 4 shards bitwise the unsharded logits and LFSR state through
``infer``, both engines and a stream session, a 2 replica x 2 shard
fleet bitwise the unsharded fleet, M-2 with per-lane URS at 4 shards
(Lite's W8A8 split refused), M-2 and Elite at 2, each path's
launches n times the unsharded; the default mesh refused on one card
(run on ``cuda:0, cuda:1`` where there are two), and one Lite dispatch
timed at 1, 2 and 4 shards.  The ``tiles`` phase pins the kernels' templates through
``KernelTuning``: every template of every tunable kernel at Lite's, M-2's
and Elite's ``plan_shapes`` (and the head's fc1, and flash attention at a
tinyllama shape) held bitwise against the wrapper's own pick and against
the plain version, each timed (``tile_row`` lines), then one dispatch of
each spec under every ``tuning_candidates(quick=False)`` entry and under
``plan_tuning``, bitwise ``DEFAULT_TUNING``'s logits with the pinned
templates in the wrappers' ``.templates`` counters.  Before the tuner,
the ``trace`` phase runs the trace pass (``repro_torch.analysis.trace``)
on CUDA tensors over the Lite, M-2 and fused Elite plans: no finding, and
each plan's kernel launches named in its recorded op stream.  An early line prints
the ``launch_profile()`` the script applied before torch started CUDA.
The ``train`` phase trains on the card: full-width
PointMLP-Lite (8/8 fake quant) on the synthetic set, one step against the
CPU (indices identical; loss, gradients and refreshed BN stats within
stated bounds, the CPU replaying the card's fake-quant codes, which are
counted), 20 steps at batch 32 (the eval loss must drop; ms a step,
samples/s, peak memory, a profiled step), a checkpoint at step 10
restored and finished (bitwise under deterministic algorithms), then
``compress`` and the Lite spec serving the result bitwise the CPU's; and
Elite (FPS, learnable affine), one step against the CPU and 3 at batch
32.  Then the decoder LM, tinyllama-1.1b at full width and depth in
bf16 with random weights from a seed: the flash-attention and W8A16
kernels against their plain versions at its shapes, a scoring forward of
4 x 2048 tokens through the flash kernel held against the plain-attention
route, a 2-layer cut held against the CPU, and ``Engine.generate``
(prefill plus 32 greedy decode steps) whose last logits are held against
the forward.  Then it trains the LM (bf16, AdamW, the xla route, which
launches no hand kernel: JAX trains on plain products): a 2-layer cut's
gradients and one ``build_train_step`` step against the CPU, remat on and
off bitwise under deterministic algorithms; ``fit`` at full depth with
remat for 20 steps at 4 x 2048 on the synthetic token stream (the loss
must fall; ms a step, tokens/s, peak memory, a profiled step and the f32
attention's share, one step at B1 with remat on and off); a checkpoint
resume at the 2-layer cut, bitwise; moonshot at full width cut to 2
layers for 5 steps and its smoke config's step against the CPU replaying
the card's routing; and flash refusing a gradient before any launch.
Then the MoE decoder moonshot-v1-16b-a3b at full width and
depth (48 layers, 64 experts top-6, 28.06 B parameters in bf16): the
flash kernel at its shape, a 2-layer cut against the CPU, a 4 x 2048
scoring forward on the flash, xla and xla_chunked routes (entries dropped
at the default capacity, a profile split among attention, router,
dispatch, expert products and combine), and ``Engine.generate`` with the
host syncs of a decode step; and one forward each of llama4-maverick,
internvl2 (stub embeddings), yi-9b and minitron-8b at their smoke configs
against the CPU.  Two MoE runs that round differently may route a
near-tied token differently, and then its output moves by a whole
expert: the share of choices that agree is printed, and the held run
replays the reference run's routing (``route_tap``).  Last, the
families on other backbones at full width and depth (bf16, random
weights from a seed): xlstm-1.3b (cut to one group of 8 of its 48
layers, 7 mLSTM to 1 sLSTM: ``FAMILY_DEPTH``),
hymba-1.5b (32 layers, attention with a 1024-token window beside SSM
heads) and whisper-tiny (4 + 4 layers over 1500 stub frames): the flash
kernel at their three shapes (Hymba's window over 25 query and 5 KV
heads, Whisper's non-causal encoder over 1500 keys and its causal
decoder at 448), a cut held against the CPU, the scoring forward (4 x
2048 tokens; Whisper 4 x 448 after 1500 frames; Hymba and Whisper on the
flash and xla routes; xLSTM's sLSTM time loop timed alone) and
``Engine.generate`` (B4, 64 greedy steps; Hymba's 1536-token prompt
wraps its rolling cache), each decode step held against a forward over
the extended sequence.  Between the LM and its training come the
dry-run phases: ``sp_flash`` (tinyllama's 4 x 2048 flash forward with
``seq_parallel=True`` under the host mesh, bitwise the plain forward,
the kernel once a layer), ``dryrun_card`` (the dry-run's fake prefill and
2-layer AdamW step against the same steps run on the card: FLOPs equal,
shapes and dtypes equal, the card's peak above its arguments within 10%
of the dry-run's temp bytes) and ``dryrun_cli`` (``python -m
repro_torch.launch.dryrun --fast`` over all 80 production cells, one
full-cost cell and ``repro_torch.report``'s tables).  Last, the
``dp_train`` phases train data-parallel over a ``torch.distributed``
process group (no hand kernel on the training path): one NCCL rank at
tinyllama's full size (4 x 2048, remat), each step on
``make_host_mesh()`` bitwise the same step without a mesh, with the
step's and the gradient all-reduce's times and bytes; two gloo ranks
sharing the card (NCCL takes one rank a device) at full width cut to 2
layers in f32, held against one process on the whole batch, their params
bitwise equal, and the int8 compressed psum of their gradients bitwise
against the same function on the CPU, then on the same two ranks
moonshot's global MoE route over a batch split between them (full
width, 2 layers, B2 x T256 bf16 under ``default``: a flash forward that
launches the kernel once a layer on each rank, the loss and its
gradient, a prefill and 8 decode steps), each rank routing its block
after the other's entry counts, held against one process on the whole
batch with its routing replayed (the drops of each block exactly its
own), its collectives against the dry-run's count; and ``python -m
torch.distributed.run --nproc-per-node 1 -m repro_torch.launch.train``
through a checkpoint and a bitwise resume.  Every path is driven with
the kernels' launch counts set to 0 just before it and read just
after.  Every phase prints one JSON line; a
failed check raises and the script exits non-zero.  The line before the
last lists every ported kernel with its numbers, and the last line is
``{"ok": true, "device": {...}}``.

It needs the repository's ``src/repro_torch`` beside it and a CUDA device;
without either it exits non-zero and prints no result.  It imports nothing
of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

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
# the launch count each reports (a count the wrapper keeps per variant;
# flash_moonshot: the flash launches of moonshot's scoring forward;
# flash_hymba_window, flash_whisper_*: the flash launches at that row's
# shape over the xLSTM, Hymba and Whisper phases' main paths).
EXTRA_ROWS = {("knn", "ball"): "knn_ball", ("knn", "seg_upsample"): "knn_k1",
              ("flash_attention", "moonshot_fwd"): "flash_moonshot",
              ("flash_attention", "hymba_window"): "flash_hymba_window",
              ("flash_attention", "whisper_enc"): "flash_whisper_enc",
              ("flash_attention", "whisper_dec"): "flash_whisper_dec"}
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


def profile_call(torch, fn, reps: int = 1, sections=(), split=None,
                 cpu: bool = True, warmup: bool = True):
    """Run ``fn`` once to warm up (unless ``warmup`` is false: the caller
    has run it already), then ``reps`` times under torch.profiler: per
    call, (host wall ms, device us per kernel name, device events: kernel
    launches and copies).  ``cpu=False`` records
    device activity only (for a call of some 10^5 kernels, whose host op
    events would take the profiler longer than the call).  Each of
    ``sections``
    (module, attribute, label) is wrapped in a ``record_function`` range
    for the profiled calls, and ``split`` gets each label's device ms a
    call (the kernels launched inside it); the ranges' own rows are left
    out of the device total."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    if warmup:
        fn()
    torch.cuda.synchronize()
    saved = []
    for mod, attr, label in sections:
        orig = getattr(mod, attr)

        def wrapped(*a, _orig=orig, _label=label, **kw):
            with record_function(_label):
                return _orig(*a, **kw)
        saved.append((mod, attr, orig))
        setattr(mod, attr, wrapped)
    try:
        with profile(activities=[ProfilerActivity.CPU] * cpu
                     + [ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    labels = {label for _, _, label in sections}
    by_name, events = {}, 0
    for ev in prof.key_averages():
        if ev.key in labels:
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                split[ev.key] = split.get(ev.key, 0.0) + (
                    getattr(ev, "device_time_total", 0) or 0) / 1e3 / reps
            continue
        # device-side events only (kernels, copies): the aten op rows
        # carry the same device time again
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0) + us / reps
            events += ev.count / reps
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

    def int8_rec(x_q, w_q, a_scale, w_scale, rows_per_lane, tile=None):
        shapes.append(("int8_matmul", *x_q.shape, w_q.shape[1],
                       a_scale.numel()))
        return int8_cuda(x_q, w_q, a_scale, w_scale, rows_per_lane, tile)

    def fused_rec(x, w, b, activation="relu", tile=None):
        shapes.append(("fused_linear", *x.shape, w.shape[1], 0))
        return fused_cuda(x, w, b, activation, tile)

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

    def knn_rec(samples, points, k, radius=None, tile=None):
        b, s, c = samples.shape
        add("knn", *knn_work(b, s, points.shape[1], c, k))
        return knn(samples, points, k, radius, tile)

    def fps_rec(points, n_samples, tile=None):
        b, n, c = points.shape
        add("fps", *fps_work(b, n, n_samples, c))
        return fps(points, n_samples, tile)

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
    # Host time a dispatch beyond its device time, per lane: the fixed
    # term of repro_torch.roofline.H100_SXM (dispatch_overhead_s).
    over = ("not measured" if isinstance(prof["device_ms"], str) else
            (eng.stats.serve_s / eng.stats.batches
             - prof["device_ms"] / 1e3) / MAX_BATCH)
    emit({"phase": "serve", "name": name, "warmup_s": warm_s,
          "dispatches": dispatches, "launches": launches,
          "per_dispatch": {k: v / dispatches for k, v in launches.items()},
          "max_abs_err_vs_cpu": err, "max_abs_logit": scale,
          "bitwise_vs_cpu": bitwise,
          "tolerance": f"{atol_rel} * max|logit|", "why": why,
          "top1_agree": top1, "samples_per_s": sps,
          "serve_s": eng.stats.serve_s, "host_s": eng.stats.host_s,
          "overhead_s_per_sample": over, "profile": prof})
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
                    {"fps": 4, "knn": 4, "fused_linear": 28})
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
                     "fused_linear": 24})
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
            {"knn": 4, "fused_linear": 28}, 1e-4, why_fp32))

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
        {"knn": 4, "knn_ball": 4, "fused_linear": 28}, 1e-4,
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
         "fused_linear": 24}, 1e-4,
        "FPS, kNN and upsample indices identical; fp32 layers (fc1 at K = "
        "1056) sum in another order than the CPU, as for Elite"))
    return total


# ------------------------------------------------- analysis, tune --

# The tune phase: Lite's quick space, every candidate measured on the
# card through PointCloudEngine over a queue of 64 clouds, three times.
TUNE_REQUESTS = 64
TUNE_ITERS = 3
# The product kernels a candidate may launch (knn runs on every one).
PRODUCT_KERNELS = ("int8_matmul", "fused_linear", "grouped_transfer_stats",
                   "grouped_transfer", "fps", "w8_matmul", "flash_attention")


def analysis_phase(torch):
    """``python -m repro_torch.analysis --all-variants`` in process: the
    spec passes over every shipped variant, the registry contracts (each
    entry run twice on CPU tensors), the op traces of every variant's
    stage callables (on CPU tensors), README.md's fleet and the
    plan-space sweep.  0 error findings; no kernel launch (it runs on the
    CPU).  Returns the launches."""
    import contextlib
    import io

    from repro_torch.analysis.__main__ import main as analyze
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, launches = counted(torch, lambda: analyze(["--all-variants",
                                                        "-q"]))
    lines = buf.getvalue().splitlines()
    summary = next((ln for ln in lines if ln.startswith("SUMMARY")), "")
    check(rc == 0 and " 0 error(s)" in summary,
          f"analysis: error findings on the shipped specs: "
          f"{buf.getvalue()}")
    check(not any(launches.values()),
          f"analysis: launched a kernel: {launches}")
    emit({"phase": "analysis", "summary": summary, "rc": rc,
          "seconds": time.perf_counter() - t0, "launches": launches})
    return launches


def trace_phase(torch, smi, plans):
    """The trace pass (``repro_torch.analysis.trace.analyze_plan_trace``)
    on CUDA tensors, where the kernels launch: each of ``plans`` (name,
    spec, the kernels its op stream must hold) finds nothing, and its
    recorded stream names those kernels' launches.  One line a plan: the
    callables traced, aten ops recorded, launches by kernel and float64
    islands accepted.  An analysis, not a main path: its launches are
    not counted."""
    import collections

    from repro_torch.analysis.trace import analyze_plan_trace
    t_all = time.perf_counter()
    for name, spec, want in plans:
        traces = []
        t0 = time.perf_counter()
        found = analyze_plan_trace(spec, device="cuda", traces=traces)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = collections.Counter()
        for tr in traces:
            launches.update(tr.launches)
        check(not found, f"trace {name}: {[str(f) for f in found]}")
        check(set(want) <= set(launches),
              f"trace {name}: expected launches of {sorted(want)} in the "
              f"op stream, recorded {dict(launches)}")
        emit({"phase": "trace", "plan": name, "card": smi,
              "callables": len(traces),
              "aten_ops": sum(tr.n_aten for tr in traces),
              "launches": dict(sorted(launches.items())),
              "f64_islands": sum(tr.islands for tr in traces),
              "seconds": seconds})
    emit({"phase": "trace_total", "seconds": time.perf_counter() - t_all})


def ranks(values):
    """1-based ranks of ``values``, largest first, ties averaged."""
    order = sorted(range(len(values)), key=lambda i: -values[i])
    out = [0.0] * len(values)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and values[order[j + 1]] == values[order[i]]:
            j += 1
        for t in range(i, j + 1):
            out[order[t]] = (i + j) / 2 + 1
        i = j + 1
    return out


def spearman(a, b):
    """Spearman's rho of two rank lists (Pearson's r on the ranks)."""
    n = len(a)
    ma, mb = sum(a) / n, sum(b) / n
    cov = sum((x - ma) * (y - mb) for x, y in zip(a, b))
    va = sum((x - ma) ** 2 for x in a) ** 0.5
    vb = sum((y - mb) ** 2 for y in b) ** 0.5
    return cov / (va * vb) if va and vb else float("nan")


def expected_kernels(spec):
    """The kernels a quick-space candidate must launch: kNN always; on
    ``cuda`` stages, the int8 product for int8 ones and the fp32 product
    for fp32 ones (their residual blocks, fused or not); the fused
    group's stats variant on either backend (a fused op is its kernel, as
    JAX's runs its Pallas kernel on any backend).  Embed and head follow
    ``spec.backend`` (``ref``)."""
    want = {"knn"}
    if spec.fused_group != "none":
        want.add("grouped_transfer_stats")
    if set(spec.stage_backend or (spec.backend,)) == {"cuda"}:
        prec = set(spec.stage_precision or (spec.precision,))
        if "int8" in prec:
            want.add("int8_matmul")
        if "fp32" in prec:
            want.add("fused_linear")
    return want


def tune_phase(torch, params, smi):
    """``tune()`` on the card at full width: Lite's topology (512 points,
    URS, k = 16) with its quick space whole (every CBR route, both group
    paths) measured, the anchor included, in the estimate's order.  Each
    candidate's measurement is counted on its own: a ``cuda`` candidate
    launches its product kernels, a ``ref`` one none, only kNN.  The
    estimate is ``H100_SXM``'s; the phase prints both ranks and
    Spearman's rho.  Returns the launches."""
    from repro_torch import roofline
    from repro_torch.api.spec import lite_spec
    from repro_torch.tune import search
    from repro_torch.tune.artifact import validate_artifact

    t0 = time.perf_counter()
    # Lite's topology with fp32 embed and head (JAX's tuner tests' base):
    # under Lite's int8 embed and head no candidate but the anchor would
    # be fp32, and the fp32 check below would hold nothing.
    base = lite_spec(N_CLASSES, precision="fp32")
    space = search.quick_space(base.serving())
    measured = []
    inner = search._measure

    def measure(cand, *args, **kw):
        out, launches = counted(torch, lambda: inner(cand, *args, **kw))
        measured.append((cand, launches, out))
        return out

    search._measure = measure
    try:
        doc = search.tune(base, params, top_k=len(space),
                          hw=roofline.H100_SXM, max_batch=MAX_BATCH,
                          n_requests=TUNE_REQUESTS, measure_iters=TUNE_ITERS,
                          seed=SEED)
    finally:
        search._measure = inner
    validate_artifact(doc)
    check(measured and measured[0][0].anchor,
          "tune: the anchor was not measured first")
    anchor_logits = measured[0][2]
    scale = anchor_logits.abs().max().item()
    rows = doc["rows"]
    anchor = rows[0]
    check(anchor["anchor"] and anchor["measured_sps"] is not None
          and anchor["frontier"], "tune: the anchor is not measured on the "
                                  "frontier")
    estimated = [c for c, _, _ in measured[1:]]
    check(estimated == sorted(estimated,
                              key=lambda c: (c.est_time, c.fingerprint)),
          "tune: candidates were not measured in (estimated time, "
          "fingerprint) order")
    want_names = {r["name"] for r in rows[1:] if r["estimated_sps"]}
    check({c.label for c in estimated} == want_names
          and len(estimated) == len(space),
          f"tune: measured {len(estimated)} candidates, the space has "
          f"{len(space)}")
    total = {k: 0 for k in counters()}
    by_name = {r["name"]: r for r in rows}
    cands = []
    for cand, launches, _ in measured:
        add_launches(total, launches)
        row = by_name[cand.label]
        check(cand.measure_error is None and row["measured_sps"],
              f"tune: {cand.label} was not measured: {cand.measure_error}")
        want = expected_kernels(cand.spec)
        for kname in ("knn",) + PRODUCT_KERNELS:
            check((launches[kname] > 0) == (kname in want),
                  f"tune: {cand.label} launched {kname} {launches[kname]} "
                  f"times; it should launch {sorted(want)} only")
        int8 = "int8" in (cand.spec.stage_precision or ()) or \
            cand.spec.precision == "int8"
        if not int8:
            check(row["err_vs_fp32"] <= 1e-4 * scale,
                  f"tune: fp32 candidate {cand.label} err_vs_fp32 "
                  f"{row['err_vs_fp32']} beyond 1e-4 * {scale}")
        cands.append({"label": cand.label, "estimated_sps":
                      row["estimated_sps"], "measured_sps":
                      row["measured_sps"], "err_vs_fp32": row["err_vs_fp32"],
                      "precision": "int8" if int8 else "fp32",
                      "frontier": row["frontier"],
                      "launches": {k: v for k, v in launches.items() if v}})
    est_rank = ranks([c["estimated_sps"] for c in cands])
    meas_rank = ranks([c["measured_sps"] for c in cands])
    for c, e, m in zip(cands, est_rank, meas_rank):
        c["estimated_rank"], c["measured_rank"] = e, m
        emit({"phase": "tune_row", **c})
    emit({"phase": "tune", "card": smi, "hw": doc["hw"], "base": base.name,
          "n_points": base.n_points, "max_batch": MAX_BATCH,
          "n_requests": TUNE_REQUESTS, "measure_iters": TUNE_ITERS,
          "candidates": len(cands), "anchor_max_abs_logit": scale,
          "fp32_tolerance": "1e-4 * the anchor's max|logit| (M-2's)",
          "spearman_rho": spearman(est_rank, meas_rank),
          "frontier": [c["label"] for c in cands if c["frontier"]],
          "launches": total, "seconds": time.perf_counter() - t0})
    return total


# ------------------------------------------------------------- tiles --

# The tiles phase: the tile sweep's timings (CUDA-graph replays, the
# median of TILE_ITERS) at Lite's, M-2's and Elite's plan shapes for a
# MAX_BATCH dispatch, and flash attention at a 512-token tinyllama shape.
TILE_ITERS = 5
TILE_FLASH_SHAPE = (32, 512, 64)
TILE_HEAD_SHAPE = (1, 512, 512)


def pinned_names(kernel: str, tile):
    """The template names (the wrappers' ``.templates`` keys) a pinned
    ``KernelTuning`` value may launch: the route suffix follows the
    operands, ``grouped_transfer``'s BN follows C_out within its row tile
    and ``fps`` runs its tail variant on a cloud past the tile."""
    from repro_torch.kernels import tuning
    routes = ("vec", "scalar")
    if kernel == "fused_linear":
        bn, small = tuning.card_tile(kernel, tile)
        return {f"bn{bn}{'_small' if small else ''}_{r}" for r in routes}
    if kernel == "int8_matmul":
        return {f"bn{tuning.card_tile(kernel, tile)}_{r}" for r in routes}
    if kernel in ("grouped_transfer", "grouped_transfer_stats"):
        rows = tuning.card_tile("grouped_transfer", tile)
        return {f"bn{bn}_{r}" for bn in tuning.GROUPED_TRANSFER_ROWS[rows]
                for r in routes}
    if kernel == "knn":
        return {f"select_q{tile}"}
    return {f"tile{tile}", f"tile{tile}_tail"}


def template_counters():
    """Each tunable wrapper's per-template launch counter, by the name of
    its launch count (``counters()``)."""
    return {k: f.templates for k, (f, attr) in counters().items()
            if attr == "launches" and hasattr(f, "templates")}


def tile_parity(torch, kernel, got, want):
    """(ok, max abs err, rule) of a template's output against the plain
    version, by the kernel phases' rules."""
    if kernel in ("knn", "fps", "int8_matmul"):
        return bool(torch.equal(got, want)), 0.0, "bitwise"
    if kernel == "flash_attention":
        tol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-5
        ok, err = rowwise_close(torch, got, want, tol)[:2]
        return ok, err, f"rowwise rtol=atol={tol}"
    err = (got - want).abs().max().item()
    return (bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5)), err,
            "rtol=atol=1e-5")


def tile_sweep(torch, kernel, shape, batch, dtype, specs):
    """Every template of ``kernel`` in the full grid at one shape: its
    output bitwise equal to the wrapper's own choice and within the plain
    version's rule, its time from ``tune.kernels.sweep``.  One
    ``tile_row`` line a template; returns the rows."""
    from repro_torch.tune import kernels as K
    args = K.make_inputs(kernel, shape, batch=batch, dtype=dtype,
                         device="cuda", seed=SEED)
    auto_tile = K.TILE_GRIDS[kernel]["full"][0]
    auto = K.run(kernel, args, auto_tile)
    want = K.plain(kernel, args)
    own = K.template_name(kernel, args, auto_tile)
    timed = dict(K.sweep(kernel, shape, batch=batch, dtype=dtype,
                         quick=False, iters=TILE_ITERS))
    rows = []
    for tile in K.TILE_GRIDS[kernel]["full"]:
        if tile not in timed:
            # a tile the kernel cannot take here (flash's other route):
            # refused as ValueError
            try:
                K.run(kernel, args, tile)
            except ValueError as e:
                rows.append({"kernel": kernel, "tile": tile,
                             "refused": str(e)})
                continue
            raise SmokeFailure(f"tiles: {kernel} {tile} ran but the sweep "
                               f"skipped it")
        got = K.run(kernel, args, tile)
        torch.cuda.synchronize()
        check(torch.equal(got, auto), f"tiles: {kernel} {tile} at {shape} "
              f"is not bitwise equal to the wrapper's own template")
        ok, err, rule = tile_parity(torch, kernel, got, want)
        check(ok, f"tiles: {kernel} {tile} at {shape}: {err} beyond the "
                  f"plain version's rule ({rule})")
        name = K.template_name(kernel, args, tile)
        rows.append({"kernel": kernel, "specs": specs, "shape": shape,
                     "batch": batch, "dtype": dtype, "tile": tile,
                     "template": name, "ms": timed[tile],
                     "own_choice": tile == auto_tile or name == own,
                     "vs_plain": rule, "max_abs_err": err})
    fastest = min((r for r in rows if "ms" in r), key=lambda r: r["ms"])
    for r in rows:
        if "ms" in r:
            r["fastest"] = r is fastest
        emit({"phase": "tile_row", **r})
    return rows


def tiles_phase(torch, smi, cases):
    """``KernelTuning`` on the card.  (a) Every template of every tunable
    kernel at ``plan_shapes`` of Lite, M-2 and Elite for a MAX_BATCH
    dispatch (the product kernels also at the head's fc1, and flash at a
    tinyllama shape, bf16 and f32): bitwise the
    wrapper's own choice, within the plain version's rule, timed.
    (b) One dispatch of each spec under every
    ``tuning_candidates(quick=False)`` entry and under ``plan_tuning``:
    logits bitwise ``DEFAULT_TUNING``'s, the same launches, and the
    ``.templates`` counters showing the pinned templates.  ``cases``:
    (name, spec, params, clouds).  Returns the dispatches' launches."""
    from repro_torch.api.build import build
    from repro_torch.kernels.tuning import DEFAULT_TUNING, pinned
    from repro_torch.tune import kernels as K

    t0 = time.perf_counter()
    K.clear_cache()
    by_shape = {}
    for name, spec, _, _ in cases:
        for kernel, shape in K.plan_shapes(spec).items():
            by_shape.setdefault((kernel, shape), []).append(name)
    rows = []
    # the head's fc1 (Lite's and M-2's 512 -> 512 at one row a cloud)
    for kernel in ("fused_linear", "int8_matmul"):
        by_shape[(kernel, TILE_HEAD_SHAPE)] = ["head_fc1"]
    for (kernel, shape), specs in by_shape.items():
        rows += tile_sweep(torch, kernel, shape, MAX_BATCH, "float32", specs)
    for dtype in ("bfloat16", "float32"):
        rows += tile_sweep(torch, "flash_attention", TILE_FLASH_SHAPE,
                           LM_BATCH, dtype, ["tinyllama-1.1b"])
    sweep_s = time.perf_counter() - t0

    total = {k: 0 for k in counters()}
    tcs = template_counters()
    dispatches = []
    for name, spec, params, clouds in cases:
        full = torch.from_numpy(clouds[:MAX_BATCH]).cuda()
        tunings = list(K.tuning_candidates(quick=False))
        tunings.append(K.plan_tuning(spec, batch=MAX_BATCH,
                                     iters=TILE_ITERS))
        want = launches0 = None
        for i, kt in enumerate(tunings):
            pipe = build(spec.replace(kernel_tuning=kt), params)
            state = pipe.seed_state(SEED, MAX_BATCH)
            for c in tcs.values():
                c.clear()
            (got, _), launches = counted(
                torch, lambda: pipe.infer(full, state.clone()))
            add_launches(total, launches)
            used = {k: dict(c) for k, c in tcs.items() if c}
            if i == 0:
                check(kt == DEFAULT_TUNING, "tiles: the first candidate is "
                                            "not DEFAULT_TUNING")
                want, launches0 = got, launches
            else:
                check(torch.equal(got, want),
                      f"tiles: {name} under {kt} is not bitwise equal to "
                      f"DEFAULT_TUNING's logits")
                check(launches == launches0,
                      f"tiles: {name} under {kt} launched {launches}, "
                      f"DEFAULT_TUNING {launches0}")
                for kernel, names in used.items():
                    field = ("grouped_transfer" if kernel.startswith(
                        "grouped_transfer") else kernel)
                    tile = pinned(field, kt)
                    if tile is not None:
                        check(set(names) <= pinned_names(kernel, tile),
                              f"tiles: {name} under {kt}: {kernel} "
                              f"launched {names}, not the pinned {tile}")
            dispatches.append({"spec": name, "tuning": dataclasses.asdict(kt),
                               "plan_tuning": i == len(tunings) - 1,
                               "templates": used,
                               "bitwise_vs_default": True})
    for d in dispatches:
        emit({"phase": "tile_dispatch", **d})
    emit({"phase": "tiles", "card": smi, "max_batch": MAX_BATCH,
          "iters": TILE_ITERS, "graph_calls": K.GRAPH_CALLS,
          "templates": sum(1 for r in rows if "ms" in r),
          "refused": sum(1 for r in rows if "refused" in r),
          "dispatches": len(dispatches), "sweep_s": sweep_s,
          "launches": total, "seconds": time.perf_counter() - t0})
    return total


# ----------------------------------------------- async, stream, fleet --

# Stream sessions: frames a session serves, the frame of its scene cut
# (+1.0 in x) and of its reset(), the drift threshold of README.md's
# stream spec, and the Elite session's eviction age.
STREAM_FRAMES, STREAM_CUT, STREAM_RESET = 32, 16, 24
STREAM_THRESHOLD = 0.05
ELITE_MAX_AGE = 8
# The async phase's Lite deadline and the fleet of README.md's "Fleet
# serving" section.
ASYNC_SLO_MS = 50.0
ASYNC_QUEUES = 5
FLEET_BATCH, FLEET_REPLICAS, LIDAR_INFLIGHT, LIDAR_SLO_MS = 8, 2, 8, 20.0


def rigid_frames(np, rng, n_points: int):
    """STREAM_FRAMES frames of one synthetic cloud, each the last turned
    by 0.004 rad about z and shifted by 0.002 of a normal draw (at most
    about 0.015 of displacement a frame on these clouds, well under
    STREAM_THRESHOLD), with a scene cut of +1.0 in x at STREAM_CUT."""
    cur = make_clouds(np, rng, 1, n_points)[0]
    c, s = np.cos(0.004), np.sin(0.004)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    frames = []
    for i in range(STREAM_FRAMES):
        if i == STREAM_CUT:
            cur = cur + np.float32([1.0, 0.0, 0.0])
        frames.append(np.ascontiguousarray(cur, np.float32))
        cur = (cur @ rot.T + 0.002 * rng.standard_normal(3)).astype(
            np.float32)
    return frames


def host_syncs(torch, fn):
    """Run ``fn`` under CUDA's sync debug mode and the profiler: (the
    synchronizing calls PyTorch reports, and per name the CUDA runtime
    calls that block the host; the profiler's own start adds some, which
    a window around ``lambda: None`` shows)."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    reported = sum("synchroniz" in str(w.message) for w in caught)
    blocking = {ev.key: ev.count for ev in prof.key_averages()
                if ev.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                              "cudaEventSynchronize", "cudaMemcpy")}
    return reported, blocking


def solo_logits(torch, pipe, cloud, max_batch):
    """A cloud served alone: zero-padded to ``max_batch``, from the seed
    LFSR state, on the pipeline's device."""
    from repro_torch.serve.batching import pad_to_batch
    batch, _ = pad_to_batch(torch.from_numpy(cloud[None]), max_batch)
    logits, _ = pipe.infer(batch, pipe.seed_state(SEED, max_batch))
    return logits[0]


def percentiles(np, values):
    lat = np.asarray(values, np.float64)
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def async_phase(torch, np, params, clouds, smi):
    """Lite (int8) through ``AsyncPointCloudEngine`` at MAX_BATCH with the
    deadline policy: the clouds submitted one at a time and pumped
    without blocking, on the real clock.  Every future is held bitwise
    against its cloud's solo dispatch on the card and against the CPU
    port's async engine.  Returns the launches."""
    from repro_torch.api.spec import lite_spec
    from repro_torch.serve.async_engine import AsyncPointCloudEngine
    from repro_torch.serve.pointcloud import PointCloudEngine
    t_phase = time.perf_counter()
    spec = lite_spec(N_CLASSES).serving(
        policy="deadline", slo_ms=ASYNC_SLO_MS).replace(backend="cuda")
    eng = AsyncPointCloudEngine.from_params(params, spec,
                                            max_batch=MAX_BATCH, seed=SEED)
    check(eng.device.type == "cuda", "async: engine is not on the card")
    warm_s = eng.warmup()

    def serve():
        futs = []
        for cloud in clouds:
            futs.append(eng.submit(cloud))
            eng.pump(block=False)
        while eng.pending:
            eng.pump(block=False)
        return futs

    eng.reset_stats()
    t0 = time.perf_counter()
    futs, launches = counted(torch, serve)
    wall_s = time.perf_counter() - t0
    dispatches = eng.stats.batches
    expect_launches("async", launches, {"knn": 4, "int8_matmul": 28},
                    dispatches)
    stats = dict(eng.stats.__dict__, samples_per_s=eng.stats.samples_per_s)
    lat = percentiles(np, eng.latencies_ms)

    for i, (cloud, fut) in enumerate(zip(clouds, futs)):
        check(torch.equal(fut.result(),
                          solo_logits(torch, eng.pipeline, cloud, MAX_BATCH)),
              f"async: request {i} differs from its solo dispatch")
    cpu = AsyncPointCloudEngine.from_params(params, spec, device="cpu",
                                            max_batch=MAX_BATCH, seed=SEED)
    cfuts = [cpu.submit(c) for c in clouds]
    cpu.flush()
    for i, (fut, cfut) in enumerate(zip(futs, cfuts)):
        check(torch.equal(fut.result().cpu(), cfut.result()),
              f"async: request {i} differs from the CPU port's")

    # One dispatch of MAX_BATCH clouds: its host syncs.
    for cloud in clouds[:MAX_BATCH]:
        eng.submit(cloud)
    reported, blocking = host_syncs(torch, lambda: eng.pump(block=False))
    eng.flush()
    _, blocking_empty = host_syncs(torch, lambda: None)

    def burst():
        for cloud in clouds:
            eng.submit(cloud)
        eng.flush()

    # The async engine beside the sync engine on the same queue: device
    # idle share under the profiler, and samples/s (each engine's own
    # serve_s) over ASYNC_QUEUES queues a turn, in turns: the async engine
    # as above ("async": its tail waits out the deadline, the card idle),
    # the sync engine, and the async engine given the whole queue at once
    # and flushed ("async_burst": no wait).
    prof_async = profile_summary(*profile_call(torch, serve))
    sync = PointCloudEngine(params, spec, max_batch=MAX_BATCH, seed=SEED)
    sync.warmup()
    prof_sync = profile_summary(*profile_call(
        torch, lambda: sync.classify(clouds)))
    turns = {"async": [], "sync": [], "async_burst": []}
    runs = {"async": serve, "async_burst": burst,
            "sync": lambda: sync.classify(clouds)}
    for kind in ("async", "sync", "async_burst", "async_burst", "sync",
                 "async"):
        engine = sync if kind == "sync" else eng
        engine.stats.reset()
        for _ in range(ASYNC_QUEUES):
            runs[kind]()
        turns[kind].append(engine.stats.samples_per_s)
    emit({"phase": "async_lite", "card": smi, "policy": eng.policy.describe(),
          "max_batch": MAX_BATCH, "requests": len(clouds),
          "dispatches": dispatches, "launches": launches,
          "warmup_s": warm_s, "wall_s": wall_s,
          "wall_samples_per_s": len(clouds) / wall_s, **stats,
          "per_request": lat,
          "bitwise_vs_solo_dispatch": True, "bitwise_vs_cpu_engine": True,
          "host_syncs_per_dispatch": {
              "sync_debug_mode": reported,
              "blocking_runtime_calls": blocking,
              "blocking_runtime_calls_empty_window": blocking_empty},
          "device_ms": prof_async["device_ms"],
          "idle_share": prof_async["idle_share"],
          "sync_engine": {"device_ms": prof_sync["device_ms"],
                          "idle_share": prof_sync["idle_share"]},
          "samples_per_s_in_turns": turns,
          "seconds": time.perf_counter() - t_phase})
    return launches


def stream_specs():
    """The stream phase's three sessions: (name, spec, max_age)."""
    from repro_torch.api.spec import elite_spec, lite_spec
    stream = dict(stream=True, stream_drift_threshold=STREAM_THRESHOLD,
                  backend="cuda")
    lite = lite_spec(N_CLASSES).replace(sampler="fps", **stream).serving()
    return (("lite", lite, None),
            ("lite_seg", lite.replace(head="seg", n_classes=SEG_CLASSES),
             None),
            ("elite", elite_spec(N_CLASSES).replace(**stream).serving(),
             ELITE_MAX_AGE))


def stream_session(torch, pipe, frames, max_age):
    """Serve ``frames`` through a direct StreamSession (reset() before
    STREAM_RESET): the logits, the hit flags, the wall ms a frame (ended
    by a device sync on the card) and the kNN and FPS launches of each
    frame."""
    from repro_torch.kernels import fps, knn
    from repro_torch.serve.streaming import StreamSession
    sess = StreamSession(pipe, seed=SEED, max_age=max_age)
    outs, hits, wall_ms, mapping = [], [], [], []
    on_card = pipe.device.type == "cuda"
    for i, frame in enumerate(frames):
        if i == STREAM_RESET:
            sess.reset()
        before = (sess.stats.hits, knn.knn_cuda.launches,
                  fps.fps_cuda.launches)
        t0 = time.perf_counter()
        out = sess.infer(frame)
        if on_card:
            torch.cuda.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0))
        outs.append(out)
        hits.append(sess.stats.hits > before[0])
        mapping.append(knn.knn_cuda.launches - before[1]
                       + fps.fps_cuda.launches - before[2])
    return outs, hits, wall_ms, mapping, sess.stats


def stream_phase(torch, np, rng, params_by_name, smi):
    """Three direct stream sessions on the card (Lite FPS, the same with
    the seg head, Elite unfused with max_age), STREAM_FRAMES drifting
    frames each with a scene cut and a reset(): hit and miss decisions
    equal to the CPU port's, every frame bitwise equal to
    ``replay_reference`` on the card, Lite bitwise and Elite within
    1e-4 of max|logit| against the CPU, a hit launching no mapping
    kernel; Lite's frames bitwise again through the async engine's
    stream.  Returns (launches, Lite's frames, Lite's logits)."""
    from repro_torch.api.build import build
    from repro_torch.serve.async_engine import AsyncPointCloudEngine
    from repro_torch.serve.streaming import replay_reference
    t_phase = time.perf_counter()
    total = {k: 0 for k in counters()}
    lite_frames = lite_outs = None
    for name, spec, max_age in stream_specs():
        params = params_by_name[name]
        pipe = build(spec, params)
        frames = rigid_frames(np, rng, spec.n_points)
        pipe.infer_collect(frames[0][None], pipe.seed_state(SEED, 1))
        (outs, hits, wall_ms, mapping, stats), launches = counted(
            torch, lambda: stream_session(torch, pipe, frames, max_age))
        misses = hits.count(False)
        seg = spec.head == "seg"
        product = ("int8_matmul", 28) if spec.precision == "int8" else (
            "fused_linear", 28)
        expect = {"knn": misses * (5 if seg else 4),
                  "knn_k1": misses if seg else 0,
                  "fps": misses * 4, product[0]: product[1] * len(frames)}
        for kname, n in launches.items():
            check(n == expect.get(kname, 0),
                  f"stream {name}: {kname} launched {n} times, expected "
                  f"{expect.get(kname, 0)} ({misses} misses of "
                  f"{len(frames)} frames)")
        check(0 < misses < len(frames), f"stream {name}: no hit or no miss")
        check(all(m == 0 for m, h in zip(mapping, hits) if h),
              f"stream {name}: a hit launched a mapping kernel")

        ref = replay_reference(pipe, frames, seed=SEED, max_age=max_age,
                               resets=(STREAM_RESET,))
        for i, (got, want) in enumerate(zip(outs, ref)):
            check(torch.equal(got, want), f"stream {name}: frame {i} differs "
                                          f"from replay_reference")
        cpu_outs, cpu_hits, _, _, cpu_stats = stream_session(
            torch, build(spec, params, device="cpu"), frames, max_age)
        check(cpu_hits == hits, f"stream {name}: hits differ from the CPU "
                                f"port's")
        got = torch.stack([o.cpu() for o in outs])
        want = torch.stack(cpu_outs)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        bitwise = bool(torch.equal(got, want))
        tol = 0.0 if spec.precision == "int8" else 1e-4
        check(bitwise if tol == 0 else err <= tol * scale,
              f"stream {name}: card vs CPU max abs err {err} beyond "
              f"{tol or 'bitwise'} * {scale}")

        # A hit and a miss dispatch alone: device time under the profiler
        # (ten calls each, per call).
        state = pipe.seed_state(SEED, 1)
        pts = torch.from_numpy(frames[1][None])
        _, _, cache = pipe.infer_collect(torch.from_numpy(frames[0][None]),
                                         state.clone())
        prof_hit = profile_summary(
            *profile_call(torch, lambda: pipe.infer_cached(
                pts, state.clone(), cache), reps=10),
            mapping_ms=("knn_kernel", "fps_kernel"))
        prof_miss = profile_summary(
            *profile_call(torch, lambda: pipe.infer_collect(
                pts, state.clone()), reps=10),
            mapping_ms=("knn_kernel", "fps_kernel"))
        row = {"phase": f"stream_{name}", "card": smi, "spec": spec.name,
               "sampler": spec.sampler, "head": spec.head,
               "fused_group": spec.fused_group, "max_age": max_age,
               "frames": len(frames), "hits": stats.hits,
               "misses": stats.misses, "evictions": stats.evictions,
               "resets": stats.resets, "hit_flags_equal_cpu": True,
               "bitwise_vs_replay_reference": True,
               "bitwise_vs_cpu": bitwise, "max_abs_err_vs_cpu": err,
               "max_abs_logit": scale,
               "tolerance": f"{tol} * max|logit|" if tol else "bitwise",
               "launches": launches,
               "mapping_launches_a_hit_skips": max(mapping),
               "hit_wall_ms": statistics.median(
                   [w for w, h in zip(wall_ms[1:], hits[1:]) if h]),
               "miss_wall_ms": statistics.median(
                   [w for w, h in zip(wall_ms[1:], hits[1:]) if not h]),
               "hit_device_ms": prof_hit["device_ms"],
               "miss_device_ms": prof_miss["device_ms"],
               "miss_mapping_device_ms": prof_miss["mapping_ms"],
               "hit_idle_share": prof_hit["idle_share"],
               "miss_idle_share": prof_miss["idle_share"]}
        # The same frames through the async engine's stream, MAX_BATCH
        # lanes a dispatch: Lite's contract is bitwise; for the fp32 specs
        # the difference is reported (the head's last product is a cuBLAS
        # call, whose kernel may change with the number of rows).
        eng = AsyncPointCloudEngine(pipe, max_batch=MAX_BATCH, seed=SEED)
        asess = eng.open_stream(max_age=max_age)
        async_err = 0.0
        for i, frame in enumerate(frames):
            if i == STREAM_RESET:
                asess.reset()
            fut = asess.submit(frame)
            eng.flush()
            async_err = max(async_err,
                            (fut.result() - outs[i]).abs().max().item())
        check(asess.stats.hits == stats.hits,
              f"stream {name}: the async session's hits differ")
        if spec.precision == "int8":
            check(async_err == 0.0, f"stream {name}: a frame through the "
                  f"async engine ({MAX_BATCH} lanes) differs from the direct "
                  f"session (max abs err {async_err})")
        row["async_engine_vs_direct_max_abs_err"] = async_err
        if name == "lite":
            lite_frames, lite_outs = frames, outs
        row["seconds"] = time.perf_counter() - t_phase
        emit(row)
        add_launches(total, launches)
    return total, lite_frames, lite_outs


def fleet_phase(torch, np, params_by_name, clouds, elite_clouds,
                lite_frames, lite_outs, smi):
    """README.md's fleet (Lite and Elite tiers, tenants ``lidar`` and
    ``analytics``, two replicas each, least-loaded, max_batch 8) on the
    card: the Lite tier is the stream phase's Lite spec (so a stream
    session can ride the fleet), Elite runs the fused group->transfer
    kernel.  Both tenants submit the whole queue without pumping, so
    ``lidar``'s bulkhead sheds; every shed is an ``Overloaded`` and every
    admitted future equals its tier's solo dispatch bitwise.  Then one
    ``fleet.open_stream("lidar")`` session replays the stream phase's
    Lite frames bitwise.  Returns the launches."""
    from repro_torch.api.spec import FleetSpec, TenantSpec, elite_spec
    from repro_torch.serve.admission import Overloaded
    from repro_torch.serve.fleet import PipelineFleet
    t_phase = time.perf_counter()
    lite = stream_specs()[0][1]
    elite = elite_spec(N_CLASSES).serving().replace(
        backend="cuda", fused_group="grouped_transfer")
    fleet_spec = FleetSpec(
        pipelines=(lite, elite),
        tenants=(TenantSpec("lidar", lite.name, slo_ms=LIDAR_SLO_MS,
                            max_inflight=LIDAR_INFLIGHT),
                 TenantSpec("analytics", elite.name, slo_ms=0.0)),
        replicas=FLEET_REPLICAS, router="least-loaded",
        max_batch=FLEET_BATCH)
    fleet = PipelineFleet.from_specs(
        fleet_spec, {lite.name: params_by_name["lite"],
                     elite.name: params_by_name["elite"]}, seed=SEED)
    warm_s = fleet.warmup()
    queues = {"lidar": clouds, "analytics": elite_clouds}

    def burst():
        admitted, shed = [], []
        for i in range(N_QUEUE):
            for tenant, queue in queues.items():
                try:
                    admitted.append((tenant, i,
                                     fleet.submit(tenant, queue[i])))
                except Overloaded as exc:
                    shed.append((tenant, exc))
        fleet.flush()
        return admitted, shed

    t0 = time.perf_counter()
    (admitted, shed), launches = counted(torch, burst)
    wall_s = time.perf_counter() - t0
    per_tier = {lite.name: {"fps": 4, "knn": 4, "int8_matmul": 28},
                elite.name: {"fps": 4, "knn": 4, "grouped_transfer_stats": 4,
                             "fused_linear": 24}}
    expect = {}
    for rep in fleet.replicas:
        for kname, n in per_tier[rep.tier].items():
            expect[kname] = expect.get(kname, 0) + n * rep.engine.stats.batches
    for kname, n in launches.items():
        check(n == expect.get(kname, 0), f"fleet: {kname} launched {n} times, "
                                         f"expected {expect.get(kname, 0)}")
    check(launches["grouped_transfer_stats"] > 0,
          "fleet: grouped_transfer never launched")
    tstats = fleet.tenant_stats()
    check(all(isinstance(exc, Overloaded) for _, exc in shed),
          "fleet: a shed is not an Overloaded")
    check(tstats["lidar"]["shed"] == N_QUEUE - LIDAR_INFLIGHT
          and tstats["lidar"]["submitted"] == LIDAR_INFLIGHT,
          f"fleet: lidar's bulkhead admitted {tstats['lidar']['submitted']}")
    pipes = {rep.tier: rep.engine.pipeline for rep in fleet.replicas}
    for tenant, i, fut in admitted:
        tier = fleet_spec.tier_of(tenant).name
        check(torch.equal(fut.result(), solo_logits(
            torch, pipes[tier], queues[tenant][i], FLEET_BATCH)),
              f"fleet: {tenant} request {i} differs from its tier's solo "
              f"dispatch")
    agg = fleet.stats()

    sess = fleet.open_stream("lidar")
    for i, frame in enumerate(lite_frames):
        if i == STREAM_RESET:
            sess.reset()
        fut = sess.submit(frame)
        fleet.flush()
        check(torch.equal(fut.result(), lite_outs[i]),
              f"fleet: lidar stream frame {i} differs from the stream "
              f"phase's Lite session")
    emit({"phase": "fleet", "card": smi, "router": fleet_spec.router,
          "replicas": len(fleet.replicas), "max_batch": FLEET_BATCH,
          "warmup_s": warm_s, "wall_s": wall_s, "launches": launches,
          "admitted": len(admitted), "shed": len(shed),
          "shed_reasons": sorted({exc.reason for _, exc in shed}),
          "tenants": tstats, "samples_per_s": agg["samples_per_s"],
          "wall_samples_per_s": len(admitted) / wall_s,
          "serve_s": agg["serve_s"], "dispatches": agg["batches"],
          "padded": agg["padded"], "bitwise_vs_tier_solo": True,
          "lidar_stream_bitwise_vs_stream_phase": True,
          "lidar_stream_hits": sess.stats.hits,
          "seconds": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------------- shards --

SHARD_COUNTS = (2, 4)
SHARD_TIMING_REPS = 15
SHARD_STREAM_FRAMES = 3           # a miss, then two hits


def shard_mesh(n: int):
    """An n-way ``("data",)`` mesh that repeats the first card: the split
    runs its shards one after another on it, the real kernels on each."""
    from repro_torch.serve.sharding import make_mesh
    return make_mesh(n, devices=["cuda:0"] * n)


def shard_phase(torch, np, params, elite_params, clouds, elite_clouds, smi):
    """The sharded dispatch (``repro_torch.serve.sharding``) on the card.

    Lite (int8, 512 points, MAX_BATCH) at 2 and 4 shards on a mesh that
    repeats the card, bitwise the unsharded logits and LFSR state through
    ``infer``, ``PointCloudEngine.classify`` (the queue), the async engine
    and a stream session (a miss, then hits); a 2 replica x 2 shard fleet
    bitwise the unsharded fleet; per-lane URS at 4 shards (Lite's W8A8
    takes one activation scale a dispatch, and its split must be refused;
    M-2, Lite's topology in fp32, splits bitwise); M-2 and Elite (fused
    group, per-sample sigma) at 2.  Every path's launches
    are counted and checked: n shards launch each kernel n times as often
    (a shard is a dispatch of MAX_BATCH / n lanes).  On one card the
    default mesh (``make_mesh(2)``) must refuse with the ``devices=``
    recipe; with two or more cards Lite also runs on the default mesh, its
    second shard on ``cuda:1``.  Last, the device and wall ms and the host
    syncs of one Lite dispatch at 1, 2 and 4 shards: the split's own cost
    on one card, not a multi-card rate.  Returns the launches."""
    from repro_torch.api.build import build
    from repro_torch.api.spec import (FleetSpec, TenantSpec, elite_spec,
                                      lite_spec, m2_spec)
    from repro_torch.serve.async_engine import AsyncPointCloudEngine
    from repro_torch.serve.fleet import PipelineFleet
    from repro_torch.serve.pointcloud import PointCloudEngine
    from repro_torch.serve.sharding import make_mesh, make_mesh2d
    from repro_torch.serve.streaming import StreamSession
    t_phase = time.perf_counter()
    total = {k: 0 for k in counters()}
    paths = {}
    n_dev = torch.cuda.device_count()
    lite = lite_spec(N_CLASSES).serving().replace(backend="cuda")
    lite_expect = {"knn": 4, "int8_matmul": 28}
    chunk = torch.from_numpy(clouds[:MAX_BATCH]).cuda()
    pipes = {1: build(lite, params)}
    state0 = pipes[1].seed_state(SEED, MAX_BATCH)
    ref = pipes[1].infer(chunk, state0.clone())

    def times(expect, n):
        return {k: v * n for k, v in expect.items()}

    def record(name, launches, expect, dispatches=1):
        expect_launches(f"shard {name}", launches, expect, dispatches)
        add_launches(total, launches)
        paths[name] = {k: v for k, v in launches.items() if v}

    def dispatch(name, pipe, n, expect, want, pts=chunk):
        got, launches = counted(torch, lambda: pipe.infer(pts, state0.clone()))
        check(got[0].device == pts.device,
              f"shard {name}: logits left the card")
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"shard {name}: logits or LFSR state differ from the "
              f"unsharded dispatch")
        record(name, launches, times(expect, n))

    def serve_async(eng):
        futs = [eng.submit(c) for c in clouds]
        eng.flush()
        return [f.result() for f in futs]

    # The unsharded references of the serving paths.
    eng1 = PointCloudEngine(params, lite, max_batch=MAX_BATCH, seed=SEED)
    queue_ref, queue_state = eng1.classify(clouds), eng1.lfsr_state
    async_ref = serve_async(AsyncPointCloudEngine(
        pipes[1], max_batch=MAX_BATCH, policy="fixed", seed=SEED))
    stream = lite.replace(stream=True,
                          stream_drift_threshold=STREAM_THRESHOLD)
    frames = rigid_frames(np, np.random.default_rng(SEED + 11),
                          512)[:SHARD_STREAM_FRAMES]
    sess1 = StreamSession(build(stream, params), seed=SEED)
    stream_ref = [sess1.infer(f) for f in frames]
    check(sess1.stats.hits == SHARD_STREAM_FRAMES - 1,
          f"shard: the unsharded stream hit {sess1.stats.hits} times")

    for n in SHARD_COUNTS:
        mesh = shard_mesh(n)
        spec = lite.replace(data_shards=n)
        pipes[n] = pipe = build(spec, params, mesh=mesh)
        check(pipe.device == torch.device("cuda", 0)
              and pipe.mesh.shape == {"data": n}
              and list(pipe.shard_params) == [torch.device("cuda", 0)],
              f"shard: lite_{n} is not one params copy on cuda:0")
        dispatch(f"lite_{n}", pipe, n, lite_expect, ref)

        eng = PointCloudEngine(params, spec, max_batch=MAX_BATCH, seed=SEED,
                               mesh=mesh)
        got, launches = counted(torch, lambda: eng.classify(clouds))
        check(torch.equal(got, queue_ref)
              and torch.equal(eng.lfsr_state, queue_state),
              f"shard: lite_{n} engine's queue differs from unsharded")
        record(f"lite_{n}_engine", launches, times(lite_expect, n),
               eng.stats.batches)

        aeng = AsyncPointCloudEngine(pipe, max_batch=MAX_BATCH,
                                     policy="fixed", seed=SEED)
        got, launches = counted(torch, lambda: serve_async(aeng))
        check(all(torch.equal(a, b) for a, b in zip(got, async_ref)),
              f"shard: lite_{n} async futures differ from unsharded")
        record(f"lite_{n}_async", launches, times(lite_expect, n),
               aeng.stats.batches)

        sess = StreamSession(build(stream.replace(data_shards=n), params,
                                   mesh=mesh), seed=SEED)
        got, launches = counted(torch, lambda: [sess.infer(f)
                                                for f in frames])
        check(all(torch.equal(a, b) for a, b in zip(got, stream_ref))
              and sess.stats.hits == sess1.stats.hits,
              f"shard: lite_{n} stream frames differ from unsharded")
        # the miss maps; the hits replay the cache (no kNN)
        record(f"lite_{n}_stream", launches,
               {"knn": 4 * n, "int8_matmul": 28 * n * len(frames)})

    # A 2 replica x 2 shard fleet against the unsharded fleet.
    fl = lite.replace(name="lite-shard")

    def fleet_run(n, mesh):
        fspec = FleetSpec(
            pipelines=(fl.replace(data_shards=n),),
            tenants=tuple(TenantSpec(t, fl.name, slo_ms=0.0,
                                     max_inflight=4 * N_QUEUE)
                          for t in ("rt", "bulk")),
            replicas=2, max_batch=MAX_BATCH)
        fleet = PipelineFleet.from_specs(fspec, {fl.name: params},
                                         seed=SEED, mesh=mesh)

        def burst():
            futs = [fleet.submit(t, c) for c in clouds for t in ("rt", "bulk")]
            fleet.flush()
            return [f.result() for f in futs]
        return fleet, counted(torch, burst)
    _, (fleet_ref, _) = fleet_run(1, None)
    fleet, (got, launches) = fleet_run(2, make_mesh2d(
        2, 2, devices=["cuda:0"] * 4))
    check(all(torch.equal(a, b) for a, b in zip(got, fleet_ref)),
          "shard: the 2 x 2 fleet differs from the unsharded fleet")
    check("devices ['cuda:0', 'cuda:0']" in fleet.describe(),
          "shard: the fleet does not name its replicas' devices")
    record("fleet_2x2", launches, times(lite_expect, 2),
           sum(rep.engine.stats.batches for rep in fleet.replicas))

    # Per-lane URS: Lite's W8A8 takes one activation scale a dispatch, so
    # its split is refused; Lite's topology in fp32 (M-2) splits bitwise.
    # (The ref backend is no yardstick on the card: its cuBLAS products
    # change kernel with the rows, so a lane's bits follow the width.)
    w8a8_refusal = None
    try:
        build(lite.replace(shared_urs=False, data_shards=4), params,
              mesh=shard_mesh(4))
    except ValueError as exc:
        w8a8_refusal = str(exc)
    check(w8a8_refusal is not None
          and "one scale per dispatch" in w8a8_refusal,
          "shard: per-lane URS with W8A8 was not refused")
    m2 = m2_spec(N_CLASSES).serving().replace(backend="cuda")
    per_lane = m2.replace(shared_urs=False)
    want = build(per_lane, params).infer(chunk, state0.clone())
    check(not torch.equal(want[1], want[1][:1].expand_as(want[1])),
          "shard: per-lane URS states do not differ by lane")
    dispatch("m2_per_lane_4", build(per_lane.replace(data_shards=4), params,
                                    mesh=shard_mesh(4)),
             4, {"knn": 4, "fused_linear": 28}, want)
    dispatch("m2_2", build(m2.replace(data_shards=2), params,
                           mesh=shard_mesh(2)),
             2, {"knn": 4, "fused_linear": 28},
             build(m2, params).infer(chunk, state0.clone()))
    elite = elite_spec(N_CLASSES).serving().replace(
        backend="cuda", fused_group="grouped_transfer")
    echunk = torch.from_numpy(elite_clouds[:MAX_BATCH]).cuda()
    dispatch("elite_2", build(elite.replace(data_shards=2), elite_params,
                              mesh=shard_mesh(2)),
             2, {"fps": 4, "knn": 4, "grouped_transfer_stats": 4,
                 "fused_linear": 24},
             build(elite, elite_params).infer(echunk, state0.clone()),
             pts=echunk)

    # The default mesh: the first CUDA devices.
    refusal = None
    if n_dev < 2:
        try:
            make_mesh(2)
        except ValueError as exc:
            refusal = str(exc)
        check(refusal is not None and "devices=" in refusal,
              f"shard: make_mesh(2) on {n_dev} card(s) did not refuse with "
              f"the devices= recipe: {refusal!r}")
    else:
        pipe = build(lite.replace(data_shards=2), params)
        check([str(d) for d in pipe.mesh.devices.flat]
              == ["cuda:0", "cuda:1"], "shard: the default mesh is not "
                                       "cuda:0, cuda:1")
        dispatch("lite_default_mesh", pipe, 2, lite_expect, ref)

    # One Lite dispatch at 1, 2 and 4 shards on one card: device ms (the
    # profiler's kernel time), wall ms (ended by a sync) and host syncs.
    timing = {}
    for n in (1,) + SHARD_COUNTS:
        def run(pipe=pipes[n]):
            return pipe.infer(chunk, state0.clone())
        prof = profile_summary(*profile_call(torch, run, reps=5))
        walls = []
        for _ in range(SHARD_TIMING_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        reported, blocking = host_syncs(torch, run)
        timing[n] = {"wall_ms": statistics.median(walls),
                     "device_ms": prof["device_ms"],
                     "idle_share": prof["idle_share"],
                     "host_syncs_reported": reported,
                     "blocking_runtime_calls": blocking}
    emit({"phase": "shard", "card": smi, "cuda_device_count": n_dev,
          "max_batch": MAX_BATCH, "shard_counts": list(SHARD_COUNTS),
          "mesh": "make_mesh(n, devices=['cuda:0'] * n)",
          "bitwise_vs_unsharded": True, "launches_by_path": paths,
          "default_mesh_refusal": refusal,
          "per_lane_w8a8_refusal": w8a8_refusal, "lite_dispatch": timing,
          "launches": total, "seconds": time.perf_counter() - t_phase})
    return total


# ---------------------------------------------------------------- LM ---

# -------------------------------------------------------------- train --

TRAIN_BATCH = 32
TRAIN_STEPS = 20
TRAIN_LR = 0.02
TRAIN_RESUME_AT = 10
ELITE_TRAIN_STEPS = 3
# Card against CPU, one float32 training step from the same params, batch
# and LFSR state.  Indices are identical, so what differs is summation
# order (cuBLAS against MKL, CUDA reductions, gather's backward summed
# with atomics on the card), ~1e-6 relative a layer, which BN on batch
# statistics magnifies where a channel's batch variance is small (the
# head's BN sees 8 or 4 rows), and a max-pool window whose two largest
# values are that close (or tied in one run, an ulp apart in the other)
# sends its gradient elsewhere.  scripts/train_rounding.py changes only
# the rounding of every product (float64 sums) in a CPU step: at seed 0
# it moved Elite's loss by 8.3e-7 relative, its gradient tree by 0.22%
# and no leaf by more than 0.59% of its norm, and a BN running stat by
# 2.8e-4 of its leaf's largest value.  The bounds leave a factor of 3.5
# to 12.  The embedding's BN mean is ~1e-10 on centred clouds, pure
# rounding: hence the absolute 1e-6.  The same script moved 22% of
# Lite's fake-quant activation codes, its loss by 2% and its gradients
# by more than their norm: one code a step away (1/127 of a tensor's
# absmax) changes the next layer's inputs enough to move codes there,
# and so on.  So Lite's CPU step replays the card's codes
# (``fake_quant_tap``) and the phase counts the codes that differ.
TRAIN_TOL = {"loss_rel": 1e-5, "leaf": 5e-2, "tree_floor": 1e-4,
             "tree": 2e-2, "bn_rel": 1e-3, "bn_abs": 1e-6}
TRAIN_WHY = (
    "float32 summation order differs (cuBLAS vs MKL, CUDA reductions, "
    "gather's backward with atomics), ~1e-6 a layer, magnified by BN on "
    "batch statistics, and near-tied max-pool windows route their "
    "gradient elsewhere; scripts/train_rounding.py measures the same "
    "change of rounding on the CPU (Elite: loss 8.3e-7, gradient tree "
    "0.22%, leaf 0.59%, BN 2.8e-4).  Lite's CPU step replays the card's "
    "fake-quant codes: one code a step apart cascades (the script moved "
    "22% of them, the loss by 2%, the gradients by more than their norm)")


def fake_quant_tap(replay=None):
    """Wrap ``layers.fake_quant_act``: record each call's activation codes
    and scale, and with ``replay`` (another run's record) return that
    run's quantized values instead of this run's own (the straight-through
    gradient is unchanged).  Returns (record, restore)."""
    from repro_torch.core import quant as Q
    from repro_torch.models import layers as L
    orig = L.fake_quant_act
    record = []

    def tap(x, q):
        scale = Q.compute_scale(x.detach(), q.a_bits)
        codes = Q.quantize(x.detach(), scale, q.a_bits)
        i = len(record)
        record.append((codes, scale))
        if replay is None:
            return orig(x, q)
        want_codes, want_scale = replay[i]
        qv = want_codes.to(x.device) * want_scale.to(x.device)
        return x + (qv - x).detach()
    L.fake_quant_act = tap
    return record, lambda: setattr(L, "fake_quant_act", orig)


def train_mapping(cfg, pts, lfsr, device):
    """Per-stage sampled and kNN indices of one training forward
    (per-cloud URS, or FPS) on ``device``."""
    from repro_torch.core import knn, sampling
    cur = pts.to(device)
    out = []
    for n_samp in cfg.stage_samples:
        if cfg.sampler == "fps":
            idx = sampling.fps(cur, n_samp)
        else:
            lfsr, idx = sampling.urs_indices_batched(
                lfsr, cur.shape[1], n_samp, batch=cur.shape[0])
            idx = idx.to(device)
        new = sampling.gather_points(cur, idx)
        out.append((idx.cpu(), knn.knn_batched(new, cur, cfg.k_neighbors)
                    .cpu()))
        cur = new
    return out


def tree_cpu(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.detach().cpu(), tree)


def compare_step(name, card, cpu):
    """Hold one training step's loss, gradients and refreshed BN stats,
    card against CPU, to ``TRAIN_TOL``; return the errors found."""
    from repro_torch.tree import leaves_with_paths
    loss_c, grads_c, bn_c = card
    loss_h, grads_h, bn_h = cpu
    t = TRAIN_TOL
    loss_err = abs(loss_c - loss_h)
    check(loss_err <= t["loss_rel"] * abs(loss_h),
          f"{name}: loss {loss_c} on the card, {loss_h} on the CPU")
    gc, gh = dict(leaves_with_paths(grads_c)), dict(leaves_with_paths(
        grads_h))
    norm = sum(float((v.double() ** 2).sum()) for v in gh.values()) ** 0.5
    tree_err = sum(float(((gc[k] - gh[k]).double() ** 2).sum())
                   for k in gh) ** 0.5
    check(tree_err <= t["tree"] * norm,
          f"{name}: gradient tree differs by {tree_err} of {norm}")
    worst_leaf, worst_at = 0.0, None
    for k, v in gh.items():
        allowed = t["leaf"] * float(v.norm()) + t["tree_floor"] * norm
        err = float((gc[k] - v).norm())
        check(err <= allowed, f"{name}: gradient of {k} differs by {err} "
                              f"> {allowed}")
        if err / allowed > worst_leaf:
            worst_leaf, worst_at = err / allowed, "/".join(map(str, k))
    bn_worst = 0.0
    for k, v in dict(leaves_with_paths(bn_h)).items():
        if k[-2:-1] != ("bn",) or k[-1] not in ("mean", "var"):
            continue
        c = dict(leaves_with_paths(bn_c))[k]
        err = float((c - v).abs().max())
        allowed = t["bn_rel"] * float(v.abs().max()) + t["bn_abs"]
        check(err <= allowed, f"{name}: BN {k} differs by {err}")
        bn_worst = max(bn_worst, err / allowed)
    return {"loss_card": loss_c, "loss_cpu": loss_h,
            "loss_rel_err": loss_err / abs(loss_h),
            "grad_tree_rel_err": tree_err / norm,
            "grad_leaf_worst_of_allowance": worst_leaf,
            "grad_leaf_worst_at": worst_at,
            "bn_worst_of_allowance": bn_worst}


def step_vs_cpu(torch, name, cfg, params, pts, cls, lfsr_seed):
    """One training step (loss, gradients, refreshed BN) on the card and
    on the CPU from the same params, batch and LFSR state; the card's run
    counted.  Lite's CPU run replays the card's activation codes."""
    from repro_torch.api.build import to_device
    from repro_torch.core import sampling
    from repro_torch.train import pointmlp as TP
    b = pts.shape[0]
    for s, ((gi, gn), (ci, cn)) in enumerate(zip(
            train_mapping(cfg, pts, sampling.seed_streams(
                lfsr_seed, b), "cuda"),
            train_mapping(cfg, pts, sampling.seed_streams(
                lfsr_seed, b), "cpu"))):
        check(torch.equal(gi, ci), f"{name}: {cfg.sampler} indices differ "
                                   f"at stage {s}")
        check(torch.equal(gn, cn), f"{name}: kNN indices differ at stage {s}")

    def run(device, replay):
        rec, restore = fake_quant_tap(replay)
        try:
            loss, grads, p_new, _ = TP.loss_and_grads(
                to_device(params, device), cfg, pts.to(device),
                cls.to(device), sampling.seed_streams(lfsr_seed, b))
        finally:
            restore()
        return (float(loss), tree_cpu(grads), tree_cpu(p_new)), rec

    (card, rec_card), launches = counted(torch, lambda: run("cuda", None))
    cpu, rec_cpu = run("cpu", rec_card)
    codes = sum(int((a.cpu() != c).sum())
                for (a, _), (c, _) in zip(rec_card, rec_cpu))
    scales = sum(int(not torch.equal(s.cpu(), t))
                 for (_, s), (_, t) in zip(rec_card, rec_cpu))
    out = compare_step(name, card, cpu)
    out.update(fake_quant_layers=len(rec_card),
               fake_quant_codes=sum(int(c.numel()) for c, _ in rec_card),
               fake_quant_codes_differ=codes,
               fake_quant_scales_differ=scales)
    return out, launches, card


def train_loop_on_card(torch, cfg, params, batches, steps, lfsr_seed,
                       start=0, lfsr=None, timed=False):
    """``steps`` trainer steps on the card, cycling ``batches`` (on the
    card), from step ``start``; returns (params, lfsr, per-step ms)."""
    from repro_torch.core import sampling
    from repro_torch.train import pointmlp as TP
    if lfsr is None:
        lfsr = sampling.seed_streams(lfsr_seed, batches[0][0].shape[0])
    ms = []
    for s in range(start, start + steps):
        pts, cls = batches[s % len(batches)]
        if timed:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
        _, params, lfsr = TP.sgd_step(params, cfg, pts, cls, lfsr, TRAIN_LR)
        if timed:
            t1.record()
            t1.synchronize()
            ms.append(t0.elapsed_time(t1))
    return params, lfsr, ms


def params_diff(a, b):
    from repro_torch.tree import leaves_with_paths
    pa, pb = dict(leaves_with_paths(a)), dict(leaves_with_paths(b))
    return max(float((pa[k] - pb[k]).abs().max()) for k in pa)


def resume_check(torch, cfg, params0, batches, straight):
    """Train ``TRAIN_RESUME_AT`` steps, checkpoint (params and LFSR state)
    to a temporary directory, restore into a fresh tree and finish;
    compare with ``straight``, the uninterrupted run's params."""
    import tempfile

    from repro_torch.models.pointmlp import pointmlp_init
    from repro_torch.train import checkpoint as ckpt
    p, lfsr, _ = train_loop_on_card(torch, cfg, params0, batches,
                                    TRAIN_RESUME_AT, SEED)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, TRAIN_RESUME_AT, {"params": p, "lfsr": lfsr},
                  extra={"step": TRAIN_RESUME_AT})
        check(ckpt.latest_step(d) == TRAIN_RESUME_AT, "checkpoint not found")
        fresh = {"params": pointmlp_init(cfg, torch.Generator(
            device="cuda").manual_seed(SEED + 99)), "lfsr": lfsr}
        back, extra = ckpt.restore(d, TRAIN_RESUME_AT, fresh)
    check(extra == {"step": TRAIN_RESUME_AT}, "checkpoint extra lost")
    check(params_diff(back["params"], p) == 0.0
          and torch.equal(back["lfsr"], lfsr),
          "restored state differs from the saved one")
    done, _, _ = train_loop_on_card(
        torch, cfg, back["params"], batches, TRAIN_STEPS - TRAIN_RESUME_AT,
        SEED, start=TRAIN_RESUME_AT, lfsr=back["lfsr"])
    diff = params_diff(done, straight)
    return {"bitwise": diff == 0.0, "max_abs_diff": diff}


def eval_loss(cfg, params, pts, cls):
    from repro_torch.core import sampling
    from repro_torch.models import layers as L
    from repro_torch.models.pointmlp import pointmlp_apply
    logits, _, _ = pointmlp_apply(params, cfg, pts, sampling.seed_streams(
        SEED + 1, pts.shape[0]))
    return float(L.softmax_cross_entropy(logits, cls))


def train_lite_phase(torch, smi, clouds):
    """``train_lite``: full-width PointMLP-Lite (8/8 fake quant) on the
    synthetic set: one step against the CPU, 20 steps cycling two batches
    (timed, profiled), resume from a checkpoint, then compress and serve
    on the card bitwise against the CPU."""
    from repro_torch.api.build import build, to_device
    from repro_torch.api.spec import lite_spec
    from repro_torch.core.compress import compress
    from repro_torch.data import pointclouds
    from repro_torch.models.pointmlp import (pointmlp_init,
                                             pointmlp_lite_config)
    from repro_torch.core import sampling
    from repro_torch.train import pointmlp as TP
    cfg = pointmlp_lite_config(N_CLASSES)
    params0 = pointmlp_init(cfg, torch.Generator().manual_seed(SEED + 20))
    total = {k: 0 for k in counters()}

    # 1-2. one step at batch 8, card against CPU
    pts, cls = pointclouds.make_batch(SEED, 0, cfg.n_points, 8, "cpu")
    vs_cpu, launches, _ = step_vs_cpu(torch, "train_lite", cfg, params0,
                                      pts, cls, SEED)
    expect_launches("train_lite step", launches, {"knn": 4})
    add_launches(total, launches)

    # 3. 20 steps at batch 32 cycling two fixed batches, timed
    batches = [pointclouds.make_batch(SEED, s, cfg.n_points, TRAIN_BATCH,
                                      "cuda") for s in range(2)]
    ev_pts = torch.cat([b[0] for b in batches])
    ev_cls = torch.cat([b[1] for b in batches])
    p_card = to_device(params0, "cuda")
    before = eval_loss(cfg, p_card, ev_pts, ev_cls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (straight, _, ms), launches = counted(torch, lambda: train_loop_on_card(
        torch, cfg, p_card, batches, TRAIN_STEPS, SEED, timed=True))
    peak = torch.cuda.max_memory_allocated()
    expect_launches("train_lite loop", launches, {"knn": 4}, TRAIN_STEPS)
    add_launches(total, launches)
    loop_launches = {k: v / TRAIN_STEPS for k, v in launches.items() if v}
    after = eval_loss(cfg, straight, ev_pts, ev_cls)
    check(after < before - 0.05, f"train_lite: eval loss {before} -> "
                                 f"{after}, not down by 0.05")
    step_ms = statistics.median(ms)
    lf = sampling.seed_streams(SEED, TRAIN_BATCH)
    prof = profile_summary(*profile_call(torch, lambda: TP.sgd_step(
        straight, cfg, batches[0][0], batches[0][1], lf.clone(), TRAIN_LR)),
        knn_ms=("knn",))

    # 4. checkpoint and resume, in the default mode and deterministic.
    # Only the restored state is required to equal the saved one: in
    # the default mode gather's backward sums with atomics, and QAT
    # carries a last-bit difference into other codes, so two runs part.
    resume = {"default": resume_check(torch, cfg, p_card, batches, straight)}
    with deterministic(torch) as det:
        det_straight, _, det_ms = train_loop_on_card(
            torch, cfg, p_card, batches, TRAIN_STEPS, SEED, timed=True)
        resume["deterministic"] = resume_check(torch, cfg, p_card,
                                               batches, det_straight)
    resume["deterministic"]["warnings"] = det.warnings
    check(resume["deterministic"]["bitwise"],
          "train_lite: a resumed run differs from the straight one "
          "under deterministic algorithms")
    resume["deterministic"]["ms_per_step_median"] = statistics.median(
        det_ms)
    resume["deterministic_vs_default_max_abs_diff"] = params_diff(
        det_straight, straight)

    # 5. compress the trained params and serve them
    deploy, _, report = compress(tree_cpu(straight), cfg)
    spec = lite_spec(N_CLASSES).serving().replace(backend="cuda")
    card_pipe = build(spec, deploy)
    cpu_pipe = build(spec, deploy, device="cpu")
    chunk = torch.from_numpy(clouds[:MAX_BATCH])
    (served, _), launches = counted(torch, lambda: card_pipe.infer(
        chunk.cuda(), card_pipe.seed_state(SEED, MAX_BATCH)))
    expect_launches("train_lite serve", launches, {"knn": 4,
                                                    "int8_matmul": 28})
    add_launches(total, launches)
    want, _ = cpu_pipe.infer(chunk, cpu_pipe.seed_state(SEED, MAX_BATCH))
    check(torch.equal(served.cpu(), want),
          "train_lite: the compressed model's logits differ on the card")
    emit({"phase": "train_lite", "card": smi, "config": cfg.name,
          "n_points": cfg.n_points, "quant": [cfg.quant.w_bits,
                                              cfg.quant.a_bits],
          "step_vs_cpu": dict(vs_cpu, batch=8, tolerance=TRAIN_TOL,
                              why=TRAIN_WHY),
          "launches_per_step": loop_launches,
          "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "lr": TRAIN_LR,
          "eval_loss_before": before, "eval_loss_after": after,
          "ms_per_step_median": step_ms, "ms_per_step": ms,
          "samples_per_s": TRAIN_BATCH / (step_ms / 1e3),
          "max_memory_allocated_bytes": peak, "profile_one_step": prof,
          "resume": resume,
          "compress": {"bn_blocks_fused": report.bn_blocks_fused,
                       "size_ratio_vs_f32": report.size_ratio_vs_f32},
          "served_bitwise_vs_cpu": True,
          "served_launches": launches})
    return total


def train_elite_phase(torch, smi):
    """``train_elite``: full-width PointMLP-Elite (FPS, learnable affine,
    fp32): one step at batch 4 against the CPU, 3 steps at batch 32."""
    from repro_torch.api.build import to_device
    from repro_torch.data import pointclouds
    from repro_torch.models.pointmlp import (pointmlp_elite_config,
                                             pointmlp_init)
    from repro_torch.tree import leaves_with_paths
    cfg = pointmlp_elite_config(N_CLASSES)
    params0 = pointmlp_init(cfg, torch.Generator().manual_seed(SEED + 21))
    gen = torch.Generator().manual_seed(SEED + 22)
    for st in params0["stages"]:          # alpha and beta off identity
        c = st["affine"]["alpha"].shape[0]
        st["affine"] = {"alpha": 0.5 + torch.rand(c, generator=gen),
                        "beta": 0.1 * torch.randn(c, generator=gen)}
    total = {k: 0 for k in counters()}
    pts, cls = pointclouds.make_batch(SEED + 1, 0, cfg.n_points, 4, "cpu")
    vs_cpu, launches, card = step_vs_cpu(torch, "train_elite", cfg, params0,
                                         pts, cls, SEED)
    expect_launches("train_elite step", launches, {"knn": 4, "fps": 4})
    add_launches(total, launches)
    g = dict(leaves_with_paths(card[1]))
    affine = {}
    for s in range(4):
        for k in ("alpha", "beta"):
            v = g[("stages", s, "affine", k)]
            check(float(v.abs().max()) > 0,
                  f"train_elite: stage {s} {k} has no gradient")
            affine[f"stage{s}.{k}"] = float(v.norm())
    batches = [pointclouds.make_batch(SEED + 1, s, cfg.n_points, TRAIN_BATCH,
                                      "cuda") for s in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (_, _, ms), launches = counted(torch, lambda: train_loop_on_card(
        torch, cfg, to_device(params0, "cuda"), batches, ELITE_TRAIN_STEPS,
        SEED, timed=True))
    peak = torch.cuda.max_memory_allocated()
    expect_launches("train_elite loop", launches, {"knn": 4, "fps": 4},
                    ELITE_TRAIN_STEPS)
    add_launches(total, launches)
    step_ms = statistics.median(ms)
    emit({"phase": "train_elite", "card": smi, "config": cfg.name,
          "n_points": cfg.n_points,
          "step_vs_cpu": dict(vs_cpu, batch=4, tolerance=TRAIN_TOL,
                              why=TRAIN_WHY),
          "affine_grad_norms": affine,
          "beta_note": "the transfer layer's BN subtracts any constant a "
                       "channel, so beta's true gradient is 0 (in JAX "
                       "too): both devices return rounding noise, held "
                       "by the tree-wide term of the leaf bound",
          "steps": ELITE_TRAIN_STEPS,
          "batch": TRAIN_BATCH, "ms_per_step_median": step_ms,
          "ms_per_step": ms,
          "samples_per_s": TRAIN_BATCH / (step_ms / 1e3),
          "max_memory_allocated_bytes": peak,
          "launches_per_step": {k: v / ELITE_TRAIN_STEPS
                                for k, v in launches.items() if v}})
    return total


def train_phases(torch, smi, clouds):
    t0 = time.perf_counter()
    total = train_lite_phase(torch, smi, clouds)
    add_launches(total, train_elite_phase(torch, smi))
    emit({"phase": "train_total", "card": smi,
          "seconds": time.perf_counter() - t0, "launches": total})
    return total


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


def flash_row(torch, label, q, k, v, causal: bool, win: int,
              timer=median_ms):
    """One flash-attention row: the kernel held against its plain version
    and timed with ``timer`` beside the plain version and (where it
    computes the same function) SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref

    b, nh, tq, d = q.shape
    nkv, tk, dt = k.shape[1], k.shape[2], q.dtype
    got = fa_mod.flash_attention_cuda(q, k, v, causal, win)
    want = ref.attention_ref(q, k, v, causal, win)
    torch.cuda.synchronize()
    # bf16: the output is rounded to bf16, so a value near a rounding
    # boundary may land one bf16 step away; f32: the sums run in another
    # order (tile order of the rescale)
    tol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
    ok, err, atol_lo, atol_hi, worst = rowwise_close(torch, got, want, tol)
    check(ok, f"flash_attention {label}: max abs err {err}, {worst} x its "
              f"allowance (rtol={tol}, atol={tol} * max|out| of the row, "
              f"{atol_lo}..{atol_hi})")
    ms = timer(torch, lambda: fa_mod.flash_attention_cuda(q, k, v, causal,
                                                          win))
    plain_ms = median_ms(torch, lambda: ref.attention_ref(
        q, k, v, causal, win), reps=5)
    lib_ms = None
    if tq == tk and win == 0:
        # SDPA's is_causal is top-left aligned: the same function only
        # where Tq == Tk
        lib_ms = timer(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
    elif tq == tk:
        # a window: SDPA with the boolean mask (True = attend) spelled out
        pos = torch.arange(tq, device=q.device)
        keep = pos[None, :] > pos[:, None] - win
        if causal:
            keep &= pos[None, :] <= pos[:, None]
        lib_ms = timer(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, enable_gqa=True))
    pairs = b * nh * attention_pairs(tq, tk, causal, win)
    nops = 4 * pairs * d
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    return dict(
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


def lm_kernel_phase(torch):
    """The flash-attention and W8A16 kernels against their plain versions
    at the LM's shapes (tinyllama: 32 query heads over 4 KV heads, head
    dim 64, 2048 tokens; and the half of them a ``model_axis`` rank
    holds, at that phase's 512 tokens)."""
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
             ("d16_window8", 8, 2, 256, 256, 16, torch.bfloat16, True, 8),
             # a model_axis rank's heads: 16 of 32, 2 of 4 kv heads
             ("model_axis_rank", h // 2, hkv // 2, MA_CUT["seq"],
              MA_CUT["seq"], 64, torch.bfloat16, True, 0))
    for label, nh, nkv, tq, tk, d, dt, causal, win in cases:
        q = torch.randn(b, nh, tq, d, generator=gen, device=dev).to(dt)
        k = torch.randn(b, nkv, tk, d, generator=gen, device=dev).to(dt)
        v = torch.randn(b, nkv, tk, d, generator=gen, device=dev).to(dt)
        rows[("flash_attention", label)] = flash_row(torch, label, q, k, v,
                                                     causal, win)

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


# ------------------------------------------------------------- dry-run --

# The dry-run CLI's cells: 10 archs x 4 shapes on each production mesh.
DRYRUN_CELLS = 80
# Where repro.launch.dryrun skips (configs.cell_is_runnable, as JAX's):
# long_500k for every arch without recurrent state or a sliding window.
DRYRUN_SKIPS = {(arch, "long_500k") for arch in (
    "whisper-tiny", "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
    "yi-9b", "tinyllama-1.1b", "minitron-8b", "llama3.2-1b",
    "internvl2-26b")}
# The card's peak above its arguments against the dry-run's temp bytes.
DRYRUN_TEMP_TOL = 0.10


def sp_flash_phase(torch, np, params, cfg):
    """tinyllama at full width and depth, B4 x T2048 on the flash route,
    under the host mesh: ``seq_parallel=True`` logits bitwise the
    ``seq_parallel=False`` ones, the kernel once a layer in each."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import get_model
    from repro_torch.sharding.context import use_mesh

    ids = torch.from_numpy(lm_tokens(np, cfg.vocab_size, LM_BATCH, LM_SEQ,
                                     SEED + 11)).cuda()
    mesh = make_host_mesh()
    total = {k: 0 for k in counters()}
    out = {}
    t0 = time.perf_counter()
    with use_mesh(mesh):
        for sp in (False, True):
            api = get_model(cfg.replace(attn_impl="flash", seq_parallel=sp))
            (out[sp], _), got = counted(torch, lambda: api.forward(params,
                                                                   ids))
            expect_launches(f"sp_flash seq_parallel={sp}", got,
                            {"flash_attention": cfg.n_layers})
            add_launches(total, got)
    check(torch.equal(out[True], out[False]),
          "sp_flash: seq_parallel logits differ from the plain forward's")
    emit({"phase": "sp_flash", "arch": cfg.name, "batch": LM_BATCH,
          "seq": LM_SEQ, "mesh": mesh.shape, "bitwise": True,
          "flash_launches_per_forward": cfg.n_layers,
          "launches": total, "seconds": time.perf_counter() - t0})
    return total


def card_operands(torch, np, api, shape, tc):
    """A cell's operands as real tensors on the card: random weights from
    a seed, token ids from numpy, the optimizer state or the cache."""
    from repro_torch.launch import steps as S
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED + 12)
    inputs = {}
    for k, spec in api.input_specs(shape).items():
        if k == "pos":
            inputs[k] = torch.tensor(shape.seq_len - 1, dtype=spec.dtype)
        else:
            inputs[k] = torch.from_numpy(rng.integers(
                0, api.cfg.vocab_size, spec.shape).astype(np.int32)).cuda()
    out = {"params": params, "inputs": inputs}
    if shape.kind == "train":
        out["opt"] = S.build_train_step(api, tc)[1](params)
    else:
        out["cache"] = api.init_cache(shape.global_batch, shape.seq_len)
    return out


def same_trees(name, real, fake):
    from repro_torch.tree import leaves_with_paths
    r, f = dict(leaves_with_paths(real)), dict(leaves_with_paths(fake))
    check(sorted(r) == sorted(f), f"{name}: the real tree's paths differ "
                                  f"from shape_trees'")
    for path, t in r.items():
        check(t.shape == f[path].shape and t.dtype == f[path].dtype,
              f"{name}: {path} is {tuple(t.shape)} {t.dtype} on the card, "
              f"{tuple(f[path].shape)} {f[path].dtype} in shape_trees")
    return len(r)


def dryrun_card_phase(torch, np, smi):
    """The dry-run against the card on a one-device mesh (n_chips = 1, so
    the ideal partition is exact): tinyllama at full width, a prefill
    (B4 x T2048, 22 layers) and an AdamW train step on a 2-layer cut (B4 x
    T2048, remat, xla route).  (a) FlopCounterMode over the real step
    counts the fake step's FLOPs exactly; (b) the real operands' shapes
    and dtypes are shape_trees', leaf for leaf; (c) the card's peak above
    its arguments is within DRYRUN_TEMP_TOL of the dry-run's temp
    bytes."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import get_model
    from repro_torch.sharding.context import use_mesh
    from repro_torch.tree import tree_leaves

    tc = TrainConfig(optimizer="adamw", lr=3e-4, lr_min=3e-5)
    cfg = get_config(LM_ARCH)
    mesh = make_host_mesh()
    check(mesh.size == 1, f"dryrun_card: the host mesh spans {mesh.size} "
                          f"devices, one expected")
    cases = (("prefill", cfg,
              ShapeConfig("card_prefill", "prefill", LM_SEQ, LM_BATCH)),
             ("train", D._with_layers(cfg, 2),
              ShapeConfig("card_train", "train", LM_SEQ, LM_BATCH)))
    for name, c, shape in cases:
        api = get_model(c)
        t0 = time.perf_counter()
        with use_mesh(mesh):
            fake = D.fake_step_cost(api, shape, tc)
            fake_trees = S.shape_trees(api, shape, tc)
        t_fake = time.perf_counter() - t0
        real = card_operands(torch, np, api, shape, tc)
        leaves = sum(same_trees(f"dryrun_card {name} {part}", real[part],
                                fake_trees[part]) for part in real)
        arg_bytes = sum(t.numel() * t.element_size()
                        for t in tree_leaves(real) if t.is_cuda)
        with use_mesh(mesh):
            warm = D.run_step(api, shape, tc, real)     # cuBLAS workspaces
            del warm
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with FlopCounterMode(display=False) as fc, D.Traffic() as tr:
                out = D.run_step(api, shape, tc, real)
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        del out
        flops = fc.get_total_flops()
        check(flops == fake["flops"],
              f"dryrun_card {name}: the card counts {flops} FLOPs, the "
              f"fake step {fake['flops']}")
        err = (peak - fake["temp_bytes"]) / fake["temp_bytes"]
        emit({"phase": "dryrun_card", "case": name, "arch": c.name,
              "layers": c.n_layers, "batch": shape.global_batch,
              "seq": shape.seq_len, "card": smi, "n_chips": mesh.size,
              "flops_card": flops, "flops_fake": fake["flops"],
              "leaves_checked": leaves,
              "argument_bytes_card": arg_bytes,
              "allocated_before_step": base,
              "temp_bytes_card": peak, "temp_bytes_fake": fake["temp_bytes"],
              "temp_tracked_on_card": tr.peak, "temp_rel_err": err,
              "tolerance": DRYRUN_TEMP_TOL,
              "op_bytes_card": tr.op_bytes, "op_bytes_fake": fake["op_bytes"],
              "fake_step_s": fake["seconds"], "fake_total_s": t_fake})
        check(abs(err) <= DRYRUN_TEMP_TOL,
              f"dryrun_card {name}: the card's peak above its arguments "
              f"{peak} is {err:+.3f} of the dry-run's {fake['temp_bytes']}")
        del real
        torch.cuda.empty_cache()


def dryrun_cli_phase(smi):
    """``python -m repro_torch.launch.dryrun --fast`` over every arch and
    shape on both production meshes (in process, its lines to a log),
    then tinyllama train_4k and moonshot's decode_32k under ``moe_local``
    on the single pod at full cost, each with its collective term (rank
    0's count), and ``repro_torch.report``'s tables from those
    records."""
    import contextlib
    import io

    from repro_torch import report
    from repro_torch.configs import LM_SHAPES, get_config, list_archs
    from repro_torch.launch import dryrun as D

    out = ROOT / "build" / "dryrun_torch"
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        try:
            D.main(["--mesh", "both", "--fast", "--out", str(out)])
        except SystemExit as e:          # "<n> cells failed"
            print(f"[exit] FAILED {e}")
    t_fast = time.perf_counter() - t0
    lines = [ln for ln in log.getvalue().splitlines()
             if ln.startswith("[") and ln.count("|") == 2]
    cells = {}
    for ln in lines:
        mesh, arch, shape = ln[1:ln.index("]")].split("|")
        cells[mesh, arch, shape] = ln
    check(len(cells) == DRYRUN_CELLS and "FAILED" not in log.getvalue(),
          f"dryrun_cli: {len(cells)} cells, {DRYRUN_CELLS} expected, or a "
          f"failure:\n{log.getvalue()[-4000:]}")
    skips = {(a, s) for (m, a, s), ln in cells.items() if "SKIPPED" in ln}
    check(skips == DRYRUN_SKIPS and all(
        ("SKIPPED" in ln) == ((a, s) in DRYRUN_SKIPS)
        for (m, a, s), ln in cells.items()),
        f"dryrun_cli: skipped {sorted(skips)}")
    t1 = time.perf_counter()
    full = D.run_cell(LM_ARCH, "train_4k", "pod", out_dir=str(out))
    t_full = time.perf_counter() - t1
    check(full["status"] == "ok" and full["roofline"]["t_compute"] > 0
          and full["roofline"]["t_collective"] > 0,
          "dryrun_cli: the full-cost cell has no roofline or no collective "
          "term")
    # moonshot's moe_local decode cell: the whole view counted, and rank
    # 0's per-rank dispatch for the collective term
    t2 = time.perf_counter()
    moe = D.run_cell(MOE_ARCH, "decode_32k", "pod", out_dir=str(out),
                     variant="moe_local")
    t_moe = time.perf_counter() - t2
    mrl = moe["roofline"]
    check(moe["status"] == "ok" and mrl["t_collective"] is not None and
          mrl["t_collective"] > 0 and mrl["coll_by_type"] and
          set(mrl["coll_by_type"]) <= {"all-reduce", "all-gather",
                                       "all-to-all"},
          f"dryrun_cli: {MOE_ARCH} decode_32k moe_local has no collective "
          f"term: {mrl}")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        report.main(["--dir", str(out)])
    tables = log.getvalue()
    check(tables.count("| ok |") == DRYRUN_CELLS - 2 * len(DRYRUN_SKIPS)
          and f"| {LM_ARCH} | train_4k | train | " in tables,
          "dryrun_cli: the report's tables lack rows")
    (out / "report.md").write_text(tables)
    emit({"phase": "dryrun_cli", "card": smi, "cells": len(cells),
          "failures": 0, "skipped": len(skips) * 2,
          "fast_seconds": t_fast, "seconds_per_fast_cell": t_fast / len(cells),
          "full_cell": f"{LM_ARCH} train_4k pod", "full_cell_seconds": t_full,
          "full_step_seconds": full["compile_s"],
          "bytes_per_device": full["bytes_per_device"],
          "roofline": {k: full["roofline"][k] for k in (
              "t_compute", "t_memory", "t_collective", "bottleneck",
              "coll_by_type")},
          "rank_cost": full["rank_cost"],
          "moe_local_cell": f"{MOE_ARCH} decode_32k pod moe_local",
          "moe_local_cell_seconds": t_moe,
          "moe_local_roofline": {k: mrl[k] for k in (
              "t_compute", "t_memory", "t_collective", "bottleneck",
              "coll_by_type")},
          "useful_flops_ratio": full["useful_flops_ratio"],
          "roofline_fraction": full["roofline_fraction"],
          "deferred_without_slow_cells": [
              f"{a} {s}" for a in list_archs() for s in LM_SHAPES
              if D.slow_cell(get_config(a), LM_SHAPES[s])]})


def dryrun_phases(torch, np, smi):
    """The dry-run slice: ``sp_flash``, ``dryrun_card``, ``dryrun_cli``;
    returns the flash launches of sp_flash's main path."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    params = get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(SEED))
    total = sp_flash_phase(torch, np, params, cfg)
    del params
    torch.cuda.empty_cache()
    dryrun_card_phase(torch, np, smi)
    dryrun_cli_phase(smi)
    emit({"phase": "dryrun_total", "card": smi,
          "seconds": time.perf_counter() - t0})
    return total


# ----------------------------------------------------------------- MoE --

MOE_ARCH = "moonshot-v1-16b-a3b"
# jax.eval_shape(lm_init) of the JAX config: 56.13 GB in bf16 (the
# router in f32)
MOE_PARAMS = 28_057_995_264
MOE_PROMPT, MOE_GEN = 512, 32
# A first-layer routing flip between two roundings (the card against the
# CPU, one attention route against another) is accepted where its k-th and
# (k+1)-th router probabilities differ by less than this.  Both runs start
# the layer from the same embeddings, and a bf16 step of the router input
# moves a logit by about 2**-8 of its size, a probability of 0.1 by
# 4e-4; a flip needs the two probabilities' moves together to pass the
# gap, about 8e-4, and the limit leaves a factor of 2.5.  A later layer's
# inputs also carry the earlier layers' differences, and there the flips
# are only counted.
MOE_GAP = 2e-3
SMOKE_ARCHS = ("llama4-maverick-400b-a17b", "internvl2-26b", "yi-9b",
               "minitron-8b")


def route_tap(fn, replay=None):
    """Run ``fn`` with ``moe.route`` and ``moe.dispatch`` wrapped: record
    each call's top-k experts, the gap between its k-th and (k+1)-th
    router probabilities, its dropped entries and each dispatch's
    ``(order, keep)`` (device tensors, no sync).  With ``replay`` (another run's top-k experts, call by call)
    route to those experts instead, with weights renormalized from this
    run's own probabilities: the two runs then dispatch and drop alike,
    and differ by rounding only.  Returns (fn's result, the record)."""
    from repro_torch.models import moe as M
    route, dispatch = M.route, M.dispatch
    record = {"top_e": [], "gap": [], "dropped": [], "entries": []}
    calls = None if replay is None else iter(replay)

    def tapped_route(p, cfg, xf):
        probs, top_p, top_e = route(p, cfg, xf)
        srt = probs.sort(dim=-1, descending=True).values
        k = cfg.experts_per_token
        record["gap"].append(srt[:, k - 1] - srt[:, k])
        if calls is not None:
            top_e = next(calls).to(xf.device)
            top_p = probs.gather(1, top_e)
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        record["top_e"].append(top_e)
        return probs, top_p, top_e

    def tapped_dispatch(cfg, xf, top_e, c, off=None):
        d = dispatch(cfg, xf, top_e, c, off)
        record["dropped"].append((~d.keep).sum())
        record["entries"].append((d.order, d.keep))
        return d

    M.route, M.dispatch = tapped_route, tapped_dispatch
    try:
        out = fn()
    finally:
        M.route, M.dispatch = route, dispatch
    if replay is not None:
        check(len(record["top_e"]) == len(replay),
              f"routing replay: {len(replay)} calls recorded, "
              f"{len(record['top_e'])} replayed")
    return out, record


def routing_agreement(torch, ref, other):
    """Per layer: the share of the reference's (token, slot) choices the
    other run also made, and the tokens whose expert sets differ; the
    reference's gap at each first-layer flip."""
    shares, misses = [], []
    for a, b in zip(ref["top_e"], other["top_e"]):
        hit = (a[:, :, None] == b.to(a.device)[:, None, :]).any(-1)
        shares.append(hit.float().mean().item())
        misses.append((~hit).any(-1))
    return {"share_all_layers": sum(shares) / len(shares),
            "share_by_layer": shares,
            "tokens_flipped_by_layer": [int(m.sum()) for m in misses],
            "first_layer_flip_gaps": ref["gap"][0][misses[0]].tolist()}


def check_first_layer_flips(name, agreement):
    worst = max(agreement["first_layer_flip_gaps"], default=0.0)
    check(worst < MOE_GAP, f"{name}: a first-layer routing flip at a gap "
                           f"of {worst} >= {MOE_GAP}")


def moe_sections():
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    return ((A, "attn_apply", "attention"), (M, "route", "router"),
            (M, "dispatch", "dispatch"), (M, "experts", "expert_products"),
            (M, "combine", "combine"))


def moe_forward_bound_ms(cfg, b: int, t: int):
    """The operations side of a scoring forward's bound: each product's
    operations at its type's peak (bf16 tensor cores; the f32 router on
    the CUDA cores), ms by part; and the capacity."""
    from repro_torch.models.moe import capacity
    n, d, hd = b * t, cfg.d_model, cfg.kv_head_dim
    c = capacity(cfg, n)
    q_out = cfg.n_heads * hd
    kv_out = cfg.n_kv_heads * hd
    parts = {
        "experts": cfg.n_layers * 6 * cfg.n_experts * c * d * cfg.d_ff
        / BF16_OPS_PER_S,
        "attention_projections": cfg.n_layers * 2 * n * d * (
            2 * q_out + 2 * kv_out) / BF16_OPS_PER_S,
        "flash": cfg.n_layers * 4 * b * cfg.n_heads * attention_pairs(
            t, t, True, 0) * hd / BF16_OPS_PER_S,
        "unembed": 2 * n * d * cfg.vocab_size / BF16_OPS_PER_S,
        "router_f32": cfg.n_layers * 2 * n * d * cfg.n_experts
        / FP32_OPS_PER_S,
    }
    return {k: 1e3 * v for k, v in parts.items()}, c


def moe_kernel_phase(torch, smi):
    """The flash kernel at moonshot's shape (16 query heads over 16 KV
    heads, head dim 128, B4 T2048 bf16 causal) against its plain version,
    timed as CUDA-graph replays beside SDPA."""
    from repro_torch.kernels import flash_attention as fa_mod

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    q, k, v = (torch.randn(LM_BATCH, 16, LM_SEQ, 128, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    row = flash_row(torch, "moonshot_fwd", q, k, v, True, 0, timer=graph_ms)
    row.update(timing="CUDA-graph replays (ms and library_ms)", card=smi,
               events_ms=median_ms(torch, lambda: fa_mod.flash_attention_cuda(
                   q, k, v, True, 0)))
    return emit_rows({("flash_attention", "moonshot_fwd"): row})


def moe_cpu_phase(torch, np, cfg, smi):
    """moonshot cut to 2 layers at full width, B2 T128 (capacity 32): the
    card (flash kernel) against the CPU (plain versions).  The CPU first
    routes on its own (the share of choices that agree is printed), then
    replays the card's routing, and its logits are held against the
    card's."""
    from repro_torch.api.build import to_device
    from repro_torch.models.api import get_model
    from repro_torch.models.moe import capacity

    cut = cfg.replace(n_layers=2, attn_impl="flash")
    api = get_model(cut)
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED + 5))
    ids = torch.from_numpy(lm_tokens(np, cut.vocab_size, 2, 128, SEED + 1))
    ((got, _), card), launches = counted(torch, lambda: route_tap(
        lambda: api.forward(params, ids.cuda())))
    expect_launches("moe 2 layers", launches, {"flash_attention": 2})
    cpu_params = to_device(params, "cpu")
    del params
    (_, cpu_free) = route_tap(lambda: api.forward(cpu_params, ids))
    agree = routing_agreement(torch, card, cpu_free)
    check_first_layer_flips("moe 2 layers", agree)
    (want, _), _ = route_tap(lambda: api.forward(cpu_params, ids),
                          replay=[e.cpu() for e in card["top_e"]])
    got = got.cpu()
    check(bool(torch.isfinite(got).all()), "moe 2 layers: not finite")
    err, scale = rel_err(got, want)
    check(err <= LM_TOL_2_LAYERS * scale,
          f"moe 2 layers: card vs CPU (the card's routing) max abs err "
          f"{err} > {LM_TOL_2_LAYERS} * {scale}")
    emit({"phase": "moe_card_vs_cpu", "arch": cfg.name, "layers": 2,
          "batch": 2, "seq": 128, "capacity": capacity(cut, 256),
          "launches": launches, "max_abs_err_vs_cpu": err,
          "max_abs_logit": scale,
          "tolerance": f"{LM_TOL_2_LAYERS} * max|logit|, the CPU replaying "
                       f"the card's routing",
          "routing_agreement_cpu_own": agree,
          "first_layer_gap_limit": MOE_GAP,
          "dropped_card": [int(x) for x in card["dropped"]],
          "top1_agree": (got.argmax(-1) == want.argmax(-1)).float().mean()
          .item(), "card": smi})
    return launches


def moe_forward_phase(torch, np, params, cfg, smi):
    """Score LM_BATCH x LM_SEQ ids through the flash route (48 launches),
    the xla route and the xla_chunked route.  The xla route is the
    reference: each other route first routes on its own (the share of
    choices that agree is printed), then replays the xla route's routing,
    and its logits are held against the reference's, one route at a time
    (each logits tensor is 5.37 GB)."""
    from repro_torch.models.api import get_model
    from repro_torch.tree import tree_leaves

    ids = torch.from_numpy(lm_tokens(np, cfg.vocab_size, LM_BATCH, LM_SEQ,
                                     SEED)).cuda()
    apis = {impl: get_model(cfg.replace(attn_impl=impl))
            for impl in ("flash", "xla", "xla_chunked")}
    torch.cuda.reset_peak_memory_stats()
    ((ref, aux), ref_rec), launches_xla = counted(torch, lambda: route_tap(
        lambda: apis["xla"].forward(params, ids)))
    expect_launches("moe forward xla", launches_xla, {})
    check(ref.shape == (LM_BATCH, LM_SEQ, cfg.vocab_size)
          and bool(torch.isfinite(ref).all()) and aux.item() > 0,
          f"moe forward xla: logits not finite [{LM_BATCH}, {LM_SEQ}, "
          f"{cfg.vocab_size}] or aux not positive")
    scale = ref.abs().max().item()
    routes, launches_flash = {}, None
    for impl in ("flash", "xla_chunked"):
        fn = (lambda api=apis[impl]: api.forward(params, ids))
        ((logits, _), own), launches = counted(torch, lambda: route_tap(fn))
        expect_launches(f"moe forward {impl}", launches,
                        {"flash_attention": cfg.n_layers}
                        if impl == "flash" else {})
        if impl == "flash":
            launches_flash, flash_rec = launches, own
        top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        # in place: a logits tensor is 5.37 GB
        free_err = logits.sub_(ref).abs_().max().item()
        del logits
        agree = routing_agreement(torch, ref_rec, own)
        check_first_layer_flips(f"moe forward {impl}", agree)
        (logits, _), _ = route_tap(fn, replay=ref_rec["top_e"])
        err = logits.sub_(ref).abs_().max().item()
        del logits
        check(err <= LM_TOL_FULL * scale,
              f"moe forward: {impl} vs xla (xla's routing) max abs err "
              f"{err} > {LM_TOL_FULL} * {scale}")
        routes[impl] = {"max_abs_err_vs_xla": err,
                        "max_abs_err_vs_xla_own_routing": free_err,
                        "top1_agree_own_routing": top1,
                        "routing_agreement_own": agree}
    del ref
    peak = torch.cuda.max_memory_allocated()
    dropped = [int(x) for x in flash_rec["dropped"]]
    tok_s = {}
    for impl in ("flash", "xla", "xla_chunked"):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apis[impl].forward(params, ids)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        tok_s[impl] = LM_BATCH * LM_SEQ / statistics.median(times)
    bound, c = moe_forward_bound_ms(cfg, LM_BATCH, LM_SEQ)
    # bytes: every parameter read once, the f32 logits written once
    bytes_ms = 1e3 * (sum(t.numel() * t.element_size()
                          for t in tree_leaves(params))
                      + 4 * LM_BATCH * LM_SEQ * cfg.vocab_size
                      ) / HBM_BYTES_PER_S
    split = {}
    prof = profile_summary(*profile_call(
        torch, lambda: apis["flash"].forward(params, ids),
        sections=moe_sections(), split=split))
    split = {label: split.get(label) or "not measured"
             for _, _, label in moe_sections()}
    emit({"phase": "moe_forward", "arch": cfg.name, "layers": cfg.n_layers,
          "batch": LM_BATCH, "seq": LM_SEQ, "dtype": cfg.dtype,
          "launches": launches_flash, "max_abs_logit": scale,
          "tolerance": f"{LM_TOL_FULL} * max|logit|, each route replaying "
                       f"the xla route's routing",
          "routes": routes, "first_layer_gap_limit": MOE_GAP,
          "capacity": c, "dropped_by_layer": dropped,
          "dropped_total": sum(dropped),
          "entries_per_layer": LM_BATCH * LM_SEQ * cfg.experts_per_token,
          "entries_total": cfg.n_layers * LM_BATCH * LM_SEQ
          * cfg.experts_per_token,
          "drop_rate": sum(dropped) / (cfg.n_layers * LM_BATCH * LM_SEQ
                                       * cfg.experts_per_token),
          "max_memory_allocated": peak, "tokens_per_s": tok_s,
          "ms_flash": 1e3 * LM_BATCH * LM_SEQ / tok_s["flash"],
          "bound_ms": max(sum(bound.values()), bytes_ms),
          "bound_parts_ms": bound, "bound_bytes_ms": bytes_ms,
          "bound_by": ("operations" if sum(bound.values()) >= bytes_ms
                       else "bytes"), "profile_flash": prof,
          "device_ms_split": split, "card": smi})
    return launches_flash


def generate_replay(torch, gen_rec, n_layers: int, b: int):
    """The forward's routing, layer by layer, from a generate run's
    record (the prefill's layers, then each decode step's): positions in
    order, [B * (prompt + steps), k] a layer."""
    calls = gen_rec["top_e"]
    steps = len(calls) // n_layers
    out = []
    for layer in range(n_layers):
        parts = [calls[s * n_layers + layer] for s in range(steps)]
        k = parts[0].shape[-1]
        out.append(torch.cat([p.reshape(b, -1, k) for p in parts],
                             dim=1).reshape(-1, k))
    return out


def moe_generate_phase(torch, np, params, cfg, smi):
    """Engine.generate: B=4, a 512-token prompt, 32 greedy tokens.  Held
    under capacity_factor = E / k, where the capacity is at least a call's
    tokens and nothing drops: the last decode logits against the flash
    forward over the prompt and the generated ids, the forward replaying
    the generate run's routing.  Timed and profiled at the default
    factor."""
    from repro_torch.models.api import get_model
    from repro_torch.models.moe import capacity
    from repro_torch.serve.engine import Engine
    from repro_torch.tree import tree_leaves

    n_tok = LM_BATCH * (MOE_PROMPT + MOE_GEN)
    nodrop = cfg.replace(attn_impl="flash", capacity_factor=cfg.n_experts
                         / cfg.experts_per_token)
    check(capacity(nodrop, n_tok) >= n_tok, "moe generate: the no-drop "
                                            "factor drops")
    prompt = torch.from_numpy(lm_tokens(np, cfg.vocab_size, LM_BATCH,
                                        MOE_PROMPT, SEED + 2))
    api = get_model(nodrop)
    eng = Engine(api, params, max_len=MOE_PROMPT + MOE_GEN,
                 batch_size=LM_BATCH)
    (out, rec), launches = counted(torch, lambda: route_tap(
        lambda: eng.generate({"tokens": prompt}, MOE_GEN)))
    expect_launches("moe generate", launches, {})
    ids = out["ids"]
    check(ids.shape == (LM_BATCH, MOE_GEN) and int(ids.min()) >= 0
          and int(ids.max()) < cfg.vocab_size, "moe generate: bad ids")
    full = torch.cat([prompt.cuda(), ids], dim=1)
    (free, _), own = route_tap(lambda: api.forward(params, full))
    free_err = (out["logits"] - free[:, -1]).abs().max().item()
    replay = generate_replay(torch, rec, cfg.n_layers, LM_BATCH)
    agree = routing_agreement(torch, own, {"top_e": replay})
    check_first_layer_flips("moe generate", agree)
    del free
    (want, _), _ = route_tap(lambda: api.forward(params, full), replay=replay)
    want = want[:, -1]
    err, scale = rel_err(out["logits"], want)
    check(err <= LM_TOL_FULL * scale,
          f"moe generate: last decode logits vs forward (generate's "
          f"routing) max abs err {err} > {LM_TOL_FULL} * {scale}")
    check(sum(int(x) for x in rec["dropped"]) == 0,
          "moe generate: an entry dropped under the no-drop factor")

    # the default factor: timed, a decode step profiled and its syncs
    api = get_model(cfg.replace(attn_impl="flash"))
    eng = Engine(api, params, max_len=MOE_PROMPT + MOE_GEN,
                 batch_size=LM_BATCH)
    eng.generate({"tokens": prompt}, MOE_GEN)            # warm-up
    timed, launches_d = counted(torch, lambda: eng.generate(
        {"tokens": prompt}, MOE_GEN))
    expect_launches("moe generate (default factor)", launches_d, {})
    cache = api.init_cache(LM_BATCH, MOE_PROMPT + 1)
    _, cache = api.prefill(params, {"tokens": prompt.cuda()}, cache)
    step = {"token": timed["ids"][:, 0], "pos": MOE_PROMPT}
    prof = profile_summary(*profile_call(
        torch, lambda: api.decode_step(params, step, cache)))
    reported, blocking = host_syncs(
        torch, lambda: api.decode_step(params, step, cache))
    _, blocking_empty = host_syncs(torch, lambda: None)
    check(reported == 0, f"moe decode step: {reported} host syncs reported")
    st = timed["stats"]
    # a decode step reads every parameter but the embedding table (the
    # dense-capacity expert products read every expert) and the cache
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    nbytes -= params["embed"]["table"].numel() * params["embed"][
        "table"].element_size()
    nbytes += sum(t.numel() * t.element_size() for t in cache.values())
    step_ms = 1e3 * st.decode_s / MOE_GEN
    emit({"phase": "moe_generate", "arch": cfg.name, "batch": LM_BATCH,
          "prompt": MOE_PROMPT, "new_tokens": MOE_GEN,
          "launches": launches, "check_capacity_factor":
          nodrop.capacity_factor,
          "why_factor": "E / k makes the capacity at least a call's tokens, "
                        "so neither generate nor the forward drops: a "
                        "prefill and a decode step otherwise drop other "
                        "entries than one forward over the same tokens",
          "max_abs_err_last_logits_vs_forward": err, "max_abs_logit": scale,
          "tolerance": f"{LM_TOL_FULL} * max|logit|, the forward replaying "
                       f"the generate run's routing",
          "max_abs_err_own_routing": free_err,
          "routing_agreement_forward_own": agree,
          "top1_agree": (out["logits"].argmax(-1) == want.argmax(-1))
          .float().mean().item(),
          "default_factor": cfg.capacity_factor,
          "prefill_capacity": capacity(cfg, LM_BATCH * MOE_PROMPT),
          "prefill_ms": 1e3 * st.prefill_s,
          "decode_ms_per_step": step_ms,
          "decode_tokens_per_s": st.decode_tok_per_s,
          "decode_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
          "decode_bound_by": "bytes", "decode_bytes": nbytes,
          "decode_ms_over_bound": step_ms / (1e3 * nbytes / HBM_BYTES_PER_S),
          "profile_decode_step": prof,
          "host_syncs_decode_step": {"reported": reported,
                                     "blocking_calls": blocking,
                                     "profiler_baseline": blocking_empty},
          "card": smi})
    return launches


def moe_smoke_phase(torch, np, smi):
    """One forward each of the other decoder configs at their JAX smoke
    configs (bf16, 2 layers, d 64), the card (flash kernel, head dim 16)
    against the CPU; internvl2 on stub [B, T, d] embeddings.  The CPU
    replays the card's routing (maverick)."""
    from repro_torch.api.build import to_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import get_model

    total, lines = {k: 0 for k in counters()}, {}
    for i, arch in enumerate(SMOKE_ARCHS):
        cfg = get_smoke_config(arch).replace(attn_impl="flash")
        api = get_model(cfg)
        params = api.init(torch.Generator(device="cuda").manual_seed(
            SEED + 20 + i))
        if cfg.frontend == "patch_stub":
            x = torch.from_numpy(np.random.default_rng(SEED + 3 + i)
                                 .standard_normal((2, 64, cfg.d_model))
                                 .astype(np.float32))
        else:
            x = torch.from_numpy(lm_tokens(np, cfg.vocab_size, 2, 64,
                                           SEED + 3 + i))
        ((got, aux), card), launches = counted(torch, lambda: route_tap(
            lambda: api.forward(params, x.cuda())))
        expect_launches(f"{arch} smoke", launches,
                        {"flash_attention": cfg.n_layers})
        cpu_params = to_device(params, "cpu")
        (_, own) = route_tap(lambda: api.forward(cpu_params, x))
        (want, want_aux), _ = route_tap(
            lambda: api.forward(cpu_params, x),
            replay=[e.cpu() for e in card["top_e"]] or None)
        got = got.cpu()
        err, scale = rel_err(got, want)
        check(bool(torch.isfinite(got).all()) and err <= LM_TOL_2_LAYERS
              * scale, f"{arch} smoke: card vs CPU max abs err {err} > "
                       f"{LM_TOL_2_LAYERS} * {scale}")
        lines[arch] = {"family": cfg.family, "launches": launches[
            "flash_attention"], "max_abs_err_vs_cpu": err,
            "max_abs_logit": scale, "aux": aux.item(),
            "aux_cpu": want_aux.item()}
        if card["top_e"]:
            agree = routing_agreement(torch, card, own)
            lines[arch]["routing_agreement_cpu_own"] = agree[
                "share_all_layers"]
        add_launches(total, launches)
    emit({"phase": "moe_smoke_configs", "configs": lines,
          "tolerance": f"{LM_TOL_2_LAYERS} * max|logit|, the CPU replaying "
                       f"the card's routing", "card": smi})
    return total


def moe_phases(torch, np, smi):
    """The MoE and remaining decoder phases: moonshot-v1-16b-a3b at full
    width and depth (bf16, random weights from a seed), then the other
    decoder configs at smoke size.  Returns (kernel rows, launches on
    main paths, flash launches of the moonshot forward)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import active_param_count, param_count

    rows = moe_kernel_phase(torch, smi)
    cfg = get_config(MOE_ARCH)
    total = dict(moe_cpu_phase(torch, np, cfg, smi))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n = param_count(params)
    check(n == MOE_PARAMS, f"moe init: {n} params, expected {MOE_PARAMS}")
    emit({"phase": "moe_init", "arch": cfg.name, "params": n,
          "active_params": active_param_count(params, cfg),
          "seconds": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated(),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "card": smi})
    fwd = moe_forward_phase(torch, np, params, cfg, smi)
    add_launches(total, fwd)
    add_launches(total, moe_generate_phase(torch, np, params, cfg, smi))
    del params
    torch.cuda.empty_cache()
    add_launches(total, moe_smoke_phase(torch, np, smi))
    return rows, total, fwd["flash_attention"]


# -------------------------------------------------------- LM training --

LM_TRAIN_LR = 3e-4
LM_TRAIN_STEPS = 20
LM_TRAIN_CUT = dict(batch=2, seq=256)
# bf16 gradients of two runs that round differently (the card against the
# CPU), each leaf's max error as a fraction of the leaf's max|g|.  bf16
# keeps 8 significant bits: where the two runs round an activation a
# step (2**-8 relative) apart, every gradient that sums over it moves,
# and a leaf's largest error lands where many such terms add up.  The CPU
# tests measured up to 2.6e-2 of XLA against the port at smoke width
# (tests/test_torch_lm_train.py, which holds 6e-2); the same bound here.
LM_GRAD_TOL = 6e-2
MOE_TRAIN_STEPS = 5
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 512


class deterministic:
    """``torch.use_deterministic_algorithms`` within the block (warnings
    only, cuBLAS's workspace pinned); ``.warnings`` holds what it said."""

    def __init__(self, torch):
        self.torch = torch
        self.warnings = []

    def __enter__(self):
        self.saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        self.torch.use_deterministic_algorithms(True, warn_only=True)
        self.caught = warnings.catch_warnings(record=True)
        self.log = self.caught.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        self.caught.__exit__(*exc)
        self.warnings = sorted({str(w.message)[:120] for w in self.log})
        self.torch.use_deterministic_algorithms(False)
        if self.saved_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = self.saved_env
        return False


def grad_stats(card, cpu):
    """Each gradient leaf of ``card`` against ``cpu`` (the reference; the
    sums run on its device): the worst leaf's max error as a fraction of
    its max|g| (inf where a zero leaf differs), where it is, and the
    tree's relative L2 error."""
    from repro_torch.tree import leaves_with_paths
    gc, gh = dict(leaves_with_paths(card)), dict(leaves_with_paths(cpu))
    worst, worst_at, err2, norm2 = 0.0, None, 0.0, 0.0
    for path, h in gh.items():
        h = h.float()
        c = gc[path].float().to(h.device)
        scale = float(h.abs().max())
        err = float((c - h).abs().max())
        frac = err / scale if scale else (math.inf if err else 0.0)
        if frac > worst or worst_at is None:
            worst, worst_at = frac, "/".join(map(str, path))
        err2 += float(((c - h).double() ** 2).sum())
        norm2 += float((h.double() ** 2).sum())
    return {"grad_leaf_worst_frac_of_max": worst, "grad_leaf_worst_at":
            worst_at, "grad_tree_rel_l2": (err2 / norm2) ** 0.5}


def grads_close(name, card, cpu, tol=LM_GRAD_TOL):
    """Hold each gradient leaf of ``card`` to ``cpu``: max error within
    ``tol`` of the leaf's max|g|.  Returns :func:`grad_stats`."""
    stats = grad_stats(card, cpu)
    check(stats["grad_leaf_worst_frac_of_max"] <= tol,
          f"{name}: gradient of {stats['grad_leaf_worst_at']} differs by "
          f"{stats['grad_leaf_worst_frac_of_max']} of its max|g| > {tol}")
    return dict(stats, tolerance=f"{tol} of each leaf's max|g|")


def weight_stats(card, cpu, lr: float):
    """Weights after one AdamW step on the card against the CPU.  A first
    step moves each weight by about lr * sign(g) (an element whose
    gradient is near 0 may move the other way), and each side rounds its
    weight to the grid once: at most half a step of its dtype, 2**-8 of
    it in bf16, so the two roundings add at most 2**-7 of the larger
    weight (the CPU's may land near 0 where the card's lands near 2 lr).
    ``over_allowance`` is the largest excess over ``2 lr + max(|w_card|,
    |w_cpu|) 2**-7`` (held at <= 0)."""
    from repro_torch.tree import leaves_with_paths
    moved, total_el, worst, over = 0, 0, 0.0, -math.inf
    hp = dict(leaves_with_paths(cpu))
    for path, c in leaves_with_paths(card):
        h = hp[path].float()
        c = c.float().cpu()
        d = (c - h).abs()
        room = h.abs().maximum(c.abs()) * 2.0 ** -7
        over = max(over, float((d - 2 * lr - room).max()))
        moved += int((d > 0).sum())
        total_el += d.numel()
        worst = max(worst, float(d.max()))
    return {"weights_that_differ": moved, "weights": total_el,
            "max_abs_weight_diff": worst, "over_allowance": over,
            "allowance": "2 lr + max(|w_card|, |w_cpu|) 2**-7"}


def lm_train_step_phase(torch, cfg, smi):
    """tinyllama cut to 2 layers at full width, B2 x T256 bf16 (remat, the
    xla route): gradients and one ``build_train_step`` AdamW step on the
    card against the CPU, and the card's gradients with remat on and off
    bitwise under deterministic algorithms."""
    from repro_torch.api.build import to_device
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_data
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import get_model
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.tree import leaves_with_paths

    cut = cfg.replace(n_layers=2)
    api = get_model(cut)
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED + 30))
    batch = lm_data.synth_batch(SEED, 0, LM_TRAIN_CUT["batch"],
                                LM_TRAIN_CUT["seq"], cut.vocab_size,
                                device="cpu")
    batch_c = to_device(batch, "cuda")
    ((loss_c, _), g_c), launches = counted(
        torch, lambda: value_and_grad(api.loss_fn, params, batch_c))
    expect_launches("lm_train 2 layers", launches, {})
    cpu_params = to_device(params, "cpu")
    t0 = time.perf_counter()
    (loss_h, _), g_h = value_and_grad(api.loss_fn, cpu_params, batch)
    cpu_s = time.perf_counter() - t0
    loss_c, loss_h = float(loss_c), float(loss_h)
    check(abs(loss_c - loss_h) <= 1e-3 * abs(loss_h),
          f"lm_train 2 layers: loss {loss_c} on the card, {loss_h} on "
          f"the CPU")
    grads = grads_close("lm_train 2 layers", g_c, g_h)
    del g_c, g_h

    tc = TrainConfig(optimizer="adamw", lr=LM_TRAIN_LR,
                     lr_min=LM_TRAIN_LR / 10, steps=LM_TRAIN_STEPS,
                     batch_size=LM_TRAIN_CUT["batch"])
    train_step, init_opt = build_train_step(api, tc)
    (p_c, _, m_c), launches = counted(torch, lambda: train_step(
        params, init_opt(params), batch_c, 0))
    expect_launches("lm_train 2-layer step", launches, {})
    p_h, _, m_h = train_step(cpu_params, init_opt(cpu_params), batch, 0)
    check(abs(float(m_c["grad_norm"]) - float(m_h["grad_norm"]))
          <= 1e-2 * float(m_h["grad_norm"]),
          f"lm_train step: grad_norm {float(m_c['grad_norm'])} on the "
          f"card, {float(m_h['grad_norm'])} on the CPU")
    weights = weight_stats(p_c, p_h, LM_TRAIN_LR)
    check(weights["over_allowance"] <= 0, f"lm_train step: weights moved "
                                          f"{weights['max_abs_weight_diff']}"
                                          f" apart")
    del p_c, p_h, cpu_params

    with deterministic(torch) as det:
        runs = [value_and_grad(get_model(cut.replace(remat=r)).loss_fn,
                               params, batch_c)[1] for r in (True, False)]
        torch.cuda.synchronize()
    on, off = (dict(leaves_with_paths(g)) for g in runs)
    remat_bitwise = all(torch.equal(on[k], off[k]) for k in on)
    check(remat_bitwise, "lm_train: gradients with remat on and off differ "
                         "under deterministic algorithms")
    emit({"phase": "lm_train_step", "arch": cfg.name, "layers": 2,
          "batch": LM_TRAIN_CUT["batch"], "seq": LM_TRAIN_CUT["seq"],
          "dtype": cut.dtype, "remat": cut.remat,
          "attn_impl": cut.attn_impl, "launches": launches,
          "loss_card": loss_c, "loss_cpu": loss_h,
          "loss_rel_err": abs(loss_c - loss_h) / abs(loss_h), **grads,
          "cpu_value_and_grad_s": cpu_s,
          "step": {"grad_norm_card": float(m_c["grad_norm"]),
                   "grad_norm_cpu": float(m_h["grad_norm"]),
                   "lr": float(m_c["lr"]),
                   **{k: weights[k] for k in ("weights_that_differ",
                                              "weights",
                                              "max_abs_weight_diff")}},
          "remat_on_off_bitwise_deterministic": remat_bitwise,
          "deterministic_warnings": det.warnings, "card": smi})
    return launches


def attention_f32_ms(torch, cfg, b: int, t: int):
    """Device ms of one layer's f32 attention (``_sdpa_xla`` at the
    training shape, bf16 q, k, v) as a remat step runs it: a forward,
    then the recompute's forward and the backward."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    hd = cfg.kv_head_dim

    def rnd(h):
        return (torch.randn(b, t, h, hd, generator=gen, device="cuda")
                .to(torch.bfloat16).requires_grad_(True))
    q, k, v = rnd(cfg.n_heads), rnd(cfg.n_kv_heads), rnd(cfg.n_kv_heads)
    cot = torch.randn(b, t, cfg.n_heads, hd, generator=gen,
                      device="cuda").to(torch.bfloat16)

    def fwd():
        with torch.no_grad(), L.f32_sums():
            return A._sdpa_xla(q, k, v, True, 0, 0)

    def fwd_bwd():
        with L.f32_sums():
            out = A._sdpa_xla(q, k, v, True, 0, 0)
            return torch.autograd.grad(out, (q, k, v), cot)
    return (median_ms(torch, fwd, reps=5, inner=2, warmup=1),
            median_ms(torch, fwd_bwd, reps=5, inner=2, warmup=1))


def lm_train_bound_ms(cfg, n_params: int, b: int, t: int):
    """A remat training step's bound, ms by part, each part at its own
    limit: the bf16 products (6 N per token, the embedding table's gather
    left out, plus remat's second forward of the layers, 2 N_layers per
    token) at the bf16 peak; the xla route's f32 attention (Q.K and P.V
    over the full T x T square: a forward, the recompute and a backward
    of twice the forward) at the f32 peak; AdamW's bytes (bf16 param and
    gradient read, f32 m and v read and written, the param written: 22
    bytes a param) at the memory rate."""
    tokens = b * t
    d, hd = cfg.d_model, cfg.kv_head_dim
    embed = cfg.vocab_size * d
    layers = n_params - embed * (1 if cfg.tie_embeddings else 2) - d
    bf16 = (6 * (n_params - embed) + 2 * layers) * tokens
    attn = cfg.n_layers * 4 * 4 * b * cfg.n_heads * t * t * hd
    return {"bf16_products": 1e3 * bf16 / BF16_OPS_PER_S,
            "f32_attention": 1e3 * attn / FP32_OPS_PER_S,
            "adamw_bytes": 1e3 * 22 * n_params / HBM_BYTES_PER_S}


def lm_train_fit_phase(torch, cfg, smi):
    """tinyllama at full width and depth (remat, the xla route): ``fit``
    with AdamW for LM_TRAIN_STEPS steps at LM_BATCH x LM_SEQ on the
    synthetic stream, a profiled step, the f32 attention's share, and one
    step at B1 with remat on and off (peak memory of each)."""
    import tempfile

    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_data
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import param_count
    from repro_torch.train.train_loop import fit

    api = get_model(cfg)
    events, losses, drop = [], [], {}

    def on_step(step, params, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(float(metrics["loss"]))

    def data(start):
        return lm_data.stream(SEED, LM_BATCH, LM_SEQ, cfg.vocab_size, start,
                              device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(optimizer="adamw", lr=LM_TRAIN_LR,
                         lr_min=LM_TRAIN_LR / 10, steps=LM_TRAIN_STEPS,
                         batch_size=LM_BATCH, checkpoint_every=0,
                         checkpoint_dir=d)
        t0 = time.perf_counter()
        result, launches = counted(torch, lambda: fit(
            api, tc, data, hooks={"on_step": on_step}, device="cuda"))
        fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    expect_launches("lm_train fit", launches, {})
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    step_ms = statistics.median(ms)
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"lm_train fit: loss {losses[0]} -> {losses[-1]}, not down")
    params, opt_state = result["params"], result["opt_state"]
    n = param_count(params)
    del result

    train_step, _ = build_train_step(api, tc)
    batch = lm_data.synth_batch(SEED, LM_TRAIN_STEPS, LM_BATCH, LM_SEQ,
                                cfg.vocab_size, device="cuda")
    prof = profile_summary(*profile_call(torch, lambda: train_step(
        params, opt_state, batch, LM_TRAIN_STEPS)[2]["loss"].item()),
        gemm_f32_ms=("sgemm", "f32f32"), softmax_ms=("softmax",))
    fwd_ms, fwd_bwd_ms = attention_f32_ms(torch, cfg, LM_BATCH, LM_SEQ)
    attn_ms = cfg.n_layers * (fwd_ms + fwd_bwd_ms)
    if isinstance(prof["device_ms"], float):
        prof["f32_attention_share_of_device"] = attn_ms / prof["device_ms"]
    bound = lm_train_bound_ms(cfg, n, LM_BATCH, LM_SEQ)

    peaks = {}
    one = lm_data.synth_batch(SEED, 0, 1, LM_SEQ, cfg.vocab_size,
                              device="cuda")
    for remat in (True, False):
        step_r, _ = build_train_step(get_model(cfg.replace(remat=remat)), tc)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resting = torch.cuda.memory_allocated()
        out = step_r(params, opt_state, one, LM_TRAIN_STEPS)
        torch.cuda.synchronize()
        peaks[f"remat_{remat}"] = {
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "above_params_and_opt_state":
                torch.cuda.max_memory_allocated() - resting,
            "loss": float(out[2]["loss"])}
        del out
    emit({"phase": "lm_train_fit", "arch": cfg.name, "params": n,
          "layers": cfg.n_layers, "batch": LM_BATCH, "seq": LM_SEQ,
          "dtype": cfg.dtype, "remat": cfg.remat, "attn_impl": cfg.attn_impl,
          "optimizer": "adamw", "lr": LM_TRAIN_LR, "steps": LM_TRAIN_STEPS,
          "launches": launches, "loss_step_0": losses[0],
          "loss_last": losses[-1], "losses": losses,
          "ms_per_step_median": step_ms, "ms_per_step": ms,
          "tokens_per_s": LM_BATCH * LM_SEQ / (step_ms / 1e3),
          "fit_seconds": fit_s, "max_memory_allocated": peak,
          "bound_ms": bound, "bound_ms_total": sum(bound.values()),
          "profile_one_step": prof,
          "f32_attention_ms_per_layer": {"forward": fwd_ms,
                                         "forward_and_backward": fwd_bwd_ms},
          "f32_attention_ms_per_step": attn_ms,
          "b1_step_peak_memory": peaks, "card": smi})
    return launches


def fit_resume(torch, api, data, batch_size: int, name: str):
    """``fit`` with a checkpoint every 3 steps, under deterministic
    algorithms: 6 steps straight, against a run stopped in step 4 and a
    second ``fit`` that resumes from step 3's checkpoint.  Checks the
    final params bitwise and the checkpoint bitwise the params it saved;
    returns (a record of the run, the launches of both ``fit`` calls)."""
    import tempfile

    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_loop import fit
    from repro_torch.tree import leaves_with_paths

    saved = {}

    def keep_step_3(step, params, metrics):
        if step == 2:
            saved.update(leaves_with_paths(tree_cpu(params)))

    def die(step, params, metrics):
        if step == 3:
            for _ in range(3000):         # the step-3 saves are in flight
                if ckpt.latest_step(f"{d}/b") == ckpt.latest_step(
                        f"{d}/b/opt") == 3:
                    break
                time.sleep(0.01)
            raise KeyboardInterrupt("preempted")

    with tempfile.TemporaryDirectory() as d, deterministic(torch) as det:
        def tc(sub):
            return TrainConfig(optimizer="adamw", lr=LM_TRAIN_LR,
                               lr_min=LM_TRAIN_LR / 10, steps=6,
                               batch_size=batch_size, checkpoint_every=3,
                               checkpoint_dir=f"{d}/{sub}")
        (straight, l1) = counted(torch, lambda: fit(
            api, tc("a"), data, hooks={"on_step": keep_step_3},
            device="cuda"))
        try:
            fit(api, tc("b"), data, hooks={"on_step": die}, device="cuda")
            check(False, f"{name}: the run was not stopped")
        except KeyboardInterrupt:
            pass
        check(ckpt.latest_step(f"{d}/b") == 3, f"{name}: no checkpoint at "
                                               f"step 3")
        back, _ = ckpt.restore(f"{d}/b", 3, straight["params"])
        manifest = json.loads(pathlib.Path(
            f"{d}/b/step_00000003/manifest.json").read_text())
        round_trip = all(torch.equal(v.cpu(), saved[k])
                         for k, v in leaves_with_paths(back))
        resumed_steps = []
        (resumed, l2) = counted(torch, lambda: fit(
            api, tc("b"), data, hooks={"on_step": lambda step, p, m:
                                       resumed_steps.append(step)},
            device="cuda"))
    check(round_trip, f"{name}: the checkpoint differs from the params it "
                      f"saved")
    diff = params_diff(resumed["params"], straight["params"])
    check(diff == 0.0, f"{name}: resumed params differ from the straight "
                       f"run's by {diff}")
    launches = dict(l1)
    add_launches(launches, l2)
    return ({"steps": 6, "checkpoint_every": 3, "stopped_in_step": 4,
             "resumed_from": 3, "bitwise": True,
             "checkpoint_round_trip_bitwise": round_trip,
             "checkpoint_dtypes": sorted({v["dtype"] for v in
                                          manifest["leaves"].values()}),
             "checkpoint_shapes": {k: v["shape"] for k, v in
                                   manifest["leaves"].items()},
             "resumed_steps": resumed_steps,
             "deterministic_warnings": det.warnings}, launches)


def lm_train_resume_phase(torch, cfg, smi):
    """``fit`` at the 2-layer cut, stopped and resumed (:func:`fit_resume`):
    final params bitwise, and the bf16 checkpoint bitwise the params it
    saved."""
    from repro_torch.data import lm_data
    from repro_torch.models.api import get_model

    def data(start):
        return lm_data.stream(SEED + 1, LM_TRAIN_CUT["batch"],
                              LM_TRAIN_CUT["seq"], cfg.vocab_size, start,
                              device="cuda")
    rec, launches = fit_resume(torch, get_model(cfg.replace(n_layers=2)),
                               data, LM_TRAIN_CUT["batch"], "lm_train resume")
    expect_launches("lm_train resume", launches, {})
    del rec["checkpoint_shapes"]
    emit({"phase": "lm_train_resume", "arch": cfg.name, "layers": 2, **rec,
          "card": smi})
    return launches


def moe_train_phase(torch, np, smi):
    """moonshot at full width cut to 2 layers (remat, the xla route):
    MOE_TRAIN_STEPS AdamW steps at MOE_TRAIN_BATCH x MOE_TRAIN_SEQ (loss,
    ms a step, peak memory, entries dropped); then one step of the smoke
    config on the card against the CPU, the CPU replaying the card's
    routing."""
    from repro_torch.api.build import to_device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_data
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import get_model
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import param_count
    from repro_torch.train.train_loop import value_and_grad

    cfg = get_config(MOE_ARCH).replace(n_layers=2)
    api = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED + 31))
    n = param_count(params)
    tc = TrainConfig(optimizer="adamw", lr=LM_TRAIN_LR,
                     lr_min=LM_TRAIN_LR / 10, steps=MOE_TRAIN_STEPS,
                     batch_size=MOE_TRAIN_BATCH)
    train_step, init_opt = build_train_step(api, tc)
    opt = init_opt(params)
    losses, ms, dropped, calls = [], [], [], []

    def run():
        nonlocal params, opt
        for s in range(MOE_TRAIN_STEPS):
            batch = lm_data.synth_batch(SEED + 2, s, MOE_TRAIN_BATCH,
                                        MOE_TRAIN_SEQ, cfg.vocab_size,
                                        device="cuda")
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            (params, opt, m), rec = route_tap(lambda: train_step(
                params, opt, batch, s))
            t1.record()
            t1.synchronize()
            ms.append(t0.elapsed_time(t1))
            losses.append(float(m["loss"]))
            calls.append(len(rec["dropped"]))
            dropped.append([int(x) for x in rec["dropped"][:cfg.n_layers]])
    _, launches = counted(torch, run)
    expect_launches("moe_train", launches, {})
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"moe_train: loss {losses[0]} -> {losses[-1]}, not down")
    del params, opt
    torch.cuda.empty_cache()
    entries = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ * cfg.experts_per_token

    scfg = get_smoke_config(MOE_ARCH)
    sapi = get_model(scfg)
    sp = sapi.init(torch.Generator().manual_seed(SEED + 32), device="cpu")
    batch = lm_data.synth_batch(SEED + 3, 0, 2, 64, scfg.vocab_size,
                                device="cpu")
    (((loss_c, _), g_c), card), s_launches = counted(torch, lambda: route_tap(
        lambda: value_and_grad(sapi.loss_fn, to_device(sp, "cuda"),
                               to_device(batch, "cuda"))))
    expect_launches("moe_train smoke", s_launches, {})
    (_, own) = route_tap(lambda: value_and_grad(sapi.loss_fn, sp, batch))
    agree = routing_agreement(torch, card, own)
    check_first_layer_flips("moe_train smoke", agree)
    ((loss_h, _), g_h), _ = route_tap(
        lambda: value_and_grad(sapi.loss_fn, sp, batch),
        replay=[e.cpu() for e in card["top_e"]])
    loss_c, loss_h = float(loss_c), float(loss_h)
    check(abs(loss_c - loss_h) <= 1e-3 * abs(loss_h),
          f"moe_train smoke: loss {loss_c} on the card, {loss_h} on the "
          f"CPU")
    grads = grads_close("moe_train smoke", g_c, g_h)
    emit({"phase": "moe_train", "arch": cfg.name, "layers": 2,
          "params": n, "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ,
          "dtype": cfg.dtype, "remat": cfg.remat, "attn_impl": cfg.attn_impl,
          "capacity": capacity(cfg, MOE_TRAIN_BATCH * MOE_TRAIN_SEQ),
          "launches": launches, "losses": losses,
          "ms_per_step": ms, "ms_per_step_median": statistics.median(ms[1:]),
          "tokens_per_s": MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
          / (statistics.median(ms[1:]) / 1e3),
          "max_memory_allocated": peak,
          "dispatch_calls_per_step": calls,
          "entries_per_layer": entries,
          "dropped_by_step_and_layer": dropped,
          "smoke_step_vs_cpu": {
              "arch": scfg.name, "dtype": scfg.dtype, "batch": 2, "seq": 64,
              "launches": s_launches, "loss_card": loss_c,
              "loss_cpu": loss_h, **grads,
              "routing": "the CPU replays the card's routing",
              "routing_agreement_cpu_own": agree,
              "first_layer_gap_limit": MOE_GAP},
          "card": smi})
    add = dict(launches)
    add_launches(add, s_launches)
    return add


def lm_refusal_phase(torch, smi, arch: str = LM_ARCH):
    """Flash under grad: ``loss_fn`` of ``arch``'s smoke config with
    ``attn_impl="flash"`` raises on the card before any launch; the same
    forward without a gradient launches the kernel once an attention
    layer (Whisper: its encoder's and its decoder's self-attention)."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import get_model
    from repro_torch.train.train_loop import value_and_grad

    cfg = get_smoke_config(arch).replace(attn_impl="flash")
    api = get_model(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED + 34))
    batch = family_batch(torch, np, cfg, 2, 64, SEED)

    def train():
        try:
            value_and_grad(api.loss_fn, params, batch)
        except NotImplementedError as e:
            return str(e)
        return None
    msg, refused = counted(torch, train)
    check(msg is not None and "no backward" in msg,
          f"{arch}: flash under grad did not refuse")
    expect_launches(f"{arch} flash refusal", refused, {})
    inp = batch if cfg.family == "audio" else batch["tokens"]
    with torch.no_grad():
        _, served = counted(torch, lambda: api.forward(params, inp))
    expect_launches(f"{arch} flash forward without grad", served,
                    {"flash_attention": cfg.n_layers + cfg.n_enc_layers})
    emit({"phase": "lm_train_flash_refusal", "arch": arch, "refused": msg,
          "launches_under_grad": refused["flash_attention"],
          "launches_without_grad": served["flash_attention"], "card": smi})
    return served


def lm_train_phases(torch, np, smi):
    """The LM training phases (no hand kernel: JAX trains on plain
    products, and flash has no backward).  Returns the launches on the
    paths they drive."""
    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    total = {k: 0 for k in counters()}
    add_launches(total, lm_train_step_phase(torch, cfg, smi))
    add_launches(total, lm_train_fit_phase(torch, cfg, smi))
    torch.cuda.empty_cache()
    add_launches(total, lm_train_resume_phase(torch, cfg, smi))
    add_launches(total, moe_train_phase(torch, np, smi))
    add_launches(total, lm_refusal_phase(torch, smi))
    torch.cuda.empty_cache()
    return total


# ------------------------------------------- xLSTM, Hymba and Whisper --

FAMILY_ARCHS = ("xlstm-1.3b", "hymba-1.5b", "whisper-tiny")
# Engine.generate: greedy, FAMILY_GEN decode steps at LM_BATCH; Hymba's
# prompt overruns its 1024-slot window, so prefill wraps the rolling
# cache; Whisper's decoder context is 448 tokens (Radford et al. 2022).
FAMILY_GEN = 64
FAMILY_PROMPT = {"xlstm-1.3b": 512, "hymba-1.5b": 1536, "whisper-tiny": 4}
WHISPER_CTX = 448
# The dtype in which each family's cut is held against the CPU; bf16 is
# measured and printed beside.  A random-weight xLSTM amplifies a rounding
# difference by orders of magnitude (an mLSTM head whose q.k sum is near
# 0 flips sign through the head norm), so its bf16 logits move by 9-48%
# of max|logit| between two roundings, in the JAX reference as here (bf16
# against f32 of one 8-layer group at width 256: 9.3% in JAX, 9.0% in the
# port): xLSTM is held in f32, where only the sum order differs.
FAMILY_HELD_DTYPE = {"ssm": "float32"}
# Decode against the forward is held in f32 for all three (the params
# cast): in bf16 the decode path (rolling cache, recurrent step, f32
# state) and the forward (flash, chunk scan) round apart by 2-3% of
# max|logit| over 32-48 layers, which flips the argmax wherever the top
# two logits are closer (Hymba: 21 of 260 ids on an H100), and xLSTM's
# by 58%.  A generated id may differ from the f32 forward's argmax only
# where that forward's two largest logits are closer than FAMILY_TIE_GAP
# of max|logit| (a near tie); each such position is reported.  bf16's
# numbers are printed beside.
FAMILY_GEN_HELD_DTYPE = "float32"
FAMILY_TIE_GAP = 2e-3
# The flash rows of these families: (label, H, Hkv, T, causal, window),
# bf16, B4, head dim 64; and the shape under which flash_shapes counts
# each row's launches on the main paths.
FAMILY_FLASH = (("hymba_window", 25, 5, LM_SEQ, True, 1024),
                ("whisper_enc", 6, 6, 1500, False, 0),
                ("whisper_dec", 6, 6, WHISPER_CTX, True, 0))
FAMILY_FLASH_SHAPE = {"hymba_window": f"causal T{LM_SEQ} window 1024",
                      "whisper_enc": "noncausal T1500",
                      "whisper_dec": f"causal T{WHISPER_CTX}"}


# xLSTM's card phases run at full width cut in depth to one group of
# slstm_every layers (7 mLSTM, 1 sLSTM): at its 48 layers its serving
# phases took 140.56 s and its training 190.48 s of a 1031.44 s run;
# the cut is named in each of its lines ("depth_cut").  Hymba and
# Whisper keep their depth.
FAMILY_DEPTH = {"xlstm-1.3b": 8}


def family_config(arch: str):
    """``get_config(arch)`` cut to FAMILY_DEPTH's layers where it names
    the arch."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.replace(n_layers=FAMILY_DEPTH[arch]) \
        if arch in FAMILY_DEPTH else cfg


def depth_cut(cfg) -> str:
    """The phase line's note of :func:`family_config`'s cut."""
    from repro_torch.configs import get_config
    full = get_config(cfg.name).n_layers
    return f"n_layers {full} -> {cfg.n_layers}" if full != cfg.n_layers \
        else "none"


def family_cut(cfg):
    """The cut held against the CPU: full width, two layers (xLSTM: one
    group of ``slstm_every`` layers, the depth that holds an sLSTM block;
    Whisper: two encoder and two decoder layers)."""
    if cfg.family == "ssm":
        return cfg.replace(n_layers=cfg.slstm_every)
    if cfg.family == "audio":
        return cfg.replace(n_layers=2, n_enc_layers=2)
    return cfg.replace(n_layers=2)


def family_flash_calls(cfg) -> int:
    """Flash launches of one forward on the flash route: one an attention
    layer (Whisper: encoder and decoder self-attention; its
    cross-attention is plain, as in JAX)."""
    return {"ssm": 0, "hybrid": cfg.n_layers,
            "audio": cfg.n_layers + cfg.n_enc_layers}[cfg.family]


def family_inputs(torch, np, cfg, b: int, t: int, seed: int):
    """The forward's input on the CPU: token ids [b, t], and for Whisper
    the batch dict with stub frames [b, enc_seq, d] (standard normal, a
    numpy seed)."""
    ids = torch.from_numpy(lm_tokens(np, cfg.vocab_size, b, t, seed))
    if cfg.family != "audio":
        return ids
    frames = np.random.default_rng(seed + 100).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return {"frames": torch.from_numpy(frames), "tokens": ids}


def to_card(x):
    return ({k: v.cuda() for k, v in x.items()} if isinstance(x, dict)
            else x.cuda())


def flash_shapes(fn):
    """Run ``fn`` with ``ops.flash_attention`` wrapped to count its calls on
    CUDA tensors by shape: (its result, {"causal T2048 window 1024" and
    the like: calls})."""
    from repro_torch.kernels import ops
    seen = {}
    orig = ops.flash_attention

    def wrapped(q, k, v, causal=True, window=0, *a, **kw):
        if q.is_cuda:
            key = (f"{'causal' if causal else 'noncausal'} T{q.shape[2]}"
                   + (f" window {window}" if window else ""))
            seen[key] = seen.get(key, 0) + 1
        return orig(q, k, v, causal, window, *a, **kw)
    ops.flash_attention = wrapped
    try:
        out = fn()
    finally:
        ops.flash_attention = orig
    return out, seen


def add_counts(total, seen):
    for k, v in seen.items():
        total[k] = total.get(k, 0) + v


def family_kernel_phase(torch, smi):
    """The flash kernel at the shapes these families give it (bf16, B4,
    head dim 64, CUDA-graph replays beside SDPA): Hymba's causal window of
    1024 over 25 query heads and 5 KV heads at T 2048; Whisper's encoder,
    non-causal over 1500 frames (not a multiple of the 128-row tile), and
    its decoder's causal self-attention at its 448-token context."""
    from repro_torch.kernels import flash_attention as fa_mod

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    rows = {}
    for label, nh, nkv, t, causal, win in FAMILY_FLASH:
        q = torch.randn(LM_BATCH, nh, t, 64, generator=gen,
                        device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(LM_BATCH, nkv, t, 64, generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        row = flash_row(torch, label, q, k, v, causal, win, timer=graph_ms)
        row.update(timing="CUDA-graph replays (ms and library_ms)",
                   card=smi, events_ms=median_ms(
                       torch, lambda: fa_mod.flash_attention_cuda(
                           q, k, v, causal, win)))
        rows[("flash_attention", label)] = row
        del q, k, v
    return emit_rows(rows)


def family_cpu_phase(torch, np, cfg, smi):
    """The full-width cut (:func:`family_cut`), B2 T128 (Whisper: 1500
    frames), on the card (the flash kernel on Hymba and Whisper) against
    the CPU (plain versions), held in FAMILY_HELD_DTYPE (the same params
    cast) with bf16 printed beside."""
    from repro_torch.api.build import to_device
    from repro_torch.models.api import get_model

    cut = family_cut(cfg).replace(attn_impl="flash")
    params = get_model(cut).init(
        torch.Generator(device="cuda").manual_seed(SEED + 5))
    inp = family_inputs(torch, np, cut, 2, 128, SEED + 1)
    held = FAMILY_HELD_DTYPE.get(cut.family, cut.dtype)
    rec, total, seen = {}, None, None
    for dtype in dict.fromkeys((cut.dtype, held)):
        api = get_model(cut.replace(dtype=dtype))
        p = cast_floats(torch, params, dtype)
        ((got, _), seen), launches = counted(torch, lambda: flash_shapes(
            lambda: api.forward(p, to_card(inp))))
        expect_launches(f"{cfg.name} cut {dtype}", launches,
                        {"flash_attention": family_flash_calls(cut)})
        total = launches if total is None else {
            k: total[k] + v for k, v in launches.items()}
        cpu_p = to_device(p, "cpu")
        del p
        t0 = time.perf_counter()
        want, _ = api.forward(cpu_p, inp)
        cpu_s = time.perf_counter() - t0
        del cpu_p
        got = got.cpu()
        check(bool(torch.isfinite(got).all()),
              f"{cfg.name} cut {dtype}: not finite")
        err, scale = rel_err(got, want)
        rec[dtype] = {"max_abs_err_vs_cpu": err, "max_abs_logit": scale,
                      "top1_agree": (got.argmax(-1) == want.argmax(-1))
                      .float().mean().item(), "cpu_seconds": cpu_s}
    del params
    # the 8-layer xLSTM group is deeper than the others' two: the
    # full-depth limit
    tol = LM_TOL_FULL if cut.n_layers > 2 else LM_TOL_2_LAYERS
    err, scale = (rec[held][k] for k in ("max_abs_err_vs_cpu",
                                          "max_abs_logit"))
    check(err <= tol * scale, f"{cfg.name} cut ({held}): card vs CPU max "
                              f"abs err {err} > {tol} * {scale}")
    emit({"phase": "family_card_vs_cpu", "arch": cfg.name,
          "layers": cut.n_layers, "enc_layers": cut.n_enc_layers,
          "batch": 2, "seq": 128, "launches": total, "flash_shapes": seen,
          "held_dtype": held, "tolerance": f"{tol} * max|logit|, in {held}",
          **rec, "card": smi})
    return total, seen


def wall_ms(torch, fn, reps: int = 3) -> float:
    """Median host wall ms of ``reps`` synchronized calls."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def timed_calls(torch, mod, attr, fn):
    """Run ``fn`` once with ``mod.attr`` wrapped to synchronize around
    each of its calls: (the wrapped calls' wall ms summed, ``fn``'s wall
    ms)."""
    orig = getattr(mod, attr)
    spent = [0.0]

    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        spent[0] += 1e3 * (time.perf_counter() - t0)
        return out
    setattr(mod, attr, wrapped)
    try:
        total = wall_ms(torch, fn, reps=1)
    finally:
        setattr(mod, attr, orig)
    return spent[0], total


def family_forward_phase(torch, np, params, cfg, smi):
    """The scoring forward at full width and depth: xLSTM and Hymba on 4 x
    2048 ids, Whisper on frames [4, 1500, 384] and 4 x 448 tokens; Hymba
    and Whisper on the flash and the xla route (held against each other),
    xLSTM on its one route (it has no attention).  tokens/s from the
    median of 3 wall times, a profiled forward (xLSTM's with device
    activity only: its sLSTM loop makes about 200k kernels), and for
    xLSTM the sLSTM blocks' share of a forward."""
    from repro_torch.models import xlstm as X
    from repro_torch.models.api import get_model

    t = WHISPER_CTX if cfg.family == "audio" else LM_SEQ
    inp = to_card(family_inputs(torch, np, cfg, LM_BATCH, t, SEED))
    impls = ("xla",) if cfg.family == "ssm" else ("flash", "xla")
    apis = {impl: get_model(cfg.replace(attn_impl=impl)) for impl in impls}
    out, launches, seen, tok_s, ms = {}, {}, {}, {}, {}
    for impl, api in apis.items():
        ((logits, aux), seen[impl]), launches[impl] = counted(
            torch, lambda: flash_shapes(lambda: api.forward(params, inp)))
        check(logits.shape == (LM_BATCH, t, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()) and aux.item() == 0,
              f"{cfg.name} forward {impl}: logits not finite [{LM_BATCH}, "
              f"{t}, {cfg.vocab_size}]")
        out[impl] = logits
        del logits
        ms[impl] = wall_ms(torch, lambda: api.forward(params, inp))
        tok_s[impl] = LM_BATCH * t / (ms[impl] / 1e3)
    expect_launches(f"{cfg.name} forward xla", launches["xla"], {})
    rec = {"phase": "family_forward", "arch": cfg.name,
           "layers": cfg.n_layers, "batch": LM_BATCH, "seq": t,
           "dtype": cfg.dtype, "tokens_per_s": tok_s, "wall_ms": ms,
           "card": smi}
    main = "xla"
    if "flash" in apis:
        main = "flash"
        expect_launches(f"{cfg.name} forward flash", launches["flash"],
                        {"flash_attention": family_flash_calls(cfg)})
        err, scale = rel_err(out["flash"], out["xla"])
        check(err <= LM_TOL_FULL * scale,
              f"{cfg.name} forward: flash vs xla max abs err {err} > "
              f"{LM_TOL_FULL} * {scale}")
        rec.update(launches=launches["flash"], flash_shapes=seen["flash"],
                   max_abs_err_flash_vs_xla=err, max_abs_logit=scale,
                   tolerance=f"{LM_TOL_FULL} * max|logit|",
                   top1_agree=(out["flash"].argmax(-1) == out["xla"]
                               .argmax(-1)).float().mean().item())
    del out
    prof = profile_summary(*profile_call(
        torch, lambda: apis[main].forward(params, inp),
        cpu=cfg.family != "ssm"),
        flash_ms=("flash_attention_wgmma_kernel",
                  "flash_attention_ffma_kernel"))
    rec["profile_" + main] = prof
    if cfg.family == "ssm":
        # the sLSTM time loop's share of a forward: each block's call
        # synchronized and timed inside one forward; one block alone
        # profiled (host-paced: about 17 small kernels a step)
        s_ms, f_ms = timed_calls(torch, X, "slstm_block_apply",
                                 lambda: apis[main].forward(params, inp))
        x = torch.randn(LM_BATCH, t, cfg.d_model, device="cuda").to(
            torch.bfloat16)
        sp = X._at(params["sblocks"], 0)
        rec.update(slstm_ms_in_forward=s_ms, forward_ms_timed=f_ms,
                   slstm_share_of_forward=s_ms / f_ms,
                   profile_slstm_block=profile_summary(*profile_call(
                       torch, lambda: X.slstm_block_apply(sp, cfg, x),
                       cpu=False)))
        del x
    emit(rec)
    return launches[main], seen[main]


def decode_vs_forward(torch, api, params, batch, out, prompt_len: int):
    """The last decode logits of ``out`` (an ``Engine.generate`` result)
    against ``api.forward`` over the prompt and the generated ids, and
    every id chosen (the prefill's pick, each decode step's, the last
    step's argmax) against the forward's argmax where it was chosen: (max
    abs err, max|logit|, [[row, position, top-2 gap / max|logit|] of
    each id that differs])."""
    ids = out["ids"]
    tokens = torch.cat([batch["tokens"].cuda(), ids], dim=1)
    full_in = (dict(to_card(batch), tokens=tokens)
               if "frames" in batch else tokens)
    full, _ = api.forward(params, full_in)
    err, scale = rel_err(out["logits"], full[:, -1])
    chosen = torch.cat([ids, out["logits"].argmax(-1)[:, None]], dim=1)
    fwd = full[:, prompt_len - 1:]
    del full
    top2 = fwd.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]) / scale
    ties = [[b, p, gap[b, p].item()]
            for b, p in (chosen != fwd.argmax(-1)).nonzero().tolist()]
    return err, scale, ties


def family_generate_phase(torch, np, params, cfg, smi):
    """Engine.generate, B4, greedy, FAMILY_GEN steps (prompt
    FAMILY_PROMPT; Whisper with its 1500 stub frames, max_len 448),
    timed, a decode step profiled.  Held in FAMILY_GEN_HELD_DTYPE (a
    second generate with the params cast to f32): the last decode logits
    against the forward (flash route) over the prompt and the generated
    ids, and every generated id against that forward's argmax at its
    position (a disagreement allowed only at a near tie, FAMILY_TIE_GAP,
    and reported); bf16's printed beside."""
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import Engine

    prompt_len = FAMILY_PROMPT[cfg.name]
    impl = "xla" if cfg.family == "ssm" else "flash"
    api = get_model(cfg.replace(attn_impl=impl))
    max_len = WHISPER_CTX if cfg.family == "audio" else \
        prompt_len + FAMILY_GEN
    eng = Engine(api, params, max_len=max_len, batch_size=LM_BATCH)
    batch = family_inputs(torch, np, cfg, LM_BATCH, prompt_len, SEED + 2)
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    n_flash = cfg.n_enc_layers if cfg.family == "audio" else 0
    eng.generate(batch, 2)                                   # warm-up
    (out, seen), launches = counted(torch, lambda: flash_shapes(
        lambda: eng.generate(batch, FAMILY_GEN)))
    expect_launches(f"{cfg.name} generate", launches,
                    {"flash_attention": n_flash})
    ids = out["ids"]
    check(ids.shape == (LM_BATCH, FAMILY_GEN) and int(ids.min()) >= 0
          and int(ids.max()) < cfg.vocab_size,
          f"{cfg.name} generate: bad ids")
    checks = {cfg.dtype: decode_vs_forward(torch, api, params, batch, out,
                                           prompt_len)}
    held = FAMILY_GEN_HELD_DTYPE
    if held != cfg.dtype:
        api_h = get_model(cfg.replace(attn_impl=impl, dtype=held))
        p_h = cast_floats(torch, params, held)
        (out_h, seen_h), launches_h = counted(torch, lambda: flash_shapes(
            lambda: Engine(api_h, p_h, max_len=max_len,
                           batch_size=LM_BATCH).generate(batch,
                                                         FAMILY_GEN)))
        expect_launches(f"{cfg.name} generate {held}", launches_h,
                        {"flash_attention": n_flash})
        add_counts(seen, seen_h)
        launches = {k: v + launches_h[k] for k, v in launches.items()}
        checks[held] = decode_vs_forward(torch, api_h, p_h, batch, out_h,
                                         prompt_len)
        del p_h, out_h
    err, scale, ties = checks[held]
    check(err <= LM_TOL_FULL * scale,
          f"{cfg.name} generate ({held}): last decode logits vs forward "
          f"max abs err {err} > {LM_TOL_FULL} * {scale}")
    check(all(g < FAMILY_TIE_GAP for _, _, g in ties),
          f"{cfg.name} generate ({held}): ids differ from the forward's "
          f"argmax away from a near tie: {ties}")
    cache = api.init_cache(LM_BATCH, max_len)
    _, cache = api.prefill(params, to_card(batch), cache)
    step = {"token": ids[:, 0], "pos": prompt_len}
    prof = profile_summary(*profile_call(
        torch, lambda: api.decode_step(params, step, cache)))
    del cache
    st = out["stats"]
    emit({"phase": "family_generate", "arch": cfg.name, "batch": LM_BATCH,
          "prompt": prompt_len, "new_tokens": FAMILY_GEN, "max_len": max_len,
          "launches": launches, "flash_shapes": seen,
          "prefill_ms": 1e3 * st.prefill_s,
          "decode_ms_per_step": 1e3 * st.decode_s / FAMILY_GEN,
          "decode_tokens_per_s": st.decode_tok_per_s,
          "held_dtype": held,
          "tolerance": f"{LM_TOL_FULL} * max|logit|, in {held}; an id may "
                       f"differ only where the forward's top-2 gap is under "
                       f"{FAMILY_TIE_GAP} * max|logit|",
          **{dt: {"max_abs_err_last_logits_vs_forward": e,
                  "max_abs_logit": sc, "positions": LM_BATCH * (
                      FAMILY_GEN + 1), "ids_differ": len(tl),
                  "near_ties": tl} for dt, (e, sc, tl) in checks.items()},
          "profile_decode_step": prof, "card": smi})
    return launches, seen


def family_phases(torch, np, smi):
    """xlstm-1.3b, hymba-1.5b and whisper-tiny at full width and depth
    (bf16, random weights from a seed): the flash rows at their shapes, a
    cut against the CPU, the scoring forward and Engine.generate.
    Returns (kernel rows, launches on main paths, flash calls by shape on
    main paths)."""
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import param_count

    rows = family_kernel_phase(torch, smi)
    total, shapes = {k: 0 for k in counters()}, {}
    for arch in FAMILY_ARCHS:
        cfg = family_config(arch)
        t_arch = time.perf_counter()
        launches, seen = family_cpu_phase(torch, np, cfg, smi)
        add_launches(total, launches)
        add_counts(shapes, seen)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = get_model(cfg).init(
            torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        emit({"phase": "family_init", "arch": cfg.name,
              "params": param_count(params),
              "seconds": time.perf_counter() - t0,
              "memory_allocated": torch.cuda.memory_allocated()})
        for fn in (family_forward_phase, family_generate_phase):
            launches, seen = fn(torch, np, params, cfg, smi)
            add_launches(total, launches)
            add_counts(shapes, seen)
        del params
        torch.cuda.empty_cache()
        emit({"phase": "family_total", "arch": arch,
              "depth_cut": depth_cut(cfg),
              "seconds": time.perf_counter() - t_arch,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "card": smi})
    return rows, total, shapes


# ------------------------------ xLSTM, Hymba and Whisper training --

# fit at full width and depth: (batch, seq, steps).  xLSTM at a multiple
# of its 256-step chunk (512 sLSTM steps a block, 6 blocks); Hymba past
# its 1024-token window; Whisper at its 448-token decoder context over
# 1500 stub frames.
FAMILY_FIT = {"xlstm-1.3b": (4, 512, 5), "hymba-1.5b": (4, LM_SEQ, 10),
              "whisper-tiny": (4, WHISPER_CTX, 20)}
# One step of each cut (family_cut) on the card against the CPU, its
# gradients held to LM_GRAD_TOL of each leaf's max|g| in
# FAMILY_HELD_DTYPE (xLSTM in f32).  Not tighter in f32: xLSTM's f32
# gradient is ill-conditioned, not only its bf16 one: lowering about
# half the params by one ulp moves it by 2.3e-4 to 4.0e-4 of max|g| at
# widths 1024 and 512 (8 layers, B2 x T256, on the CPU; at 1024 no
# normalizer clamp changes side), and ulp_floor prints that floor on the
# card at full width beside the card-against-CPU error.
FAMILY_STEP_CUT = dict(batch=2, seq=128)
# The per-step latency xLSTM's bound charges the sLSTM recurrence: its T
# steps depend on each other, forward and backward.  A step is at least
# one grid-wide handoff of h (a launch, or a cooperative grid barrier:
# about 2 us on an H100) before the next step's [B, dh] x [dh, 4 dh]
# products of its heads can start.
SLSTM_STEP_US = 2.0


def family_batch(torch, np, cfg, b: int, t: int, seed: int, step: int = 0,
                 device="cuda"):
    """Batch ``step`` of a family's training stream: the synthetic tokens
    and labels (``data.lm_data``), and for Whisper stub frames [b,
    enc_seq, d] (standard normal, numpy-seeded by (seed, step))."""
    from repro_torch.data import lm_data
    batch = lm_data.synth_batch(seed, step, b, t, cfg.vocab_size,
                                device=device)
    if cfg.family == "audio":
        frames = np.random.default_rng([seed, step, 7]).standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        batch["frames"] = torch.from_numpy(frames).to(device)
    return batch


def grad_tap(fn):
    """Run ``fn`` with ``train_loop.value_and_grad`` wrapped to keep what
    each call returns: (``fn``'s result, [((loss, metrics), grads)])."""
    from repro_torch.train import train_loop
    orig = train_loop.value_and_grad
    rec = []

    def tapped(loss_fn, params, batch):
        out = orig(loss_fn, params, batch)
        rec.append(out)
        return out
    train_loop.value_and_grad = tapped
    try:
        return fn(), rec
    finally:
        train_loop.value_and_grad = orig


def cast_floats(torch, params, dtype: str):
    """The params with every float leaf not in f32 cast to ``dtype`` (an
    f32 leaf, such as Hymba's D-skip, stays f32 in either config)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda a: a.to(getattr(torch, dtype)) if
                    a.is_floating_point() and a.dtype != torch.float32
                    else a, params)


def ulp_floor(torch, cfg, params, grads, batch, seed: int = SEED + 42):
    """The conditioning floor of a gradient: the worst leaf's change, as a
    fraction of its max|g|, when every float param moves by 2**-p of
    itself, p its dtype's mantissa bits (one or two ulps: 2**-23 in f32,
    2**-7 in bf16; a random sign from a generator seeded with ``seed``),
    on the same device and code path."""
    from repro_torch.models.api import get_model
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.tree import tree_map
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def nudge(t):
        if not t.is_floating_point():
            return t
        sign = torch.randint(0, 2, t.shape, generator=gen,
                             device=t.device) * 2 - 1
        ulp = torch.finfo(t.dtype).eps
        return (t.double() * (1 + sign * ulp)).to(t.dtype)
    _, moved = value_and_grad(get_model(cfg).loss_fn,
                              tree_map(nudge, params), batch)
    return grad_stats(moved, grads)["grad_leaf_worst_frac_of_max"]


def family_train_step_phase(torch, np, cfg, smi):
    """(a) The full-width cut (:func:`family_cut`), FAMILY_STEP_CUT (Whisper
    over its 1500 frames), remat, the xla route: one
    ``build_accumulating_step`` AdamW step on the card and on the CPU from
    the same params and batch, its gradients tapped.  Held in
    FAMILY_HELD_DTYPE (xLSTM in f32; Hymba and Whisper in bf16): each
    gradient leaf within LM_GRAD_TOL of its max|g|, the loss within rtol
    1e-3, the weights within :func:`weight_stats`'s allowance, with the
    floor (:func:`ulp_floor`, the held dtype's) beside; xLSTM's bf16
    figures are printed beside."""
    from repro_torch.api.build import to_device
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.api import get_model
    from repro_torch.train.train_loop import build_accumulating_step

    cut = family_cut(cfg)
    held = FAMILY_HELD_DTYPE.get(cut.family, cut.dtype)
    b, t = FAMILY_STEP_CUT["batch"], FAMILY_STEP_CUT["seq"]
    params = get_model(cut).init(
        torch.Generator(device="cuda").manual_seed(SEED + 40))
    batch = family_batch(torch, np, cut, b, t, SEED + 4, device="cpu")
    tc = TrainConfig(optimizer="adamw", lr=LM_TRAIN_LR,
                     lr_min=LM_TRAIN_LR / 10, steps=LM_TRAIN_STEPS,
                     batch_size=b)
    rec, total = {}, {k: 0 for k in counters()}
    for dtype in dict.fromkeys((cut.dtype, held)):
        step, init_opt = build_accumulating_step(
            get_model(cut.replace(dtype=dtype)), tc)
        p_c_in = cast_floats(torch, params, dtype)
        ((p_c, _, m_c), tap_c), launches = counted(torch, lambda: grad_tap(
            lambda: step(p_c_in, init_opt(p_c_in), to_card(batch), 0)))
        add_launches(total, launches)
        cpu_p = to_device(p_c_in, "cpu")
        t0 = time.perf_counter()
        (p_h, _, m_h), tap_h = grad_tap(
            lambda: step(cpu_p, init_opt(cpu_p), batch, 0))
        cpu_s = time.perf_counter() - t0
        ((loss_c, _), g_c), ((loss_h, _), g_h) = tap_c[0], tap_h[0]
        loss_c, loss_h = float(loss_c), float(loss_h)
        floor = (ulp_floor(torch, cut.replace(dtype=dtype), p_c_in, g_c,
                           to_card(batch)) if dtype == held
                 else "not measured")
        rec[dtype] = {
            "loss_card": loss_c, "loss_cpu": loss_h,
            "loss_rel_err": abs(loss_c - loss_h) / abs(loss_h),
            **grad_stats(g_c, g_h), "grad_tolerance": LM_GRAD_TOL,
            "one_ulp_floor_on_card": floor,
            "grad_norm_card": float(m_c["grad_norm"]),
            "grad_norm_cpu": float(m_h["grad_norm"]),
            **weight_stats(p_c, p_h, LM_TRAIN_LR), "cpu_step_s": cpu_s}
        del p_c, p_h, g_c, g_h, cpu_p, tap_c, tap_h, p_c_in
        torch.cuda.empty_cache()
    del params
    emit({"phase": "family_train_step", "arch": cfg.name,
          "layers": cut.n_layers, "enc_layers": cut.n_enc_layers,
          "batch": b, "seq": t, "remat": cut.remat,
          "attn_impl": cut.attn_impl, "held_dtype": held,
          "tolerance": "loss rtol 1e-3; each gradient leaf within "
                       "grad_tolerance of its max|g|; weights within 2 lr "
                       "+ max(|w_card|, |w_cpu|) 2**-7", "launches": total,
          **rec, "card": smi})
    r = rec[held]
    check(r["loss_rel_err"] <= 1e-3, f"{cfg.name} train step ({held}): loss "
                                     f"{r['loss_card']} on the card, "
                                     f"{r['loss_cpu']} on the CPU")
    check(r["grad_leaf_worst_frac_of_max"] <= r["grad_tolerance"],
          f"{cfg.name} train step ({held}): gradient of "
          f"{r['grad_leaf_worst_at']} differs by "
          f"{r['grad_leaf_worst_frac_of_max']} of its max|g|")
    check(r["over_allowance"] <= 0, f"{cfg.name} train step ({held}): "
                                    f"weights moved "
                                    f"{r['max_abs_weight_diff']} apart")
    expect_launches(f"{cfg.name} train step", total, {})
    return total


def family_remat_phase(torch, np, cfg, smi):
    """(b) The cut in bf16 under deterministic algorithms: gradients with
    remat on and off bitwise equal; then at B1 and the fit's length, the
    peak memory of a gradient with remat on and off."""
    from repro_torch.models.api import get_model
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.tree import leaves_with_paths

    cut = family_cut(cfg)
    params = get_model(cut).init(
        torch.Generator(device="cuda").manual_seed(SEED + 41))
    batch = family_batch(torch, np, cut, FAMILY_STEP_CUT["batch"],
                         FAMILY_STEP_CUT["seq"], SEED + 5)

    def grads(remat, batch):
        return value_and_grad(get_model(cut.replace(remat=remat)).loss_fn,
                              params, batch)
    with deterministic(torch) as det:
        runs, launches = counted(torch, lambda: [grads(r, batch)[1]
                                                 for r in (True, False)])
    on, off = (dict(leaves_with_paths(g)) for g in runs)
    bitwise = all(torch.equal(on[k], off[k]) for k in on)
    del runs, on, off
    _, t, _ = FAMILY_FIT[cfg.name]
    one = family_batch(torch, np, cut, 1, t, SEED + 6)
    peaks = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resting = torch.cuda.memory_allocated()
        (loss, _), g = grads(remat, one)
        torch.cuda.synchronize()
        peaks[f"remat_{remat}"] = {
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "above_params": torch.cuda.max_memory_allocated() - resting,
            "loss": float(loss)}
        del g
    del params
    emit({"phase": "family_train_remat", "arch": cfg.name,
          "layers": cut.n_layers, "enc_layers": cut.n_enc_layers,
          "batch": FAMILY_STEP_CUT["batch"], "seq": FAMILY_STEP_CUT["seq"],
          "dtype": cut.dtype, "launches": launches,
          "remat_on_off_bitwise_deterministic": bitwise,
          "deterministic_warnings": det.warnings,
          "b1_peak_memory": {"batch": 1, "seq": t, **peaks}, "card": smi})
    check(bitwise, f"{cfg.name}: gradients with remat on and off differ "
                   f"under deterministic algorithms")
    expect_launches(f"{cfg.name} remat", launches, {})
    return launches


def dense_leaves(tree):
    """(path, numel) of each dense product weight (a ``w`` leaf outside a
    conv) of ``tree``."""
    from repro_torch.tree import leaves_with_paths
    return [(path, t.numel()) for path, t in leaves_with_paths(tree)
            if path[-1] == "w" and "conv" not in path]


def scan_f32_flops(b: int, t: int, h: int, dk: int, dv: int,
                   chunk: int = 256) -> float:
    """One forward of ``linear_scan.chunked_scan``'s f32 products (T
    padded to the chunk): the decayed scores against v (L dv a token),
    the chunk states' read-out and build (2 dk dv a token), 2 flops
    each."""
    t_pad = -(-t // chunk) * chunk
    return 2.0 * b * h * t_pad * (chunk * dv + 2 * dk * dv)


def attn_f32_flops(b: int, h: int, tq: int, tk: int, hd: int) -> float:
    """One forward of the xla route's Q.K and P.V over the full tq x tk
    square (the mask applied to the scores, not skipped)."""
    return 4.0 * b * h * tq * tk * hd


def family_train_bound_ms(cfg, params, b: int, t: int):
    """A remat training step's bound, ms by part, each part at its own
    limit: :func:`lm_train_bound_ms`'s parts, adapted to each family.

    * bf16 products: 6 flops a dense weight and token (the forward and the
      backward's two products) at the tokens it sees (Whisper's encoder
      and its decoder's cross K and V at the 1500 frames), plus 2 a weight
      and token for remat's second forward of the checkpointed layers
      (xLSTM: the mLSTM layers only); xLSTM adds its sLSTM recurrent
      product (h [dh, 4 dh] blocks a step, not rematerialized) and the
      chunk scan's q.k (L dk a token); the embedding gather is left out.
    * f32 products at the f32 peak: the chunk scan's (``scan_f32_flops``;
      xLSTM's mLSTM and Hymba's SSD heads) and the xla route's attention
      as it computes it (``attn_f32_flops``: Hymba's full T x T whatever
      the 1024 window, masked after; Whisper's encoder 1500 x 1500, its
      decoder's causal T x T and its cross T x 1500), each a forward, the
      recompute and a backward of twice the forward; Whisper's tied
      unembedding (f32, 6 a weight and token, not rematerialized).
    * xLSTM's sLSTM recurrence as latency: T dependent steps a block
      forward and T backward at SLSTM_STEP_US each (no product can start
      before the step before it ends).
    * AdamW's bytes (bf16 param and gradient read, f32 m and v read and
      written, the param written: 22 bytes a param) at the memory rate."""
    from repro_torch.models.transformer import param_count
    tok = b * t
    n = param_count(params)
    bf16 = f32 = latency_s = 0.0
    t_pad = -(-t // 256) * 256
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import _dims, group_layout
        _, h, dk, dv = _dims(cfg)
        ng, mper = group_layout(cfg)
        dense = sum(k for _, k in dense_leaves(params))
        m = sum(k for _, k in dense_leaves(params["mblocks"]))
        bf16 = (6 * dense + 2 * m) * tok
        bf16 += 6.0 * tok * params["sblocks"]["r"].numel()
        bf16 += 4 * ng * mper * 2.0 * b * h * t_pad * 256 * dk
        f32 = 4 * ng * mper * scan_f32_flops(b, t, h, dk, dv)
        latency_s = ng * 2 * t * SLSTM_STEP_US * 1e-6
    elif cfg.family == "hybrid":
        hd = cfg.kv_head_dim
        dv = cfg.d_model // cfg.n_heads
        blocks = sum(k for _, k in dense_leaves(params["blocks"]))
        bf16 = (8 * blocks + 6 * cfg.d_model * cfg.vocab_size) * tok
        bf16 += 4 * cfg.n_layers * 2.0 * b * cfg.n_heads * t_pad * 256 \
            * cfg.ssm_state
        f32 = 4 * cfg.n_layers * (
            attn_f32_flops(b, cfg.n_heads, t, t, hd)
            + scan_f32_flops(b, t, cfg.n_heads, cfg.ssm_state, dv))
    else:
        hd = cfg.kv_head_dim
        te = b * cfg.enc_seq
        enc = sum(k for _, k in dense_leaves(params["enc_blocks"]))
        cross = sum(k for path, k in dense_leaves(params["dec_blocks"])
                    if "cross_attn" in path and path[-2] in ("wk", "wv"))
        dec = sum(k for _, k in dense_leaves(params["dec_blocks"])) - cross
        bf16 = 8 * (enc * te + cross * te + dec * tok)
        f32 = 6.0 * cfg.vocab_size * cfg.d_model * tok
        f32 += 4 * (cfg.n_enc_layers * attn_f32_flops(
            b, cfg.n_heads, cfg.enc_seq, cfg.enc_seq, hd)
            + cfg.n_layers * (attn_f32_flops(b, cfg.n_heads, t, t, hd)
                              + attn_f32_flops(b, cfg.n_heads, t,
                                               cfg.enc_seq, hd)))
    out = {"bf16_products": 1e3 * bf16 / BF16_OPS_PER_S,
           "f32_products": 1e3 * f32 / FP32_OPS_PER_S,
           "adamw_bytes": 1e3 * 22 * n / HBM_BYTES_PER_S}
    if latency_s:
        out["slstm_latency"] = 1e3 * latency_s
    return out


def slstm_timed_step(torch, X, fn):
    """Run ``fn`` (a training step) once with each sLSTM block's forward
    call synchronized and timed, and its backward too: a hook on the
    block's output marks where autograd enters it, one on its input where
    it leaves (the input's gradient is whole only after the block's
    chain).  Returns (sLSTM forward ms, sLSTM backward ms, the step's
    wall ms)."""
    orig = X.slstm_block_apply
    spent = {"forward": 0.0, "backward": 0.0}
    entered = []

    def mark(g):
        torch.cuda.synchronize()
        entered.append(time.perf_counter())

    def leave(g):
        torch.cuda.synchronize()
        spent["backward"] += 1e3 * (time.perf_counter() - entered.pop())

    def wrapped(p, cfg, x, state=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, st = orig(p, cfg, x, state)
        torch.cuda.synchronize()
        spent["forward"] += 1e3 * (time.perf_counter() - t0)
        if y.requires_grad and x.requires_grad:
            y.register_hook(mark)
            x.register_hook(leave)
        return y, st
    X.slstm_block_apply = wrapped
    try:
        total = wall_ms(torch, fn, reps=1)
    finally:
        X.slstm_block_apply = orig
    return spent["forward"], spent["backward"], total


def family_fit_phase(torch, np, cfg, smi):
    """(c) ``fit`` at full width and depth (bf16, remat, the xla route,
    AdamW as ``launch.train`` sets it) for FAMILY_FIT's steps on the
    synthetic stream (Whisper's stub frames drawn in bulk before the run):
    every loss and gradient norm finite, the step's ms (CUDA events at
    each step's end, the median of the steps after the first), tokens/s,
    peak memory; a profiled step (xLSTM's with device activity only), its
    bound by part (:func:`family_train_bound_ms`), and for xLSTM the sLSTM
    blocks' share of a step (:func:`slstm_timed_step`)."""
    import tempfile

    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_data
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import xlstm as X
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import param_count
    from repro_torch.train.train_loop import fit

    b, t, steps = FAMILY_FIT[cfg.name]
    api = get_model(cfg)
    frames = None
    if cfg.family == "audio":
        frames = torch.from_numpy(np.random.default_rng(SEED + 7)
                                  .standard_normal((steps + 1, b,
                                                    cfg.enc_seq,
                                                    cfg.d_model))
                                  .astype(np.float32)).cuda()

    def batch_at(step):
        batch = lm_data.synth_batch(SEED + 8, step, b, t, cfg.vocab_size,
                                    device="cuda")
        if frames is not None:
            batch["frames"] = frames[step]
        return batch

    def data(start):
        step = start
        while True:
            yield batch_at(step)
            step += 1
    events, losses, norms = [], [], []

    def on_step(step, params, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(optimizer="adamw", lr=LM_TRAIN_LR,
                         lr_min=LM_TRAIN_LR / 10, steps=steps,
                         batch_size=b, checkpoint_every=0,
                         checkpoint_dir=d)
        t0 = time.perf_counter()
        result, launches = counted(torch, lambda: fit(
            api, tc, data, hooks={"on_step": on_step}, device="cuda"))
        fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ms = [a.elapsed_time(z) for a, z in zip(events, events[1:])]
    step_ms = statistics.median(ms)
    params, opt_state = result["params"], result["opt_state"]
    n = param_count(params)
    del result
    train_step, _ = build_train_step(api, tc)
    batch = batch_at(steps)
    prof = profile_summary(*profile_call(torch, lambda: train_step(
        params, opt_state, batch, steps)[2]["loss"].item(),
        cpu=cfg.family != "ssm", warmup=False))
    bound = family_train_bound_ms(cfg, params, b, t)
    rec = {"phase": "family_train_fit", "arch": cfg.name, "params": n,
           "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
           "batch": b, "seq": t, "dtype": cfg.dtype, "remat": cfg.remat,
           "attn_impl": cfg.attn_impl, "optimizer": "adamw",
           "lr": LM_TRAIN_LR, "steps": steps, "launches": launches,
           "losses": losses, "grad_norms": norms,
           "ms_per_step_median": step_ms, "ms_per_step": ms,
           "tokens_per_s": b * t / (step_ms / 1e3), "fit_seconds": fit_s,
           "max_memory_allocated": peak, "bound_ms": bound,
           "bound_ms_total": sum(bound.values()),
           "step_over_bound": step_ms / sum(bound.values()),
           "profile_one_step": prof, "card": smi}
    if cfg.family == "ssm":
        fwd, bwd, wall = slstm_timed_step(torch, X, lambda: train_step(
            params, opt_state, batch, steps)[2]["loss"].item())
        rec.update(slstm_forward_ms=fwd, slstm_backward_ms=bwd,
                   step_ms_timed=wall, slstm_share_of_step=(fwd + bwd) / wall)
    del params, opt_state
    emit(rec)
    check(len(losses) == steps and all(map(math.isfinite, losses + norms)),
          f"{cfg.name} fit: losses {losses}, gradient norms {norms}")
    expect_launches(f"{cfg.name} fit", launches, {})
    return launches


def family_resume_phase(torch, np, smi):
    """(d) The smoke xLSTM's ``fit`` on the card, stopped after its step-3
    checkpoint and resumed (:func:`fit_resume`): the nested [groups,
    per_group] stacks through ``train/checkpoint.py``, bitwise under
    deterministic algorithms."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm_data
    from repro_torch.models.api import get_model

    cfg = get_smoke_config("xlstm-1.3b").replace(remat=True)

    def data(start):
        return lm_data.stream(SEED + 9, 2, 64, cfg.vocab_size, start,
                              device="cuda")
    rec, launches = fit_resume(torch, get_model(cfg), data, 2,
                               "xlstm resume")
    shapes = rec.pop("checkpoint_shapes")
    nested = {k: v for k, v in shapes.items() if k.startswith("mblocks")}
    emit({"phase": "family_train_resume", "arch": cfg.name, "smoke": True,
          "layers": cfg.n_layers, "remat": cfg.remat, **rec,
          "mblocks_checkpoint_shapes": nested, "launches": launches,
          "card": smi})
    check(all(v[:2] == [2, 1] for v in nested.values()) and nested,
          f"xlstm resume: mblocks checkpointed as {nested}")
    expect_launches("xlstm resume", launches, {})
    return launches


def family_train_phases(torch, np, smi):
    """Training of xlstm-1.3b, hymba-1.5b and whisper-tiny (no hand kernel
    on the path: JAX trains them on plain products, and flash has no
    backward): per arch (a) a cut's step against the CPU, (b) remat
    bitwise and its peak memory, (c) ``fit`` at full width and depth;
    then (d) a resume and (e) the flash refusal of Hymba and Whisper.
    Returns the launches on the paths they drive."""
    total = {k: 0 for k in counters()}
    for arch in FAMILY_ARCHS:
        cfg = family_config(arch)
        t0 = time.perf_counter()
        for fn in (family_train_step_phase, family_remat_phase,
                   family_fit_phase):
            add_launches(total, fn(torch, np, cfg, smi))
            torch.cuda.empty_cache()
        emit({"phase": "family_train_total", "arch": arch,
              "depth_cut": depth_cut(cfg),
              "seconds": time.perf_counter() - t0, "card": smi})
    add_launches(total, family_resume_phase(torch, np, smi))
    for arch in ("hymba-1.5b", "whisper-tiny"):
        add_launches(total, lm_refusal_phase(torch, smi, arch))
    torch.cuda.empty_cache()
    return total


# ------------------------------------------- data-parallel training --

DP_STEPS = 3
# (b): tinyllama at full width cut to 2 layers, f32 (the CPU test's
# dtype, whose tolerance it keeps), global batch 4 x 512 over 2 ranks
DP_CUT = dict(layers=2, batch=4, seq=512, steps=2, ranks=2)
# the CPU test's tolerance (tests/test_torch_dp_train.py): f32 sums over
# the two ranks' blocks against one sum over the whole batch
DP_RTOL = 1e-5
DP_LEAF_ATOL = 1e-5
# (b)'s global MoE case: moonshot at full width cut to MA_CUT's 2 layers,
# bf16, global batch MA_CUT's MoE B2 x T256 over the two data ranks
# (``default``: a sequence a rank, the experts whole on each), each rank
# routing its block after the other's entry counts.  Held against one
# process on the card running the whole batch, its routing replayed
# (route_tap): the logits and served logits within MA_MOE_TOL of
# max|logit|, the gradients (the mean of the ranks') within LM_GRAD_TOL
# of each leaf's max|g| (bf16 sums over other row blocks), the drops of
# each block exactly the one process's for its tokens.  The aux differs
# only through the router probabilities' f32 mean over 512 tokens, whose
# inputs carry the bf16 GEMMs' roundings of another row count; the loss
# also through the cross-entropy of bf16 logits: both held relative.
DP_MOE_AUX_RTOL = 1e-3
DP_MOE_LOSS_RTOL = 1e-2


class TimedMean:
    """Wraps ``train.train_loop.group_mean``: CUDA events around each
    call on a mesh and the bytes of the gradients it reduces."""

    def __init__(self, torch, loop):
        self.torch, self.loop, self.orig = torch, loop, loop.group_mean
        self.events, self.nbytes = [], []

    def __enter__(self):
        def timed(grads, mesh, *rest):
            from repro_torch.tree import tree_leaves
            if mesh is None:
                return self.orig(grads, mesh, *rest)
            a = self.torch.cuda.Event(enable_timing=True)
            b = self.torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.orig(grads, mesh, *rest)
            b.record()
            self.events.append((a, b))
            self.nbytes.append(sum(x.numel() * x.element_size()
                                   for x in tree_leaves(grads)))
            return out
        self.loop.group_mean = timed
        return self

    def __exit__(self, *exc):
        self.loop.group_mean = self.orig
        return False

    def ms(self):
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def dp_nccl_phase(torch, smi):
    """(a) One NCCL rank at full size: ``train_loop.fit(..., mesh=
    make_host_mesh())`` over a process group of one, tinyllama-1.1b (22
    layers, bf16, remat, the xla route) at LM_BATCH x LM_SEQ for DP_STEPS
    steps (no checkpoints), each step's params and metrics bitwise those
    of ``fit`` without a mesh (both under deterministic algorithms); the
    step ms of each (``fit``'s own ``dt``, a synchronize after each step)
    and the gradient all-reduce's ms and bytes."""
    import contextlib
    import io
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_data
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models.api import get_model
    from repro_torch.train import train_loop as loop
    from repro_torch.tree import tree_leaves

    cfg = get_config(LM_ARCH)
    api = get_model(cfg)
    saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE",
                                             "LOCAL_RANK")}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    t0 = time.perf_counter()
    snaps, bitwise = [], []

    def keep(step, params, metrics):
        snaps.append(([x.clone() for x in tree_leaves(params)],
                      {k: v.clone() for k, v in metrics.items()}))

    def same(step, params, metrics):
        want_p, want_m = snaps[step]
        bitwise.append(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params), want_p)) and sorted(metrics) ==
            sorted(want_m) and all(torch.equal(metrics[k], want_m[k])
                                   for k in want_m))
    try:
        with tempfile.TemporaryDirectory() as d:
            dev = init_distributed(init_method=f"file://{d}/store")
            init_s = time.perf_counter() - t0
            mesh = make_host_mesh()
            check(dist.get_backend() == "nccl" and mesh.shape ==
                  {"data": 1} and mesh.device_mesh is not None,
                  f"dp_train nccl: backend {dist.get_backend()}, mesh "
                  f"{mesh.shape}")
            tc = TrainConfig(optimizer="adamw", lr=LM_TRAIN_LR,
                             lr_min=LM_TRAIN_LR / 10, steps=DP_STEPS,
                             batch_size=LM_BATCH, seed=SEED + 40,
                             checkpoint_every=0,
                             checkpoint_dir=f"{d}/ckpt")

            def data(start):
                return lm_data.stream(seed=SEED, batch=LM_BATCH,
                                      seq_len=LM_SEQ, vocab=cfg.vocab_size,
                                      start_step=start, device=dev)
            log = io.StringIO()
            with deterministic(torch) as det, TimedMean(torch, loop) as tm, \
                    contextlib.redirect_stdout(log):
                got, launches = counted(torch, lambda: loop.fit(
                    api, tc, data, hooks={"on_step": keep}, log_every=1,
                    device=dev, mesh=mesh))
                reduce_ms = tm.ms()
                del got["params"], got["opt_state"]
                want = loop.fit(api, tc, data, hooks={"on_step": same},
                                log_every=1, device=dev)
                del want["params"], want["opt_state"]
            expect_launches("dp_train nccl", launches, {})
            check(len(bitwise) == DP_STEPS and all(bitwise),
                  f"dp_train nccl: fit on the mesh is not bitwise fit "
                  f"without it: {bitwise}")
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if dist.is_initialized():
            dist.destroy_process_group()
    del snaps
    torch.cuda.empty_cache()
    ms = {"mesh": [h["dt"] * 1e3 for h in got["history"]],
          "plain": [h["dt"] * 1e3 for h in want["history"]]}
    emit({"phase": "dp_train_nccl", "entry": "train_loop.fit(mesh=)",
          "arch": cfg.name, "layers": cfg.n_layers,
          "batch": LM_BATCH, "seq": LM_SEQ, "dtype": cfg.dtype,
          "remat": cfg.remat, "attn_impl": cfg.attn_impl, "ranks": 1,
          "backend": "nccl", "steps": DP_STEPS, "launches": launches,
          "bitwise_each_step": bitwise,
          "losses": [h["loss"] for h in got["history"]],
          "step_ms_mesh": ms["mesh"], "step_ms_plain": ms["plain"],
          "step_ms_mesh_median_after_first": statistics.median(
              ms["mesh"][1:]),
          "step_ms_plain_median_after_first": statistics.median(
              ms["plain"][1:]),
          "allreduce_ms": reduce_ms, "allreduce_bytes": tm.nbytes[0],
          "allreduce_calls": len(reduce_ms), "init_distributed_s": init_s,
          "deterministic_algorithms": True,
          "deterministic_warnings": det.warnings,
          "seconds": time.perf_counter() - t0, "card": smi})
    return launches


def dp_gloo_probe(torch, dist):
    """gloo all-reduces of CUDA tensors, SUM and MAX, f32 and int32: the
    results (and their device) as a rank sees them."""
    r = dist.get_rank()
    out = {}
    for dtype in (torch.float32, torch.int32):
        for op in ("SUM", "MAX"):
            x = torch.arange(4, device="cuda", dtype=dtype) + 10 * r
            dist.all_reduce(x, op=getattr(dist.ReduceOp, op))
            out[f"{op}_{str(dtype)[6:]}"] = (x.cpu().tolist(), x.device.type)
    return out


def dp_gloo_rank(rank: int, work: str, seed: int) -> None:
    """(b)'s rank: gloo on ``cuda:0`` beside the other rank; writes what
    the parent checks to ``<work>/rank<r>.pt``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_data
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models.api import get_model
    from repro_torch.sharding import rules
    from repro_torch.train import grad_compress as GC
    from repro_torch.train import train_loop as loop
    from repro_torch.tree import tree_leaves, tree_map, unflatten_like

    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_CUT["ranks"]),
                      LOCAL_RANK="0")
    dev = init_distributed("cuda:0", backend="gloo",
                           init_method=f"file://{work}/store")
    torch.zeros(1, device=dev)
    mesh = make_host_mesh(dev)
    out = {"probe": dp_gloo_probe(torch, dist), "rank": rank,
           "coordinate": mesh.coordinate("data"), "device": str(dev)}
    cfg = get_config(LM_ARCH).replace(n_layers=DP_CUT["layers"],
                                      dtype="float32")
    api = get_model(cfg)
    tc = TrainConfig(optimizer="adamw", lr=LM_TRAIN_LR,
                     lr_min=LM_TRAIN_LR / 10, steps=LM_TRAIN_STEPS,
                     batch_size=DP_CUT["batch"])
    params = api.init(torch.Generator().manual_seed(seed), device=dev)
    batch = lm_data.synth_batch(SEED, 0, DP_CUT["batch"], DP_CUT["seq"],
                                cfg.vocab_size, device=dev)
    _, g = loop.value_and_grad(api.loss_fn, params, {
        k: rules.constrain_batch(v, mesh) for k, v in batch.items()})
    # the compressed psum of this rank's block gradients, on the card and
    # on the CPU, with the same bits (a CPU generator seeded by the rank)
    gen = torch.Generator().manual_seed(seed + 100 + rank)
    bits = unflatten_like(g, [torch.randint(0, 2 ** 32, x.shape,
                                            generator=gen)
                              for x in tree_leaves(g)])
    psum = GC.make_compressed_psum(("data",), mesh)
    errs = GC.init_error_state(g)
    t0 = time.perf_counter()
    red_c, err_c = psum(g, errs, tree_map(lambda b: b.to(dev), bits))
    torch.cuda.synchronize()
    psum_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    red_h, err_h = psum(tree_map(lambda x: x.cpu(), g),
                        tree_map(lambda x: x.cpu(), errs), bits)
    psum_cpu_s = time.perf_counter() - t0
    diff = []
    for name, a, b in (("reduced", red_c, red_h), ("error", err_c, err_h)):
        for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
            x = x.cpu()
            bad = (x.view(torch.int32) != y.view(torch.int32)).nonzero()
            for j in bad[:20].tolist():
                diff.append((name, i, tuple(j), float(x[tuple(j)]),
                             float(y[tuple(j)])))
            if len(bad) > 20:
                diff.append((name, i, "more", len(bad), None))
    del red_c, err_c, red_h, err_h, bits, errs
    out["psum"] = {"differ": diff, "card_s": psum_card_s,
                   "cpu_s": psum_cpu_s}
    out["grads"] = tree_map(lambda x: x.cpu(),
                            loop.group_mean(g, mesh))
    del g
    step, init_opt = loop.build_accumulating_step(api, tc, mesh)
    opt = init_opt(params)
    out["steps"] = []

    def steps(params, opt):
        for i in range(DP_CUT["steps"]):
            b = lm_data.synth_batch(SEED, i, DP_CUT["batch"], DP_CUT["seq"],
                                    cfg.vocab_size, device=dev)
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, b, i)
            torch.cuda.synchronize()
            out["steps"].append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": tree_map(lambda x: x.cpu(), params)})
    # the data-parallel steps are this phase's path: their launches
    _, out["launches"] = counted(torch, lambda: steps(params, opt))
    del params, opt, step
    torch.cuda.empty_cache()
    import numpy as np
    out["moe"] = dp_moe_rank(torch, np, mesh, dev, seed + 1, work)
    torch.save(out, f"{work}/rank{rank}.pt")
    dist.destroy_process_group()


def dp_gloo_reference(torch, api, cfg, seed: int):
    """(b)'s one-process run on the whole batch, the yardstick (its
    launches are not the path's): (per-step metrics and params on the
    host, the loss, the gradients on the host)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_data
    from repro_torch.train import train_loop as loop

    tc = TrainConfig(optimizer="adamw", lr=LM_TRAIN_LR,
                     lr_min=LM_TRAIN_LR / 10, steps=LM_TRAIN_STEPS,
                     batch_size=DP_CUT["batch"])
    params = api.init(torch.Generator().manual_seed(seed), device="cuda")
    batch = lm_data.synth_batch(SEED, 0, DP_CUT["batch"], DP_CUT["seq"],
                                cfg.vocab_size, device="cuda")
    (loss, _), grads = loop.value_and_grad(api.loss_fn, params, batch)
    grads = tree_cpu(grads)
    step, init_opt = loop.build_accumulating_step(api, tc)
    opt = init_opt(params)
    ref = []
    for i in range(DP_CUT["steps"]):
        b = lm_data.synth_batch(SEED, i, DP_CUT["batch"], DP_CUT["seq"],
                                cfg.vocab_size, device="cuda")
        params, opt, metrics = step(params, opt, b, i)
        ref.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "params": tree_cpu(params)})
    return ref, float(loss), grads


def dp_moe_config():
    from repro_torch.configs import get_config
    return get_config(MOE_ARCH).replace(n_layers=MA_CUT["layers"])


def dp_moe_inputs(torch, np, cfg, device):
    """Token ids [B, T + MA_DECODE], drawn alike in each process, and the
    training batch of the first T + 1 (labels the next token)."""
    t = MA_CUT["moe_seq"]
    ids = torch.from_numpy(lm_tokens(np, cfg.vocab_size, MA_CUT["moe_batch"],
                                     t + MA_DECODE, SEED + 56)).to(device)
    return ids, {"tokens": ids[:, :t], "labels": ids[:, 1:t + 1]}


def dp_moe_run(torch, api, params, ids, batch, mesh=None, flash=True):
    """The case's calls, in order, on this process's block of the batch
    (``mesh``'s data block; the whole batch without one): the forward on
    the flash route (``flash``; else xla), the loss and its gradient on
    the xla route, then a prefill of the first T ids and MA_DECODE decode
    steps through the serve steps.  Returns (logits, aux, loss, grads,
    the serve steps' logits)."""
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models.api import get_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train import train_loop as loop

    fwd = get_model(api.cfg.replace(attn_impl="flash")) if flash else api
    t = MA_CUT["moe_seq"]
    rows = ids.shape[0] // (1 if mesh is None else mesh.shape["data"])
    block = batch if mesh is None else {
        k: rules.constrain_batch(v, mesh) for k, v in batch.items()}
    with use_mesh(mesh):
        with torch.no_grad():
            logits, aux = fwd.forward(params, block["tokens"])
        (loss, _), grads = loop.value_and_grad(api.loss_fn, params, block)
        cache = api.init_cache(rows, t + MA_DECODE, device=ids.device)
        with torch.no_grad():
            seq, _ = ma_decode(api, params, ids, cache,
                               build_prefill_step(api),
                               build_decode_step(api), t)
    return logits, aux, loss, grads, seq


def held_grads(grads):
    """The gradient leaves the case holds: every layer's and the final
    norm's (the two vocab tables, 1.3 GB in bf16, are left out)."""
    return {k: v for k, v in grads.items() if k not in ("embed", "unembed")}


def cross_block_drops(np, top_e, e: int, c: int, blocks: int) -> int:
    """Entries a block keeps when routed on its own at capacity ``c`` but
    drops after the blocks before it (host arithmetic on the routing)."""
    flat = top_e.reshape(blocks, -1).cpu().numpy()
    off = np.zeros(e, np.int64)
    out = 0
    for r in range(blocks):
        cnt = np.bincount(flat[r], minlength=e)
        out += int((np.minimum(cnt, c) - np.clip(c - off, 0, cnt)).sum())
        off += cnt
    return out


def dp_moe_reference(torch, np, work: str, seed: int):
    """(b)'s MoE case on one process on the card, the whole batch: its
    calls' routing (replayed by the ranks), gaps, results and held
    gradients saved to ``<work>/moe_ref.pt``.  Returns each call's drops
    by block and the entries a later block drops for an earlier one."""
    from repro_torch.models import moe as M
    from repro_torch.models.api import get_model

    cfg = dp_moe_config()
    api = get_model(cfg)
    params = ma_params(torch, api, seed)
    ids, batch = dp_moe_inputs(torch, np, cfg, "cuda")
    t0 = time.perf_counter()
    (logits, aux, loss, grads, seq), rec = route_tap(
        lambda: dp_moe_run(torch, api, params, ids, batch))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k, blocks = cfg.experts_per_token, DP_CUT["ranks"]
    drops, cross = [], []
    for top_e, (order, keep) in zip(rec["top_e"], rec["entries"]):
        n = top_e.shape[0]
        block = (order // k) // (n // blocks)
        drops.append([int(((~keep) & (block == r)).sum())
                      for r in range(blocks)])
        cross.append(cross_block_drops(np, top_e, cfg.n_experts,
                                       M.capacity(cfg, n), blocks))
    torch.save({"routing": rec["top_e"], "gap": rec["gap"],
                "logits": logits, "aux": aux, "loss": loss,
                "grads": held_grads(grads), "serve": seq},
               f"{work}/moe_ref.pt")
    del params, grads
    torch.cuda.empty_cache()
    return {"drops": drops, "cross_block_drops": cross,
            "calls": len(rec["top_e"]), "seconds": seconds,
            "loss": float(loss), "aux": float(aux)}


def dp_moe_rank(torch, np, mesh, dev, seed: int, work: str):
    """(b)'s MoE case on this gloo rank: its own routing against the
    reference's (flips, no replay), then the counted run with the
    reference's routing replayed (its launches, collectives and drops),
    held to the one process's results; the ranks' mean loss and
    gradients through the data group."""
    from repro_torch.models.api import get_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train import train_loop as loop

    cfg = dp_moe_config()
    api = get_model(cfg)
    ref = torch.load(f"{work}/moe_ref.pt", map_location=dev)
    params = ma_params(torch, api, seed, dev)
    ids, batch = dp_moe_inputs(torch, np, cfg, dev)
    r, n = mesh.coordinate("data"), mesh.shape["data"]

    def mine(t):
        return t.narrow(0, r * (t.shape[0] // n), t.shape[0] // n)
    out = {}
    flash = get_model(cfg.replace(attn_impl="flash"))
    with torch.no_grad(), use_mesh(mesh):
        _, own = route_tap(lambda: flash.forward(
            params, rules.constrain_batch(batch["tokens"], mesh)))
    out["routing_agreement"] = routing_agreement(
        torch, {"top_e": [mine(t) for t in ref["routing"][:cfg.n_layers]],
                "gap": [mine(g) for g in ref["gap"][:cfg.n_layers]]}, own)
    with TimedCollectives(torch) as tc:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ((logits, aux, loss, grads, seq), rec), launches = counted(
            torch, lambda: route_tap(
                lambda: dp_moe_run(torch, api, params, ids, batch, mesh),
                replay=[mine(t) for t in ref["routing"]]))
        torch.cuda.synchronize()
        out["run_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = launches
    out["collectives"] = tc.record()
    out["collective_log"] = list(tc.log)
    out["dropped"] = [int(d) for d in rec["dropped"]]
    out["logits_err"] = rel_err(logits, mine(ref["logits"]))
    out["serve_err"] = [rel_err(a, mine(b)) for a, b in zip(seq,
                                                            ref["serve"])]
    out["aux"] = (float(aux), float(ref["aux"]))
    from repro_torch.tree import tree_map
    mean = loop.group_mean({"loss": loss.float(), "grads": tree_map(
        lambda g: g.float(), held_grads(grads))}, mesh)
    out["loss"] = (float(mean["loss"]), float(ref["loss"]))
    out["grads"] = grad_stats(mean["grads"], ref["grads"])
    del params, grads, mean, ref
    torch.cuda.empty_cache()
    return out


def dp_moe_counted(torch):
    """What rank 0 of the two data ranks sends in (b)'s MoE case, counted
    as the dry-run counts: its calls on fake tensors on the counting mesh
    (the xla route: flash refuses fake tensors; attention moves nothing
    over ``data``).  Returns (its log of ``Collective``s, seconds)."""
    from repro_torch.launch.mesh import Mesh, counting_mesh
    from repro_torch.launch.steps import fake_mode
    from repro_torch.models.api import get_model
    from repro_torch.sharding import collectives as C

    t0 = time.perf_counter()
    mesh = counting_mesh(Mesh(("data",), (DP_CUT["ranks"],)))
    cfg = dp_moe_config()
    b, t = MA_CUT["moe_batch"], MA_CUT["moe_seq"]
    with fake_mode():
        api = get_model(cfg)
        params = api.init(torch.Generator(), device="meta")
        ids = torch.empty((b, t + MA_DECODE), dtype=torch.int64,
                          device="meta")
        batch = {"tokens": ids[:, :t], "labels": ids[:, 1:t + 1]}
        with C.record() as log:
            dp_moe_run(torch, api, params, ids, batch, mesh, flash=False)
    return log, time.perf_counter() - t0


def run_ranks(torch, target, n: int, work: str, seed: int, what: str,
              during=None, timeout: float = 600):
    """Start ``n`` spawned ranks ``target(r, work, seed)``, call
    ``during()`` meanwhile, join them (killing any still alive after
    ``timeout`` s), check their exit codes and load each
    ``<work>/rank<r>.pt``: (the ranks' records, ``during()``'s
    result)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, work, seed))
             for r in range(n)]
    try:
        for pr in procs:
            pr.start()
        got = during() if during is not None else None
        for pr in procs:
            pr.join(timeout=timeout)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    check(all(pr.exitcode == 0 for pr in procs),
          f"{what}: rank exit codes {[pr.exitcode for pr in procs]}")
    return [torch.load(f"{work}/rank{r}.pt", weights_only=False)
            for r in range(n)], got


def dp_gloo_phase(torch, smi):
    """(b) Two gloo ranks sharing ``cuda:0`` (NCCL refuses two ranks on
    one device): tinyllama-1.1b at full width cut to DP_CUT["layers"]
    layers, f32, global batch DP_CUT["batch"] x DP_CUT["seq"].  The
    ranks' averaged gradients and each step's loss are held against one
    process's on the whole batch (rtol DP_RTOL, and DP_LEAF_ATOL of each
    gradient leaf's max|g|), the ranks' params are bitwise equal after
    each of DP_CUT["steps"] steps (their distance from the one-process
    params is printed), and the compressed psum of the rank gradients on
    the card is bitwise the same function on the CPU with the same bits.
    Each rank counts the launches of its steps, which are the phase's.
    First each rank checks that gloo all-reduces CUDA tensors (SUM and
    MAX, f32 and int32) in place on the card.  Then the global MoE
    route's case (DP_MOE_* above, :func:`dp_moe_check`): the one process
    runs first, the ranks replay its routing, and the count runs while
    the ranks do."""
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model
    from repro_torch.tree import leaves_with_paths

    seed = SEED + 41
    cfg = get_config(LM_ARCH).replace(n_layers=DP_CUT["layers"],
                                      dtype="float32")
    api = get_model(cfg)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        # the MoE case's one process first: the ranks replay its routing
        moe_ref = dp_moe_reference(torch, np, work, seed + 1)
        t_moe_ref = time.perf_counter() - t0

        def during():
            # the one-process run on the whole batch, and the MoE case's
            # count on the counting mesh, meanwhile
            return dp_gloo_reference(torch, api, cfg, seed), \
                dp_moe_counted(torch)
        ranks, ((ref, loss, grads), (moe_log, moe_count_s)) = run_ranks(
            torch, dp_gloo_rank, DP_CUT["ranks"], work, seed,
            "dp_train gloo", during=during)
    phase_s = time.perf_counter() - t0
    n = DP_CUT["ranks"]
    launches = {k: 0 for k in counters()}
    for r, out in enumerate(ranks):
        expect_launches(f"dp_train gloo rank {r}", out["launches"], {})
        add_launches(launches, out["launches"])
        check(out["coordinate"] == r, f"dp_train gloo: rank {r} at "
                                      f"{out['coordinate']}")
        want_sum = [sum(10 * q + i for q in range(n)) for i in range(4)]
        want_max = [10 * (n - 1) + i for i in range(4)]
        for key, (vals, where) in out["probe"].items():
            want = want_sum if key.startswith("SUM") else want_max
            check(where == "cuda" and [int(v) for v in vals] == want,
                  f"dp_train gloo: all_reduce {key} of CUDA tensors gave "
                  f"{vals} on {where}, expected {want} on cuda")

    def worst(got, want):
        return excess_frac(torch, got, want, DP_RTOL)

    rec = {"ranks_params_bitwise_each_step": [], "grads_worst": [],
           "params_worst": []}
    for out in ranks:
        f, at = worst(out["grads"], grads)
        rec["grads_worst"].append({"atol_frac_of_max": f, "at": at})
        check(f <= DP_LEAF_ATOL, f"dp_train gloo: rank {out['rank']}'s "
                                 f"gradient {at} off by {f} of its max|g|")
        check(not out["psum"]["differ"],
              f"dp_train gloo: the compressed psum on the card differs from "
              f"the CPU's: {out['psum']['differ'][:10]}")
    for i in range(DP_CUT["steps"]):
        a = dict(leaves_with_paths(ranks[0]["steps"][i]["params"]))
        same = all(torch.equal(a[p], x) for out in ranks[1:]
                   for p, x in leaves_with_paths(out["steps"][i]["params"]))
        rec["ranks_params_bitwise_each_step"].append(same)
        check(same, f"dp_train gloo: ranks' params differ after step {i}")
        f, at = worst(ranks[0]["steps"][i]["params"], ref[i]["params"])
        rec["params_worst"].append({"atol_frac_of_max": f, "at": at})
        lw, lg = ref[i]["metrics"]["loss"], ranks[0]["steps"][i]["metrics"][
            "loss"]
        check(abs(lg - lw) <= DP_RTOL * abs(lw),
              f"dp_train gloo: step {i} loss {lg} against {lw}")
    emit({"phase": "dp_train_gloo", "arch": cfg.name,
          "layers": DP_CUT["layers"], "cut": "n_layers 22 -> 2",
          "batch": DP_CUT["batch"], "seq": DP_CUT["seq"],
          "dtype": cfg.dtype, "ranks": n, "backend": "gloo",
          "device": ranks[0]["device"],
          "gloo_cuda_allreduce": ranks[0]["probe"],
          "loss_one_process": float(loss), **rec,
          "step_ms_ranks": [[s["ms"] for s in out["steps"]]
                            for out in ranks],
          "step_metrics": [s["metrics"] for s in ranks[0]["steps"]],
          "one_process_metrics": [s["metrics"] for s in ref],
          "launches_by_rank": [out["launches"] for out in ranks],
          "psum_bitwise_card_cpu": True,
          "psum_card_s": [out["psum"]["card_s"] for out in ranks],
          "psum_cpu_s": [out["psum"]["cpu_s"] for out in ranks],
          "tolerance": f"rtol {DP_RTOL}, atol {DP_LEAF_ATOL} of each "
                       f"leaf's max", "seconds": phase_s, "card": smi})
    add_launches(launches, dp_moe_check(ranks, moe_ref, moe_log,
                                        moe_count_s, t_moe_ref, phase_s,
                                        smi))
    return launches


def dp_moe_check(ranks, moe_ref, moe_log, count_s: float, ref_s: float,
                 phase_s: float, smi):
    """(b)'s MoE case, checked and printed: each rank held to the one
    process (DP_MOE_* above), its collectives to the count, flash
    launched once a layer by each rank's forward.  Returns the ranks'
    launches."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    n_ranks, layers = DP_CUT["ranks"], MA_CUT["layers"]
    launches = {k: 0 for k in counters()}
    counted = [(c.op, c.bytes, c.dtype, c.group_size) for c in moe_log]
    gather_bytes = n_ranks * cfg.n_experts * 8
    lines = []
    for r, out in enumerate(ranks):
        m = out["moe"]
        where = f"dp_train moe_global rank {r}"
        add_launches(launches, m["launches"])
        expect_launches(where, m["launches"], {"flash_attention": layers})
        check_first_layer_flips(where, m["routing_agreement"])
        err, scale = m["logits_err"]
        check(err <= MA_MOE_TOL * scale, f"{where}: logits off by {err} of "
                                         f"max {scale}")
        for i, (err, scale) in enumerate(m["serve_err"]):
            check(err <= MA_MOE_TOL * scale, f"{where}: serve step {i} "
                                             f"logits off by {err} of {scale}")
        got, want = m["aux"]
        check(abs(got - want) <= DP_MOE_AUX_RTOL * abs(want),
              f"{where}: aux {got} against one process's {want}")
        got, want = m["loss"]
        check(abs(got - want) <= DP_MOE_LOSS_RTOL * abs(want),
              f"{where}: loss {got} against one process's {want}")
        g = m["grads"]
        check(g["grad_leaf_worst_frac_of_max"] <= LM_GRAD_TOL,
              f"{where}: gradient {g['grad_leaf_worst_at']} off by "
              f"{g['grad_leaf_worst_frac_of_max']} of its max|g|")
        want = [d[r] for d in moe_ref["drops"]]
        check(m["dropped"] == want, f"{where}: dropped {m['dropped']}, the "
                                    f"one process's for its block {want}")
        sent = [(c.op, c.bytes, c.dtype, c.group_size)
                for c in m["collective_log"]]
        check(sent == counted, f"{where}: its collectives differ from the "
                               f"count: {sent[:8]} against {counted[:8]}")
        gathers = [c for c in m["collective_log"] if c.dtype == "int64"]
        check(len(gathers) == moe_ref["calls"] and all(
            c.op == "all-gather" and c.bytes == gather_bytes
            for c in gathers), f"{where}: the offsets' gathers {gathers}")
        lines.append({
            "rank": r, "launches": m["launches"], "run_ms": m["run_ms"],
            "logits_err_of_max": m["logits_err"][0] / m["logits_err"][1],
            "serve_err_of_max": [e / s for e, s in m["serve_err"]],
            "aux": m["aux"], "loss": m["loss"], "grads": g,
            "dropped": m["dropped"],
            "routing_agreement_own": m["routing_agreement"],
            "offsets_gather": {
                "calls": len(gathers), "bytes_each": gather_bytes,
                "bytes_sent": sum(c.bytes for c in gathers),
                "ms": sum(c.seconds for c in gathers) * 1e3},
            "collectives": m["collectives"]})
    emit({"phase": "dp_train_moe_global", "arch": MOE_ARCH,
          "layers": layers, "cut": f"n_layers {cfg.n_layers} -> {layers}",
          "batch": MA_CUT["moe_batch"], "seq": MA_CUT["moe_seq"],
          "decode_steps": MA_DECODE, "dtype": cfg.dtype,
          "profile": cfg.sharding_profile,
          "capacity_factor": cfg.capacity_factor, "ranks": n_ranks,
          "backend": "gloo", "route_calls": moe_ref["calls"],
          "drops_by_block_one_process": moe_ref["drops"],
          "cross_block_drops": moe_ref["cross_block_drops"],
          "one_process": {"loss": moe_ref["loss"], "aux": moe_ref["aux"],
                          "ms": moe_ref["seconds"] * 1e3},
          "offsets_gather_counted_bytes": sum(
              b for op, b, dt, _ in counted if dt == "int64"),
          "count_seconds": count_s, "reference_seconds": ref_s,
          "ranks_detail": lines,
          "tolerance": f"logits and serve logits {MA_MOE_TOL} of max|logit| "
                       f"(routing replayed), aux rtol {DP_MOE_AUX_RTOL}, "
                       f"loss rtol {DP_MOE_LOSS_RTOL}, gradients "
                       f"{LM_GRAD_TOL} of each leaf's max|g|, drops exact",
          "phase_seconds": phase_s, "card": smi})
    return launches


def run_session(cmd, env, timeout: float):
    """(exit code, stdout, stderr) of ``cmd`` run in a session of its
    own; on a timeout the whole session (``torchrun`` and its workers) is
    killed and the timeout raised."""
    import signal
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, out, err


def dp_launch_rank(counts_path: str, argv) -> int:
    """(c)'s rank under ``torch.distributed.run``: the launcher's own
    entry, ``repro_torch.launch.train.main(argv)``, as ``-m
    repro_torch.launch.train`` runs it, with every launch count set to 0
    just before it; rank 0 writes the counts to ``counts_path``."""
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch.launch import train
    _, launches = counted(torch, lambda: train.main(argv))
    if os.environ.get("RANK", "0") == "0":
        pathlib.Path(counts_path).write_text(json.dumps(launches))
    return 0


def dp_launch_phase(torch, smi):
    """(c) ``launch.train`` under ``python -m torch.distributed.run
    --standalone --nproc-per-node 1`` on the card at the smoke config
    (its rank runs ``launch.train.main`` through :func:`dp_launch_rank`,
    which counts its launches): 3 steps with a checkpoint a step, then
    the same command after a crash that lost step 3's checkpoints
    resumes from step 2 and writes step 3 bitwise the uninterrupted
    run's."""
    import shutil
    import tempfile

    import numpy as np

    t0 = time.perf_counter()
    launches = {k: 0 for k in counters()}
    with tempfile.TemporaryDirectory() as d:
        ckpt = pathlib.Path(d) / "ckpt"
        counts = pathlib.Path(d) / "launches.json"
        argv = ["--arch", LM_ARCH, "--smoke", "--steps", "3", "--batch", "4",
                "--seq", "64", "--ckpt-dir", str(ckpt)]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", str(ROOT / "chip_smoke.py"),
               "--dp-launch-rank", str(counts), *argv]
        env = dict(os.environ, PYTHONPATH=str(SRC))
        runs = []
        for what in ("straight", "resumed"):
            t1 = time.perf_counter()
            counts.unlink(missing_ok=True)
            rc, stdout, stderr = run_session(cmd, env, timeout=300)
            check(rc == 0, f"dp_train launch ({what}): exit {rc}\n"
                           f"{stdout[-2000:]}\n{stderr[-2000:]}")
            done = [ln for ln in stdout.splitlines()
                    if ln.startswith("done:")]
            check(len(done) == 1, f"dp_train launch ({what}): {done}")
            got = json.loads(counts.read_text())
            expect_launches(f"dp_train launch ({what})", got, {})
            add_launches(launches, got)
            runs.append({"run": what, "done": done[0], "launches": got,
                         "seconds": time.perf_counter() - t1})
            if what == "straight":
                shutil.copytree(ckpt / "step_00000003",
                                pathlib.Path(d) / "kept")
                for sub in (ckpt, ckpt / "opt"):
                    shutil.rmtree(sub / "step_00000003")
        check("(step 2)" in runs[1]["done"] and "(step 0)" not in
              runs[1]["done"], f"dp_train launch: resumed {runs[1]}")
        with np.load(pathlib.Path(d) / "kept" / "shards_host0.npz") as a, \
                np.load(ckpt / "step_00000003" / "shards_host0.npz") as b:
            same = sorted(a.files) == sorted(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files)
    check(same, "dp_train launch: the resumed step 3 differs from the "
                "uninterrupted one")
    emit({"phase": "dp_train_launch", "entry": "repro_torch.launch.train."
          "main under torch.distributed.run", "argv": " ".join(argv),
          "runs": runs, "resumed_bitwise": same,
          "seconds": time.perf_counter() - t0, "card": smi})
    return launches


def dp_train_phases(torch, np, smi):
    """Data-parallel training over a process group (no hand kernel on the
    training path: the xla route, since flash refuses a gradient): (a)
    one NCCL rank at full size, (b) two gloo ranks sharing the card (and
    on them moonshot's global MoE route, whose flash forward launches
    the kernel), (c)
    ``launch.train`` under ``torch.distributed.run``.  Returns the
    launches on the paths they drive."""
    t0 = time.perf_counter()
    total = {k: 0 for k in counters()}
    add_launches(total, dp_nccl_phase(torch, smi))
    add_launches(total, dp_gloo_phase(torch, smi))
    add_launches(total, dp_launch_phase(torch, smi))
    torch.cuda.empty_cache()
    emit({"phase": "dp_train_total", "seconds": time.perf_counter() - t0,
          "card": smi})
    return total


# ------------------------------------- a model axis over processes --

# Two gloo ranks sharing cuda:0 as (data=1, model=2) (NCCL refuses two
# ranks on one device): each holds its blocks of the params, the AdamW
# state and the KV cache.  Full width, cut to 2 layers (the phase line
# names the cut); (a) tinyllama f32, B4 x T512, one default and one fsdp
# AdamW step; (b) tinyllama bf16, the flash forward B4 x T512, then
# prefill and MA_DECODE decode steps; (c) moonshot bf16 under moe_local,
# B2 x T256; (d) (b)'s model served under cache_seq: a prompt of
# MA_SERVE["prompt"] into a cache of MA_SERVE["max_len"] slots (a block
# of 512 a rank), MA_DECODE decodes that cross slot 512; (e) the same
# under infer2d; (f) (c)'s model under infer2d (its rows split over
# model, each rank gathering its data block's rows for moe_local); (g)
# (a)'s model under seq_parallel (a remat step, the residual stream a
# rank's half of T), then (b)'s flash forward, prefill and decodes under
# seq_parallel; (h) (c)'s model under moe_local_sp (xla_chunked
# attention); (i) xLSTM (FAMILY_DEPTH's 8 layers), Hymba and Whisper (2
# layers) at full width, f32, trained tensor-parallel under default at
# MA_FAMILY_CUT; (j) the same three served at full width on the flash
# route under default and cache_seq (MA_FAMILY_SERVE).
MA_AXES = (("data", 1), ("model", 2))
MA_CUT = dict(layers=2, batch=4, seq=512, moe_batch=2, moe_seq=256)
MA_DECODE = 8
MA_SERVE = dict(prompt=508, max_len=1024)
# (a): f32 sums over two ranks' blocks against one process's, as the CPU
# test holds them (tests/test_torch_model_axis.py)
MA_GRAD_RTOL, MA_GRAD_ATOL = 1e-5, 1e-5
# (b): bf16 logits over the model axis against one process on the card,
# whose forward takes the plain attention route: the row blocks' partial
# products round to bf16 before their f32 sum, and flash sums in another
# order than the plain softmax (1.05e-2 of max|logit| at 22 layers in
# PERF.md's flash row)
MA_LOGIT_TOL = 2e-2
# (c): moe_local adds y * w in f32 and casts once, the global route in
# bf16 slot by slot; with the reference's routing replayed the logits
# differ by those roundings and the attention's partial sums
MA_MOE_TOL = 2e-2
# (i): the families' training step at full width
MA_FAMILY_CUT = dict(batch=2, seq=256)
# (i): xLSTM's f32 gradient moves by about 3e-5 of max|g| when its
# params move by one ulp (``ulp_floor`` at MA_FAMILY_CUT on one process,
# 2.97e-5 on an H100), past MA_GRAD_ATOL: a split that sums in another
# order cannot hold it there.  Its gradients are held to MA_XLSTM_FLOORS
# times the largest floor of MA_FLOOR_DRAWS seeded nudges measured in
# the same run on one process; Hymba's and Whisper's to MA_GRAD_ATOL.
MA_XLSTM_FLOORS = 2.0
MA_FLOOR_DRAWS = 3
# (j): B2, a prompt into a cache of max_len slots, then MA_DECODE decodes,
# under each of MA_FAMILY_PROFILES.  xLSTM at FAMILY_DEPTH's 8 layers (no
# attention: its state the cache); Hymba at 2 layers, as (i), its prompt
# of 1020 into its 1024-slot window (512 slots a rank under cache_seq),
# the decodes wrapping from slot 1023, rank 1's block, to slot 0, rank
# 0's; Whisper whole (4 encoder and 4 decoder layers) on its 1500
# encoder frames (750 a rank under cache_seq), its prompt crossing the
# self cache's block boundary at 224 of WHISPER_CTX's 448 slots.  bf16
# on the flash route (flash runs in Whisper's encoder; a prefill or
# decode with a cache attends on the plain path, as JAX's), xLSTM in the
# dtype its cuts are held in (FAMILY_HELD_DTYPE: a random-weight xLSTM
# amplifies one bf16 rounding by orders of magnitude).
# (j): xLSTM's f32 logits and cache against one process's f32 run:
# 1.510e-5-1.899e-5 of max|x| on an H100 (the split sums in another
# order), where a bf16 case's roundings take MA_LOGIT_TOL
MA_F32_SERVE_TOL = 1e-4
MA_FAMILY_SERVE = {"xlstm-1.3b": dict(prompt=256, max_len=512),
                   "hymba-1.5b": dict(prompt=1020, max_len=1024),
                   "whisper-tiny": dict(prompt=220, max_len=WHISPER_CTX)}
MA_FAMILY_SERVE_BATCH = 2
MA_FAMILY_PROFILES = ("default", "cache_seq")


def ma_serve_tol(cfg):
    """(j)'s limit, a fraction of max|x|, for a family's serve case: by
    the dtype its cuts are held in (FAMILY_HELD_DTYPE)."""
    held = FAMILY_HELD_DTYPE.get(cfg.family, cfg.dtype)
    return MA_F32_SERVE_TOL if held == "float32" else MA_LOGIT_TOL


class TimedCollectives:
    """``sharding.collectives.record``'s log of the collectives issued
    inside the block, the card synchronized around each call (gloo
    stages CUDA tensors through the host): :meth:`record` gives each
    kind's calls, host ms and bytes (JAX's convention: an all-reduce's
    or all-to-all's operand, an all-gather's result); ``log`` holds the
    ``Collective``s, which :func:`ma_counted`'s counting runs are held
    to."""

    def __init__(self, torch):
        from repro_torch.sharding import collectives as C
        self._ctx = C.record(sync=torch.cuda.synchronize)
        self.log = []

    def __enter__(self):
        self.log = self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)

    def record(self):
        return by_kind(self.log)


def by_kind(log):
    """A collective log's calls, host ms and bytes by op."""
    out = {"ms": {}, "calls": {}, "bytes": {}}
    for c in log:
        out["ms"][c.op] = out["ms"].get(c.op, 0.0) + c.seconds * 1e3
        out["calls"][c.op] = out["calls"].get(c.op, 0) + 1
        out["bytes"][c.op] = out["bytes"].get(c.op, 0) + c.bytes
    return out


def excess_frac(torch, got, want, rtol: float):
    """The worst leaf of ``got`` against ``want`` (trees on any device):
    its largest excess over ``rtol * |want|`` as a fraction of the leaf's
    max|want|, and where it is."""
    from repro_torch.tree import leaves_with_paths
    w = dict(leaves_with_paths(want))
    frac, at = 0.0, None
    for path, x in leaves_with_paths(got):
        y = w[path].float().to(x.device)
        scale = float(y.abs().max())
        excess = float(((x.float() - y).abs() - rtol * y.abs()).max())
        f = excess / scale if scale else (math.inf if excess > 0 else 0.0)
        if f > frac or at is None:
            frac, at = f, "/".join(map(str, path))
    return frac, at


def adam_step_excess(torch, got, want, g_got, g_want, norms, lr: float,
                     wd: float, rtol: float):
    """Params after one AdamW step (``got``, whole) against the
    one-process step's (``want``), as ``tests/test_torch_model_axis.py``
    holds them: each element may differ by ``rtol * |want|``, plus what
    the two gradients change in the step, ``lr * |d_got - d_want|``
    (``d = g / (|g| + 1e-8)`` the first step's direction of the gradient
    ``g`` clipped by its norm in ``norms``), plus ``1e-6 * lr``.  The
    worst leaf's largest excess over that allowance as a fraction of its
    max|want| (<= 0 where every element is within it), and where it is."""
    from repro_torch.tree import leaves_with_paths
    w, gg, gw = (dict(leaves_with_paths(t)) for t in (want, g_got, g_want))
    clip = [min(1.0, 1.0 / (n + 1e-9)) for n in norms]

    def direction(g, c):
        g = g.double() * c
        return g / (g.abs() + 1e-8)
    frac, at = -math.inf, None
    for path, x in leaves_with_paths(got):
        y = w[path].double().to(x.device)
        allowed = rtol * y.abs() + lr * (
            direction(gg[path].to(x.device), clip[0]) -
            direction(gw[path].to(x.device), clip[1])).abs() + 1e-6 * lr
        excess = float(((x.double() - y).abs() - allowed).max())
        f = excess / max(float(y.abs().max()), 1e-30)
        if f > frac:
            frac, at = f, "/".join(map(str, path))
    return frac, at


def nbytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def ma_configs():
    """(a)'s, (b)'s and (c)'s configs at full width and MA_CUT's depth,
    (g)'s and (h)'s (theirs under seq_parallel), and (i)'s
    (:func:`family_cut` of each family, f32)."""
    from repro_torch.configs import get_config
    dense = get_config(LM_ARCH).replace(n_layers=MA_CUT["layers"])
    moe = get_config(MOE_ARCH).replace(n_layers=MA_CUT["layers"])
    out = {"a": dense.replace(dtype="float32"),
           "b": dense.replace(attn_impl="flash"),
           "c": moe.replace(capacity_factor=moe.n_experts /
                            moe.experts_per_token,
                            sharding_profile="moe_local")}
    out["g"] = out["a"].replace(seq_parallel=True, remat=True)
    out["g_flash"] = out["b"].replace(seq_parallel=True)
    out["h"] = out["c"].replace(seq_parallel=True, attn_impl="xla_chunked")
    for arch in FAMILY_ARCHS:
        out["i_" + arch] = family_cut(get_config(arch)).replace(
            dtype="float32")
        cfg = family_config(arch)
        if cfg.family == "hybrid":
            cfg = cfg.replace(n_layers=2)
        out["j_" + arch] = cfg.replace(
            attn_impl="flash",
            dtype=FAMILY_HELD_DTYPE.get(cfg.family, cfg.dtype))
    return out


def ma_serve_inputs(torch, np, cfg, device):
    """(j)'s prompt and decode tokens [B, prompt + MA_DECODE] and, for
    Whisper, its stub frames [B, enc_seq, d] (else None), drawn alike in
    each process."""
    b, n = MA_FAMILY_SERVE_BATCH, MA_FAMILY_SERVE[cfg.name]["prompt"]
    ids = torch.from_numpy(lm_tokens(np, cfg.vocab_size, b, n + MA_DECODE,
                                     SEED + 54)).to(device)
    if cfg.family != "audio":
        return ids, None
    return ids, torch.from_numpy(np.random.default_rng(
        SEED + 55).standard_normal((b, cfg.enc_seq, cfg.d_model))
        .astype(np.float32)).to(device)


def ckpt_inputs(fn):
    """Run ``fn`` with ``transformer.checkpointed`` wrapped: (its result,
    the bytes of each checkpointed layer's input, the tensor that layer
    keeps for its recompute)."""
    from repro_torch.models import transformer as T
    real, seen = T.checkpointed, []

    def spy(layer, x, *rest):
        seen.append(x.numel() * x.element_size())
        return real(layer, x, *rest)
    T.checkpointed = spy
    try:
        return fn(), seen
    finally:
        T.checkpointed = real


def ma_inputs(torch, np, cfgs, device):
    """Every part's inputs, drawn alike in each process."""
    from repro_torch.data import lm_data
    b, t = MA_CUT["batch"], MA_CUT["seq"]
    mb, mt = MA_CUT["moe_batch"], MA_CUT["moe_seq"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    return {"batch": lm_data.synth_batch(SEED, 0, b, t,
                                         cfgs["a"].vocab_size, device=device),
            "ids": torch.from_numpy(lm_tokens(
                np, cfgs["b"].vocab_size, b, t + MA_DECODE,
                SEED + 50)).to(device),
            "moe_ids": torch.from_numpy(lm_tokens(
                np, cfgs["c"].vocab_size, mb, mt, SEED + 51)).to(device),
            "moe_x": torch.randn(mb, mt, cfgs["c"].d_model, device="cuda",
                                 generator=gen).to(torch.bfloat16)}


def ma_params(torch, api, seed: int, device="cuda"):
    return api.init(torch.Generator(device="cuda").manual_seed(seed),
                    device=device)


def ma_train_config():
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(optimizer="adamw", lr=LM_TRAIN_LR,
                       lr_min=LM_TRAIN_LR / 10, steps=LM_TRAIN_STEPS,
                       batch_size=MA_CUT["batch"])


def ma_decode(api, params, ids, cache, prefill, decode, t=MA_CUT["seq"],
              frames=None):
    """Prefill on the first ``t`` ids (and Whisper's ``frames``), then
    MA_DECODE steps fed the ids after them: (each step's logits, the
    cache)."""
    first = {"tokens": ids[:, :t]}
    if frames is not None:
        first["frames"] = frames
    logits, cache = prefill(params, first, cache)
    out = [logits]
    for i in range(MA_DECODE):
        logits, cache = decode(params, {"token": ids[:, t + i],
                                        "pos": t + i}, cache)
        out.append(logits)
    return out, cache


def model_axis_reference(torch, np, work: str, seed: int):
    """One process on the card, no mesh: (a)'s gradients, params and
    grad norm after the first step, and step ms; (b)'s forward (on the
    plain attention route) and decode logits, (c)'s MoE layer, forward and routing
    (the routing replayed by the ranks), and (c)'s drops at the config's
    capacity factor.  Saved to ``<work>/ref_<part>.pt``."""
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import moe as M
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import layer_params
    from repro_torch.train import train_loop as loop

    cfgs = ma_configs()
    inp = ma_inputs(torch, np, cfgs, "cuda")
    out = {}
    api = get_model(cfgs["a"])
    params = ma_params(torch, api, seed)
    _, grads = loop.value_and_grad(api.loss_fn, params, inp["batch"])
    step, init_opt = loop.build_accumulating_step(api, ma_train_config())
    opt = init_opt(params)
    ms = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p1, o1, m1 = step(params, opt, inp["batch"], i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = {"p1": p1, "grad_norm": float(m1["grad_norm"])}
        del p1, o1
    torch.save({"grads": grads, **first}, f"{work}/ref_a.pt")
    out["a_step_ms"] = ms
    del params, grads, opt, first

    # the plain attention route: each rank's flash forward is held
    # against it (prefill and decode take the plain route on both sides)
    api = get_model(cfgs["b"].replace(attn_impl="xla"))
    params = ma_params(torch, api, seed + 1)
    with torch.no_grad():
        logits, _ = api.forward(params, inp["ids"][:, :MA_CUT["seq"]])
        cache = api.init_cache(MA_CUT["batch"], MA_CUT["seq"] + MA_DECODE)
        seq, _ = ma_decode(api, params, inp["ids"], cache,
                           build_prefill_step(api), build_decode_step(api))
        # (d) and (e): the prompt into the long cache
        cache = api.init_cache(MA_CUT["batch"], MA_SERVE["max_len"])
        served, cache = ma_decode(api, params, inp["ids"], cache,
                                  build_prefill_step(api),
                                  build_decode_step(api),
                                  MA_SERVE["prompt"])
    torch.save({"logits": logits, "decode": seq}, f"{work}/ref_b.pt")
    torch.save({"decode": served, "cache": cache}, f"{work}/ref_d.pt")
    del params, logits, cache, seq, served

    glob = cfgs["c"].replace(sharding_profile="default")
    api = get_model(glob)
    params = ma_params(torch, api, seed + 2)
    with torch.no_grad():
        p0 = layer_params(params["blocks"], 0)["moe"]
        (y, aux), rec_l = route_tap(lambda: M.moe_apply(p0, glob,
                                                        inp["moe_x"]))
        (logits, _), rec_f = route_tap(lambda: api.forward(
            params, inp["moe_ids"]))
        conf = glob.replace(capacity_factor=get_config_cf(MOE_ARCH))
        _, rec_d = route_tap(lambda: get_model(conf).forward(
            params, inp["moe_ids"]))
    torch.save({"y": y, "aux": aux, "top_e": rec_l["top_e"][0],
                "logits": logits, "routing": rec_f["top_e"],
                "dropped_global": [int(d) for d in rec_d["dropped"]]},
               f"{work}/ref_c.pt")
    del params, logits, y

    # (i) each family's gradients on one process (xLSTM's one-ulp floor,
    # the largest of MA_FLOOR_DRAWS nudges)
    for arch in FAMILY_ARCHS:
        cut = cfgs["i_" + arch]
        api = get_model(cut)
        params = ma_params(torch, api, seed + 3)
        batch = family_batch(torch, np, cut, MA_FAMILY_CUT["batch"],
                             MA_FAMILY_CUT["seq"], SEED + 53)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (loss, _), grads = loop.value_and_grad(api.loss_fn, params, batch)
        torch.cuda.synchronize()
        out[f"i_{arch}_grad_ms"] = (time.perf_counter() - t0) * 1e3
        floors = [ulp_floor(torch, cut, params, grads, batch, SEED + 42 + i)
                  for i in range(MA_FLOOR_DRAWS)] \
            if cut.family == "ssm" else None
        torch.save({"grads": grads, "loss": float(loss), "floors": floors,
                    "floor": max(floors) if floors else None},
                   f"{work}/ref_i_{arch}.pt")
        del params, grads
        torch.cuda.empty_cache()

    # (j) each family served on one process, the plain attention route
    for arch in FAMILY_ARCHS:
        api = get_model(cfgs["j_" + arch].replace(attn_impl="xla"))
        params = ma_params(torch, api, seed + 4)
        ids, frames = ma_serve_inputs(torch, np, api.cfg, "cuda")
        with torch.no_grad():
            cache = api.init_cache(MA_FAMILY_SERVE_BATCH,
                                   MA_FAMILY_SERVE[arch]["max_len"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seq, cache = ma_decode(api, params, ids, cache,
                                   build_prefill_step(api),
                                   build_decode_step(api),
                                   MA_FAMILY_SERVE[arch]["prompt"], frames)
            torch.cuda.synchronize()
            out[f"j_{arch}_ms"] = (time.perf_counter() - t0) * 1e3
        torch.save({"logits": seq, "cache": cache}, f"{work}/ref_j_{arch}.pt")
        del params, cache, seq
        torch.cuda.empty_cache()
    return out


def get_config_cf(arch: str) -> float:
    from repro_torch.configs import get_config
    return get_config(arch).capacity_factor


def ma_counted(torch):
    """What each rank of MA_AXES sends in (a)'s ``default`` step, (c)'s
    ``moe_local`` forward and (d)'s ``cache_seq`` decode step, counted as
    the dry-run counts it: rank 0's program on fake tensors on the
    counting mesh (``launch.mesh.counting_mesh``: no process group, no
    card) under ``collectives.record``.  Returns ({case: its log of
    ``Collective``s}, the seconds it took)."""
    from repro_torch.launch.mesh import Mesh, counting_mesh
    from repro_torch.launch.steps import build_decode_step, fake_mode
    from repro_torch.models.api import get_model
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train import train_loop as loop

    t0 = time.perf_counter()
    mesh = counting_mesh(Mesh(*zip(*MA_AXES)))
    cfgs = ma_configs()
    b, t = MA_CUT["batch"], MA_CUT["seq"]
    out = {}

    def meta(shape):
        return torch.empty(shape, dtype=torch.int64, device="meta")
    with fake_mode():
        api = get_model(cfgs["a"])
        step, init_opt = loop.build_accumulating_step(
            api, ma_train_config(), mesh, "default")
        local = rules.place(api.init(torch.Generator(), device="meta"),
                            step.placement(mesh).params)
        opt = init_opt(local)
        with C.record() as log:
            step(local, opt, {"tokens": meta((b, t)),
                              "labels": meta((b, t))}, 1)
        out["a"] = log
        api = get_model(cfgs["c"])
        params = api.init(torch.Generator(), device="meta")
        local = rules.place(params, rules.params_shardings(params, mesh,
                                                           "moe_local"))
        with use_mesh(mesh), torch.no_grad(), C.record() as log:
            api.forward(local, meta((MA_CUT["moe_batch"],
                                     MA_CUT["moe_seq"])))
        out["c"] = log
        api = get_model(cfgs["b"].replace(sharding_profile="cache_seq"))
        params = api.init(torch.Generator(), device="meta")
        local = rules.place(params, loop.placement(api, mesh,
                                                   "cache_seq").params)
        cache = api.init_cache(b, MA_SERVE["max_len"], device="meta")
        cache = rules.place(cache, rules.cache_shardings(cache, mesh,
                                                         "cache_seq"))
        pos = MA_SERVE["prompt"] + MA_DECODE
        with use_mesh(mesh), torch.no_grad(), C.record() as log:
            build_decode_step(api)(local, {"token": meta((b,)), "pos": pos},
                                   cache)
        out["d"] = log
    return out, time.perf_counter() - t0


def model_axis_rank(rank: int, work: str, seed: int) -> None:
    """One rank of the phase on ``cuda:0``: (a), (b), (c) on its blocks,
    each held against the reference on the card; writes what the parent
    checks and prints to ``<work>/rank<r>.pt``."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_group_mesh
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import moe as M
    from repro_torch.models.api import get_model
    from repro_torch.models.transformer import layer_params
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import use_mesh, use_placement
    from repro_torch.train import train_loop as loop
    from repro_torch.tree import leaves_with_paths, tree_map

    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    dev = init_distributed("cuda:0", backend="gloo",
                           init_method=f"file://{work}/store")
    torch.zeros(1, device=dev)
    mesh = make_group_mesh(MA_AXES, dev)
    cfgs = ma_configs()
    inp = ma_inputs(torch, np, cfgs, dev)
    out = {"rank": rank, "coords": {a: mesh.coordinate(a)
                                    for a in mesh.axis_names},
           "launches": {k: 0 for k in counters()}}

    # (a) a default and an fsdp AdamW step, f32
    api = get_model(cfgs["a"])
    params = ma_params(torch, api, seed, dev)
    ref = torch.load(f"{work}/ref_a.pt", map_location=dev)
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), params)
    out["a"] = {}
    for profile in ("default", "fsdp"):
        step, init_opt = loop.build_accumulating_step(
            api, ma_train_config(), mesh, profile)
        pl = step.placement(mesh)
        local = rules.place(params, pl.params)
        rec = {"param_bytes": nbytes(local),
               "param_bytes_shard": rules.shard_bytes(params, pl.params),
               "param_bytes_whole": nbytes(params)}
        with use_placement(pl):
            (_, g), rec["ckpt_input_bytes"] = ckpt_inputs(
                lambda: loop.value_and_grad(api.loss_fn, local, {
                    k: rules.constrain_batch(v, mesh, profile)
                    for k, v in inp["batch"].items()}))
        g = rules.gather(loop.group_mean(g, mesh, pl), pl.params)
        rec["grad_worst_frac"], rec["grad_worst_at"] = excess_frac(
            torch, g, ref["grads"], MA_GRAD_RTOL)
        opt = init_opt(local)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (p1, o1, m1), launches = counted(
            torch, lambda: step(local, opt, inp["batch"], 0))
        rec["step_ms"] = [(time.perf_counter() - t0) * 1e3]
        add_launches(out["launches"], launches)
        rec["launches"] = launches
        # the counted step's outputs: its norm (the clip's all-reduce over
        # the placement's axes) and its params gathered whole
        rec["grad_norm"] = [float(m1["grad_norm"]), ref["grad_norm"]]
        rec["p1_excess_frac"], rec["p1_at"] = adam_step_excess(
            torch, rules.gather(p1, pl.params), ref["p1"], g, ref["grads"],
            rec["grad_norm"], float(m1["lr"]),
            ma_train_config().weight_decay, MA_GRAD_RTOL)
        del g
        with TimedCollectives(torch) as tc:
            t0 = time.perf_counter()
            p2, _, m2 = step(p1, o1, inp["batch"], 1)
            torch.cuda.synchronize()
            rec["step_ms_collectives_timed"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        step(p1, o1, inp["batch"], 1)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["collectives"] = tc.record()
        rec["collective_log"] = list(tc.log)
        rec["opt_bytes"] = nbytes(o1)
        rec["opt_bytes_shard"] = rules.shard_bytes(init_opt(meta), pl.opt)
        rec["loss"] = [float(m1["loss"]), float(m2["loss"])]
        sh = dict(leaves_with_paths(pl.params))
        rec["whole_leaves"] = {
            "/".join(map(str, p)): x.cpu() for p, x in leaves_with_paths(p2)
            if all(a is None for a in sh[p].spec)}
        rec["blocks"] = {"/".join(map(str, p)): tuple(x.shape)
                         for p, x in leaves_with_paths(p1)}
        out["a"][profile] = rec
        del local, opt, p1, o1, p2
        torch.cuda.empty_cache()

    # (g) the same model under seq_parallel: a remat step on each rank's
    # half of the sequence
    api = get_model(cfgs["g"])
    step, init_opt = loop.build_accumulating_step(api, ma_train_config(),
                                                  mesh)
    pl = step.placement(mesh)
    local = rules.place(params, pl.params)
    rec = {"param_bytes": nbytes(local),
           "param_bytes_shard": rules.shard_bytes(params, pl.params)}
    with use_placement(pl):
        (_, g), rec["ckpt_input_bytes"] = ckpt_inputs(
            lambda: loop.value_and_grad(api.loss_fn, local, inp["batch"]))
    g = rules.gather(loop.group_mean(g, mesh, pl), pl.params)
    rec["grad_worst_frac"], rec["grad_worst_at"] = excess_frac(
        torch, g, ref["grads"], MA_GRAD_RTOL)
    del g
    opt = init_opt(local)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (p1, o1, m1), launches = counted(
        torch, lambda: step(local, opt, inp["batch"], 0))
    rec["step_ms"] = [(time.perf_counter() - t0) * 1e3]
    add_launches(out["launches"], launches)
    rec["launches"] = launches
    rec["grad_norm"] = [float(m1["grad_norm"]), ref["grad_norm"]]
    with TimedCollectives(torch) as tc:
        t0 = time.perf_counter()
        p2, _, _ = step(p1, o1, inp["batch"], 1)
        torch.cuda.synchronize()
        rec["step_ms_collectives_timed"] = (time.perf_counter() - t0) * 1e3
    rec["collectives"] = tc.record()
    t0 = time.perf_counter()
    step(p1, o1, inp["batch"], 1)
    torch.cuda.synchronize()
    rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
    rec["norm_gains"] = {k: p2["blocks"][k]["g"].cpu()
                         for k in ("ln1", "ln2")}
    out["g"] = rec
    del local, opt, p1, o1, p2
    torch.cuda.empty_cache()
    del params, ref, meta

    # (b) bf16: the flash forward, prefill and decode steps
    api = get_model(cfgs["b"])
    params = ma_params(torch, api, seed + 1, dev)
    local = rules.place(params, rules.params_shardings(params, mesh))
    ref = torch.load(f"{work}/ref_b.pt", map_location=dev)
    rec = {}
    with use_mesh(mesh), torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (logits, _), launches = counted(torch, lambda: api.forward(
            local, inp["ids"][:, :MA_CUT["seq"]]))
        rec["forward_ms"] = (time.perf_counter() - t0) * 1e3
        rec["forward_launches"] = launches
        add_launches(out["launches"], launches)
        rec["forward_err"], rec["forward_scale"] = rel_err(logits,
                                                           ref["logits"])
        del logits
        cache = api.init_cache(MA_CUT["batch"], MA_CUT["seq"] + MA_DECODE)
        csh = rules.cache_shardings(cache, mesh)
        cache = rules.place(cache, csh)
        rec["cache_block"] = tuple(cache["k"].shape)
        prefill, decode = build_prefill_step(api), build_decode_step(api)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (seq, cache), launches = counted(torch, lambda: ma_decode(
            api, local, inp["ids"], cache, prefill, decode))
        rec["prefill_decode_ms"] = (time.perf_counter() - t0) * 1e3
        rec["decode_launches"] = launches
        add_launches(out["launches"], launches)
        rec["decode_errs"] = [rel_err(a, b) for a, b in
                              zip(seq, ref["decode"])]
        with TimedCollectives(torch) as tc:
            t0 = time.perf_counter()
            decode(local, {"token": inp["ids"][:, -1],
                           "pos": MA_CUT["seq"] + MA_DECODE - 1}, cache)
            torch.cuda.synchronize()
            rec["decode_step_ms_collectives_timed"] = (
                time.perf_counter() - t0) * 1e3
        rec["decode_collectives"] = tc.record()
    out["b"] = rec
    del cache, seq

    # (g) the flash forward, prefill and decodes under seq_parallel
    api = get_model(cfgs["g_flash"])
    rec = {}
    with use_mesh(mesh), torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (logits, _), launches = counted(torch, lambda: api.forward(
            local, inp["ids"][:, :MA_CUT["seq"]]))
        rec["forward_ms"] = (time.perf_counter() - t0) * 1e3
        rec["forward_launches"] = launches
        add_launches(out["launches"], launches)
        rec["forward_err"], rec["forward_scale"] = rel_err(logits,
                                                           ref["logits"])
        del logits
        cache = rules.place(api.init_cache(MA_CUT["batch"],
                                           MA_CUT["seq"] + MA_DECODE), csh)
        (seq, cache), launches = counted(torch, lambda: ma_decode(
            api, local, inp["ids"], cache, build_prefill_step(api),
            build_decode_step(api)))
        rec["decode_launches"] = launches
        add_launches(out["launches"], launches)
        rec["decode_errs"] = [rel_err(a, b) for a, b in
                              zip(seq, ref["decode"])]
    out["g_flash"] = rec
    del local, cache, ref, seq
    torch.cuda.empty_cache()

    # (d) cache_seq and (e) infer2d: (b)'s model served from its blocks
    ref = torch.load(f"{work}/ref_d.pt", map_location=dev)
    for part, profile in (("d", "cache_seq"), ("e", "infer2d")):
        api = get_model(cfgs["b"].replace(sharding_profile=profile))
        pl = loop.placement(api, mesh, profile)
        local = rules.place(params, pl.params)
        rec = {"profile": profile, "param_bytes": nbytes(local),
               "param_bytes_shard": rules.shard_bytes(params, pl.params),
               "param_bytes_whole": nbytes(params)}
        with use_mesh(mesh), torch.no_grad():
            cache = api.init_cache(MA_CUT["batch"], MA_SERVE["max_len"])
            whole = tuple(cache["k"].shape)
            csh = rules.cache_shardings(cache, mesh, profile)
            cache = rules.place(cache, csh)
            rec.update(cache_block=tuple(cache["k"].shape),
                       cache_whole=whole,
                       cache_block_rule=csh["k"].shard_shape(whole),
                       cache_block_bytes=nbytes(cache))
            prefill, decode = (build_prefill_step(api, profile),
                               build_decode_step(api))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (seq, cache), launches = counted(torch, lambda: ma_decode(
                api, local, inp["ids"], cache, prefill, decode,
                MA_SERVE["prompt"]))
            rec["prefill_decode_ms"] = (time.perf_counter() - t0) * 1e3
            rec["launches"] = launches
            add_launches(out["launches"], launches)
            rec["decode_errs"] = [rel_err(a, b) for a, b in
                                  zip(seq, ref["decode"])]
            got = rules.gather(cache, csh)
            rec["cache_errs"] = [rel_err(got[k], ref["cache"][k])
                                 for k in ("k", "v")]
            del got
            pos = MA_SERVE["prompt"] + MA_DECODE
            with TimedCollectives(torch) as tc:
                t0 = time.perf_counter()
                decode(local, {"token": inp["ids"][:, pos], "pos": pos},
                       cache)
                torch.cuda.synchronize()
                rec["decode_step_ms_collectives_timed"] = (
                    time.perf_counter() - t0) * 1e3
            rec["decode_collectives"] = tc.record()
            rec["decode_collective_log"] = list(tc.log)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(local, {"token": inp["ids"][:, pos + 1], "pos": pos + 1},
                   cache)
            torch.cuda.synchronize()
            rec["decode_step_ms"] = (time.perf_counter() - t0) * 1e3
        out[part] = rec
        del local, cache, seq
        torch.cuda.empty_cache()
    del params, ref

    # (c) moonshot bf16 under moe_local
    api = get_model(cfgs["c"])
    params = ma_params(torch, api, seed + 2, dev)
    local = rules.place(params, rules.params_shardings(params, mesh,
                                                       "moe_local"))
    ref = torch.load(f"{work}/ref_c.pt", map_location=dev)
    rec = {"experts_held": int(local["blocks"]["moe"]["gate_w"].shape[1])}
    dropped = []
    dispatch_local = M.dispatch_local

    def tapped(xf, top_e, e_lo, e_local, cap):
        d = dispatch_local(xf, top_e, e_lo, e_local, cap)
        mine = ((top_e >= e_lo) & (top_e < e_lo + e_local)).sum()
        dropped.append(mine - d.keep.sum())
        return d
    with use_mesh(mesh), torch.no_grad():
        p0 = layer_params(local["blocks"], 0)["moe"]
        (y, aux), tap = route_tap(lambda: M.moe_apply(p0, cfgs["c"],
                                                      inp["moe_x"]))
        rec["layer_routing_bitwise"] = bool(torch.equal(tap["top_e"][0],
                                                        ref["top_e"]))
        rec["layer_aux_bitwise"] = bool(torch.equal(aux, ref["aux"]))
        rec["layer_err"], rec["layer_scale"] = rel_err(y, ref["y"])
        (logits, _), launches = counted(torch, lambda: route_tap(
            lambda: api.forward(local, inp["moe_ids"]),
            replay=ref["routing"])[0])
        add_launches(out["launches"], launches)
        rec["launches"] = launches
        rec["forward_err"], rec["forward_scale"] = rel_err(logits,
                                                           ref["logits"])
        # without the replay: the share of the reference's choices made,
        # the forward's collectives logged
        with TimedCollectives(torch) as tc:
            _, tap = route_tap(lambda: api.forward(local, inp["moe_ids"]))
        rec["collectives"] = tc.record()
        rec["collective_log"] = list(tc.log)
        rec["forward_routing_share"] = [
            float((a[:, :, None] == b[:, None, :]).any(-1).float().mean())
            for a, b in zip(ref["routing"], tap["top_e"])]
        conf = cfgs["c"].replace(capacity_factor=get_config_cf(MOE_ARCH))
        M.dispatch_local = tapped
        try:
            get_model(conf).forward(local, inp["moe_ids"])
        finally:
            M.dispatch_local = dispatch_local
        rec["dropped_local"] = [int(d) for d in dropped]
    out["c"] = rec

    # (h) the same under moe_local_sp, routing replayed
    rec = {}
    with use_mesh(mesh), torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (logits, _), launches = counted(torch, lambda: route_tap(
            lambda: get_model(cfgs["h"]).forward(local, inp["moe_ids"]),
            replay=ref["routing"])[0])
        rec["forward_ms"] = (time.perf_counter() - t0) * 1e3
    add_launches(out["launches"], launches)
    rec["launches"] = launches
    rec["forward_err"], rec["forward_scale"] = rel_err(logits, ref["logits"])
    out["h"] = rec
    del local, logits
    torch.cuda.empty_cache()

    # (f) the same under infer2d: each rank's row, its data block's rows
    # gathered for the moe_local dispatch, its experts cut from the
    # gathered layer
    pl = loop.placement(api, mesh, "infer2d")
    local = rules.place(params, pl.params)
    rec = {"param_bytes": nbytes(local),
           "param_bytes_shard": rules.shard_bytes(params, pl.params),
           "param_bytes_whole": nbytes(params)}
    del params
    ids = rules.constrain_batch(inp["moe_ids"], mesh, "infer2d")
    rows = rules.block_index(mesh, ("data", "model")) * ids.shape[0]
    with use_placement(pl), torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (logits, _), launches = counted(torch, lambda: route_tap(
            lambda: api.forward(local, ids), replay=ref["routing"])[0])
        rec["forward_ms"] = (time.perf_counter() - t0) * 1e3
    add_launches(out["launches"], launches)
    rec["launches"] = launches
    rec["rows"] = [rows, rows + ids.shape[0]]
    rec["forward_err"], rec["forward_scale"] = rel_err(
        logits, ref["logits"][rows:rows + ids.shape[0]])
    out["f"] = rec
    del local, logits

    # (i) xLSTM, Hymba and Whisper: a training step split over model
    out["i"] = {}
    for arch in FAMILY_ARCHS:
        api = get_model(cfgs["i_" + arch])
        params = ma_params(torch, api, seed + 3, dev)
        ref = torch.load(f"{work}/ref_i_{arch}.pt", map_location=dev)
        batch = family_batch(torch, np, api.cfg, MA_FAMILY_CUT["batch"],
                             MA_FAMILY_CUT["seq"], SEED + 53, device=dev)
        step, init_opt = loop.build_accumulating_step(
            api, ma_train_config(), mesh)
        pl = step.placement(mesh)
        local = rules.place(params, pl.params)
        rec = {"param_bytes": nbytes(local),
               "param_bytes_shard": rules.shard_bytes(params, pl.params),
               "param_bytes_whole": nbytes(params), "floor": ref["floor"],
               "floors": ref["floors"]}
        del params
        opt = init_opt(local)
        # one step, counted and timed; its gradients tapped and checked
        with TimedCollectives(torch) as tc:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ((p1, _, _), tap), launches = counted(torch, lambda: grad_tap(
                lambda: step(local, opt, batch, 0)))
            rec["step_ms_collectives_timed"] = (time.perf_counter() -
                                                t0) * 1e3
        add_launches(out["launches"], launches)
        rec["launches"] = launches
        rec["collectives"] = tc.record()
        # the step's mean over a data axis of one rank left them as they
        # were
        (loss, _), g = tap[0]
        g = rules.gather(loop.group_mean(g, mesh, pl), pl.params)
        rec["loss"] = [float(loss), ref["loss"]]
        rec["grad_worst_frac"], rec["grad_worst_at"] = excess_frac(
            torch, g, ref["grads"], MA_GRAD_RTOL)
        del g, ref, tap
        sh = dict(leaves_with_paths(pl.params))
        rec["whole_leaves"] = {
            "/".join(map(str, p)): x.cpu() for p, x in leaves_with_paths(p1)
            if all(a is None for a in sh[p].spec)}
        out["i"][arch] = rec
        del local, opt, p1
        torch.cuda.empty_cache()

    # (j) xLSTM, Hymba and Whisper served from each rank's blocks
    out["j"] = {}
    for arch in FAMILY_ARCHS:
        ref = torch.load(f"{work}/ref_j_{arch}.pt", map_location=dev)
        for profile in MA_FAMILY_PROFILES:
            out["j"][arch, profile] = ma_serve_case(
                torch, np, cfgs["j_" + arch], profile, mesh, dev, seed + 4,
                ref, out["launches"])
        del ref
        torch.cuda.empty_cache()
    torch.save(out, f"{work}/rank{rank}.pt")
    dist.destroy_process_group()


def ma_serve_case(torch, np, cfg, profile, mesh, dev, seed, ref, total):
    """(j) one family under ``profile`` on this rank: the prefill and
    decode steps on its blocks of the weights and the cache, counted;
    each step's logits and the gathered cache against one process's
    (``ref``); each cache block's shape and bytes beside the rules'; a
    decode step timed with its collectives, and one without."""
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models.api import get_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train import train_loop as loop
    from repro_torch.tree import leaves_with_paths

    api = get_model(cfg.replace(sharding_profile=profile))
    params = ma_params(torch, api, seed, dev)
    pl = loop.placement(api, mesh, profile)
    local = rules.place(params, pl.params)
    rec = {"param_bytes": nbytes(local),
           "param_bytes_shard": rules.shard_bytes(params, pl.params),
           "param_bytes_whole": nbytes(params)}
    del params
    ids, frames = ma_serve_inputs(torch, np, cfg, dev)
    n = MA_FAMILY_SERVE[cfg.name]["prompt"]
    with use_mesh(mesh), torch.no_grad():
        whole = api.init_cache(MA_FAMILY_SERVE_BATCH,
                               MA_FAMILY_SERVE[cfg.name]["max_len"])
        csh = rules.cache_shardings(whole, mesh, profile)
        cache = rules.place(whole, csh)
        sh = dict(leaves_with_paths(csh))
        rec["cache_blocks"] = {
            "/".join(map(str, p)): [tuple(x.shape),
                                    sh[p].shard_shape(tuple(w.shape)),
                                    tuple(w.shape)]
            for (p, x), (_, w) in zip(leaves_with_paths(cache),
                                      leaves_with_paths(whole))}
        rec.update(cache_bytes=nbytes(cache),
                   cache_bytes_shard=rules.shard_bytes(whole, csh),
                   cache_bytes_whole=nbytes(whole))
        del whole
        prefill, decode = (build_prefill_step(api, profile),
                           build_decode_step(api))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (seq, cache), launches = counted(torch, lambda: ma_decode(
            api, local, ids, cache, prefill, decode, n, frames))
        rec["prefill_decode_ms"] = (time.perf_counter() - t0) * 1e3
        add_launches(total, launches)
        rec["launches"] = launches
        rec["decode_errs"] = [rel_err(a, b) for a, b in
                              zip(seq, ref["logits"])]
        rec["cache_blocks_after"] = {
            "/".join(map(str, p)): tuple(x.shape)
            for p, x in leaves_with_paths(cache)}
        got = dict(leaves_with_paths(rules.gather(cache, csh)))
        rec["cache_errs"] = {"/".join(map(str, p)): rel_err(got[p], w)
                             for p, w in leaves_with_paths(ref["cache"])}
        del got
        pos = n + MA_DECODE
        with TimedCollectives(torch) as tc:
            t0 = time.perf_counter()
            decode(local, {"token": ids[:, -1], "pos": pos}, cache)
            torch.cuda.synchronize()
            rec["decode_step_ms_collectives_timed"] = (
                time.perf_counter() - t0) * 1e3
        rec["decode_collectives"] = tc.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(local, {"token": ids[:, -1], "pos": pos + 1}, cache)
        torch.cuda.synchronize()
        rec["decode_step_ms"] = (time.perf_counter() - t0) * 1e3
    return rec


def model_axis_phases(torch, np, smi):
    """``model_axis``: a ``model`` axis over two gloo ranks sharing the
    card, as (data=1, model=2) (module comment above MA_AXES): (a)
    gradients within MA_GRAD_ATOL of each leaf's max|g| of one process's,
    the counted step's grad norm and params (gathered) against one
    process's step (``adam_step_excess``), whole leaves bitwise on both
    ranks after a step, each rank's param and AdamW bytes
    ``rules.shard_bytes``'s; (b) the flash forward on each rank's heads
    (``flash_attention`` launched on both ranks) against one process's
    plain attention route, and each prefill and decode step's logits,
    within MA_LOGIT_TOL of max|logit|; (c) the MoE layer's routing and aux bitwise one
    process's, the forward within MA_MOE_TOL with its routing replayed,
    and the entries dropped at the config's capacity factor, local
    against global; (d) ``cache_seq`` and (e) ``infer2d`` serving (b)'s
    model from each rank's blocks, every step's logits and the gathered
    cache within MA_LOGIT_TOL of one process's, each cache block the
    rules' (never the whole cache) and its bytes, a decode step's
    collectives; (f) (c)'s model under ``infer2d`` within MA_MOE_TOL with
    its routing replayed; (g) (a)'s model under ``seq_parallel``, its
    gradients and grad norm as (a)'s, each checkpointed layer input half
    (a) ``default``'s bytes, the norm gains bitwise on both ranks after
    a step, and (b)'s flash forward (flash launched on both ranks),
    prefill and decodes under ``seq_parallel`` within MA_LOGIT_TOL; (h)
    (c)'s model under ``moe_local_sp`` within MA_MOE_TOL, routing
    replayed; (i) xLSTM, Hymba and Whisper trained under ``default``,
    the gradients within MA_GRAD_ATOL of one process's (xLSTM within
    MA_XLSTM_FLOORS of the largest of its MA_FLOOR_DRAWS one-ulp
    floors), the loss within MA_GRAD_RTOL, whole leaves bitwise on both
    ranks after the step, bytes ``shard_bytes``'s; (j) xLSTM, Hymba and Whisper served under
    ``default`` and ``cache_seq`` from each rank's blocks, every step's
    logits and each leaf of the gathered cache within ma_serve_tol of one
    process's, each cache block the rules' before and after the steps,
    the cache's and params' bytes ``shard_bytes``'s, flash launched on
    both ranks in Whisper's encoder, a decode step's collectives.  Step,
    forward and collective ms beside the card.  Returns the launches on
    the paths they drive (both ranks')."""
    import tempfile

    seed = SEED + 60
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        ref = model_axis_reference(torch, np, work, seed)
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t0
        ranks, (counted, t_counted) = run_ranks(
            torch, model_axis_rank, 2, work, seed, "model_axis",
            during=lambda: ma_counted(torch))
        ref_c = torch.load(f"{work}/ref_c.pt", map_location="cpu")
    launches = {k: 0 for k in counters()}
    for r, out in enumerate(ranks):
        add_launches(launches, out["launches"])
        for profile, rec in out["a"].items():
            where = f"model_axis (a) {profile} rank {r}"
            check(rec["grad_worst_frac"] <= MA_GRAD_ATOL,
                  f"{where}: gradient {rec['grad_worst_at']} off by "
                  f"{rec['grad_worst_frac']} of its max|g|")
            got_n, want_n = rec["grad_norm"]
            check(abs(got_n - want_n) <= MA_GRAD_RTOL * abs(want_n),
                  f"{where}: the step's grad norm {got_n} against one "
                  f"process's {want_n}")
            check(rec["p1_excess_frac"] <= 0,
                  f"{where}: params after the step, {rec['p1_at']} beyond "
                  f"its allowance by {rec['p1_excess_frac']} of its max")
            check(rec["param_bytes"] == rec["param_bytes_shard"] <
                  rec["param_bytes_whole"] and rec["opt_bytes"] ==
                  rec["opt_bytes_shard"],
                  f"{where}: bytes {rec['param_bytes']} (shard_bytes "
                  f"{rec['param_bytes_shard']}), AdamW {rec['opt_bytes']} "
                  f"({rec['opt_bytes_shard']})")
            expect_launches(where, rec["launches"], {})
        b = out["b"]
        check(b["forward_launches"]["flash_attention"] ==
              MA_CUT["layers"], f"model_axis (b) rank {r}: flash launched "
                                f"{b['forward_launches']} times")
        expect_launches(f"model_axis (b) decode rank {r}",
                        b["decode_launches"], {})
        for i, (err, scale) in enumerate([(b["forward_err"],
                                           b["forward_scale"])] +
                                         b["decode_errs"]):
            check(err <= MA_LOGIT_TOL * scale,
                  f"model_axis (b) rank {r} step {i}: logits off by {err} > "
                  f"{MA_LOGIT_TOL} * {scale}")
        c = out["c"]
        check(c["layer_routing_bitwise"] and c["layer_aux_bitwise"],
              f"model_axis (c) rank {r}: the MoE layer's routing or aux is "
              f"not one process's")
        check(c["forward_err"] <= MA_MOE_TOL * c["forward_scale"],
              f"model_axis (c) rank {r}: logits off by {c['forward_err']} > "
              f"{MA_MOE_TOL} * {c['forward_scale']}")
        expect_launches(f"model_axis (c) rank {r}", c["launches"], {})
        for part in ("d", "e"):
            d = out[part]
            where = f"model_axis ({part}) {d['profile']} rank {r}"
            expect_launches(where, d["launches"], {})
            for i, (err, scale) in enumerate(d["decode_errs"]):
                check(err <= MA_LOGIT_TOL * scale,
                      f"{where} step {i}: logits off by {err} > "
                      f"{MA_LOGIT_TOL} * {scale}")
            for k, (err, scale) in zip("kv", d["cache_errs"]):
                check(err <= MA_LOGIT_TOL * scale,
                      f"{where}: the gathered cache's {k} off by {err} > "
                      f"{MA_LOGIT_TOL} * {scale}")
            check(d["cache_block"] == d["cache_block_rule"] and
                  d["cache_block"] != d["cache_whole"],
                  f"{where}: cache block {d['cache_block']} (the rules' "
                  f"{d['cache_block_rule']}, whole {d['cache_whole']})")
        for part in ("d", "e", "f"):
            d = out[part]
            check(d["param_bytes"] == d["param_bytes_shard"] <
                  d["param_bytes_whole"],
                  f"model_axis ({part}) rank {r}: param bytes "
                  f"{d['param_bytes']} (shard_bytes "
                  f"{d['param_bytes_shard']})")
        f = out["f"]
        check(f["forward_err"] <= MA_MOE_TOL * f["forward_scale"],
              f"model_axis (f) rank {r}: logits off by {f['forward_err']} > "
              f"{MA_MOE_TOL} * {f['forward_scale']}")
        expect_launches(f"model_axis (f) rank {r}", f["launches"], {})
        g = out["g"]
        where = f"model_axis (g) seq_parallel rank {r}"
        check(g["grad_worst_frac"] <= MA_GRAD_ATOL,
              f"{where}: gradient {g['grad_worst_at']} off by "
              f"{g['grad_worst_frac']} of its max|g|")
        got_n, want_n = g["grad_norm"]
        check(abs(got_n - want_n) <= MA_GRAD_RTOL * abs(want_n),
              f"{where}: the step's grad norm {got_n} against one "
              f"process's {want_n}")
        check(g["param_bytes"] == g["param_bytes_shard"],
              f"{where}: param bytes {g['param_bytes']} (shard_bytes "
              f"{g['param_bytes_shard']})")
        full = out["a"]["default"]["ckpt_input_bytes"]
        check(len(g["ckpt_input_bytes"]) == len(full) == MA_CUT["layers"]
              and all(2 * a == b for a, b in zip(g["ckpt_input_bytes"],
                                                 full)),
              f"{where}: checkpointed inputs {g['ckpt_input_bytes']} B, "
              f"default's {full} B (half expected)")
        expect_launches(where, g["launches"], {})
        gf = out["g_flash"]
        check(gf["forward_launches"]["flash_attention"] == MA_CUT["layers"],
              f"{where}: flash launched {gf['forward_launches']} times")
        expect_launches(f"{where} decode", gf["decode_launches"], {})
        for i, (err, scale) in enumerate([(gf["forward_err"],
                                           gf["forward_scale"])] +
                                         gf["decode_errs"]):
            check(err <= MA_LOGIT_TOL * scale,
                  f"{where} bf16 step {i}: logits off by {err} > "
                  f"{MA_LOGIT_TOL} * {scale}")
        h = out["h"]
        check(h["forward_err"] <= MA_MOE_TOL * h["forward_scale"],
              f"model_axis (h) moe_local_sp rank {r}: logits off by "
              f"{h['forward_err']} > {MA_MOE_TOL} * {h['forward_scale']}")
        expect_launches(f"model_axis (h) rank {r}", h["launches"], {})
        for arch, fam in out["i"].items():
            where = f"model_axis (i) {arch} rank {r}"
            tol = MA_GRAD_ATOL if fam["floor"] is None else \
                MA_XLSTM_FLOORS * fam["floor"]
            check(fam["grad_worst_frac"] <= tol,
                  f"{where}: gradient {fam['grad_worst_at']} off by "
                  f"{fam['grad_worst_frac']} of its max|g| > {tol}")
            got_l, want_l = fam["loss"]
            check(abs(got_l - want_l) <= MA_GRAD_RTOL * abs(want_l),
                  f"{where}: loss {got_l} against one process's {want_l}")
            check(fam["param_bytes"] == fam["param_bytes_shard"] <
                  fam["param_bytes_whole"],
                  f"{where}: param bytes {fam['param_bytes']} (shard_bytes "
                  f"{fam['param_bytes_shard']}, whole "
                  f"{fam['param_bytes_whole']})")
            expect_launches(where, fam["launches"], {})
        for (arch, profile), j in out["j"].items():
            where = f"model_axis (j) {arch} {profile} rank {r}"
            cfg = ma_configs()["j_" + arch]
            expect_launches(where, j["launches"], {
                "flash_attention": cfg.n_enc_layers}
                if cfg.family == "audio" else {})
            tol = ma_serve_tol(cfg)
            for i, (err, scale) in enumerate(j["decode_errs"]):
                check(err <= tol * scale,
                      f"{where} step {i}: logits off by {err} > "
                      f"{tol} * {scale}")
            for leaf, (err, scale) in j["cache_errs"].items():
                check(err <= tol * scale,
                      f"{where}: the gathered cache's {leaf} off by {err} "
                      f"> {tol} * {scale}")
            for leaf, (got, rule, whole) in j["cache_blocks"].items():
                check(got == rule == j["cache_blocks_after"][leaf],
                      f"{where}: cache block {leaf} {got}, after the steps "
                      f"{j['cache_blocks_after'][leaf]} (the rules' {rule},"
                      f" whole {whole})")
            check(j["cache_bytes"] == j["cache_bytes_shard"] <
                  j["cache_bytes_whole"] and j["param_bytes"] ==
                  j["param_bytes_shard"] < j["param_bytes_whole"],
                  f"{where}: cache bytes {j['cache_bytes']} (shard_bytes "
                  f"{j['cache_bytes_shard']}, whole {j['cache_bytes_whole']})"
                  f", param bytes {j['param_bytes']} (shard_bytes "
                  f"{j['param_bytes_shard']})")
    for profile in ("default", "fsdp"):
        a0, a1 = (out["a"][profile] for out in ranks)
        same = sorted(a0["whole_leaves"]) == sorted(a1["whole_leaves"]) and \
            all(torch.equal(a0["whole_leaves"][k], a1["whole_leaves"][k])
                for k in a0["whole_leaves"])
        check(same, f"model_axis (a) {profile}: the leaves both ranks hold "
                    f"differ after a step")
    g0, g1 = (out["g"]["norm_gains"] for out in ranks)
    check(all(torch.equal(g0[k], g1[k]) for k in g0),
          "model_axis (g): the norm gains differ between the ranks after a "
          "seq_parallel step")
    for arch in FAMILY_ARCHS:
        w0, w1 = (out["i"][arch]["whole_leaves"] for out in ranks)
        check(sorted(w0) == sorted(w1) and
              all(torch.equal(w0[k], w1[k]) for k in w0),
              f"model_axis (i) {arch}: the leaves both ranks hold differ "
              f"after a step")
    sent = {"a": [out["a"]["default"]["collective_log"] for out in ranks],
            "c": [out["c"]["collective_log"] for out in ranks],
            "d": [out["d"]["decode_collective_log"] for out in ranks]}
    for case, logs in sent.items():
        want = by_kind(counted[case])["bytes"]
        for r, got in enumerate(logs):
            # Collective's equality: op, bytes, dtype and group size
            check(got == counted[case] and by_kind(got)["bytes"] == want,
                  f"model_axis ({case}): rank {r} sent "
                  f"{by_kind(got)['bytes']} in {len(got)} collectives; the "
                  f"counting run on fake tensors counts {want} in "
                  f"{len(counted[case])}")
    local_drops = [sum(x) for x in zip(*(out["c"]["dropped_local"]
                                         for out in ranks))]
    emit({"phase": "model_axis", "mesh": dict(MA_AXES), "backend": "gloo",
          "device": "cuda:0 (both ranks)",
          "cut": f"n_layers -> {MA_CUT['layers']} (tinyllama 22, moonshot "
                 f"48), full width",
          "a": {"arch": LM_ARCH, "dtype": "float32", "batch": MA_CUT["batch"],
                "seq": MA_CUT["seq"], "one_process_step_ms":
                    ref["a_step_ms"],
                **{p: {k: [out["a"][p][k] for out in ranks] for k in (
                    "grad_worst_frac", "grad_worst_at", "grad_norm",
                    "p1_excess_frac", "p1_at", "param_bytes",
                    "param_bytes_whole", "opt_bytes", "step_ms",
                    "step_ms_collectives_timed", "collectives", "loss")}
                   for p in ("default", "fsdp")},
                "whole_leaves_bitwise": {
                    p: sorted(ranks[0]["a"][p]["whole_leaves"]) for p in (
                        "default", "fsdp")},
                "tolerance": f"gradients rtol {MA_GRAD_RTOL}, atol "
                             f"{MA_GRAD_ATOL} of each leaf's max|g|; grad "
                             f"norm rtol {MA_GRAD_RTOL}; params after the "
                             f"step rtol {MA_GRAD_RTOL} plus lr * the "
                             f"gradients' change of the Adam direction"},
          "b": {"arch": LM_ARCH, "dtype": "bfloat16", "attn_impl": "flash",
                "prompt": MA_CUT["seq"], "decode_steps": MA_DECODE,
                "note": "prefill and decode attend over the cache on the "
                        "plain path, as JAX's do; the flash launches are "
                        "the scoring forward's, on each rank's heads, held "
                        "against one process's plain attention route",
                **{k: [out["b"][k] for out in ranks] for k in (
                    "forward_launches", "forward_ms", "forward_err",
                    "forward_scale", "decode_errs", "cache_block",
                    "prefill_decode_ms", "decode_step_ms_collectives_timed",
                    "decode_collectives")},
                "tolerance": f"{MA_LOGIT_TOL} of max|logit|"},
          "c": {"arch": MOE_ARCH, "dtype": "bfloat16",
                "profile": "moe_local", "batch": MA_CUT["moe_batch"],
                "seq": MA_CUT["moe_seq"],
                "capacity_factor": ma_configs()["c"].capacity_factor,
                **{k: [out["c"][k] for out in ranks] for k in (
                    "experts_held", "layer_routing_bitwise",
                    "layer_aux_bitwise", "layer_err", "layer_scale",
                    "forward_err", "forward_scale",
                    "forward_routing_share", "collectives")},
                "dropped_per_layer_at_cf": get_config_cf(MOE_ARCH),
                "dropped_local": local_drops,
                "dropped_global": ref_c["dropped_global"],
                "tolerance": f"{MA_MOE_TOL} of max|logit|, routing "
                             f"replayed"},
          **{part: {"arch": LM_ARCH, "dtype": "bfloat16",
                    "profile": ranks[0][part]["profile"],
                    "prompt": MA_SERVE["prompt"],
                    "max_len": MA_SERVE["max_len"],
                    "decode_steps": MA_DECODE,
                    **{k: [out[part][k] for out in ranks] for k in (
                        "cache_block", "cache_whole", "cache_block_bytes",
                        "param_bytes", "param_bytes_whole", "decode_errs",
                        "cache_errs", "prefill_decode_ms", "decode_step_ms",
                        "decode_step_ms_collectives_timed",
                        "decode_collectives")},
                    "note": "decode_collectives: one decode step's calls and "
                            "bytes by kind on the rank (an all-reduce's or "
                            "all-to-all's operand, an all-gather's result); "
                            "gloo stages CUDA tensors through the host, so "
                            "the ms are no multi-card rate",
                    "tolerance": f"{MA_LOGIT_TOL} of max|x|, logits and "
                                 f"the gathered cache"}
             for part in ("d", "e")},
          "f": {"arch": MOE_ARCH, "dtype": "bfloat16",
                "profile": "infer2d (moe_local dispatch)",
                "batch": MA_CUT["moe_batch"], "seq": MA_CUT["moe_seq"],
                **{k: [out["f"][k] for out in ranks] for k in (
                    "rows", "param_bytes", "param_bytes_whole",
                    "forward_ms", "forward_err", "forward_scale")},
                "tolerance": f"{MA_MOE_TOL} of max|logit|, routing "
                             f"replayed"},
          "g": {"arch": LM_ARCH, "seq_parallel": True,
                "f32": {"batch": MA_CUT["batch"], "seq": MA_CUT["seq"],
                        "remat": True,
                        **{k: [out["g"][k] for out in ranks] for k in (
                            "grad_worst_frac", "grad_worst_at", "grad_norm",
                            "param_bytes", "ckpt_input_bytes", "step_ms",
                            "step_ms_collectives_timed", "collectives")},
                        "default_ckpt_input_bytes": [
                            out["a"]["default"]["ckpt_input_bytes"]
                            for out in ranks],
                        "tolerance": f"gradients rtol {MA_GRAD_RTOL}, atol "
                                     f"{MA_GRAD_ATOL} of each leaf's "
                                     f"max|g|, against one process"},
                "bf16_flash": {
                    **{k: [out["g_flash"][k] for out in ranks] for k in (
                        "forward_launches", "forward_ms", "forward_err",
                        "forward_scale", "decode_errs")},
                    "note": "the flash forward gathers T before attention "
                            "and runs on each rank's heads; the prompt of "
                            f"{MA_CUT['seq']} splits over model, the "
                            "decode steps (T = 1) stay whole",
                    "tolerance": f"{MA_LOGIT_TOL} of max|logit| against "
                                 f"one process's plain attention route"}},
          "h": {"arch": MOE_ARCH, "dtype": "bfloat16",
                "profile": "moe_local_sp (moe_local, seq_parallel, "
                           "xla_chunked)",
                "batch": MA_CUT["moe_batch"], "seq": MA_CUT["moe_seq"],
                **{k: [out["h"][k] for out in ranks] for k in (
                    "forward_ms", "forward_err", "forward_scale")},
                "tolerance": f"{MA_MOE_TOL} of max|logit|, routing "
                             f"replayed, against one process's global "
                             f"route on the plain attention"},
          "i": {"dtype": "float32", "profile": "default",
                "batch": MA_FAMILY_CUT["batch"], "seq": MA_FAMILY_CUT["seq"],
                **{arch: {"layers": ma_configs()["i_" + arch].n_layers,
                          "one_process_grad_ms": ref[f"i_{arch}_grad_ms"],
                          **{k: [out["i"][arch][k] for out in ranks]
                             for k in ("grad_worst_frac", "grad_worst_at",
                                       "loss", "floor", "floors",
                                       "param_bytes",
                                       "param_bytes_whole",
                                       "step_ms_collectives_timed",
                                       "collectives")}}
                   for arch in FAMILY_ARCHS},
                "tolerance": f"gradients rtol {MA_GRAD_RTOL}, atol "
                             f"{MA_GRAD_ATOL} of each leaf's max|g| "
                             f"(xLSTM: {MA_XLSTM_FLOORS} times the largest "
                             f"of {MA_FLOOR_DRAWS} one-ulp floors on one "
                             f"process), loss rtol "
                             f"{MA_GRAD_RTOL}"},
          "j": {arch: {"layers": ma_configs()["j_" + arch].n_layers,
                       "dtype": ma_configs()["j_" + arch].dtype,
                       "batch": MA_FAMILY_SERVE_BATCH, **MA_FAMILY_SERVE[arch],
                       "decode_steps": MA_DECODE,
                       "one_process_ms": ref[f"j_{arch}_ms"],
                       **{profile: {k: [out["j"][arch, profile][k]
                                        for out in ranks] for k in (
                           "launches", "decode_errs", "cache_errs",
                           "cache_blocks", "cache_bytes", "cache_bytes_whole",
                           "param_bytes", "param_bytes_whole",
                           "prefill_decode_ms", "decode_step_ms",
                           "decode_step_ms_collectives_timed",
                           "decode_collectives")}
                          for profile in MA_FAMILY_PROFILES}}
                for arch in FAMILY_ARCHS},
          "j_tolerance": f"{MA_F32_SERVE_TOL} (xLSTM, f32) and "
                         f"{MA_LOGIT_TOL} (Hymba and Whisper, bf16) of "
                         f"max|x|, every step's logits and each leaf of "
                         f"the gathered cache, against one process's plain "
                         f"attention route",
          "note": "collectives: calls, ms and bytes by kind on the rank "
                  "over one step (an all-reduce's or all-to-all's operand, "
                  "an all-gather's result); gloo stages CUDA tensors "
                  "through the host, so the ms are no multi-card rate",
          "counted": {
              "note": "rank 0's program on fake tensors on the counting "
                      "mesh (the dry-run's count), against what each "
                      "rank sent: (a) default step, (c) moe_local "
                      "forward, (d) cache_seq decode step, equal entry "
                      "by entry",
              **{case: {k: v for k, v in by_kind(log).items() if k != "ms"}
                 for case, log in counted.items()},
              "seconds": t_counted},
          "reference_s": t_ref, "launches": launches,
          "seconds": time.perf_counter() - t0, "card": smi})
    return launches


def main() -> int:
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch is missing; run it from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # the launch recipe, before torch initialises CUDA
    from repro_torch.launch.profile import launch_profile
    profile = launch_profile()
    applied = profile.apply()
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
    emit({"phase": "launch_profile", "name": profile.name,
          "env": dict(profile.env), "applied": applied,
          "shell_prefix": profile.shell_prefix()})
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
        expect={"knn": 4, "fused_linear": 28},
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
                "fused_linear": 24},
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
    add_launches(total, analysis_phase(torch))
    trace_phase(torch, smi, (
        ("lite", lite, {"int8_matmul"}), ("m2", m2, {"fused_linear"}),
        ("elite", elite, {"grouped_transfer", "knn", "fused_linear"})))
    add_launches(total, tune_phase(torch, params, smi))
    add_launches(total, tiles_phase(torch, smi, (
        ("lite", lite, params, clouds), ("m2", m2, params, clouds),
        ("elite", elite, elite_params, elite_clouds))))

    t_engines = time.perf_counter()
    add_launches(total, async_phase(torch, np, params, clouds, smi))
    seg_params = pointmlp_init(stream_specs()[1][1].to_model_config(),
                               torch.Generator().manual_seed(SEED + 9))
    perturb_bn(torch, seg_params, torch.Generator().manual_seed(SEED + 10))
    by_name = {"lite": params, "lite_seg": seg_params, "elite": elite_params}
    got, lite_frames, lite_outs = stream_phase(torch, np, rng, by_name, smi)
    add_launches(total, got)
    add_launches(total, fleet_phase(torch, np, by_name, clouds, elite_clouds,
                                    lite_frames, lite_outs, smi))
    emit({"phase": "engines_total", "card": smi,
          "seconds": time.perf_counter() - t_engines})
    add_launches(total, shard_phase(torch, np, params, elite_params, clouds,
                                    elite_clouds, smi))
    add_launches(total, train_phases(torch, smi, clouds))
    del elite_params, params, seg_params, by_name
    lm_rows, got = lm_phases(torch, np)
    rows.update(lm_rows)
    for k, v in got.items():
        total[k] += v
    torch.cuda.empty_cache()
    add_launches(total, dryrun_phases(torch, np, smi))
    add_launches(total, lm_train_phases(torch, np, smi))
    moe_rows, got, total["flash_moonshot"] = moe_phases(torch, np, smi)
    rows.update(moe_rows)
    add_launches(total, got)
    torch.cuda.empty_cache()
    fam_rows, got, shapes = family_phases(torch, np, smi)
    rows.update(fam_rows)
    add_launches(total, got)
    for label, shape in FAMILY_FLASH_SHAPE.items():
        total["flash_" + label] = shapes.get(shape, 0)
    add_launches(total, family_train_phases(torch, np, smi))
    add_launches(total, dp_train_phases(torch, np, smi))
    add_launches(total, model_axis_phases(torch, np, smi))

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
                                 "inf_radius_equals_knn", "kernel_route",
                                 "tflops", "timing") if k in r}})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-launch-rank"]:
        sys.exit(dp_launch_rank(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
