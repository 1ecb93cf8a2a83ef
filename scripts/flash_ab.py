#!/usr/bin/env python3
"""Time flash-attention kernel sources against each other on one GPU.

    python3 scripts/flash_ab.py [OTHER.cu ...]

Builds ``src/repro_torch/csrc/flash_attention.cu`` (as ``shipped``) and
each other source given (each must export ``flash_attention_launch`` with
the same C signature, as a parent commit's copy or an edited variant
does) with the port's ``nvcc`` flags, holds every one against the plain
version at tinyllama's attention shapes (bf16: causal D64, causal D128,
window 256, non-causal), and times them in turns (shipped, others, others
in reverse, shipped), each a median of CUDA-event windows, beside
``scaled_dot_product_attention`` where it computes the same function.
Prints the card line, then one JSON line a shape; exits non-zero without
a CUDA device or if a source fails to build, launch or agree.

To hold a change against its parent on one card::

    git show HEAD~1:src/repro_torch/csrc/flash_attention.cu > build/parent.cu
    python3 scripts/flash_ab.py build/parent.cu
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = [  # (B, H, Hkv, T, D, causal, window)
    (4, 32, 4, 2048, 64, True, 0),
    (4, 16, 4, 2048, 128, True, 0),
    (4, 32, 4, 2048, 64, True, 256),
    (4, 32, 4, 2048, 64, False, 0),
]
TOL = 2.0 ** -7     # the smoke's bf16 allowance, per output row


def median_ms(torch, fn, reps: int = 30, inner: int = 10) -> float:
    for _ in range(3):
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


def build(sources, build_dir, nvcc_flags, argtypes):
    """Compile every source in parallel; -> {name: launch function}."""
    procs = {}
    for name, src in sources.items():
        so = build_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *nvcc_flags, "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).flash_attention_launch
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_ab.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    sources = {"shipped": ROOT / "src/repro_torch/csrc/flash_attention.cu"}
    for arg in sys.argv[1:]:
        sources[pathlib.Path(arg).stem] = pathlib.Path(arg).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(sources, pathlib.Path(tmp), _build.NVCC_FLAGS,
                    _build.SIGNATURES["flash_attention"][1])
        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator(device="cuda").manual_seed(4)
        for b, h, hkv, t, d, causal, win in SHAPES:
            q, k, v = (torch.randn(b, n, t, d, generator=gen, device="cuda")
                       .to(torch.bfloat16) for n in (h, hkv, hkv))
            out = torch.empty_like(q)

            def call(fn):
                _build.check("flash_attention", fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b, h, hkv, t, t, d, int(causal),
                    int(win), 1, 1.0 / d ** 0.5, stream))

            want = ref.attention_ref(q, k, v, causal, win).float()
            allowed = TOL * (want.abs() + want.abs().amax(-1, keepdim=True))
            allowed = allowed.clamp_min(1e-30)
            row = {"shape": f"B={b} H={h} Hkv={hkv} T={t} D={d} "
                            f"causal={causal} window={win}"}
            for name, fn in fns.items():
                call(fn)
                worst = ((out.float() - want).abs() / allowed).max().item()
                if not worst <= 1.0:
                    raise RuntimeError(f"{name} at {row['shape']}: "
                                       f"{worst} x its allowance")
                row[f"{name}_err_over_allowed"] = worst
            names = list(fns)
            for name in names + names[::-1]:
                row.setdefault(f"{name}_ms", []).append(
                    median_ms(torch, lambda: call(fns[name])))
            if win == 0:
                row["sdpa_ms"] = median_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, enable_gqa=True))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
