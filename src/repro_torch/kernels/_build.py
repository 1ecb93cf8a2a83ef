"""Build and load the CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exports a plain C launch function and compiles,
with its own ``nvcc`` process (all started together), into
``build/repro_torch/<name>-<hash>.so`` at the repository root, for
``sm_90a``.  The hash covers the source, every shared header
(``csrc/*.cuh``, which a source includes from its own directory) and the
flags, so an edited source or header rebuilds and an unchanged one loads
from disk.  The libraries are
loaded with ``ctypes``: every pointer and the stream pass as
``c_void_p``, every int as ``c_int`` (a scratch buffer's length as
``c_longlong``), every float as ``c_float``, and each launch function
returns its ``cudaGetLastError()`` code.

Nothing here runs at import: the CPU tests import every module without
``nvcc``.  Only the repository's own sources are compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List, NamedTuple, Tuple

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# Per-source extra flags: the kNN and FPS distances and the fused
# group's normalization must round every product and sum on its own, as
# the plain versions do (no FMA contraction; an explicit fmaf stays fused).
EXTRA_FLAGS: Dict[str, List[str]] = {"knn": ["--fmad=false"],
                                     "fps": ["--fmad=false"],
                                     "grouped_transfer": ["--fmad=false"]}

P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
              ctypes.c_float)
# name -> (C symbol, argtypes); every launch function returns an int.
SIGNATURES: Dict[str, Tuple[str, list]] = {
    "knn": ("knn_launch", [P, P, P, P, L, I, I, I, I, I, F, P]),
    "int8_matmul": ("int8_matmul_launch", [P] * 5 + [I] * 5 + [P]),
    "fused_linear": ("fused_linear_launch", [P] * 4 + [I] * 5 + [P]),
    "fps": ("fps_launch", [P, P, P, L, I, I, I, P]),
    "grouped_transfer": ("grouped_transfer_launch",
                         [P] * 10 + [I] * 10 + [P]),
    "w8_matmul": ("w8_matmul_launch", [P] * 5 + [I] * 6 + [P]),
    "flash_attention": ("flash_attention_launch",
                        [P] * 4 + [I] * 9 + [F, P]),
}

# The column-tile widths of the two GEMM kernels' templates
# (csrc/int8_matmul.cu, csrc/fused_linear.cu).  A launch passes
# tmpl = vec + 2 * TILE_WIDTHS.index(BN) + 8 * small.
TILE_WIDTHS = (16, 32, 64, 128)


class GemmTemplate(NamedTuple):
    """A GEMM kernel's template: its column tile ``bn``, its load route
    (``vec``: 16-byte copies and stores; else scalar, masked) and, for
    ``fused_linear``, whether it is the small tile (``small``: 4 outputs
    a thread, for products that the wide tile leaves the card idle on)."""
    bn: int
    vec: bool
    small: bool = False

    @property
    def code(self) -> int:
        return int(self.vec) + 2 * TILE_WIDTHS.index(self.bn) + 8 * self.small

    @property
    def name(self) -> str:
        return (f"bn{self.bn}{'_small' if self.small else ''}_"
                f"{'vec' if self.vec else 'scalar'}")


def gemm_template(n: int, vec: bool) -> GemmTemplate:
    """The narrowest column tile that covers ``n`` columns (the widest
    past 128), with the given load route."""
    bn = next((t for t in TILE_WIDTHS if t >= n), TILE_WIDTHS[-1])
    return GemmTemplate(bn, vec)


def aligned16(*ts) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    default = pathlib.Path(home) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str, csrc: pathlib.Path = CSRC
            ) -> Tuple[pathlib.Path, List[str]]:
    """The library a build of ``<csrc>/<name>.cu`` makes, and its flags."""
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so", flags


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every stale kernel library in parallel, load them all.

    Raises ``RuntimeError`` with the compiler's output if a build fails.
    """
    with _lock:
        if len(_libs) == len(SIGNATURES):
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in SIGNATURES:
            out, flags = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, out, tmp, proc))
        errors = []
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name, (symbol, argtypes) in SIGNATURES.items():
            lib = ctypes.CDLL(str(_target(name)[0]))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return dict(_libs)


def launcher(name: str):
    """The C launch function of kernel ``name`` (building at first use)."""
    lib = _libs.get(name) or build_all()[name]
    return getattr(lib, SIGNATURES[name][0])


def check(name: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{code}")
