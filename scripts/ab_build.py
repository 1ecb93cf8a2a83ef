"""Build copies of a port kernel source for the A/B scripts.

``build`` compiles each source with its own ``nvcc`` process (all
started together) and binds its ``<kernel>_launch`` through ``ctypes``,
the argument types read from the source's own ``extern "C"`` signature,
so a parent commit's copy with an older signature binds as it is.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess

NVCC = "/usr/local/cuda/bin/nvcc"


def argtypes(src: pathlib.Path, symbol: str) -> list:
    """ctypes argument types of ``extern "C" int symbol(...)`` in src."""
    params = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)",
                       src.read_text()).group(1)
    return [ctypes.c_void_p if "*" in p else
            ctypes.c_longlong if "long long" in p else
            ctypes.c_float if "float" in p else ctypes.c_int
            for p in params.split(",")]


def build(kernel, sources, build_dir, flags, ptxas=False, ptxas_dir=None):
    """Compile {name: path} in parallel with ``flags`` (and ``-I`` the
    port's csrc, for its headers); -> {name: launch function}.

    ``ptxas`` adds ``-Xptxas -v`` and prints one JSON line a source with
    each kernel template's registers and any spills; ``ptxas_dir`` also
    keeps each whole report there as ``ptxas-<kernel>-<name>.txt``.
    """
    from repro_torch.kernels import _build
    symbol = f"{kernel}_launch"
    procs = {}
    for name, src in sources.items():
        so = pathlib.Path(build_dir) / f"{kernel}-{name}.so"
        cmd = [NVCC, *flags, "-I", str(_build.CSRC),
               *(["-Xptxas", "-v"] if ptxas else []), "-o", str(so),
               str(src)]
        procs[name] = (pathlib.Path(src), so, subprocess.Popen(
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
            spills = [ln for ln in log.splitlines() if "spill" in ln
                      and " 0 bytes spill stores" not in ln]
            info = [ln.split("ptxas info    : ")[-1] for ln in
                    log.splitlines() if "registers" in ln or ln in spills]
            print(json.dumps({"ptxas": f"{kernel} {name}",
                              "spilling_lines": len(spills), "info": info}),
                  flush=True)
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes = argtypes(src, symbol)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns
