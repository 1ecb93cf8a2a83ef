"""The port's example scripts run on the CPU (``--device cpu``).

Each twin of a JAX example (``examples/torch_serve_pointcloud.py``,
``torch_serve_async.py``, ``torch_serve_fleet.py``,
``torch_serve_stream.py``, ``torch_serve_lm.py``) runs once at its
smallest flags in a subprocess; the five start together and share this
worker's cores (one intra-op thread each).  Each test reads its script's
exit code and the lines that show the demo did its work: the queue
drained in fixed-shape batches, every async client answered, the burst
shed and every admitted request resolved, stream hits and the replay
bitwise the cold dispatch, the MoE LM generating its tokens.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch  # noqa: F401
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# script -> its smallest flags
RUNS = {
    "torch_serve_pointcloud": ["--requests", "3", "--batch", "2", "--int8"],
    "torch_serve_async": ["--requests", "3", "--batch", "2",
                          "--gap-ms", "1"],
    "torch_serve_fleet": ["--replicas", "1", "--batch", "2",
                          "--max-inflight", "2", "--burst", "4"],
    "torch_serve_stream": ["--frames", "4", "--n-points", "128"],
    "torch_serve_lm": ["--arch", "moonshot-v1-16b-a3b", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"],
}


@pytest.fixture(scope="module")
def outputs():
    """Every script's (exit code, output), the five run at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *flags,
         "--device", "cpu"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, flags in RUNS.items()}
    out = {}
    try:
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=300)
            out[name] = (proc.returncode, log)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _ran(outputs, name):
    rc, log = outputs[name]
    assert rc == 0, f"{name} exited {rc}:\n{log}"
    return log


def test_serve_pointcloud(outputs):
    log = _ran(outputs, "torch_serve_pointcloud")
    assert log.count("  request ") == 3
    assert "3 requests in 2 fixed-shape batches (1 pad lanes)" in log


def test_serve_async(outputs):
    log = _ran(outputs, "torch_serve_async")
    assert log.count(")  latency ") == 3
    assert "3 requests in " in log and "p50/p95 queue latency" in log


def test_serve_fleet(outputs):
    log = _ran(outputs, "torch_serve_fleet")
    assert log.count("  shed: ") == 2
    assert "admitted 2/4; every admitted request resolved (0 pending)" in log
    assert "lidar      tier=lite-int8" in log


def test_serve_stream(outputs):
    log = _ran(outputs, "torch_serve_stream")
    assert "steady scan: 4 frames, 3 hits" in log
    assert "cold-vs-stream bitwise equal: True" in log
    assert "seg head: per-point logits (128, " in log


def test_serve_lm(outputs):
    log = _ran(outputs, "torch_serve_lm")
    assert "arch=moonshot-v1-16b-a3b batch=2 prompt=8 gen=4" in log
    ids = log.split("first request ids:")[1].splitlines()[0]
    assert len(ast.literal_eval(ids.strip())) == 4
