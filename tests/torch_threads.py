"""Caps torch's intra-op threads in a pytest-xdist worker, on import.

Each worker's torch opens one intra-op thread a core by default, so six
workers on eight cores run 48 threads that wait on one another.  Under
xdist (``PYTEST_XDIST_WORKER`` set) a worker takes its share of the
cores, ``max(1, cpu_count // PYTEST_XDIST_WORKER_COUNT)``; elsewhere
torch keeps its own count.  The port's test files import this module
first thing after torch (``tests/`` is on ``sys.path`` under pytest and
for a test file run as a script).
"""
import os

import torch


def share() -> int:
    """This worker's share of the cores (0: not an xdist worker)."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return 0
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(1, workers))


if share():
    torch.set_num_threads(share())
