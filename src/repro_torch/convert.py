"""Carry a parameter tree from the JAX package into the port.

``from_numpy_tree`` takes a tree whose leaves are NumPy arrays (a test
turns a JAX tree into one with ``jax.tree_util.tree_map(np.asarray,
params)``) and returns the port's tree: the same nesting, lists and
dict keys, with tensors on ``device``.  Raw trees (with ``bn`` entries)
are fused and exported by the port's own ``build``; frozen trees from
``repro.api.build(...).params`` keep their int8 ``q`` and f32 ``scale``
exactly.  bf16 leaves (NumPy's ``ml_dtypes`` ``bfloat16``, which
``torch.from_numpy`` does not take) cross bit for bit through their
16-bit patterns.  Stacked per-layer leaves (``[L, ...]``, as the JAX
``lm_init`` makes them) keep their layout.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def from_numpy_tree(tree: Any, device="cpu") -> Any:
    """NumPy-leaved nested dict/list/tuple tree -> tensor tree on
    ``device`` (dtypes kept: int8 stays int8, float32 stays float32,
    bfloat16 becomes ``torch.bfloat16`` with the same bits)."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        arr = np.array(tree)
        if arr.dtype.name == "bfloat16":
            bits = torch.from_numpy(arr.view(np.int16))
            return bits.view(torch.bfloat16).to(device)
        return torch.from_numpy(arr).to(device)
    raise TypeError(f"from_numpy_tree: unsupported leaf "
                    f"{type(tree).__name__}; convert JAX arrays with "
                    f"np.asarray first")
