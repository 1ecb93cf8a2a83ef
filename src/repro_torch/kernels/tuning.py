"""Per-kernel tile-size configuration, copied from ``repro.kernels.tuning``.

``PipelineSpec.kernel_tuning`` carries a :class:`KernelTuning` so the
port's spec fields mirror the JAX spec's.  The CUDA kernels use fixed
tiles, so ``build`` raises ``NotImplementedError`` for any tuning other
than ``DEFAULT_TUNING``.  The field names keep the JAX kernels' names.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def _check_tile(name: str, v, n: int) -> None:
    vs = v if isinstance(v, tuple) else (v,)
    if isinstance(v, tuple) and len(v) != n:
        raise ValueError(f"KernelTuning.{name} wants {n} tile dims, got {v!r}")
    for t in vs:
        if not isinstance(t, int) or isinstance(t, bool) or t <= 0:
            raise ValueError(
                f"KernelTuning.{name} tiles must be positive ints, got {v!r}")


@dataclasses.dataclass(frozen=True)
class KernelTuning:
    """Frozen per-kernel tile sizes (the defaults reproduce the kernels'
    historical hardcoded values, so ``DEFAULT_TUNING`` is a no-op).

    Fields mirror the kernel signatures:
      * ``fused_linear``: (tm, tk, tn) for the fused CBR matmul.
      * ``grouped_transfer``: tile_s — sample-rows per grid step of the
        fused gather+normalize+affine+transfer kernel.
      * ``int8_matmul``: (tm, tk, tn) for the int8 MXU matmul.
      * ``fps``: tile_n — points per distance-update tile.
      * ``knn``: tile_s — query rows per grid step.
      * ``flash_attention``: (tq, tk) — query/key tile lengths.
    """
    fused_linear: Tuple[int, int, int] = (128, 128, 128)
    grouped_transfer: int = 64
    int8_matmul: Tuple[int, int, int] = (128, 128, 128)
    fps: int = 512
    knn: int = 128
    flash_attention: Tuple[int, int] = (128, 128)

    def __post_init__(self):
        for name, n in (("fused_linear", 3), ("int8_matmul", 3),
                        ("flash_attention", 2)):
            v = getattr(self, name)
            if isinstance(v, list):
                object.__setattr__(self, name, tuple(v))
            _check_tile(name, getattr(self, name), n)
        for name in ("grouped_transfer", "fps", "knn"):
            _check_tile(name, getattr(self, name), 1)

    def replace(self, **kw) -> "KernelTuning":
        return dataclasses.replace(self, **kw)


DEFAULT_TUNING = KernelTuning()
