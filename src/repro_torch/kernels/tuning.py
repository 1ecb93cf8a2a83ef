"""Per-kernel tile configuration, and the tiles each CUDA kernel has.

:class:`KernelTuning` is a copy of ``repro.kernels.tuning.KernelTuning``:
the same field names, tuple arity, defaults and checks, so a spec's
fingerprint and label read the same in both packages.  ``PipelineSpec.
kernel_tuning`` carries it and ``repro_torch.api.plan.lower`` binds the
pinned tiles onto each op.

On the card a field names one of the kernel's own templates:

=====================  ==============================  =======================
field                  what it pins on the card        tiles the card has
=====================  ==============================  =======================
``fused_linear``       (BM, BK, BN) of a template of   wide (128, 16, 128),
(tm, tk, tn)           ``csrc/fused_linear.cu``: the   (128, 16, 64),
                       wide tile (BK 16) or the small  (256, 16, 32),
                       one (BK 32)                     (256, 16, 16); small
                                                       (32, 32, 32),
                                                       (64, 32, 16)
``int8_matmul``        (BM, BK, BN) of a template of   (128, 64, 128),
(tm, tk, tn)           ``csrc/int8_matmul.cu`` (BM on  (256, 64, 64),
                       its 16-byte route; the scalar   (256, 64, 32),
                       route halves it)                (256, 64, 16)
``grouped_transfer``   rows of the product a block     128 (BN 64 or 128),
                       (BM) of the wide tile that      256 (BN 16 or 32)
                       ``csrc/grouped_transfer.cu``
                       runs; BN follows C_out within
                       that row tile
``fps``                the register tile THREADS * 8   256, 512, ..., 8192;
                       of ``fps_kernel``; a cloud      a cloud past the tile
                       larger than it runs the TAIL    keeps the rest in a
                       variant at that THREADS         scratch tail
``knn``                queries a block of             any multiple of 8,
                       ``knn_kernel`` (8 warps, tile  where N <= 1024 and
                       / 8 queries a warp)            k <= 32 (the rounds
                                                       kernel has no tile)
``flash_attention``    (BQ, BKV) of the route that     ``ffma`` (64, 64),
(tq, tk)               dtype and head dim select       ``wgmma`` (128, 128)
=====================  ==============================  =======================

A field at its default value means the wrapper's own per-shape rule, as
before tiles could be pinned: ``DEFAULT_TUNING`` launches the same
templates, the same number of times, with the same bits.  Any other
value pins one template: it is launched as named, or the call raises
``ValueError`` naming the tiles the kernel has; it is never replaced by
the wrapper's choice.  (So a default value that is also a card tile,
``knn=128`` or ``fps=512``, cannot be pinned: it means the rule.)

Every tile gives the same bits: the int8 sums are exact, the kNN and FPS
indices do not depend on how the work is split, and every fp32 output is
one in-order fmaf chain whatever the tile.

Nothing here imports torch: the spec module imports this one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


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

    What each names on the card is in the module docstring.
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

#: The tunable kernels, one a ``KernelTuning`` field.
KERNELS = ("fused_linear", "int8_matmul", "grouped_transfer", "knn", "fps",
           "flash_attention")

# The card's templates, read off the sources.  fused_linear: (BM, BK, BN)
# -> (BN, small); fp32_wide_tile.cuh's Wide<BN> (BM 128 at BN >= 64, else
# 256; BK 16) and fused_linear.cu's Small<BN> (one row and 4 columns a
# thread: BM 64 at BN 16, 32 at BN 32; SBK 32).
FUSED_LINEAR_TILES: Dict[Tuple[int, int, int], Tuple[int, bool]] = {
    (128, 16, 128): (128, False), (128, 16, 64): (64, False),
    (256, 16, 32): (32, False), (256, 16, 16): (16, False),
    (32, 32, 32): (32, True), (64, 32, 16): (16, True)}
# int8_matmul.cu's Tile<BN, true>: (BM, BK, BN) -> BN (BK: 64-byte ring
# chunks; BM 128 at BN 128, else 256).
INT8_MATMUL_TILES: Dict[Tuple[int, int, int], int] = {
    (128, 64, 128): 128, (256, 64, 64): 64, (256, 64, 32): 32,
    (256, 64, 16): 16}
# grouped_transfer.cu runs fp32_wide_tile.cuh's Wide<BN>: rows a block ->
# the column tiles of that row tile.
GROUPED_TRANSFER_ROWS: Dict[int, Tuple[int, ...]] = {128: (64, 128),
                                                     256: (16, 32)}
# fps.cu: THREADS in 32 .. 1024, 8 points a thread in registers.
FPS_POINTS_PER_THREAD = 8
FPS_TILES = tuple(FPS_POINTS_PER_THREAD * t
                  for t in (32, 64, 128, 256, 512, 1024))
# knn.cu's knn_kernel: 8 warps a block; past these sizes the rounds
# kernel runs, 4 warps a block, no query tile.
KNN_WARPS = 8
KNN_SELECT_K, KNN_SELECT_POINTS = 32, 1024
# flash_attention.cu: each route's (BQ, BKV).
FLASH_TILES: Dict[str, Tuple[int, int]] = {"ffma": (64, 64),
                                           "wgmma": (128, 128)}


def _lacks(kernel: str, tile, has: str):
    return ValueError(f"{kernel}: the card has no tile {tile!r}; it has "
                      f"{has}")


def card_tile(kernel: str, tile, shape: Optional[tuple] = None, *,
              route: Optional[str] = None):
    """The launch parameter that ``tile`` pins for ``kernel`` on the card.

    Returns: ``fused_linear`` (BN, small); ``int8_matmul`` BN;
    ``grouped_transfer`` BM (rows a block); ``fps`` THREADS; ``knn``
    queries a warp; ``flash_attention`` the (BQ, BKV) of ``route``.
    ``shape`` is ``knn``'s (N, k), where given: the rounds kernel runs
    past N = 1024 or k = 32 and has no query tile.  ``route`` is
    ``flash_attention``'s (``kernels.flash_attention.route``); without
    it a tile of either route passes.  Raises ``ValueError`` naming the
    tiles the kernel has.
    """
    if kernel == "fused_linear":
        if tuple(tile) not in FUSED_LINEAR_TILES:
            raise _lacks(kernel, tile, ", ".join(map(str,
                                                     FUSED_LINEAR_TILES)))
        return FUSED_LINEAR_TILES[tuple(tile)]
    if kernel == "int8_matmul":
        if tuple(tile) not in INT8_MATMUL_TILES:
            raise _lacks(kernel, tile, ", ".join(map(str,
                                                     INT8_MATMUL_TILES)))
        return INT8_MATMUL_TILES[tuple(tile)]
    if kernel == "grouped_transfer":
        if tile not in GROUPED_TRANSFER_ROWS:
            raise _lacks(kernel, tile, "rows a block 128 (BN 64, 128) and "
                                       "256 (BN 16, 32)")
        return tile
    if kernel == "fps":
        if tile not in FPS_TILES:
            raise _lacks(kernel, tile, f"register tiles {FPS_TILES}")
        return tile // FPS_POINTS_PER_THREAD
    if kernel == "knn":
        if not isinstance(tile, int) or tile <= 0 or tile % KNN_WARPS:
            raise _lacks(kernel, tile, f"queries a block in multiples of "
                                       f"{KNN_WARPS}")
        if shape is not None:
            n, k = shape
            if k > KNN_SELECT_K or n > KNN_SELECT_POINTS:
                raise ValueError(
                    f"knn: a query tile pins knn_kernel, which takes "
                    f"N <= {KNN_SELECT_POINTS} and k <= {KNN_SELECT_K}; at "
                    f"N={n}, k={k} the rounds kernel runs, which has none")
        return tile // KNN_WARPS
    if kernel == "flash_attention":
        tile = tuple(tile)
        have = ({route: FLASH_TILES[route]} if route is not None
                else FLASH_TILES)
        if tile not in have.values():
            raise _lacks(kernel, tile, ", ".join(
                f"{r} {t}" for r, t in have.items()))
        return tile
    raise KeyError(f"unknown tunable kernel {kernel!r}; known: "
                   f"{', '.join(KERNELS)}")


def pinned(kernel: str, tuning: Optional[KernelTuning]):
    """``tuning``'s field for ``kernel``, or None at its default value
    (the wrapper's own rule) or when ``tuning`` is None."""
    if tuning is None:
        return None
    tile = getattr(tuning, kernel)
    return None if tile == getattr(DEFAULT_TUNING, kernel) else tile


def resolve(kernel: str, tuning: Optional[KernelTuning],
            shape: Optional[tuple] = None, *, route: Optional[str] = None):
    """The card's launch parameter that ``tuning`` pins for ``kernel``
    (see :func:`card_tile`), or None where the field is at its default:
    the wrapper's own per-shape rule."""
    tile = pinned(kernel, tuning)
    return None if tile is None else card_tile(kernel, tile, shape,
                                               route=route)


def check(tuning: Optional[KernelTuning]) -> None:
    """Raise ``ValueError`` for any pinned field that names a tile its
    kernel lacks (the shape-free part of :func:`card_tile`)."""
    for kernel in KERNELS:
        resolve(kernel, tuning)


def grouped_transfer_bn(rows: int, c_out: int) -> int:
    """The column tile of ``grouped_transfer``'s row tile ``rows``: the
    narrowest of that row tile's that covers ``c_out``, else its widest."""
    bns = GROUPED_TRANSFER_ROWS[rows]
    return next((bn for bn in bns if bn >= c_out), bns[-1])


def template_tile(kernel: str, bn: int, small: bool = False,
                  vec: bool = True) -> Tuple[int, int, int]:
    """(BM, BK, BN) of the template a GEMM launch takes, from its column
    tile: ``fused_linear``'s wide or small tile, ``int8_matmul``'s (half
    the rows on its scalar route), or ``grouped_transfer``'s wide tile."""
    if kernel == "int8_matmul":
        bm, bk, _ = next(t for t, b in INT8_MATMUL_TILES.items() if b == bn)
        return (bm if vec else bm // 2, bk, bn)
    if kernel == "grouped_transfer":
        small = False
    return next(t for t, v in FUSED_LINEAR_TILES.items() if v == (bn, small))
