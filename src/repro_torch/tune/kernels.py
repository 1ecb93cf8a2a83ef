"""Per-kernel tile sweep on the card, feeding the plan search.

The twin of ``repro.tune.kernels``.  The plan-level tuner
(:mod:`repro_torch.tune.search`) ranks whole specs; this module ranks the
templates inside one spec's kernels: timed sweeps over each kernel's tile
grid (``KernelTuning`` values, ``repro_torch.kernels.tuning``) at the
plan's shapes, cached per ``(kernel, shape, batch, dtype, device)`` so a
search that lowers the same geometry twice pays for one sweep::

    from repro_torch.tune.kernels import plan_tuning, tuning_candidates

    kt = plan_tuning(spec, batch=32)        # measured best tiles, on the card
    pipe = build(spec.replace(kernel_tuning=kt), params)

    # or let the roofline search rank a static candidate set:
    space = enumerate_plan_space(base, kernel_tunings=tuning_candidates())

Each grid starts with the field's default value, which means the
wrapper's own per-shape rule; the rest are the card's templates.  On the
card a call is timed as device time: one untimed warm-up, then the median
of ``iters`` CUDA-event windows, each one replay of a CUDA graph of
``GRAPH_CALLS`` calls, per call (back-to-back calls of a short kernel
would time the Python wrapper).  ``device="cpu"`` times the plain
versions on the host clock, for the tests only: no number from it is the
card's.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import tuning as T
from repro_torch.kernels.tuning import DEFAULT_TUNING, KernelTuning

_D = DEFAULT_TUNING

#: Per-kernel sweep grids, the field's default (the wrapper's own rule)
#: first.  ``quick``: 2 a kernel; ``full``: every template the card has
#: (``knn``: six of its multiples of 8).
TILE_GRIDS: Dict[str, Dict[str, tuple]] = {
    "fused_linear": {
        "quick": (_D.fused_linear, (32, 32, 32)),
        "full": (_D.fused_linear, *T.FUSED_LINEAR_TILES)},
    "int8_matmul": {
        "quick": (_D.int8_matmul, (256, 64, 32)),
        "full": (_D.int8_matmul, *T.INT8_MATMUL_TILES)},
    "grouped_transfer": {
        "quick": (_D.grouped_transfer, 256),
        "full": (_D.grouped_transfer, *T.GROUPED_TRANSFER_ROWS)},
    "fps": {
        "quick": (_D.fps, 256),
        "full": (_D.fps, *(t for t in T.FPS_TILES if t != _D.fps))},
    "knn": {
        "quick": (_D.knn, 32),
        "full": (_D.knn, 8, 16, 32, 64, 256)},
    "flash_attention": {
        "quick": (_D.flash_attention, T.FLASH_TILES["ffma"]),
        "full": (_D.flash_attention, T.FLASH_TILES["ffma"])},
}

#: Calls a timed CUDA graph holds.
GRAPH_CALLS = 10

#: Sweep cache: (kernel, shape, batch, dtype, device name) -> [(tile,
#: ms a call), ...], fastest first.
_CACHE: Dict[Tuple, List[Tuple]] = {}


def clear_cache() -> None:
    _CACHE.clear()


def _known(kernel: str) -> None:
    if kernel not in TILE_GRIDS:
        raise KeyError(f"unknown tunable kernel {kernel!r}; known: "
                       f"{', '.join(sorted(TILE_GRIDS))}")


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def wrapper_tile(kernel: str, tile):
    """The ``tile=`` a wrapper takes for a ``KernelTuning`` value: None
    (its own rule) at the field's default."""
    return None if tile == getattr(DEFAULT_TUNING, kernel) else tile


def make_inputs(kernel: str, shape: tuple, *, batch: int = 1,
                dtype: str = "float32", device="cuda", seed: int = 0):
    """The inputs of one call of ``kernel`` at ``shape`` (JAX's sweep
    shapes) for a dispatch of ``batch`` clouds, from
    ``np.random.default_rng(seed)``, on ``device``:

    * ``fused_linear``/``int8_matmul`` (m, k, n): ``batch * m`` rows;
    * ``grouped_transfer`` (n, s, k, c): C_out = C, sigma computed inside;
    * ``fps`` (n, s); ``knn`` (s, n, k): xyz clouds;
    * ``flash_attention`` (h, t, d): ``max(h // 4, 1)`` KV heads, causal,
      in ``dtype`` (float32 or bfloat16).
    """
    _known(kernel)
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def normal(*dims, scale=1.0):
        a = (rng.standard_normal(dims) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    def ints(lo, hi, *dims, dt=np.int8):
        return torch.from_numpy(rng.integers(lo, hi, dims).astype(dt)).to(dev)

    if kernel == "fused_linear":
        m, k, n = shape
        return (normal(batch * m, k), normal(k, n, scale=0.05),
                normal(n, scale=0.1))
    if kernel == "int8_matmul":
        m, k, n = shape
        a_scale = torch.from_numpy(
            rng.uniform(0.01, 0.02, batch).astype(np.float32)).to(dev)
        return (ints(-128, 128, batch * m, k), ints(-128, 128, k, n),
                a_scale, normal(n, scale=0.01).abs(), m)
    if kernel == "grouped_transfer":
        n, s, k, c = shape
        feats = normal(batch, n, c)
        nidx = ints(0, n, batch, s, k, dt=np.int64)
        centers = torch.gather(feats, 1, ints(0, n, batch, s, 1, dt=np.int64)
                               .expand(-1, -1, c)).contiguous()
        return (feats, nidx, centers, normal(c), normal(c, scale=0.1),
                normal(2 * c, c, scale=0.05), normal(c, scale=0.1))
    if kernel == "fps":
        n, s = shape
        return normal(batch, n, 3), s
    if kernel == "knn":
        s, n, k = shape
        return normal(batch, s, 3), normal(batch, n, 3), k
    h, t, d = shape
    dt = getattr(torch, dtype)
    hkv = max(h // 4, 1)
    return (normal(batch, h, t, d).to(dt), normal(batch, hkv, t, d).to(dt),
            normal(batch, hkv, t, d).to(dt))


def run(kernel: str, args: tuple, tile):
    """One call of ``kernel``'s wrapper on ``args`` (from
    :func:`make_inputs`) at ``tile``: the kernel on CUDA tensors, the
    plain version (the tile checked) on CPU tensors."""
    from repro_torch.kernels import grouped_transfer, int8_matmul, ops
    tile = wrapper_tile(kernel, tile)
    if kernel == "fused_linear":
        return ops.fused_linear(*args, "relu", tile)
    if kernel == "int8_matmul":
        if args[0].is_cuda:
            return int8_matmul.int8_matmul_cuda(*args, tile)
        if tile is not None:
            T.card_tile(kernel, tile)
        return plain(kernel, args)
    if kernel == "grouped_transfer":
        feats, nidx, centers, alpha, beta, w, b = args
        return grouped_transfer.grouped_transfer(
            feats, nidx, centers, None, alpha, beta, w, b, tile=tile)
    if kernel == "fps":
        return ops.fps(*args, tile=tile)
    if kernel == "knn":
        return ops.knn_batched(*args, tile=tile)
    tq, tk = tile if tile is not None else DEFAULT_TUNING.flash_attention
    return ops.flash_attention(*args, causal=True, tq=tq, tk=tk)


def plain(kernel: str, args: tuple):
    """The plain PyTorch version of ``kernel`` on ``args``."""
    from repro_torch.kernels import ref
    if kernel == "fused_linear":
        return ref.fused_linear_ref(*args, "relu")
    if kernel == "int8_matmul":
        return ref.int8_matmul_ref(*args)
    if kernel == "grouped_transfer":
        feats, nidx, centers, alpha, beta, w, b = args
        return ref.grouped_transfer_ref(feats, nidx, centers, None, alpha,
                                        beta, w, b)
    if kernel == "fps":
        return ref.fps_ref(*args)
    if kernel == "knn":
        return ref.knn_ref(*args)
    return ref.attention_ref(*args, causal=True)


def template_name(kernel: str, args: tuple, tile) -> str:
    """The name of the template a call of :func:`run` launches on the card
    (the wrappers' ``.templates`` keys), for CUDA or CPU ``args``."""
    from repro_torch.kernels import (_build, flash_attention, fps,
                                     fused_linear, grouped_transfer,
                                     int8_matmul, knn)
    tile = wrapper_tile(kernel, tile)
    sms = (fused_linear._sm_count(args[0].device.index) if args[0].is_cuda
           else fused_linear.H100_SMS)
    if kernel == "fused_linear":
        x, w, _ = args
        return fused_linear.template(x.shape[0], x.shape[1], w.shape[1],
                                     _build.aligned16(x, w), sms, tile).name
    if kernel == "int8_matmul":
        x_q, w_q = args[:2]
        return int8_matmul.template(x_q.shape[1], w_q.shape[1],
                                    _build.aligned16(x_q, w_q), tile).name
    if kernel == "grouped_transfer":
        feats, nidx, centers, alpha, beta, w, _ = args
        b, s, k = nidx.shape
        t = grouped_transfer.template(
            b * s * k, feats.shape[2], w.shape[1],
            _build.aligned16(feats, centers, alpha, beta, w), sms, tile)
        return _build.GemmTemplate(t.bn, t.vec).name
    if kernel == "fps":
        points, _ = args
        return fps.template(points.shape[1], tile)
    if kernel == "knn":
        smp, pts, k = args
        return knn.template(smp.shape[0], smp.shape[1], pts.shape[1], k,
                            tile)
    q = args[0]
    rt = flash_attention.route(q.dtype, q.shape[-1])
    bq, bkv = (T.FLASH_TILES[rt] if tile is None
               else T.card_tile(kernel, tile, route=rt))
    return f"{rt}_{bq}x{bkv}"


def time_call(fn, iters: int, device: torch.device) -> float:
    """ms a call of ``fn``: one untimed warm-up call, then the median of
    ``iters`` timings (on the card: CUDA-event windows over one replay of
    a graph of :data:`GRAPH_CALLS` calls; on the CPU: the host clock)."""
    fn()
    iters = max(iters, 1)
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_CALLS)
    del graph
    return statistics.median(times)


def sweep(kernel: str, shape: tuple, *, device=None, batch: int = 1,
          dtype: str = "float32", grid: Optional[tuple] = None,
          quick: bool = False, iters: int = 5, seed: int = 0
          ) -> List[Tuple]:
    """Timed tile sweep of one kernel at one shape.

    Returns ``[(tile, ms a call), ...]`` sorted fastest first (ties by the
    tile's text), served from the module cache on a repeat ``(kernel,
    shape, batch, dtype, device name)``.  ``grid`` overrides the builtin
    grid; ``quick`` selects the 2-point one.  A tile whose call raises
    (one the kernel lacks, or cannot take at this shape) is skipped; an
    empty sweep raises ``ValueError``.  ``device`` None means ``cuda``
    (raising without a GPU); ``"cpu"`` times the plain versions.
    """
    from repro_torch.api.build import resolve_device
    _known(kernel)
    dev = resolve_device(device)
    key = (kernel, tuple(shape), batch, str(dtype), _device_name(dev))
    if key in _CACHE:
        return _CACHE[key]
    tiles = grid if grid is not None else \
        TILE_GRIDS[kernel]["quick" if quick else "full"]
    args = make_inputs(kernel, shape, batch=batch, dtype=dtype, device=dev,
                       seed=seed)
    table: List[Tuple] = []
    errs = []
    for tile in tiles:
        try:
            ms = time_call(lambda: run(kernel, args, tile), iters, dev)
        except (ValueError, TypeError) as e:     # a tile it cannot take
            errs.append(f"{tile}: {type(e).__name__}: {e}")
            continue
        table.append((tile, ms))
    if not table:
        raise ValueError(f"tile sweep for {kernel} at shape {shape} "
                         f"produced no timing: every tile failed "
                         f"({'; '.join(errs)})")
    table.sort(key=lambda r: (r[1], str(r[0])))
    _CACHE[key] = table
    return table


def best_tile(kernel: str, shape: tuple, **kw):
    """The fastest tile from :func:`sweep` (cached)."""
    return sweep(kernel, shape, **kw)[0][0]


def plan_shapes(spec) -> Dict[str, tuple]:
    """The shapes each tunable kernel runs at under ``spec``, per cloud
    (``repro.tune.kernels.plan_shapes``'s dict): the product kernels at
    the FLOP-heaviest transfer layer, the mapping kernels at stage 1.
    ``flash_attention`` has no site in the point pipeline."""
    cfg = spec.to_model_config()
    dims = [cfg.embed_dim] + list(cfg.stage_dims)
    k = cfg.k_neighbors
    s_best = max(range(len(cfg.stage_dims)),
                 key=lambda s: (cfg.stage_samples[s] * k
                                * 2 * dims[s] * dims[s + 1]))
    mm_shape = (cfg.stage_samples[s_best] * k, 2 * dims[s_best],
                dims[s_best + 1])
    return {
        "fused_linear": mm_shape,
        "int8_matmul": mm_shape,
        "grouped_transfer": (cfg.n_points, cfg.stage_samples[0], k,
                             cfg.embed_dim),
        "fps": (cfg.n_points, cfg.stage_samples[0]),
        "knn": (cfg.stage_samples[0], cfg.n_points, k),
    }


def plan_tuning(spec, *, batch: int = 1, quick: bool = False,
                iters: int = 5, device=None) -> KernelTuning:
    """The measured-best :class:`KernelTuning` for ``spec`` at a dispatch
    of ``batch`` clouds: one sweep a tunable kernel at the plan's shapes
    (cached); ``flash_attention`` keeps its default.  ``device`` as in
    :func:`sweep` (the card by default)."""
    shapes = plan_shapes(spec)
    kw = dict(batch=batch, quick=quick, iters=iters, device=device)
    return KernelTuning(**{k: best_tile(k, shape, **kw)
                           for k, shape in shapes.items()})


#: ``tuning_candidates``' smaller and larger tiles: templates every
#: kernel has at every shape (the kNN tile needs N <= 1024 and k <= 32).
SMALL_TILES = KernelTuning(fused_linear=(32, 32, 32),
                           int8_matmul=(256, 64, 32), grouped_transfer=256,
                           fps=256, knn=32)
LARGE_TILES = KernelTuning(fused_linear=(128, 16, 128),
                           int8_matmul=(128, 64, 128), grouped_transfer=128,
                           fps=2048, knn=256)


def tuning_candidates(quick: bool = True) -> Tuple[KernelTuning, ...]:
    """A static :class:`KernelTuning` candidate set for
    ``enumerate_plan_space(..., kernel_tunings=...)`` (no timing: the
    roofline estimate ranks them by the card's tile waste), in the order
    of ``repro.tune.kernels.tuning_candidates``: the defaults, the small
    tiles, and (``quick=False``) the large ones."""
    if quick:
        return (DEFAULT_TUNING, SMALL_TILES)
    return (DEFAULT_TUNING, SMALL_TILES, LARGE_TILES)
