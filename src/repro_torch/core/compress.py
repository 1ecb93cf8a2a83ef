"""The HLS4PC compression ladder (Fig. 1, Table 1, Fig. 4), in PyTorch.

The port of ``repro.core.compress``.  :func:`compression_ladder` lists
the paper's variants::

    Elite (FPS, affine, BN, fp32, 1024 points)
    M-1 (URS, alpha/beta pruned, BN fused, 1024)
    M-2 (... 512)   M-3 (... 256)   M-4 (... 128)
    Lite = M-2 + 8/8 quantization (the Pareto point of Fig. 4)

:func:`precision_sweep` is Fig. 4's W/A sweep over the M-2 topology, and
:func:`compress` the deploy-side transform after training: exact BN
fusion, then the int8 weight export.  Its backend keys are the port's
``int8_ref`` (dequantized-weight matmul) and ``int8_cuda`` (W8A8 through
the int8 kernel), in place of ``int8_pallas``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

from repro_torch.core import fusion as F
from repro_torch.core import quant as Q
from repro_torch.models.pointmlp import (PointMLPConfig, pointmlp_elite_config,
                                         pointmlp_lite_config,
                                         pointmlp_m2_config)


def compression_ladder(n_classes: int = 40) -> List[PointMLPConfig]:
    """Table 1's rungs: Elite, M-1 .. M-4 (URS, ``norm``), Lite."""
    elite = pointmlp_elite_config(n_classes)
    base = elite.replace(sampler="urs", affine_mode="norm")
    return [
        elite,
        base.replace(name="M-1", n_points=1024),
        base.replace(name="M-2", n_points=512),
        base.replace(name="M-3", n_points=256),
        base.replace(name="M-4", n_points=128),
        pointmlp_lite_config(n_classes),
    ]


def precision_sweep(n_classes: int = 40) -> List[PointMLPConfig]:
    """Fig. 4's Pareto sweep: W/A bits over the M-2 topology."""
    m2 = pointmlp_m2_config(n_classes)
    return [m2.replace(name=f"M-2-w{wb}a{ab}",
                       quant=Q.QuantConfig(w_bits=wb, a_bits=ab))
            for wb, ab in [(32, 32), (16, 16), (8, 8), (6, 6), (4, 4),
                           (8, 16), (4, 8)]]


@dataclasses.dataclass
class CompressionReport:
    name: str
    size_bytes: int
    size_ratio_vs_f32: float
    bn_blocks_fused: int


def compress(params: Any, cfg: PointMLPConfig, backend: str = "int8_ref"
             ) -> Tuple[Any, PointMLPConfig, CompressionReport]:
    """Deploy-side transform: fuse BN exactly, then export int8 weights
    (where the config quantizes and ``w_bits <= 8``).

    Returns (deploy params, deploy config with ``use_bn=False`` and the
    quant config's ``backend``, report).
    """
    f32_size = Q.tree_size_bytes(params)
    n_bn = F.count_bn_blocks(params)
    fused = F.fuse_tree(params)
    qcfg = (dataclasses.replace(cfg.quant, backend=backend)
            if cfg.quant.enabled else cfg.quant)
    if cfg.quant.enabled and cfg.quant.w_bits <= 8:
        deploy = Q.quantize_tree(fused, qcfg)
    else:
        deploy = fused
    size = Q.tree_size_bytes(deploy)
    report = CompressionReport(name=cfg.name, size_bytes=size,
                               size_ratio_vs_f32=f32_size / max(size, 1),
                               bn_blocks_fused=n_bn)
    return deploy, cfg.replace(use_bn=False, quant=qcfg), report
