"""Architecture registry: ``--arch <id>`` resolution, as ``repro.configs``.

``get_config``/``get_smoke_config`` resolve each of the JAX package's
ten archs (decoder, MoE and VLM; the Whisper encoder-decoder; xLSTM;
Hymba) to the same values; an unknown id raises ``KeyError``.
``LM_SHAPES`` and ``cell_is_runnable`` are the dry-run's cells.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (LM_SHAPES, ModelConfig, ShapeConfig,
                                      cell_is_runnable, shape_for)

_ARCH_MODULES: Dict[str, str] = {
    "whisper-tiny": "whisper_tiny",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "yi-9b": "yi_9b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "minitron-8b": "minitron_8b",
    "llama3.2-1b": "llama3_2_1b",
    "internvl2-26b": "internvl2_26b",
    "xlstm-1.3b": "xlstm_1_3b",
    "hymba-1.5b": "hymba_1_5b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {list_archs()}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


__all__ = ["LM_SHAPES", "ModelConfig", "ShapeConfig", "cell_is_runnable",
           "get_config", "get_smoke_config", "list_archs", "shape_for"]
