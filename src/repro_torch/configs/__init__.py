"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

One module per assigned architecture; ids match the assignment table.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .base import ArchConfig, ShapeSpec, SHAPES

from . import (
    seamless_m4t_large_v2,
    qwen3_32b,
    phi3_medium_14b,
    gemma_2b,
    qwen2_5_3b,
    kimi_k2_1t_a32b,
    deepseek_v2_236b,
    zamba2_7b,
    xlstm_1_3b,
    phi3_vision_4_2b,
)

_MODULES = {
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "qwen3-32b": qwen3_32b,
    "phi3-medium-14b": phi3_medium_14b,
    "gemma-2b": gemma_2b,
    "qwen2.5-3b": qwen2_5_3b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "zamba2-7b": zamba2_7b,
    "xlstm-1.3b": xlstm_1_3b,
    "phi-3-vision-4.2b": phi3_vision_4_2b,
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    try:
        return _MODULES[arch_id].CONFIG
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")


def get_smoke(arch_id: str) -> ArchConfig:
    try:
        return _MODULES[arch_id].smoke()
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")


def shape_applies(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False
    return True


def cells(include_inapplicable: bool = False):
    """All (arch_id, shape) evaluation cells per the assignment."""
    out = []
    for aid in ARCH_IDS:
        cfg = get_config(aid)
        for shp in SHAPES:
            if include_inapplicable or shape_applies(cfg, shp):
                out.append((aid, shp))
    return out


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "get_config",
           "get_smoke", "shape_applies", "cells"]
