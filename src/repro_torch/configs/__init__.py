"""Architecture registry of the port — `get_config(arch_id)` for every
preset of the JAX package's `configs/` (their files copied as they
stand, registered in the same order), its shape specs, and `SENSOR500`,
the paper's own graph workload (Section IV-D / VI)."""
from __future__ import annotations

from typing import Dict, List

from . import (deepseek_7b, deepseek_v2_236b, hymba_1_5b, qwen1_5_32b,
               qwen1_5_4b, qwen2_vl_2b, qwen3_moe_30b_a3b, rwkv6_1_6b,
               sensor500, starcoder2_3b, whisper_large_v3)
from .base import SHAPES, ModelConfig, ShapeSpec, shape_applicable

_REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (deepseek_7b, starcoder2_3b, qwen1_5_4b, qwen1_5_32b,
              deepseek_v2_236b, qwen3_moe_30b_a3b, whisper_large_v3,
              rwkv6_1_6b, hymba_1_5b, qwen2_vl_2b)
}

ARCH_IDS: List[str] = list(_REGISTRY)
SENSOR500 = sensor500.CONFIG


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCH_IDS}")
    return _REGISTRY[name]


__all__ = ["ARCH_IDS", "SHAPES", "SENSOR500", "ModelConfig", "ShapeSpec",
           "get_config", "shape_applicable"]
