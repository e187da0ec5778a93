"""Architecture registry of the port — `get_config(arch_id)` for the dense
presets of the JAX package's `configs/` (their files copied as they
stand) — and `SENSOR500`, the paper's own graph workload (Section IV-D /
VI).  The MoE, MLA, RWKV, hybrid, encoder-decoder and VLM presets come
with their mixers (ROADMAP.md, queue 1 item 11)."""
from __future__ import annotations

from typing import Dict, List

from . import (deepseek_7b, qwen1_5_32b, qwen1_5_4b, sensor500,
               starcoder2_3b)
from .base import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (deepseek_7b, starcoder2_3b, qwen1_5_4b, qwen1_5_32b)
}

ARCH_IDS: List[str] = list(_REGISTRY)
SENSOR500 = sensor500.CONFIG


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCH_IDS}")
    return _REGISTRY[name]


__all__ = ["ARCH_IDS", "SENSOR500", "ModelConfig", "get_config"]
