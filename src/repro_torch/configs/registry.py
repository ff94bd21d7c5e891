"""Architecture registry: ``get_config(arch_id)`` resolves ``--arch``
over the reference's ten archs, in the reference's order."""
from __future__ import annotations

import importlib

from .base import ModelConfig, reduced_for_smoke

__all__ = ["ARCHS", "get_config"]

# arch id → module name
ARCHS: dict[str, str] = {
    "mixtral-8x22b": "mixtral_8x22b",
    "yi-6b": "yi_6b",
    "internvl2-1b": "internvl2_1b",
    "qwen3-4b": "qwen3_4b",
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2-7b": "qwen2_7b",
    "granite-20b": "granite_20b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "hubert-xlarge": "hubert_xlarge",
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg = mod.CONFIG
    return reduced_for_smoke(cfg) if smoke else cfg
