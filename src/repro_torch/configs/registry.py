"""Architecture registry: ``get_config(arch_id)`` resolves ``--arch``.

Only the archs whose model family is ported are listed; the others join
with the slices that port their families.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig, reduced_for_smoke

__all__ = ["ARCHS", "get_config"]

# arch id → module name
ARCHS: dict[str, str] = {
    "qwen3-4b": "qwen3_4b",
    "rwkv6-3b": "rwkv6_3b",
    "zamba2-2.7b": "zamba2_2p7b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg = mod.CONFIG
    return reduced_for_smoke(cfg) if smoke else cfg
