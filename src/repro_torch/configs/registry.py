"""Architecture registry and input-shape catalogue.

``get_config(arch_id)`` resolves ``--arch`` over the reference's ten
archs, in the reference's order; ``input_specs`` and
``decode_state_specs`` give the tensors of every (architecture × input
shape) pair the dry-run and the roofline count, on the ``meta`` device
(shapes and dtypes, no storage).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from .base import ModelConfig, reduced_for_smoke

__all__ = ["ARCHS", "SHAPES", "InputShape", "get_config", "input_specs",
           "decode_state_specs", "shape_applicability"]

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


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg = mod.CONFIG
    return reduced_for_smoke(cfg) if smoke else cfg


def shape_applicability(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason): encoder-only archs have no decode step; long_500k
    needs sub-quadratic attention (native SSM/hybrid/SWA, or the
    sliding-window variant)."""
    if shape.kind == "decode":
        if not cfg.supports_decode:
            return False, "encoder-only: no decode step"
        if shape.seq_len > 32768 and not cfg.supports_long_context():
            return False, "quadratic full attention at 500k context"
    return True, ""


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape | str) -> dict:
    """Meta tensors for one step of the given kind.

    train/prefill → the ``batch`` argument of ``loss``/``forward``;
    decode        → the ``tokens`` argument of ``decode_step`` (the decode
                    *state* comes from ``decode_state_specs``).
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    if shape.kind == "decode":
        return {"tokens": _meta((b,), i32)}
    if cfg.family == "audio":
        return {"frames": _meta((b, s, cfg.frontend_dim), torch.float32),
                "labels": _meta((b, s), i32)}
    if cfg.family == "vlm":
        p = cfg.frontend_tokens
        return {"tokens": _meta((b, s - p), i32),
                "patch_embeds": _meta((b, p, cfg.frontend_dim), torch.float32)}
    return {"tokens": _meta((b, s), i32)}


def decode_state_specs(cfg: ModelConfig, shape: InputShape | str):
    """The decode state (KV cache / SSM state) at this shape's context
    length, built by ``Model.init_decode_state`` on the meta device: its
    shapes and dtypes, never a cache's bytes."""
    from repro_torch.models import Model

    if isinstance(shape, str):
        shape = SHAPES[shape]
    return Model(cfg).init_decode_state(shape.global_batch, shape.seq_len, device="meta")
