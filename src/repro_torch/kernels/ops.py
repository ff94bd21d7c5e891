"""Public kernel entry points (the ``ops.py`` layer): dispatch by the
tensors' device.

A CUDA tensor launches the hand-written kernel, or the call raises; a CPU
tensor takes the kernel's plain PyTorch version in ``ref.py``.  There is
no other switch.  Each kernel wrapper counts its launches, so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref as _ref
from .decode_attention import decode_attention_cuda
from .flash_attention import flash_attention_cuda

__all__ = ["flash_attention", "decode_attention", "launch_counts", "reset_launch_counts"]

_WRAPPERS = {
    "flash_attention": flash_attention_cuda,
    "decode_attention": decode_attention_cuda,
}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"attention kernels run on cuda or cpu tensors, not {t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,K,D) → (B,S,H,D) in q's dtype."""
    if _on_cuda(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return _ref.flash_attention_ref(q, k, v, causal, window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, next_pos: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,D) over caches (B,C,K,D), masked by ``positions`` (C,) and
    ``next_pos`` () → (B,H,D) in q's dtype."""
    if _on_cuda(q):
        return decode_attention_cuda(q, k_cache, v_cache, positions, next_pos,
                                     window=window)
    return _ref.decode_attention_ref(q, k_cache, v_cache, positions, next_pos, window)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
