"""Single-token decode attention over a ring-buffer KV cache: the wrapper
of the hand-written Hopper kernel ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::decode_attention_fwd``,
the kernel form of the model's decode attention.  On the H100 it is bound
by the memory rate (each cache byte feeds a few multiply-adds); the kernel
reads each K/V byte once, shared by the G query heads of a KV group, splits
the cache tiles over enough blocks to fill the SMs (combining the splits'
partial softmax states in a second kernel), and reads ``positions`` and
``next_pos`` from device memory, so no decode step waits on the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .flash_attention import DTYPE_CODES, check_attention_inputs

__all__ = ["decode_attention_cuda", "num_splits"]

TILE = 64            # cache slots per tile (BK in the kernel)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def num_splits(batch: int, kv_heads: int, capacity: int, sm_count: int) -> int:
    """Cache splits per (batch, KV head): enough blocks for two per SM,
    never more splits than tiles, and every split owning at least one
    tile (the kernel gives each ceil(tiles / splits) tiles)."""
    tiles = -(-capacity // TILE)
    want = -(-2 * sm_count // (batch * kv_heads))
    per_split = -(-tiles // min(tiles, max(1, want)))
    return -(-tiles // per_split)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, positions: torch.Tensor,
                          next_pos: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,D), caches (B,C,K,D), positions int32 (C,) and next_pos int32
    (one element), all CUDA tensors on one device → (B,H,D) in q's dtype.
    Launches on the current stream without synchronising."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {q.device}")
    check_attention_inputs(q, k_cache, v_cache, window=window)
    b, h, d = q.shape
    c = k_cache.shape[1]
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b:
        raise ValueError(f"q {tuple(q.shape)} vs caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)}")
    for name, t, n in (("positions", positions, c), ("next_pos", next_pos, 1)):
        if t.dtype != torch.int32 or t.numel() != n or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be {n} contiguous int32 on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    kh = k_cache.shape[2]
    splits = num_splits(b, kh, c, _sm_count(q.device.index))
    out = torch.empty_like(q)
    part_acc = torch.empty((b, kh, splits, h // kh, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, kh, splits, h // kh, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        positions.data_ptr(), next_pos.data_ptr(), out.data_ptr(),
                        part_acc.data_ptr(), part_ml.data_ptr(),
                        b, c, h, kh, d, -1 if window is None else int(window),
                        splits, DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
