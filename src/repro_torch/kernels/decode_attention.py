"""Single-token decode attention over a ring-buffer KV cache: the wrapper
of the hand-written Hopper kernel ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::decode_attention_fwd``,
the kernel form of the model's decode attention.  On the H100 it is bound
by the memory rate (each cache byte feeds a few multiply-adds).  The kernel
reads each K/V byte once, shared by the query heads of a KV group, through
a ring of 16-byte ``cp.async`` copies; it splits the cache tiles over a
thread-block cluster of up to ``MAX_SPLITS`` blocks, which merge their
partial softmax states through distributed shared memory in the same
launch; and it reads ``positions`` and ``next_pos`` from device memory, so
no decode step waits on the host.  The wrapper allocates only the output,
and with ``lse=True`` each row's log-sum-exp beside it (what tensor-parallel
decode merges the partials of slot ranges by, ``distributed/tp.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from . import _build
from .flash_attention import DTYPE_CODES, check_attention_inputs

__all__ = ["decode_attention_cuda", "num_splits", "splits_for", "TILE", "MAX_SPLITS"]

TILE = 64            # cache slots per tile (BK in the kernel)
MAX_SPLITS = 8       # splits form one thread-block cluster: the portable size
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def num_splits(batch: int, kv_heads: int, capacity: int, sm_count: int,
               clusters_fit: Callable[[int], bool] = lambda splits: True) -> int:
    """Cache splits per (batch, KV head): the most, from a bound of two
    blocks per SM and ``MAX_SPLITS`` (one cluster) and halving from there,
    whose clusters ``clusters_fit`` on the card at once; never more splits
    than tiles, and every split owning at least one tile (the kernel gives
    each ceil(tiles / splits) tiles)."""
    tiles = -(-capacity // TILE)
    want = 2 * sm_count // (batch * kv_heads)
    bound = min(tiles, MAX_SPLITS, max(1, want))
    while True:
        splits = -(-tiles // -(-tiles // bound))
        if splits == 1 or clusters_fit(splits):
            return splits
        bound = (bound + 1) // 2


@functools.lru_cache(maxsize=None)
def splits_for(device: int, batch: int, heads: int, kv_heads: int, capacity: int,
               head_dim: int, dtype: torch.dtype) -> int:
    """``num_splits`` for a launch on CUDA device ``device``, whose clusters
    fit when the occupancy API runs at least as many of them at once as the
    launch needs."""
    fn = _build.load("decode_attention").decode_attention_clusters
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def clusters_fit(splits: int) -> bool:
        need_fit = (ctypes.c_int * 2)()
        with torch.cuda.device(device):
            err = fn(batch, heads, kv_heads, head_dim, DTYPE_CODES[dtype], splits,
                     ctypes.addressof(need_fit))
        if err:
            raise RuntimeError(f"decode_attention_clusters failed: CUDA error {err}")
        return need_fit[1] >= need_fit[0]

    return num_splits(batch, kv_heads, capacity, _sm_count(device), clusters_fit)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, positions: torch.Tensor,
                          next_pos: torch.Tensor, window: Optional[int] = None,
                          lse: bool = False):
    """q (B,H,D), caches (B,C,K,D), positions int32 (C,) and next_pos int32
    (one element), all CUDA tensors on one device → (B,H,D) in q's dtype;
    with ``lse`` the pair (out, each row's log-sum-exp of the allowed
    scaled scores, natural log, f32 (B,H), -inf where no slot is allowed).
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
    splits = splits_for(q.device.index, b, h, kh, c, d, q.dtype)
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("the kernel's 16-byte loads need 16-byte aligned q and caches")
    out = torch.empty_like(q)
    rows = torch.empty((b, h), dtype=torch.float32, device=q.device) if lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        positions.data_ptr(), next_pos.data_ptr(), out.data_ptr(),
                        None if rows is None else rows.data_ptr(),
                        b, c, h, kh, d, -1 if window is None else int(window),
                        splits, DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention_cuda.launches += 1
    return (out, rows) if lse else out


decode_attention_cuda.launches = 0
