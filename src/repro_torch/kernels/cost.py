"""Declared costs of the kernel entry points: what one call of each kernel
must do, from its argument shapes, dtypes and flags alone.

Every number here is the yardstick of two readers: the static counter
(``repro_torch.analysis.cert.costs``), which counts a kernel call as its
declared cost rather than as the arithmetic of its plain version, and
``chip_smoke.py``'s per-kernel bounds.  A ``KernelCost`` holds

* ``flops``: the least arithmetic the data needs (attention over the pairs
  its causal/window mask allows, the scans' recurrence: one rank-1 update
  of the state and one read of it per position and head), which is what a
  floor and a bound must use;
* ``bytes_read`` / ``bytes_written``: each input read once, each output
  written once;
* ``unit`` and ``passes``: the peak that prices the flops (``bf16`` and
  ``tf32`` tensor cores, ``f32`` CUDA cores) and the tensor-core passes a
  product takes (the scans multiply in split TF32: three);
* ``matmul_flops``: the products the kernel issues as written, one pass,
  by the counter's convention (``2·prod(out)·K`` per product).  Attention
  counts its two products over every (query, key) pair, masked or not, as
  a counter counts a masked product; the scans count the products of the
  CUDA kernels' own tiles (WKV: fold tiles of 32 rows, 16-row sub-blocks;
  SSD: sub-tiles of 64 rows), which differ from the TPU kernels' folds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .mamba2_ssd import SUB_TILE
from .rwkv6_scan import FOLD_TILE, SUB_BLOCK

__all__ = ["KernelCost", "attention_pairs", "flash_attention_cost", "flash_attention_bwd_cost",
           "decode_attention_cost", "rwkv6_wkv_cost", "mamba2_ssd_cost", "rwkv6_wkv_grad_cost",
           "mamba2_ssd_grad_cost", "call_cost", "call_outputs"]


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: float
    bytes_read: float
    bytes_written: float
    unit: str                  # "bf16" | "tf32" | "f32"
    passes: int = 1
    matmul_flops: float = 0.0

    @property
    def bytes(self) -> float:
        return self.bytes_read + self.bytes_written

    def seconds(self, hw) -> tuple[float, str]:
        """The least time on ``hw`` (a ``Hardware`` with ``mem_bw`` and
        ``peak(unit)``) and what bounds it: ``"bytes"`` or
        ``"operations"``."""
        t_bytes = self.bytes / hw.mem_bw
        t_ops = self.passes * self.flops / hw.peak(self.unit)
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _size(shape) -> int:
    return math.prod(int(n) for n in shape)


def _unit(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def attention_pairs(s_q: int, s_k: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs of full-sequence attention that the mask
    allows: key position <= query position under ``causal``, and within
    ``window`` positions of it."""
    qp = np.arange(s_q, dtype=np.int64)
    hi = np.minimum(qp, s_k - 1) if causal else np.full(s_q, s_k - 1, np.int64)
    lo = np.maximum(qp - window + 1, 0) if window is not None else np.zeros(s_q, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_cost(q_shape, k_shape, dtype: torch.dtype, causal: bool = True,
                         window: Optional[int] = None) -> KernelCost:
    """q (B,S,H,D), k and v (B,S,K,D) → o like q: Q·Kᵀ and P·V over the
    allowed pairs, 2·D flops each."""
    b, s, h, d = (int(n) for n in q_shape)
    esz = dtype.itemsize
    pairs = attention_pairs(s, int(k_shape[1]), causal, window)
    return KernelCost(flops=4.0 * b * h * d * pairs,
                      bytes_read=(_size(q_shape) + 2 * _size(k_shape)) * esz,
                      bytes_written=_size(q_shape) * esz, unit=_unit(dtype),
                      matmul_flops=4.0 * b * h * d * s * int(k_shape[1]))


def flash_attention_bwd_cost(q_shape, k_shape, dtype: torch.dtype, causal: bool = True,
                             window: Optional[int] = None) -> KernelCost:
    """The backward from q, k, v, o and dO to dq, dk, dv: five products
    over the allowed pairs (S = Q·Kᵀ again, dV = Pᵀ·dO, dP = dO·Vᵀ,
    dQ = dS·K, dK = dSᵀ·Q).  The forward's log-sum-exp it reads is not
    counted."""
    b, s, h, d = (int(n) for n in q_shape)
    esz = dtype.itemsize
    pairs = attention_pairs(s, int(k_shape[1]), causal, window)
    return KernelCost(flops=10.0 * b * h * d * pairs,
                      bytes_read=(3 * _size(q_shape) + 2 * _size(k_shape)) * esz,
                      bytes_written=(_size(q_shape) + 2 * _size(k_shape)) * esz,
                      unit=_unit(dtype),
                      matmul_flops=10.0 * b * h * d * s * int(k_shape[1]))


def decode_attention_cost(q_shape, cache_shape, dtype: torch.dtype,
                          window: Optional[int] = None) -> KernelCost:
    """q (B,H,D) over caches (B,C,K,D), positions (C,) i32 and next_pos ()
    → o like q; every slot takes part, or the ``window`` latest where that
    is fewer (which slots hold a token is data the shapes do not give)."""
    b, h, d = (int(n) for n in q_shape)
    c = int(cache_shape[1])
    esz = dtype.itemsize
    n = c if window is None else min(c, int(window))
    return KernelCost(flops=4.0 * b * h * d * n,
                      bytes_read=(_size(q_shape) + 2 * _size(cache_shape)) * esz + 4 * (c + 1),
                      bytes_written=_size(q_shape) * esz, unit=_unit(dtype),
                      matmul_flops=4.0 * b * h * d * c)


def rwkv6_wkv_cost(r_shape) -> KernelCost:
    """r, k, v, logw (B,S,H,K) and u (H,K), f32 → y (B,S,H,K) f32.  Per
    fold tile of ``FOLD_TILE`` rows and head the CUDA kernel multiplies the
    off-diagonal 16 × 16 block of the scores, A·V, the state read and the
    fold."""
    b, s, h, k = (int(n) for n in r_shape)
    tiles = -(-s // FOLD_TILE)
    t = FOLD_TILE
    per_tile = 2.0 * SUB_BLOCK * SUB_BLOCK * k + 2.0 * t * t * k + 4.0 * t * k * k
    return KernelCost(flops=4.0 * b * s * h * k * k,
                      bytes_read=(4 * b * s * h * k + h * k) * 4.0,
                      bytes_written=b * s * h * k * 4.0, unit="tf32", passes=3,
                      matmul_flops=b * h * tiles * per_tile)


def mamba2_ssd_cost(x_shape, n_state: int) -> KernelCost:
    """x (B,S,H,P), dt (B,S,H), a (H,), B and C (B,S,N), f32 → y like x.
    Per sub-tile of ``SUB_TILE`` rows the CUDA kernel forms C·Bᵀ once per
    batch and, per head, the gated G·X, C·hᵀ and the fold."""
    b, s, h, p = (int(n) for n in x_shape)
    n = int(n_state)
    tiles = -(-s // SUB_TILE)
    t = SUB_TILE
    return KernelCost(flops=4.0 * b * s * h * p * n,
                      bytes_read=(b * s * h * p + b * s * h + h + 2 * b * s * n) * 4.0,
                      bytes_written=b * s * h * p * 4.0, unit="tf32", passes=3,
                      matmul_flops=b * tiles * (2.0 * t * t * n
                                                + h * (2.0 * t * t * p + 4.0 * t * p * n)))


def rwkv6_wkv_grad_cost(r_shape, chunk: int) -> KernelCost:
    """The gradient of the WKV scan through its chunked form at ``chunk``
    (``RWKV6WKV.backward``): each input and dy read once, each input's
    gradient written once; twice the chunked forward's arithmetic, the
    intra-chunk terms over the triangle the data needs.  Per pair (t > u),
    head and column: the decay difference, its exp, two products and the
    sum into A, and A·v (7); per position and head the state's inflow and
    readout (4 K²) and the elementwise terms (8 K)."""
    b, s, h, k = (int(n) for n in r_shape)
    pairs = s // chunk * (chunk * (chunk - 1) // 2)
    fwd = 7 * b * pairs * h * k + 4 * b * s * h * k * k + 8 * b * s * h * k
    return KernelCost(flops=2.0 * fwd, bytes_read=(5 * b * s * h * k + h * k) * 4.0,
                      bytes_written=(4 * b * s * h * k + h * k) * 4.0, unit="f32")


def mamba2_ssd_grad_cost(x_shape, n_state: int, chunk: int) -> KernelCost:
    """The gradient of the SSD scan through its chunked form at ``chunk``
    (``Mamba2SSD.backward``), as ``rwkv6_wkv_grad_cost``.  Per pair
    (t >= u): C·B (2 N), the decay difference, its exp and the gating (4
    per head), the product with x (2 P per head); per position and head
    the state's inflow and readout (4 P N) and the elementwise terms
    (4 P)."""
    b, s, h, p = (int(n) for n in x_shape)
    n = int(n_state)
    pairs = s // chunk * (chunk * (chunk + 1) // 2)
    fwd = 2 * b * pairs * n + (4 + 2 * p) * b * pairs * h + (4 * p * n + 4 * p) * b * s * h
    return KernelCost(flops=2.0 * fwd,
                      bytes_read=(2 * b * s * h * p + b * s * h + h + 2 * b * s * n) * 4.0,
                      bytes_written=(b * s * h * p + b * s * h + h + 2 * b * s * n) * 4.0,
                      unit="f32")


def call_cost(name: str, args: tuple, kw: dict) -> KernelCost:
    """The declared cost of one call of entry point ``name`` of
    ``kernels.ops`` (``flash_attention_bwd``: the backward of a flash call)
    on tensors ``args`` and flags ``kw``."""
    if name == "flash_attention":
        q, k = args[0], args[1]
        return flash_attention_cost(q.shape, k.shape, q.dtype, kw.get("causal", True),
                                    kw.get("window"))
    if name == "flash_attention_bwd":
        q, k = args[0], args[1]
        return flash_attention_bwd_cost(q.shape, k.shape, q.dtype, kw.get("causal", True),
                                        kw.get("window"))
    if name == "decode_attention":
        return decode_attention_cost(args[0].shape, args[1].shape, args[0].dtype,
                                     kw.get("window"))
    if name == "rwkv6_wkv":
        return rwkv6_wkv_cost(args[0].shape)
    if name == "mamba2_ssd":
        return mamba2_ssd_cost(args[0].shape, args[3].shape[-1])
    raise KeyError(f"no declared cost for kernel {name!r}")


def call_outputs(name: str, args: tuple) -> list[tuple[tuple, torch.dtype]]:
    """(shape, dtype) of each output of one call of ``name``."""
    if name in ("flash_attention", "decode_attention"):
        return [(tuple(args[0].shape), args[0].dtype)]
    if name in ("rwkv6_wkv", "mamba2_ssd"):
        return [(tuple(args[0].shape), torch.float32)]
    if name == "flash_attention_bwd":
        return [(tuple(t.shape), t.dtype) for t in args[:3]]
    raise KeyError(f"no outputs declared for kernel {name!r}")
