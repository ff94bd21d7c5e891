"""Flash attention forward: the wrapper of the hand-written Hopper kernel
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention_fwd``.
On the H100 the causal prefill is bound by the tensor-core rate.  bfloat16
inputs (the serving path) run a warp-specialised kernel: TMA loads Q, K and
V tiles straight from the (B,S,H,D) / (B,S,K,D) tensors into a ring of
shared-memory stages, two warpgroups multiply with ``wgmma`` and keep the
online softmax in registers.  float32 inputs run the first version's f32
FMA kernel.  Both keep every intermediate on chip and skip KV tiles outside
the causal/window band; see the source's note.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention_cuda", "check_attention_inputs", "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_attention_inputs(q: torch.Tensor, *kv: torch.Tensor,
                           window: Optional[int] = None) -> None:
    """The checks every attention wrapper makes before a launch: one
    device and dtype (float32 or bfloat16), contiguous tensors, a
    supported head_dim, and query heads divisible by KV heads."""
    for t in (q, *kv):
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"mixed dtypes {q.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("attention kernels take contiguous tensors")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    d = q.shape[-1]
    if d not in SUPPORTED_HEAD_DIMS or any(t.shape[-1] != d for t in kv):
        raise ValueError(f"head_dim {d} not supported {SUPPORTED_HEAD_DIMS}")
    h, kh = q.shape[-2], kv[0].shape[-2]
    if h % kh:
        raise ValueError(f"num_heads {h} not divisible by num_kv_heads {kh}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,K,D) CUDA tensors → (B,S,H,D) in q's dtype.
    Launches on the current stream without synchronising."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    check_attention_inputs(q, k, v, window=window)
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s):
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)} / v {tuple(v.shape)}")
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 kernel's TMA loads need 16-byte aligned tensors")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        b, s, h, k.shape[2], d, int(causal),
                        -1 if window is None else int(window),
                        DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
