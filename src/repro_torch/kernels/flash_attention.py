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

The gradient: ``FlashAttention`` is a ``torch.autograd.Function`` whose
forward is that kernel and whose backward is the hand-written kernel of
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd_cuda``), which
recomputes each row's log-sum-exp, so the forward kernel writes nothing
more than the output.  On CPU tensors the Function runs the plain versions
of both (``ref.flash_attention_ref`` / ``ref.flash_attention_bwd_ref``),
which tests its wiring without a card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from . import ref as _ref

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda", "FlashAttention",
           "check_attention_inputs", "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("flash_attention_bwd").flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


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


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, do: torch.Tensor, causal: bool = True,
                             window: Optional[int] = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_cuda``: q (B,S,H,D), k/v (B,S,K,D),
    its output o and the output's gradient do (B,S,H,D), CUDA tensors →
    (dq, dk, dv) in the inputs' dtype.  Three launches on the current
    stream (the rows' log-sum-exp and rowsum(dO∘O) into f32 scratch, then
    dK/dV, then dQ), counted as one call; does not synchronise."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got {q.device}")
    do = do.contiguous()
    check_attention_inputs(q, k, v, o, do, window=window)
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)} / v {tuple(v.shape)} / "
                         f"o {tuple(o.shape)} / do {tuple(do.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd_cuda needs 16-byte aligned tensors")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(), b, s, h, k.shape[2], d,
                            int(causal), -1 if window is None else int(window),
                            DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: on CUDA tensors the forward and
    backward kernels, on CPU tensors their plain versions.  Saves q, k, v
    and the output for the backward."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                window: Optional[int]) -> torch.Tensor:
        if q.device.type == "cuda":
            out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        else:
            out = _ref.flash_attention_ref(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v, out = ctx.saved_tensors
        if q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, do, ctx.causal, ctx.window)
        else:
            dq, dk, dv = _ref.flash_attention_bwd_ref(q, k, v, out, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None
