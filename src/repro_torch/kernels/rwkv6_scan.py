"""RWKV6 WKV scan forward: the wrapper of the hand-written Hopper kernel
``csrc/rwkv6_scan.cu``.

Replaces the TPU kernel ``repro/kernels/rwkv6_scan.py::rwkv6_wkv_fwd``.
The kernel starts from a zero state and returns y only, which is all the
model's prefill needs.  It walks the sequence in its own fold tiles of
``FOLD_TILE`` rows, whatever the chunk (a ragged last tile is masked).  A
call launches two kernels: the first forms the decayed scores A of every
fold tile (the same for every column of the state) into a scratch tensor,
pairwise on the diagonal 16-row sub-blocks and as a product off them; in
the second, one block per (batch, head, 16 columns of the state) multiplies
on the tensor cores in split TF32 and carries its columns of the (K×K) f32
state across tiles.  See the source's note for the arithmetic and what
bounds it.  ``chunk`` is checked as the reference checks it and not passed
on.  The launch counter counts calls.

``RWKV6WKV`` puts the kernel on the training path: its forward is the
kernel (the plain version on a CPU tensor), and its gradient is that of the
reference's chunked form, ``ref.rwkv6_wkv_chunked``, recomputed in the
backward under autograd at the reference's chunk.  The reference has no
Pallas backward either: ``jax.value_and_grad`` differentiates the same
chunked form.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as _ref

__all__ = ["rwkv6_wkv_cuda", "RWKV6WKV", "check_rwkv6_inputs", "occupancy", "STATE_TILE",
           "FOLD_TILE", "SUB_BLOCK", "STATE_COLUMNS", "MAX_HEAD_DIM"]

STATE_TILE = 32      # the TPU kernel's _STATE_TILE, which its chunk check names
FOLD_TILE = 32       # rows the kernel folds into the state at once
SUB_BLOCK = 16       # rows of the sub-blocks whose pairwise scores take exp directly
STATE_COLUMNS = 16   # columns of the state per block
MAX_HEAD_DIM = 64    # the kernel's largest head width (a multiple of 16)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rwkv6_scan").rwkv6_wkv_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def occupancy() -> dict:
    """What the occupancy API reports for the kernel: blocks per SM, and
    the threads and shared-memory bytes of one block.  Builds the kernel."""
    fn = _build.load("rwkv6_scan").rwkv6_wkv_occupancy
    out = [ctypes.c_int() for _ in range(3)]
    err = fn(*(ctypes.byref(o) for o in out))
    if err:
        raise RuntimeError(f"rwkv6_wkv occupancy query failed: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes"), (o.value for o in out)))


def check_rwkv6_inputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, u: torch.Tensor, chunk: int) -> None:
    """The reference kernel's checks (``rwkv6_scan.py:120-130``), on any
    device: the sequence divides into chunks, and a chunk above the fold
    tile is a multiple of it (else the fold would degenerate to tiny
    tiles); plus matching shapes."""
    b, s, h, dk = r.shape
    if k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape \
            or tuple(u.shape) != (h, dk):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"logw {tuple(logw.shape)}, u {tuple(u.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    if chunk > STATE_TILE and chunk % STATE_TILE:
        raise ValueError(f"chunk {chunk} must be <= {STATE_TILE} or a multiple of it")


def rwkv6_wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """r, k, v, logw (B,S,H,K) and u (H,K), float32 CUDA tensors →
    y (B,S,H,K) float32.  Launches on the current stream without
    synchronising."""
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv_cuda needs CUDA tensors, got {r.device}")
    check_rwkv6_inputs(r, k, v, logw, u, chunk)
    for t in (r, k, v, logw, u):
        if t.device != r.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("rwkv6_wkv_cuda takes contiguous float32 tensors on one device")
    b, s, h, dk = r.shape
    if dk > MAX_HEAD_DIM or dk % 16:
        raise ValueError(f"head width {dk} not supported (a multiple of 16 up to {MAX_HEAD_DIM})")
    out = torch.empty_like(r)
    # the decayed scores A of every fold tile, which the first kernel writes
    # and the second reads
    scores = torch.empty(b * h * -(-s // FOLD_TILE) * FOLD_TILE * FOLD_TILE, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                        u.data_ptr(), out.data_ptr(), scores.data_ptr(), b, s, h, dk, stream)
    if err:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error {err}")
    rwkv6_wkv_cuda.launches += 1
    return out


rwkv6_wkv_cuda.launches = 0


class RWKV6WKV(torch.autograd.Function):
    """The WKV scan from a zero state with its gradient: on CUDA tensors the
    forward kernel, on CPU tensors the step recurrence; the backward
    recomputes ``ref.rwkv6_wkv_chunked`` at ``grad_chunk`` on the saved
    inputs and differentiates it (dr, dk, dv, dlogw, du).  ``chunk`` is the
    kernel's, checked and not used by the backward."""

    @staticmethod
    def forward(ctx, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                u: torch.Tensor, chunk: int, grad_chunk: int) -> torch.Tensor:
        if r.device.type == "cuda":
            y = rwkv6_wkv_cuda(r, k, v, logw, u, chunk)
        else:
            y = _ref.rwkv6_wkv_ref(r, k, v, logw, u)
        ctx.save_for_backward(r, k, v, logw, u)
        ctx.grad_chunk = grad_chunk
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        r = inputs[0]
        b, _, h, dk = r.shape
        s0 = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
        with torch.enable_grad():
            y, _ = _ref.rwkv6_wkv_chunked(*inputs, ctx.grad_chunk, s0)
        grads = torch.autograd.grad(y, inputs, dy)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)
