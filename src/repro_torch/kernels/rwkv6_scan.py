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

``RWKV6WKV`` puts the kernels on the training path: its forward is the
kernel, and its backward the hand-written backward kernel
``csrc/rwkv6_scan_bwd.cu`` (``rwkv6_wkv_bwd_cuda``).  The reference has no
Pallas backward: ``jax.value_and_grad`` differentiates its chunked form, and
the backward kernel computes that gradient, the recurrence's (the chunk
changes only the rounding), in segments of ``BWD_SEGMENT`` rows worked on in
parallel (four launches a call; ``ref.rwkv6_wkv_bwd_segments`` is its plain
mirror).  On a CPU tensor the forward is the step
recurrence and the backward the plain version, ``wkv_chunked_grads``: the
reference's chunked form, ``ref.rwkv6_wkv_chunked``, recomputed at the
reference's chunk and differentiated under autograd.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as _ref

__all__ = ["rwkv6_wkv_cuda", "rwkv6_wkv_bwd_cuda", "RWKV6WKV", "wkv_chunked_grads",
           "check_rwkv6_inputs", "occupancy",
           "STATE_TILE", "FOLD_TILE", "SUB_BLOCK", "STATE_COLUMNS", "MAX_HEAD_DIM",
           "BWD_SEGMENT"]

STATE_TILE = 32      # the TPU kernel's _STATE_TILE, which its chunk check names
FOLD_TILE = 32       # rows the kernel folds into the state at once
SUB_BLOCK = 16       # rows of the sub-blocks whose pairwise scores take exp directly
STATE_COLUMNS = 16   # columns of the state per block
MAX_HEAD_DIM = 64    # the kernel's largest head width (a multiple of 16)
BWD_SEGMENT = 64     # rows of the backward kernel's segments (its SEG)

_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rwkv6_scan").rwkv6_wkv_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel():
    """The backward kernel's entry point and its scratch-size query."""
    global _bwd_fn
    if _bwd_fn is None:
        lib = _build.load("rwkv6_scan_bwd")
        fn = lib.rwkv6_wkv_bwd
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        size = lib.rwkv6_wkv_bwd_scratch
        size.argtypes = [ctypes.c_int] * 3
        size.restype = ctypes.c_longlong
        _bwd_fn = fn, size
    return _bwd_fn


def occupancy(backward: bool = False) -> dict:
    """What the occupancy API reports for the scan kernel (``backward``:
    the backward's segment kernel): blocks per SM, and the threads and
    shared-memory bytes of one block (and the backward's segment length).
    Builds the kernel."""
    names = ("blocks_per_sm", "threads", "smem_bytes") + (("segment",) if backward else ())
    fn = (_build.load("rwkv6_scan_bwd").rwkv6_wkv_bwd_occupancy if backward
          else _build.load("rwkv6_scan").rwkv6_wkv_occupancy)
    out = [ctypes.c_int() for _ in names]
    err = fn(*(ctypes.byref(o) for o in out))
    if err:
        raise RuntimeError(f"rwkv6_wkv occupancy query failed: CUDA error {err}")
    return dict(zip(names, (o.value for o in out)))


def _check_shapes(r, k, v, logw, u) -> None:
    h, dk = r.shape[2:]
    if k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape \
            or tuple(u.shape) != (h, dk):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"logw {tuple(logw.shape)}, u {tuple(u.shape)}")


def check_rwkv6_inputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, u: torch.Tensor, chunk: int) -> None:
    """The reference kernel's checks (``rwkv6_scan.py:120-130``), on any
    device: the sequence divides into chunks, and a chunk above the fold
    tile is a multiple of it (else the fold would degenerate to tiny
    tiles); plus matching shapes."""
    _check_shapes(r, k, v, logw, u)
    s = r.shape[1]
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


def rwkv6_wkv_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                       grad_chunk: int = 64) -> tuple:
    """The WKV scan's gradient from a zero state: r, k, v, logw (B,S,H,K)
    and u (H,K), float32 CUDA tensors, and dy (B,S,H,K) → (dr, dk, dv,
    dlogw, du) float32.  ``grad_chunk`` is the chunk of the reference's
    chunked form, checked as the reference checks it (it divides S) and
    not passed on: the kernel computes the recurrence's gradient.  A
    non-contiguous dy (autograd's) is made contiguous.  Launches on the
    current stream without synchronising."""
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv_bwd_cuda needs CUDA tensors, got {r.device}")
    _check_shapes(r, k, v, logw, u)
    dy = dy.contiguous()
    b, s, h, dk = r.shape
    if dy.shape != r.shape:
        raise ValueError(f"dy {tuple(dy.shape)} for r {tuple(r.shape)}")
    if grad_chunk < 1 or s % grad_chunk:
        raise ValueError(f"seq {s} not divisible by grad_chunk {grad_chunk}")
    for t in (r, k, v, logw, u, dy):
        if t.device != r.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("rwkv6_wkv_bwd_cuda takes contiguous float32 tensors on one device")
    if dk > MAX_HEAD_DIM:
        raise ValueError(f"head width {dk} not supported (up to {MAX_HEAD_DIM})")
    dr, dkk, dv, dlogw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    fn, size = _bwd_kernel()
    # the segments' summaries (then the carried state and D), decays, dlogw
    # totals and du's partials, which the launches pass on to one another
    scratch = torch.empty(size(b, s, h), dtype=torch.uint8, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
                 dy.data_ptr(), dr.data_ptr(), dkk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
                 du.data_ptr(), scratch.data_ptr(), b, s, h, dk, stream)
    if err:
        raise RuntimeError(f"rwkv6_wkv_bwd kernel launch failed: CUDA error {err}")
    rwkv6_wkv_bwd_cuda.launches += 1
    return dr, dkk, dv, dlogw, du


rwkv6_wkv_bwd_cuda.launches = 0


class RWKV6WKV(torch.autograd.Function):
    """The WKV scan from a zero state with its gradient (dr, dk, dv, dlogw,
    du): on CUDA tensors the forward kernel and the backward kernel; on CPU
    tensors the step recurrence, and the backward recomputes
    ``ref.rwkv6_wkv_chunked`` at ``grad_chunk`` on the saved inputs and
    differentiates it.  ``chunk`` is the forward kernel's; ``grad_chunk``
    is checked by the backward kernel and changes only the CPU's rounding."""

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
        if dy.device.type == "cuda":
            grads = rwkv6_wkv_bwd_cuda(*ctx.saved_tensors, dy, ctx.grad_chunk)
        else:
            grads = wkv_chunked_grads(ctx.saved_tensors, ctx.grad_chunk, dy)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def wkv_chunked_grads(saved, grad_chunk: int, dy: torch.Tensor) -> tuple:
    """(dr, dk, dv, dlogw, du): ``ref.rwkv6_wkv_chunked`` at ``grad_chunk``
    recomputed on the saved inputs and differentiated against ``dy``."""
    inputs = [t.detach().requires_grad_() for t in saved]
    r = inputs[0]
    b, _, h, dk = r.shape
    s0 = torch.zeros((b, h, dk, dk), dtype=r.dtype, device=r.device)
    with torch.enable_grad():
        y, _ = _ref.rwkv6_wkv_chunked(*inputs, grad_chunk, s0)
    return torch.autograd.grad(y, inputs, dy)
