"""Mamba2 SSD scan forward: the wrapper of the hand-written Hopper kernel
``csrc/mamba2_ssd.cu``.

Replaces the TPU kernel ``repro/kernels/mamba2_ssd.py::mamba2_ssd_fwd``.
The kernel starts from a zero state and returns y without the D-skip term,
which is what the model's prefill needs.  A call launches two kernels: the
first forms C·Bᵀ of every 64-row sub-tile once (it is the same for every
head) into a scratch tensor; in the second, one block per (batch, head, 32
rows of the state) walks the sequence in those sub-tiles, multiplies on the
tensor cores in split TF32 and carries its rows of the (P×N) f32 state
across them.  ``chunk`` and ``head_block`` are checked as the reference
checks them and do not change the result (see the source's note).  The
launch counter counts calls.

``Mamba2SSD`` puts the kernels on the training path: its forward is the
kernel, and its backward the hand-written backward kernel
``csrc/mamba2_ssd_bwd.cu`` (``mamba2_ssd_bwd_cuda``).  The reference has no
Pallas backward: ``jax.value_and_grad`` differentiates its chunked form at
the model's ``ssm_chunk``, and the backward kernel computes that gradient,
the recurrence's (the chunk changes only the rounding), in segments of
``BWD_SEGMENT`` rows worked on in parallel, dB and dC summed over each head
group on chip (four launches a call; ``ref.mamba2_ssd_bwd_segments`` is its
plain mirror).  On a CPU tensor the
forward is the step recurrence and the backward the plain version,
``ssd_chunked_grads``: the reference's chunked form,
``ref.mamba2_ssd_chunked``, recomputed at ``chunk`` and differentiated under
autograd.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as _ref

__all__ = ["mamba2_ssd_cuda", "mamba2_ssd_bwd_cuda", "Mamba2SSD", "ssd_chunked_grads",
           "check_mamba2_inputs", "occupancy",
           "MAX_DIM", "SUB_TILE", "STATE_ROWS", "BWD_SEGMENT"]

MAX_DIM = 64         # the kernel's largest head width P and state size N (multiples of 4)
SUB_TILE = 64        # rows the kernel walks at a time, whatever the chunk
STATE_ROWS = 32      # rows p of the state (columns of x) per block
BWD_SEGMENT = 128    # rows of the backward kernel's segments (its SEG)

_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("mamba2_ssd").mamba2_ssd_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel():
    """The backward kernel's entry point and its scratch-size query."""
    global _bwd_fn
    if _bwd_fn is None:
        lib = _build.load("mamba2_ssd_bwd")
        fn = lib.mamba2_ssd_bwd
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        size = lib.mamba2_ssd_bwd_scratch
        size.argtypes = [ctypes.c_int] * 4
        size.restype = ctypes.c_longlong
        _bwd_fn = fn, size
    return _bwd_fn


def occupancy(backward: bool = False) -> dict:
    """What the occupancy API reports for the scan kernel (``backward``:
    the backward's segment kernel): blocks per SM, and the threads and
    shared-memory bytes of one block (and the backward's segment length).
    Builds the kernel."""
    names = ("blocks_per_sm", "threads", "smem_bytes") + (("segment",) if backward else ())
    fn = (_build.load("mamba2_ssd_bwd").mamba2_ssd_bwd_occupancy if backward
          else _build.load("mamba2_ssd").mamba2_ssd_occupancy)
    out = [ctypes.c_int() for _ in names]
    err = fn(*(ctypes.byref(o) for o in out))
    if err:
        raise RuntimeError(f"mamba2_ssd occupancy query failed: CUDA error {err}")
    return dict(zip(names, (o.value for o in out)))


def check_mamba2_inputs(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                        head_block: int) -> None:
    """The reference kernel's checks, on any device: S % chunk and
    H % head_block; plus matching shapes."""
    b, s, h, _ = x.shape
    n = bmat.shape[-1]
    if tuple(dt.shape) != (b, s, h) or tuple(a.shape) != (h,) \
            or tuple(bmat.shape) != (b, s, n) or cmat.shape != bmat.shape:
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
                         f"B {tuple(bmat.shape)}, C {tuple(cmat.shape)}")
    if chunk < 1 or head_block < 1 or s % chunk or h % head_block:
        raise ValueError(f"S={s} % chunk={chunk} or H={h} % hb={head_block}")


def mamba2_ssd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bmat: torch.Tensor, cmat: torch.Tensor, chunk: int = 64,
                    head_block: int = 8) -> torch.Tensor:
    """x (B,S,H,P), dt (B,S,H), a (H,), B/C (B,S,N), float32 CUDA tensors →
    y (B,S,H,P) float32.  Launches on the current stream without
    synchronising."""
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd_cuda needs CUDA tensors, got {x.device}")
    check_mamba2_inputs(x, dt, a, bmat, cmat, chunk, head_block)
    for t in (x, dt, a, bmat, cmat):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("mamba2_ssd_cuda takes contiguous float32 tensors on one device")
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if p > MAX_DIM or n > MAX_DIM or p % 4 or n % 4:
        raise ValueError(f"head width {p} / state {n} not supported (multiples of 4 up to "
                         f"{MAX_DIM})")
    out = torch.empty_like(x)
    # C·Bᵀ of every sub-tile, which the first kernel writes and the second reads
    scores = torch.empty(b * -(-s // SUB_TILE) * SUB_TILE * SUB_TILE, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                        cmat.data_ptr(), out.data_ptr(), scores.data_ptr(), b, s, h, p, n,
                        stream)
    if err:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: CUDA error {err}")
    mamba2_ssd_cuda.launches += 1
    return out


mamba2_ssd_cuda.launches = 0


def mamba2_ssd_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        bmat: torch.Tensor, cmat: torch.Tensor, dy: torch.Tensor,
                        chunk: int = 64, head_block: int = 8) -> tuple:
    """The SSD scan's gradient from a zero state: x (B,S,H,P), dt (B,S,H),
    a (H,), B/C (B,S,N), float32 CUDA tensors, and dy (B,S,H,P) → (dx,
    ddt, da, dB, dC) float32.  ``chunk`` and ``head_block`` are checked as
    the reference checks them and not passed on: the kernel computes the
    recurrence's gradient.  A non-contiguous dy (autograd's) is made
    contiguous.  Launches on the current stream without synchronising."""
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd_bwd_cuda needs CUDA tensors, got {x.device}")
    check_mamba2_inputs(x, dt, a, bmat, cmat, chunk, head_block)
    dy = dy.contiguous()
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    for t in (x, dt, a, bmat, cmat, dy):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("mamba2_ssd_bwd_cuda takes contiguous float32 tensors on one device")
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if p > MAX_DIM or n > MAX_DIM:
        raise ValueError(f"head width {p} / state {n} not supported (up to {MAX_DIM})")
    dx, ddt, da = torch.empty_like(x), torch.empty_like(dt), torch.empty_like(a)
    dbm, dcm = torch.empty_like(bmat), torch.empty_like(cmat)
    fn, size = _bwd_kernel()
    # the segments' summaries (then the carried h and G), decays and dl
    # totals, and dB's and dC's partials per head group, which the launches
    # pass on to one another
    scratch = torch.empty(size(b, s, h, n), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), dbm.data_ptr(),
                 dcm.data_ptr(), scratch.data_ptr(), b, s, h, p, n, stream)
    if err:
        raise RuntimeError(f"mamba2_ssd_bwd kernel launch failed: CUDA error {err}")
    mamba2_ssd_bwd_cuda.launches += 1
    return dx, ddt, da, dbm, dcm


mamba2_ssd_bwd_cuda.launches = 0


class Mamba2SSD(torch.autograd.Function):
    """The SSD scan from a zero state with its gradient (dx, ddt, da, dB,
    dC): on CUDA tensors the forward kernel and the backward kernel; on CPU
    tensors the step recurrence, and the backward recomputes
    ``ref.mamba2_ssd_chunked`` at ``chunk`` on the saved inputs and
    differentiates it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, chunk: int, head_block: int) -> torch.Tensor:
        if x.device.type == "cuda":
            y = mamba2_ssd_cuda(x, dt, a, bmat, cmat, chunk, head_block)
        else:
            y = _ref.mamba2_ssd_ref(x, dt, a, bmat, cmat)
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        ctx.chunk, ctx.head_block = chunk, head_block
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        if dy.device.type == "cuda":
            grads = mamba2_ssd_bwd_cuda(*ctx.saved_tensors, dy, ctx.chunk, ctx.head_block)
        else:
            grads = ssd_chunked_grads(ctx.saved_tensors, ctx.chunk, dy)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def ssd_chunked_grads(saved, chunk: int, dy: torch.Tensor) -> tuple:
    """(dx, ddt, da, dB, dC): ``ref.mamba2_ssd_chunked`` at ``chunk``
    recomputed on the saved inputs and differentiated against ``dy``."""
    inputs = [t.detach().requires_grad_() for t in saved]
    with torch.enable_grad():
        y, _ = _ref.mamba2_ssd_chunked(*inputs, chunk)
    return torch.autograd.grad(y, inputs, dy)
