"""Public kernel entry points (the ``ops.py`` layer): dispatch by the
tensors' device.

A CUDA tensor launches the hand-written kernel, or the call raises; a CPU
tensor takes the kernel's plain PyTorch version in ``ref.py``.  There is
no other switch.  Each kernel wrapper counts its launches, so a run can
show that its main path went through the kernels.

Gradients: under grad with an input that requires grad, on either device,
``flash_attention`` applies ``FlashAttention`` (on the card the forward
kernel, and the backward kernel for its gradient), and the two scans apply
``RWKV6WKV`` and ``Mamba2SSD`` (on the card the forward kernel, and the
backward kernel for the gradient; on the CPU the step recurrence, and the
gradient of the reference's chunked form recomputed under autograd).
``decode_attention`` has no backward and raises ``NotImplementedError`` on
a CUDA tensor under grad, since its ctypes launch would hand autograd an
output cut from its inputs (decode runs without grad).  Without grad every
op makes its plain launch.

``count_hook`` is None except inside the static cost counter
(``repro_torch.analysis.cert.costs``), which sets it while it traces a
program on fake tensors: each entry point then hands ``(name, args,
flags)`` to the hook and returns what the hook returns (fake outputs of
the kernel's shapes), so a kernel call is counted by its declared cost
(``kernels/cost.py``) and neither launches nor counts a launch.  The hook
raises on any tensor that is not fake.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import ref as _ref
from .decode_attention import decode_attention_cuda
from .flash_attention import FlashAttention, flash_attention_bwd_cuda, flash_attention_cuda
from .mamba2_ssd import Mamba2SSD, check_mamba2_inputs, mamba2_ssd_bwd_cuda, mamba2_ssd_cuda
from .rwkv6_scan import RWKV6WKV, check_rwkv6_inputs, rwkv6_wkv_bwd_cuda, rwkv6_wkv_cuda

__all__ = ["flash_attention", "decode_attention", "rwkv6_wkv", "mamba2_ssd",
           "launch_counts", "reset_launch_counts", "count_hook"]

count_hook: Optional[Callable] = None

_WRAPPERS = {
    "flash_attention": flash_attention_cuda,
    "flash_attention_bwd": flash_attention_bwd_cuda,
    "decode_attention": decode_attention_cuda,
    "rwkv6_wkv": rwkv6_wkv_cuda,
    "rwkv6_wkv_bwd": rwkv6_wkv_bwd_cuda,
    "mamba2_ssd": mamba2_ssd_cuda,
    "mamba2_ssd_bwd": mamba2_ssd_bwd_cuda,
}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"attention kernels run on cuda or cpu tensors, not {t.device}")


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _no_backward(name: str, *ts: torch.Tensor) -> None:
    """Raise for a CUDA op under grad whose kernel has no backward."""
    if _needs_grad(*ts):
        raise NotImplementedError(
            f"{name} has no backward: decode runs without grad (serving), and on the card "
            f"its kernel's output would be cut from autograd's graph; on the CPU its plain "
            f"version is differentiable")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,K,D) → (B,S,H,D) in q's dtype."""
    if count_hook is not None:
        return count_hook("flash_attention", (q, k, v), {"causal": causal, "window": window})
    if _on_cuda(q):
        if _needs_grad(q, k, v):
            return FlashAttention.apply(q, k, v, causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return _ref.flash_attention_ref(q, k, v, causal, window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, next_pos: torch.Tensor,
                     window: Optional[int] = None, lse: bool = False):
    """q (B,H,D) over caches (B,C,K,D), masked by ``positions`` (C,) and
    ``next_pos`` () → (B,H,D) in q's dtype; with ``lse`` also each row's
    log-sum-exp (natural log, f32 (B,H), -inf where no slot is allowed)."""
    if count_hook is not None:
        return count_hook("decode_attention", (q, k_cache, v_cache, positions, next_pos),
                          {"window": window, **({"lse": True} if lse else {})})
    if _on_cuda(q):
        _no_backward("decode_attention", q, k_cache, v_cache)
        return decode_attention_cuda(q, k_cache, v_cache, positions, next_pos,
                                     window=window, lse=lse)
    return _ref.decode_attention_ref(q, k_cache, v_cache, positions, next_pos, window, lse)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
              u: torch.Tensor, chunk: int = 64,
              grad_chunk: Optional[int] = None) -> torch.Tensor:
    """The RWKV6 WKV scan from a zero state: r, k, v, logw (B,S,H,K), u
    (H,K) → y (B,S,H,K) float32.  ``chunk`` is checked on every device;
    under grad ``grad_chunk`` (default ``chunk``), the reference's chunk for
    the gradient, must divide S: the CPU differentiates the chunked form
    at it, the card's backward kernel the recurrence."""
    if count_hook is not None:
        return count_hook("rwkv6_wkv", (r, k, v, logw, u),
                          {"chunk": chunk, "grad_chunk": chunk if grad_chunk is None
                           else grad_chunk})
    check_rwkv6_inputs(r, k, v, logw, u, chunk)
    on_cuda = _on_cuda(r)
    if _needs_grad(r, k, v, logw, u):
        grad_chunk = chunk if grad_chunk is None else grad_chunk
        if grad_chunk < 1 or r.shape[1] % grad_chunk:
            raise ValueError(f"seq {r.shape[1]} not divisible by grad_chunk {grad_chunk}")
        return RWKV6WKV.apply(r, k, v, logw, u, chunk, grad_chunk)
    if on_cuda:
        return rwkv6_wkv_cuda(r, k, v, logw, u, chunk)
    return _ref.rwkv6_wkv_ref(r, k, v, logw, u)


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, chunk: int = 64, head_block: int = 8) -> torch.Tensor:
    """The Mamba2 SSD scan from a zero state, one B/C group: x (B,S,H,P),
    dt (B,S,H), a (H,), B/C (B,S,N) → y (B,S,H,P) float32 without the
    D-skip term.  ``chunk`` and ``head_block`` are checked on every device;
    under grad the CPU differentiates the chunked form at ``chunk``, the
    card's backward kernel the recurrence."""
    if count_hook is not None:
        return count_hook("mamba2_ssd", (x, dt, a, bmat, cmat),
                          {"chunk": chunk, "head_block": head_block})
    check_mamba2_inputs(x, dt, a, bmat, cmat, chunk, head_block)
    on_cuda = _on_cuda(x)
    if _needs_grad(x, dt, a, bmat, cmat):
        return Mamba2SSD.apply(x, dt, a, bmat, cmat, chunk, head_block)
    if on_cuda:
        return mamba2_ssd_cuda(x, dt, a, bmat, cmat, chunk, head_block)
    return _ref.mamba2_ssd_ref(x, dt, a, bmat, cmat)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
