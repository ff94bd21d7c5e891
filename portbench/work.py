"""The yardstick's arithmetic: the card's peaks, each kernel's least work from
a call's shapes, and a model's useful operations.

Frozen copies, so that a later change to the program cannot move them:

* peaks: the NVIDIA H100 SXM data sheet (dense, 700 W), as the program's
  ``analysis/cert/roofline.py::H100_SXM``: bf16 989 TFLOP/s, TF32 495,
  f32 67, HBM 3.35 TB/s;
* flash forward and backward: ``kernels/cost.py``'s least work (the causal
  pairs' products, each input read once and each output written once),
  with the row log-sum-exp that the training path's forward writes and its
  backward reads counted as an output and an input;
* the scans' forwards: ``kernels/cost.py``'s (4 K² or 4 P N flops a
  position and head, in split TF32: three passes at the TF32 rate);
* the scans' gradients: ``chip_smoke.py::scan_grad_work``'s least work
  (10 K² or 10 P N flops a position and head at split TF32; the bytes of
  ``kernels/cost.py``'s declared gradient costs);
* the model's operations: ``launch/roofline.py::model_flops`` (2 N D to
  serve, 6 N D to train) with N counted as ``useful_params`` says.

A least time is the larger of the operations over their peak and the
bytes over the HBM rate.
"""
from __future__ import annotations

import dataclasses
import math

PEAKS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
CARD = "NVIDIA H100 SXM (data sheet, dense, 700 W)"


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float
    unit: str          # a key of PEAKS
    passes: int = 1    # tensor-core passes a product takes (split TF32: 3)

    def seconds(self) -> float:
        """The least time on the card."""
        return max(self.passes * self.flops / PEAKS[self.unit], self.bytes / HBM_BYTES_PER_S)


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def flash_fwd(b: int, s: int, h: int, kv: int, d: int, esz: int = 2, lse: bool = False) -> Work:
    """q (B,S,H,D), k and v (B,S,KV,D) → o like q, causal; with ``lse`` also
    the rows' f32 log-sum-exp (B,H,S)."""
    q, k = b * s * h * d, b * s * kv * d
    return Work(flops=4.0 * b * h * d * causal_pairs(s),
                bytes=(q + 2 * k + q) * esz + (4.0 * b * h * s if lse else 0.0), unit="bf16")


def flash_bwd(b: int, s: int, h: int, kv: int, d: int, esz: int = 2) -> Work:
    """From q, k, v, o, dO and the rows' log-sum-exp to dq, dk, dv: five
    products over the causal pairs."""
    q, k = b * s * h * d, b * s * kv * d
    return Work(flops=10.0 * b * h * d * causal_pairs(s),
                bytes=(3 * q + 2 * k) * esz + 4.0 * b * h * s + (q + 2 * k) * esz, unit="bf16")


def wkv_fwd(b: int, s: int, h: int, k: int) -> Work:
    """r, k, v, log w (B,S,H,K) and u (H,K), f32 → y (B,S,H,K) f32."""
    n = b * s * h * k
    return Work(flops=4.0 * n * k, bytes=(4 * n + h * k) * 4.0 + n * 4.0, unit="tf32", passes=3)


def wkv_bwd(b: int, s: int, h: int, k: int) -> Work:
    """From r, k, v, log w, u and dy to their gradients."""
    n = b * s * h * k
    return Work(flops=10.0 * n * k, bytes=(5 * n + h * k) * 4.0 + (4 * n + h * k) * 4.0,
                unit="tf32", passes=3)


def ssd_fwd(b: int, s: int, h: int, p: int, n: int) -> Work:
    """x (B,S,H,P), dt (B,S,H), a (H,), B and C (B,S,N), f32 → y like x."""
    x = b * s * h * p
    return Work(flops=4.0 * x * n, bytes=(x + b * s * h + h + 2 * b * s * n) * 4.0 + x * 4.0,
                unit="tf32", passes=3)


def ssd_bwd(b: int, s: int, h: int, p: int, n: int) -> Work:
    """From x, dt, a, B, C and dy to their gradients."""
    x = b * s * h * p
    return Work(flops=10.0 * x * n,
                bytes=(2 * x + b * s * h + h + 2 * b * s * n) * 4.0
                + (x + b * s * h + h + 2 * b * s * n) * 4.0, unit="tf32", passes=3)


def useful_params(cfg: dict, n_params: int) -> tuple[float, float]:
    """(N of the body, N of the head): every weight but the embedding table,
    which is a lookup, not a product; the head's table apart, since serving
    a prompt multiplies it for the last position only."""
    vocab_rows = -(-cfg["vocab_size"] // cfg["vocab_pad_to"]) * cfg["vocab_pad_to"]
    table = vocab_rows * cfg["d_model"]
    return float(n_params - 2 * table), float(table)


def serve_flops(cfg: dict, n_params: int, batch: int, length: int) -> float:
    """2 N D for one prefill of ``batch`` rows of ``length``: the body over
    every position, the head over the last."""
    body, head = useful_params(cfg, n_params)
    return 2.0 * body * batch * length + 2.0 * head * batch


def train_flops(cfg: dict, n_params: int, batch: int, length: int) -> float:
    """6 N D for one training step (the head over every position)."""
    body, head = useful_params(cfg, n_params)
    return 6.0 * (body + head) * batch * length


def n_params(layout_shapes: dict) -> int:
    return sum(math.prod(s) for s in layout_shapes.values())
