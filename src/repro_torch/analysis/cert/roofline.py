"""Roofline latency floors and the cost-model drift gate.

A program with ``F`` flops, ``B`` unavoidable bytes (its input+output —
what even a perfectly fused executable must touch) and ``H`` bytes of
host→device upload can finish no sooner than::

    floor = max(F / peak_flops,  B / mem_bw,  H / h2d_bw)

on hardware with those ceilings.  The certifier computes this floor per
(rung, batch-size) from the static counts (``costs.py``) and uses it two
ways:

* **sanity** — the floor must sit at or below every *measured* p50 (a
  floor above a measurement means the counts or the hardware model are
  wrong);
* **drift gate** — the ratio ``prior / floor`` between the calibrated
  ``anytime/cost.py`` cold-start prior and the static floor is committed
  in the certificate.  ``--check`` recomputes the floor statically: if
  model code changed the FLOP count without anyone recalibrating the cost
  model, the ratio moves and the gate fails at ±25%.  The same
  comparison, fed a *live* cost model's priors (``drift_findings``),
  catches miscalibration at runtime.

The peak a floor uses is the one of the precision the program runs in
(``Hardware.peak(unit)``): on the H100 the perception steps' f32
convolutions run in TF32 (cuDNN's default, which the port keeps on
there), so they take the TF32 rate; where in doubt the higher peak, so a
floor stays a floor.  ``CPU_2CORE`` keeps the reference's numbers, so the
port's CPU floors can be held against the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Hardware", "CPU_2CORE", "H100_SXM", "roofline_floor", "drift_findings"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Peak ceilings for the roofline floor (all per second)."""

    name: str
    peak_flops: float            # FLOP/s, the highest rate
    mem_bw: float                # bytes/s, main memory
    h2d_bw: float                # bytes/s, host→device (loopback on CPU)
    peaks: tuple = ()            # ((unit, FLOP/s), ...) by precision

    def peak(self, unit: Optional[str] = None) -> float:
        """The rate of ``unit`` (``bf16``, ``tf32``, ``f32``), or
        ``peak_flops`` where the hardware names no such rate."""
        return dict(self.peaks).get(unit, self.peak_flops)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if not self.peaks:
            d.pop("peaks")
        else:
            d["peaks"] = dict(self.peaks)
        return d


# 2 cores × ~3 GHz × 8 f32 lanes (AVX2 FMA counts 2): generous, so the
# floor stays a floor even on a faster runner (the reference's numbers)
CPU_2CORE = Hardware("cpu-2core-avx2", peak_flops=9.6e10, mem_bw=3.0e10, h2d_bw=3.0e10)

# NVIDIA H100 SXM5 (data sheet, dense, 700 W): tensor cores 989 TFLOP/s in
# bf16 and 495 in TF32, 67 TFLOP/s of f32 outside them; 3.35 TB/s of HBM3;
# host to device over PCIe Gen5 x16, 64 GB/s one way
H100_SXM = Hardware("h100-sxm", peak_flops=989e12, mem_bw=3.35e12, h2d_bw=64e9,
                    peaks=(("bf16", 989e12), ("tf32", 495e12), ("f32", 67e12)))


def roofline_floor(flops: float, bytes_min: float, h2d_bytes: float, hw: Hardware,
                   unit: Optional[str] = None) -> float:
    """Static latency lower bound in seconds, the flops at ``unit``'s
    peak."""
    return max(flops / hw.peak(unit), bytes_min / hw.mem_bw, h2d_bytes / hw.h2d_bw)


def drift_findings(cost_table: list[dict], priors: dict, tol: float = 0.25) -> list[str]:
    """Cross-check live per-(rung, batch-size) cost-model priors against
    the certificate's committed ``prior/floor`` ratios.

    ``priors`` maps ``(rung_name, batch_size)`` → predicted latency
    seconds (e.g. from ``anytime.cost.cold_start_prior_table``).  A row
    whose live ratio deviates from the committed ratio by more than
    ``tol`` (relative) is reported — the static program and the learned
    cost model no longer describe the same computation.
    """
    findings = []
    for row in cost_table:
        key = (row["rung"], int(row["batch_size"]))
        if key not in priors or row.get("ratio") is None:
            continue
        floor = row["floor_s"]
        if floor <= 0.0:
            findings.append(f"{key}: non-positive static floor {floor}")
            continue
        live = priors[key] / floor
        committed = row["ratio"]
        drift = abs(live - committed) / committed
        if drift > tol:
            findings.append(
                f"{row['rung']}/batch{int(row['batch_size'])}: "
                f"prior/floor ratio drifted {drift:.0%} "
                f"(committed {committed:.1f}, live {live:.1f}, "
                f"tol {tol:.0%}) — recalibrate the cost model or "
                "regenerate the certificate")
    return findings
