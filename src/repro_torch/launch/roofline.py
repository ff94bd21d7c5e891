"""Roofline analysis of one rank's step, from the static counter
(``analysis.cert.costs``) over the step ``launch.lowering`` builds.

Three terms, in seconds per step on the target card (``H100_SXM``):

    compute    = counted flops per rank / peak FLOP/s of the step's precision
    memory     = fused bytes per rank / HBM rate
    collective = collective bytes per rank / link rate

* ``memory_raw_s`` is the counter's unfused bytes (``io_bytes``: every
  op's inputs and outputs) over the HBM rate, an upper estimate;
* ``memory_s`` is the fused estimate that decisions use: the program's
  arguments read once plus every computed intermediate written once and
  read once (``2 · write_bytes``: views, copies and creations left out),
  as the reference's ``hlo_fused_bytes`` counts an HLO module;
* the collective bytes are the result bytes of the collectives the step
  issues (``lowering.record_collectives``), over NVLink 4's rate per
  direction.

``model_flops`` (6·N·D dense / 6·N_active·D MoE; 2·N·D for inference)
gives the ``useful_fraction`` diagnostic, model flops over counted flops
× ranks.  The port's meshed step repeats the layer's compute on every
rank of a data row (``lowering``), so at ``model=16`` it reads about
1/16 until tensor-parallel compute lands (ROADMAP step 8b).

``memory_analysis`` is per rank, in bytes: ``arguments`` (the rank's
parameter blocks, AdamW moments, rows of the batch, decode state),
``gathered`` (full weights, and for training full gradients, which the
step makes), ``activations_estimate`` (the most that tensors saved for
backward hold at once, from the counter: an estimate, not an allocator's
peak)
and ``total``; ``fits`` is ``total <= hw.hbm_bytes``.

``analyze_extrapolated`` counts two reduced depths and extrapolates every
term affinely to the full depth (``cost(L) = fixed + per_layer · L``), as
the reference does, so a full sweep stays cheap.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.analysis.cert.roofline import H100_SXM as _CERT_H100
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.models.params import resolve_dtype

from .lowering import LoweredStep, build_lowered

__all__ = ["Hardware", "H100_SXM", "RooflineReport", "active_params", "model_flops",
           "analyze", "analyze_extrapolated", "step_unit"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float     # FLOP/s, the highest rate
    hbm_bw: float         # B/s
    link_bw: float        # B/s per direction between two cards
    hbm_bytes: float      # per-card capacity
    peaks: tuple = ()     # ((unit, FLOP/s), ...)

    def peak(self, unit: Optional[str] = None) -> float:
        return dict(self.peaks).get(unit, self.peak_flops)


# NVIDIA H100 SXM5 (data sheet, dense, 700 W): the certifier's peaks and HBM
# rate, 80 GB of HBM3, NVLink 4 at 450 GB/s per direction
H100_SXM = Hardware(name=_CERT_H100.name, peak_flops=_CERT_H100.peak_flops,
                    hbm_bw=_CERT_H100.mem_bw, link_bw=450e9, hbm_bytes=80e9,
                    peaks=_CERT_H100.peaks)


def step_unit(cfg: ModelConfig) -> str:
    """The rate a model's products run at: bf16 on the tensor cores for a
    bf16 model, else the f32 rate (``main`` turns TF32 off for models)."""
    return "bf16" if resolve_dtype(cfg.dtype) in (torch.bfloat16, torch.float16) else "f32"


def active_params(cfg: ModelConfig, model: Model) -> float:
    """Per-token active parameter count (MoE: top-k experts only)."""
    n = model.num_params()
    if not cfg.num_experts:
        return float(n)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    d, f = cfg.d_model, cfg.d_ff
    per_layer_expert = e * (3 if cfg.mlp_gated else 2) * d * f
    expert_total = cfg.num_layers * per_layer_expert
    return float(n - expert_total + expert_total * (k / e))


def model_flops(cfg: ModelConfig, shape_name) -> float:
    """Useful FLOPs per step, global: 6·N_active·D for training,
    2·N_active·D for inference (D = tokens processed in the step).
    ``shape_name`` is a name of ``SHAPES`` or an ``InputShape``."""
    n_act = active_params(cfg, Model(cfg))
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch      # one token per sequence


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    kind: str
    chips: int
    flops_per_device: float
    bytes_per_device: float           # unfused (io_bytes)
    fused_bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float                   # fused estimate — decisions use this
    collective_s: float
    dominant: str
    model_flops_global: float
    useful_fraction: float            # model flops / (counted flops × ranks)
    collectives: dict
    memory_raw_s: float = 0.0         # unfused upper estimate
    memory_analysis: Optional[dict] = None
    fits: Optional[bool] = None
    kernels: Optional[dict] = None
    fsdp: Optional[bool] = None
    grad_accum: Optional[int] = None
    note: str = ""

    def as_row(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("collectives", None)
        return d

    def bound_summary(self) -> str:
        return (f"{self.arch} × {self.shape} [{self.mesh}] {self.dominant}-bound: compute "
                f"{self.compute_s * 1e3:.3f}ms, memory {self.memory_s * 1e3:.3f}ms (raw "
                f"{self.memory_raw_s * 1e3:.3f}ms), collective {self.collective_s * 1e3:.3f}ms; "
                f"useful={self.useful_fraction:.3f}")


def _memory(step: LoweredStep, saved_bytes: float, hw: Hardware) -> tuple[dict, bool]:
    args = sum(step.resident.values())
    gathered = sum(step.gathered.values())
    act = saved_bytes
    total = args + gathered + act
    return ({"arguments": args, **{f"arguments_{k}": v for k, v in step.resident.items()},
             "gathered": gathered, **{f"gathered_{k}": v for k, v in step.gathered.items()},
             "activations_estimate": act, "total": total}, total <= hw.hbm_bytes)


def _report(step: LoweredStep, counts, table: dict, hw: Hardware, cfg, shape_name: str,
            chips: int, note: str = "") -> RooflineReport:
    flops = counts.flops
    fused = 2.0 * counts.write_bytes + sum(step.resident.values())
    cbytes = sum(v["bytes"] for v in table.values())
    compute_s = flops / hw.peak(step_unit(cfg))
    memory_s = fused / hw.hbm_bw
    memory_raw_s = counts.io_bytes / hw.hbm_bw
    collective_s = cbytes / hw.link_bw
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape_name)
    mem, fits = _memory(step, counts.saved_bytes, hw)
    return RooflineReport(
        arch=step.arch, shape=step.shape, mesh=step.mesh_desc, kind=step.kind, chips=chips,
        flops_per_device=flops, bytes_per_device=counts.io_bytes,
        fused_bytes_per_device=fused, collective_bytes_per_device=cbytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops_global=mf,
        useful_fraction=mf / (flops * chips) if flops else float("nan"), collectives=table,
        memory_raw_s=memory_raw_s, memory_analysis=mem, fits=fits,
        kernels=dict(counts.kernels), fsdp=step.fsdp, grad_accum=step.grad_accum, note=note)


def analyze(step: LoweredStep, hw: Hardware = H100_SXM) -> RooflineReport:
    """The roofline of ``step`` as built (its depth, counted in full)."""
    counts, table = step.count()
    return _report(step, counts, table, hw, step.cfg, step.input_shape, step.mesh.size)


def _analysis_depths(cfg: ModelConfig) -> tuple[int, int, int]:
    """(L1, L2, L_full) for the extrapolation, respecting family structure."""
    if cfg.family == "hybrid":
        return cfg.attn_every, 2 * cfg.attn_every, cfg.num_layers
    return 2, 4, cfg.num_layers


def analyze_extrapolated(arch: str, shape_name: str, mesh, hw: Hardware = H100_SXM, *,
                         cfg_overrides: Optional[dict] = None, rules=None, fsdp=None,
                         grad_accum=None) -> RooflineReport:
    """Count the step at two reduced depths and extrapolate every term
    affinely to the full depth.  The policies (FSDP, microbatches) are
    resolved at the full depth and held for both counts."""
    base = dict(cfg_overrides or {})
    cfg = get_config(arch)
    if base:
        cfg = cfg.replace(**base)
    l1, l2, lfull = _analysis_depths(cfg)
    full = build_lowered(arch, shape_name, mesh, cfg_overrides=base, rules=rules, fsdp=fsdp,
                         grad_accum=grad_accum)
    runs = []
    for depth in (l1, l2):
        step = build_lowered(arch, shape_name, mesh, cfg_overrides={**base, "num_layers": depth},
                             rules=rules, fsdp=full.fsdp, grad_accum=full.grad_accum)
        counts, table = step.count()
        runs.append((counts, table))

    def affine(a: float, b: float) -> float:
        return a + (b - a) / (l2 - l1) * (lfull - l1)

    (c1, t1), (c2, t2) = runs
    counts = dataclasses.replace(
        c1, flops=affine(c1.flops, c2.flops), io_bytes=affine(c1.io_bytes, c2.io_bytes),
        write_bytes=affine(c1.write_bytes, c2.write_bytes),
        saved_bytes=affine(c1.saved_bytes, c2.saved_bytes),
        kernels={k: affine(c1.kernels.get(k, 0), c2.kernels.get(k, 0))
                 for k in set(c1.kernels) | set(c2.kernels)})
    table = {}
    for op in set(t1) | set(t2):
        a = t1.get(op, {"count": 0, "bytes": 0.0})
        b = t2.get(op, {"count": 0, "bytes": 0.0})
        table[op] = {"count": affine(a["count"], b["count"]),
                     "bytes": affine(a["bytes"], b["bytes"])}
    chips = full.mesh.size
    note = (f"extrapolated from depths {l1},{l2} -> {lfull}; memory term = fused estimate "
            f"(raw upper estimate {counts.io_bytes / hw.hbm_bw * 1e3:.1f}ms); the port's "
            f"meshed step gathers every leaf and repeats the layer on every rank of a data "
            f"row (model axis: storage only until ROADMAP step 8b), so useful_fraction reads "
            f"about 1/{full.mesh.shape.get('model', 1)} of a tensor-parallel step's")
    return _report(full, counts, table, hw, cfg, shape_name, chips, note)
