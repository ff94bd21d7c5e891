"""Building, serializing, and checking the timing certificate.

The committed artifact (``analysis/torch_certificate.json``) has two kinds
of content, split by how they are produced:

* **static** — envelope hash, per-program signatures, FLOP/byte counts,
  host-op scan, the in-place-write cross-check, roofline floors on
  ``H100_SXM``.  Recomputed *exactly* at ``--check`` time from the
  shipped code by counting on fake tensors (no arithmetic runs, no card
  is needed); any difference against the committed values is a finding.
* **measured** — per-(rung, batch-size) cold-start cost-model priors
  (``prior_s``, from a short calibration on the card) and the card's own
  step times (``bench_p50_s``: the median device time of one
  whole-capacity submit of an engine at capacity *b* — every slot
  uploaded, the captured step replayed, its outputs read back — between
  CUDA events), with the card's name and power limit beside them
  (``measured``).  Only refreshed by ``--regen --measure`` on the card,
  committed like golden fixtures; ``--check`` treats them as constants
  and re-derives just the *ratios* against the fresh floors.

Severity follows the capture-hazard model: signature drift, sweep
violations, new host ops and in-place-write mismatches are **fatal** (the
envelope claim no longer holds); FLOP/byte count changes alone are
**notes** — magnitude drift is what the prior/floor ratio gate (±25%)
exists to catch.

The reference's certificate also lists ``assemble``, ``pack`` and
``slot_update`` programs per rung; the port's executor has no such
programs (``batched/executor.py``: slot writes are pinned copies into the
static block), so only ``<rung>/step`` is certified per rung, at every
declared shard count (``<rung>@data2/step`` at two shards).
"""
from __future__ import annotations

import json
import statistics
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .costs import count_program, program_io_bytes
from .envelope import InputEnvelope, default_envelope, envelope_hash
from .roofline import H100_SXM, Hardware, roofline_floor
from .tracer import certify_rung, trace_kernel, trace_ladder_rung

__all__ = [
    "CERT_VERSION",
    "DEFAULT_CERT_PATH",
    "DRIFT_TOL",
    "PERCEPTION_UNIT",
    "build_static",
    "attach_measured",
    "measure_steps",
    "check",
    "intrinsic_findings",
    "render_report",
    "load_certificate",
    "write_certificate",
]

CERT_VERSION = 1
DEFAULT_CERT_PATH = Path("analysis") / "torch_certificate.json"
DRIFT_TOL = 0.25
# the perception steps' f32 convolutions run in TF32 on the card (cuDNN's
# default): their flops take that rate
PERCEPTION_UNIT = "tf32"
# about a millisecond of the card's clock: longer than the host takes to
# stage a capacity-8 submit
SLEEP_CYCLES = 2_000_000
MEASURE_REPS = 15


def _cost_row(point, batch: int, env: InputEnvelope, hw: Hardware) -> dict:
    """Static roofline row for one (rung, batch-size): the step an engine
    with ``capacity == batch`` captures, all slots uploaded."""
    from repro_torch.perception.pipelines import build_pipeline

    built = build_pipeline(point.pipeline, scale=point.scale, pad=point.pad, device="cpu")
    raw = torch.empty((batch, *env.image_shape), dtype=torch.float32, device="meta")
    counts, out = count_program(built.device_step, raw)
    in_b, out_b = program_io_bytes((raw,), out)
    bytes_min = in_b + out_b
    # every slot dirty every tick: h2d = the whole batch
    h2d = float(batch * int(np.prod(env.image_shape)) * 4)
    floor = roofline_floor(counts.flops, bytes_min, h2d, hw, PERCEPTION_UNIT)
    return {
        "rung": point.name,
        "batch_size": int(batch),
        "flops": counts.flops,
        "bytes_min": bytes_min,
        "h2d_bytes": h2d,
        "intensity": counts.flops / bytes_min if bytes_min else 0.0,
        "floor_s": floor,
        "prior_s": None,
        "ratio": None,
        "bench_p50_s": None,
    }


def build_static(env: InputEnvelope | None = None, hw: Hardware = H100_SXM,
                 engine_cls=None) -> dict:
    """Sweep the whole envelope on the CPU and assemble the static
    certificate: counting on fake tensors end to end, no inference
    arithmetic.  ``engine_cls`` substitutes the batched engine class (the
    injection test passes a mutated copy)."""
    if env is None:
        env = default_envelope()

    programs: dict[str, dict] = {}
    violations: list[list] = []
    fleet = []
    for k in env.fleet_shards:
        divides = env.capacity % k == 0
        row = {"data_shards": int(k), "slot_spec": "data" if k > 1 else None,
               "slots_per_shard": env.capacity // k if divides else None}
        if not divides:
            violations.append(["fleet/slot_batch_spec",
                               f"capacity {env.capacity} not divisible by data axis {k}",
                               f"data={k}"])
            fleet.append(row)
            continue
        captures = {}
        for point in env.rungs:
            trace = certify_rung(point, env, engine_cls=engine_cls, shards=k)
            for name, summary in trace.programs.items():
                programs[name] = summary.to_dict()
            violations.extend([list(v) for v in trace.violations])
            captures[point.name] = trace.step_captures
        row["step_captures"] = captures
        fleet.append(row)
    for point in env.ladder_rungs:
        summary = trace_ladder_rung(point, env)
        programs[summary.name] = summary.to_dict()
    for kp in env.kernels:
        summary = trace_kernel(kp)
        programs[summary.name] = summary.to_dict()

    cost_table = [_cost_row(point, b, env, hw) for point in env.rungs for b in env.batch_sizes]
    return {
        "version": CERT_VERSION,
        "envelope_hash": envelope_hash(env),
        "envelope": env.describe(),
        "hardware": hw.to_dict(),
        "programs": programs,
        "violations": violations,
        "cost_table": cost_table,
        "fleet": fleet,
    }


def measure_steps(env: InputEnvelope, device: str | torch.device = "cuda") -> dict:
    """(rung, batch) → median device seconds of one whole-capacity submit
    of an engine at capacity ``batch`` on ``device``: every slot uploaded
    from pinned memory, the captured step replayed, its outputs copied
    back, between CUDA events on the engine's stream (one shard: the
    current stream), ``MEASURE_REPS`` times after two warm ticks.  A spin of
    ``SLEEP_CYCLES`` before the first event holds the stream while the
    host stages the frames, so host time falls outside the interval."""
    from repro_torch.batched.engine import BatchedPerceptionEngine

    rng = np.random.default_rng(0)
    out = {}
    for point in env.rungs:
        for b in env.batch_sizes:
            eng = BatchedPerceptionEngine(point.pipeline, capacity=b,
                                          image_shape=tuple(env.image_shape), device=device)
            frames = {f"cam{i}": rng.standard_normal(tuple(env.image_shape)).astype(np.float32)
                      for i in range(b)}
            for sid in frames:
                eng.join(sid)
            for _ in range(2):
                eng.tick(frames)
            ex = eng.executor
            slot_frames = {eng.active[sid].slot: f for sid, f in frames.items()}
            times = []
            for _ in range(MEASURE_REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                # the stream waits while the host stages and enqueues the
                # submit, so the events bracket device work only
                torch.cuda._sleep(SLEEP_CYCLES)
                start.record()
                ex.submit(slot_frames)
                end.record()
                ex.drain()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            out[(point.name, b)] = statistics.median(times)
            del eng
    return out


def attach_measured(cert: dict, env: InputEnvelope | None = None, measure: bool = False,
                    device: str | torch.device = "cpu", calib_n: int = 4,
                    card: Optional[dict] = None) -> dict:
    """Fill the measured columns at ``--regen`` time.

    * ``prior_s`` — the cold-start (rung, batch-size) cost-model prior
      from a short calibration (``anytime.calibrate`` at ``calib_n``
      frames per rung on ``device``), via ``cold_start_prior_table``;
    * ``ratio`` — ``prior_s / floor_s``, the drift-gate anchor;
    * ``bench_p50_s`` (``measure``: the card only) — ``measure_steps``;
      ``card`` (name, power limit) is stored beside them.
    """
    from repro_torch.anytime.cost import cold_start_prior_table
    from repro_torch.anytime.ladder import Rung, calibrate
    from repro_torch.perception.data import SceneConfig

    if env is None:
        env = default_envelope()
    rungs = [Rung(p.name, p.pipeline, p.scale) for p in env.rungs]
    ladder = calibrate(rungs, SceneConfig(), n=calib_n, device=device)
    priors = cold_start_prior_table(list(ladder), env.batch_sizes)
    bench = measure_steps(env, device) if measure else {}
    for row in cert["cost_table"]:
        key = (row["rung"], row["batch_size"])
        if key in priors:
            row["prior_s"] = priors[key]
            row["ratio"] = priors[key] / row["floor_s"] if row["floor_s"] > 0 else None
        if key in bench:
            row["bench_p50_s"] = bench[key]
    cert["measured"] = {"device": str(device), "calib_n": calib_n,
                        "bench": "device time of one whole-capacity submit (upload, step "
                                 "replay, readback), median" if measure else None,
                        **(card or {})}
    return cert


# ---------------------------------------------------------------------------
# checking
# ---------------------------------------------------------------------------

def intrinsic_findings(static: dict) -> list[str]:
    """Fatal problems a static build carries on its own, before any
    comparison against a committed certificate."""
    findings = []
    for prog, sig, where in static.get("violations", []):
        findings.append(
            f"RECAPTURE {prog}: new signature {sig} after freeze (envelope point: {where})")
    for name, p in sorted(static.get("programs", {}).items()):
        declared = set(p.get("declared_mutation", []))
        traced = p.get("mutated_inputs")
        if traced is not None:
            actual = {i for i, m in enumerate(traced) if m}
            if declared != actual:
                findings.append(
                    f"MUTATION {name}: declares in-place writes to inputs {sorted(declared)} "
                    f"but the traced program writes {sorted(actual)}")
        elif declared:
            findings.append(
                f"MUTATION {name}: declares in-place writes to inputs {sorted(declared)} but "
                "the program was not traced")
    for fleet in static.get("fleet", []):
        for rung, n in (fleet.get("step_captures") or {}).items():
            if n != fleet["data_shards"]:
                findings.append(
                    f"CAPTURES {rung}@data{fleet['data_shards']}: {n} step builds, one per "
                    f"shard expected")
    return findings


def check(committed: dict, fresh: dict, tol: float = DRIFT_TOL
          ) -> tuple[list[str], list[str]]:
    """Compare a committed certificate against a freshly counted static
    build.  Returns ``(fatal, notes)``: fatal findings fail the gate,
    notes are informational drift."""
    fatal = list(intrinsic_findings(fresh))
    notes: list[str] = []

    if committed.get("version") != fresh["version"]:
        fatal.append(f"VERSION certificate v{committed.get('version')} != "
                     f"checker v{fresh['version']} — regenerate")
        return fatal, notes
    if committed.get("envelope_hash") != fresh["envelope_hash"]:
        fatal.append(
            f"ENVELOPE hash {committed.get('envelope_hash')} → {fresh['envelope_hash']}: the "
            "declared input set changed (rung, batch size, shape, or kernel shape) — review "
            "and --regen")
    if committed.get("hardware") != fresh["hardware"]:
        fatal.append(
            "HARDWARE model changed "
            f"({committed.get('hardware', {}).get('name')} → {fresh['hardware']['name']}) — "
            "review and --regen")
    if committed.get("fleet") != fresh.get("fleet"):
        fatal.append(
            f"FLEET slot-block partition changed ({committed.get('fleet')} → "
            f"{fresh.get('fleet')}) — the sharded serving layout is part of the envelope "
            "claim; review and --regen")

    old_p = committed.get("programs", {})
    new_p = fresh["programs"]
    for name in sorted(set(old_p) - set(new_p)):
        fatal.append(f"PROGRAM {name} disappeared from the traced set")
    for name in sorted(set(new_p) - set(old_p)):
        fatal.append(f"PROGRAM {name} is new (uncertified) — --regen")
    for name in sorted(set(old_p) & set(new_p)):
        o, n = old_p[name], new_p[name]
        if o["signatures"] != n["signatures"]:
            fatal.append(f"SIGNATURES {name}: {o['signatures']} → {n['signatures']} — "
                         "traced signature set changed")
        new_hosts = set(map(tuple, n.get("host_prims", []))) \
            - set(map(tuple, o.get("host_prims", [])))
        for path, prim in sorted(new_hosts):
            fatal.append(f"HOSTPRIM {name}: new host-interaction op {prim} at {path} inside "
                         "the program")
        for field in ("flops", "mem_bytes", "transcendentals"):
            if o.get(field) != n.get(field):
                notes.append(f"{name}: {field} {o.get(field)} → {n.get(field)}")
        if o.get("unknown") != n.get("unknown"):
            notes.append(f"{name}: uncounted ops {o.get('unknown')} → {n.get('unknown')}")

    old_rows = {(r["rung"], r["batch_size"]): r for r in committed.get("cost_table", [])}
    for row in fresh["cost_table"]:
        key = (row["rung"], row["batch_size"])
        label = f"{key[0]}/batch{key[1]}"
        old = old_rows.get(key)
        if old is None:
            fatal.append(f"COST {label}: no committed row — --regen")
            continue
        floor = row["floor_s"]
        prior, ratio = old.get("prior_s"), old.get("ratio")
        if prior is not None and floor > prior:
            fatal.append(
                f"FLOOR {label}: static floor {floor * 1e3:.4f}ms exceeds the cost-model "
                f"prior {prior * 1e3:.4f}ms — counts or hardware model are wrong, or the "
                "model got cheaper without recalibration")
        if prior is not None and ratio is not None and ratio > 0:
            live = prior / floor if floor > 0 else float("inf")
            drift = abs(live - ratio) / ratio
            if drift > tol:
                fatal.append(
                    f"DRIFT {label}: prior/floor ratio moved {drift:.0%} (committed "
                    f"{ratio:.1f}, recomputed {live:.1f}, tol {tol:.0%}) — static cost and "
                    "learned prior have diverged; recalibrate or --regen")
        bench = old.get("bench_p50_s")
        if bench is not None and floor > bench:
            fatal.append(
                f"FLOOR {label}: static floor {floor * 1e3:.4f}ms exceeds the measured step "
                f"p50 {bench * 1e3:.4f}ms — the floor is not a floor; fix the counts or the "
                "hardware model")
    return fatal, notes


def render_report(fatal: list[str], notes: list[str]) -> str:
    """Human-readable gate report (written as the diff artifact)."""
    lines = ["tvcert check: " + ("FAIL" if fatal else "PASS"), ""]
    if fatal:
        lines.append(f"{len(fatal)} fatal finding(s):")
        lines += [f"  [FATAL] {f}" for f in fatal]
        lines.append("")
    if notes:
        lines.append(f"{len(notes)} note(s):")
        lines += [f"  [note]  {n}" for n in notes]
        lines.append("")
    if not fatal and not notes:
        lines.append("certificate matches the shipped tree exactly.")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def load_certificate(path: str | Path) -> dict:
    return json.loads(Path(path).read_text())


def write_certificate(cert: dict, path: str | Path) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(cert, indent=2, sort_keys=True) + "\n")
