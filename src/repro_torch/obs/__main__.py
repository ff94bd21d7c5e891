"""Observability smoke CLI (the port of the reference's
``repro/obs/__main__.py``).

Replays a golden episode with tracing attached, then asserts the
observability contract:

* the exported Chrome trace validates against the trace-event schema;
* zero spans were dropped at the default ring capacity;
* the report is byte-identical to an untraced replay of the same episode
  (observation never perturbs the system it observes);
* the attribution report assigns the contention-segment variance to the
  hardware axis (>= --min-hardware-share after factoring out the
  controller's rung adaptation).

Usage (the card unless ``--device cpu`` is given)::

    PYTHONPATH=src python -m repro_torch.obs --episode urban_rush_hour \
        --out obs_trace.json
"""
from __future__ import annotations

import argparse
import sys

import torch

from . import Observatory, attribute, validate_chrome_trace

MEDIATED_ORDER = ("model", "hardware", "data", "io", "runtime")


def contention_attribution(obs: Observatory):
    """Attribution over the contention-injected frames (contention > 1 at
    any point in their segment), with the controller's discrete rung
    adaptation conditioned out first (model-first order) so the hardware
    axis answers for exactly the injected contention variance."""
    ramped = {s.segment for s in obs.frames if s.contention > 1.0}
    sub = [s for s in obs.frames if s.segment in ramped]
    return attribute(sub, order=MEDIATED_ORDER)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Trace a golden episode and check the obs contract.")
    ap.add_argument("--episode", default="urban_rush_hour")
    ap.add_argument("--out", default=None,
                    help="write the Chrome trace_event JSON here (artifact)")
    ap.add_argument("--min-hardware-share", type=float, default=0.8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    # scenarios builds on obs: imported here, not at module level
    from ..scenarios.golden import golden_replay

    obs = Observatory()
    report_on, scheduler = golden_replay(args.episode, obs=obs, device=args.device)
    report_off, _ = golden_replay(args.episode, scheduler=scheduler)

    failures = 0

    doc = obs.chrome_trace(process_label=args.episode)
    errors = validate_chrome_trace(doc)
    if errors:
        failures += 1
        print(f"[obs] trace schema: {len(errors)} violation(s)")
        for e in errors[:10]:
            print(f"  - {e}")
    else:
        print(f"[obs] trace schema ok ({len(doc['traceEvents'])} events)")

    if obs.tracer.dropped:
        failures += 1
        print(f"[obs] DROPPED {obs.tracer.dropped} spans at ring capacity "
              f"{obs.tracer.capacity}")
    else:
        print(f"[obs] zero dropped spans ({obs.tracer.n_recorded} recorded, "
              f"capacity {obs.tracer.capacity})")

    if report_on.to_json() != report_off.to_json():
        failures += 1
        print("[obs] REPORT DRIFT: tracing changed the replay report")
    else:
        print("[obs] report byte-identical with tracing attached")

    att = contention_attribution(obs)
    injected = att.total_variance - att.explained["model"]["variance"]
    hw = att.explained["hardware"]["variance"]
    share = hw / injected if injected > 0 else 0.0
    print(att.table())
    if share < args.min_hardware_share:
        failures += 1
        print(f"[obs] hardware axis claims only {share:.1%} of injected "
              f"contention-segment variance "
              f"(need >= {args.min_hardware_share:.0%})")
    else:
        print(f"[obs] hardware axis claims {share:.1%} of injected "
              f"contention-segment variance")

    if args.out:
        obs.write_trace(args.out, process_label=args.episode)
        print(f"[obs] wrote {args.out}")

    if failures:
        print(f"[obs] FAILED: {failures} check(s)")
        return 1
    print("[obs] all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
