"""Chaos episode runner / smoke gate (the port of the reference's
``repro/chaos/__main__.py``, at one shard).

::

    PYTHONPATH=src python -m repro_torch.chaos --episode sensor_stall_storm --check
    PYTHONPATH=src python -m repro_torch.chaos --episode sensor_stall_storm --check \\
        --device cpu --json-out chaos.json

Runs on the card unless ``--device cpu`` is given, and raises without one.
``--check`` asserts the reference's recovery gates: every killed-shard
stream re-seated within ``--reseat-bound`` ticks with a populated failover
ledger (shard-loss plans), at least one completed recovery within
``--recovery-bound`` ticks (plans that degrade streams), and every rung
engine's step captured exactly once over the whole episode (in place of
the reference's zero-compile ``TraceSentinel``: membership churn, stalls,
dropped corrupt frames and aborted buckets must never build a step anew).
``--mesh`` and episodes that want more than one shard
(``shard_loss_rush_hour``) exit naming ROADMAP.md Queue 1 step 8.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from .catalog import chaos_episode_names, get_chaos_episode, run_chaos_episode

__all__ = ["main"]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.chaos",
        description="Replay a chaos episode deterministically.")
    ap.add_argument("--episode", required=True, choices=chaos_episode_names())
    ap.add_argument("--mesh", default=None,
                    help="mesh spec (not ported yet: multi-device fleet)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the episode's seed")
    ap.add_argument("--tick-scale", type=float, default=None,
                    help="stretch/shrink the base trace")
    ap.add_argument("--json-out", default=None,
                    help="write the report + gate outcomes here")
    ap.add_argument("--check", action="store_true",
                    help="one capture per engine + recovery gates; exit 1 on violation")
    ap.add_argument("--reseat-bound", type=int, default=3,
                    help="max ticks from shard kill to last failover")
    ap.add_argument("--recovery-bound", type=int, default=20,
                    help="max ticks-to-healthy for any recovery")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    ep = get_chaos_episode(args.episode)
    if args.mesh is not None:
        ap.error("--mesh: the multi-device fleet is not ported yet (ROADMAP.md Queue 1 step 8)")
    if ep.mesh_data > 1:
        ap.error(f"episode {ep.name!r} wants {ep.mesh_data} data shards: the multi-device "
                 f"fleet is not ported yet (ROADMAP.md Queue 1 step 8)")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    report, replayer, plan = run_chaos_episode(
        args.episode, seed=args.seed, tick_scale=args.tick_scale, device=args.device)
    ledger = replayer.injector.ledger
    captures = {name: eng.executor.step_captures
                for name, eng in replayer.scheduler.engines.items()}

    problems: list = []
    reseat = ledger.reseat_ticks()
    if plan.kills:
        if not ledger.failovers():
            problems.append("shard was killed but the failover ledger is empty")
        elif reseat > args.reseat_bound:
            problems.append(f"worst reseat took {reseat} ticks (bound {args.reseat_bound})")
    recovery = ledger.recovery_times()
    if any(ev.kind == "degrade" for ev in ledger.events):
        if not recovery:
            problems.append("streams were degraded but none recovered to healthy before "
                            "the episode ended")
        elif max(recovery) > args.recovery_bound:
            problems.append(f"slowest recovery took {max(recovery):g} ticks "
                            f"(bound {args.recovery_bound})")
    bad = {n: c for n, c in captures.items() if c != 1}
    if bad:
        problems.append(f"engines captured their step other than once: {bad}")

    doc = {
        "episode": args.episode,
        "base": ep.base,
        "seed": args.seed if args.seed is not None else ep.seed,
        "mesh": None,
        "device": args.device,
        "n_shards": replayer.scheduler.n_shards,
        "n_faults": len(plan.events),
        "trace_counts": captures,
        "ledger_counts": ledger.counts(),
        "reseat_ticks": reseat,
        "recovery_ticks": recovery,
        "gates": {"checked": bool(args.check), "problems": problems},
        "report": report.to_dict(),
    }
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True, allow_nan=False)
            f.write("\n")

    totals = report.totals()
    print(f"[chaos] {args.episode} ({args.device}): {totals['frames']} frames, "
          f"{totals['drops']} drops, {len(plan.events)} fault events, "
          f"ledger {ledger.counts()}")
    if reseat is not None:
        print(f"[chaos] worst reseat: {reseat} tick(s)")
    if recovery:
        print(f"[chaos] recoveries: {len(recovery)} (slowest {max(recovery):g} ticks)")
    if args.check:
        if problems:
            for p in problems:
                print(f"[chaos] GATE FAILED: {p}")
            return 1
        print("[chaos] all gates passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
