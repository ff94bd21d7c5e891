"""Chaos episode runner / smoke gate (the port of the reference's
``repro/chaos/__main__.py``).

::

    PYTHONPATH=src python -m repro_torch.chaos --episode sensor_stall_storm --check
    PYTHONPATH=src python -m repro_torch.chaos --episode shard_loss_rush_hour \\
        --mesh data=2 --mesh-devices cuda:0,cuda:0 --check --json-out chaos.json
    PYTHONPATH=src python -m repro_torch.chaos --episode shard_loss_rush_hour \\
        --mesh data=2 --mesh-devices cpu,cpu --device cpu --check

Runs on the card unless ``--device cpu`` is given, and raises without one.
``--mesh`` builds a local mesh (``repro_torch.launch.mesh``) over every
visible device of ``--device``'s type, or over ``--mesh-devices``, a
comma-separated device list in which one device may appear more than once
(two shards on one card, each on its own stream).  An episode that wants
more data shards than the mesh gives exits before anything runs.
``--check`` asserts the reference's recovery gates: every killed-shard
stream re-seated within ``--reseat-bound`` ticks with a populated failover
ledger (shard-loss plans), at least one completed recovery within
``--recovery-bound`` ticks (plans that degrade streams), and the replay's
tick loop under ``TraceSentinel(compile_budget=0)`` (membership churn,
stalls, dropped corrupt frames, aborted buckets, failover and rebalance
must never build a step anew, and on the card no tick may synchronise with
the host), with every rung engine's step captured exactly once per shard
over the whole episode.  ``--json-out`` carries the sentinel's report under
``"sentinel"``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from ..analysis.sentinel import TraceSentinel
from ..distributed.sharding import data_shards
from ..launch.mesh import make_local_mesh, parse_mesh_spec
from .catalog import chaos_episode_names, get_chaos_episode, run_chaos_episode

__all__ = ["main"]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.chaos",
        description="Replay a chaos episode deterministically.")
    ap.add_argument("--episode", required=True, choices=chaos_episode_names())
    ap.add_argument("--mesh", default=None,
                    help="mesh spec, e.g. data=2 (required when the episode wants more "
                         "than one shard)")
    ap.add_argument("--mesh-devices", default=None,
                    help="with --mesh: comma-separated devices of the mesh, repeats "
                         "allowed (e.g. cuda:0,cuda:0); default every visible device "
                         "of --device's type")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the episode's seed")
    ap.add_argument("--tick-scale", type=float, default=None,
                    help="stretch/shrink the base trace")
    ap.add_argument("--json-out", default=None,
                    help="write the report + gate outcomes here")
    ap.add_argument("--check", action="store_true",
                    help="zero-build sentinel, one capture per engine and shard + recovery "
                         "gates; exit 1 on violation")
    ap.add_argument("--reseat-bound", type=int, default=3,
                    help="max ticks from shard kill to last failover")
    ap.add_argument("--recovery-bound", type=int, default=20,
                    help="max ticks-to-healthy for any recovery")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    ep = get_chaos_episode(args.episode)
    if args.mesh_devices is not None and args.mesh is None:
        ap.error("--mesh-devices needs --mesh")
    if args.mesh is None and ep.mesh_data > 1:
        ap.error(f"episode {ep.name!r} wants {ep.mesh_data} data shards: pass --mesh "
                 f"data={ep.mesh_data} (and --mesh-devices to name one device more than once)")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    mesh = None
    if args.mesh is not None:
        devices = args.mesh_devices.split(",") if args.mesh_devices is not None else None
        try:
            mesh = make_local_mesh(**parse_mesh_spec(args.mesh), device=args.device,
                                   devices=devices)
        except ValueError as exc:
            ap.error(f"--mesh: {exc}")
        if data_shards(mesh) < ep.mesh_data:
            ap.error(f"episode {ep.name!r} wants {ep.mesh_data} data shards, but the mesh "
                     f"{mesh} gives {data_shards(mesh)}: name more devices with "
                     f"--mesh-devices (one may repeat)")

    sentinel = TraceSentinel(compile_budget=0) if args.check else None
    report, replayer, plan = run_chaos_episode(
        args.episode, mesh=mesh, sentinel=sentinel, seed=args.seed,
        tick_scale=args.tick_scale, device=args.device)
    ledger = replayer.injector.ledger
    n_shards = replayer.scheduler.n_shards
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
    bad = {n: c for n, c in captures.items() if c != n_shards}
    if bad:
        problems.append(f"engines captured their step other than once per shard "
                        f"({n_shards}): {bad}")

    doc = {
        "episode": args.episode,
        "base": ep.base,
        "seed": args.seed if args.seed is not None else ep.seed,
        "mesh": args.mesh,
        "mesh_devices": [str(d) for d in mesh.devices.flat] if mesh is not None else None,
        "device": args.device,
        "n_shards": n_shards,
        "n_faults": len(plan.events),
        "trace_counts": captures,
        "ledger_counts": ledger.counts(),
        "reseat_ticks": reseat,
        "recovery_ticks": recovery,
        "gates": {"checked": bool(args.check), "problems": problems},
        "sentinel": sentinel.report().to_dict() if sentinel is not None else None,
        "report": report.to_dict(),
    }
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True, allow_nan=False)
            f.write("\n")

    totals = report.totals()
    print(f"[chaos] {args.episode} ({args.device}, {n_shards} shard(s)): {totals['frames']} "
          f"frames, "
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
