"""Dry-run: count every (architecture × input shape) step on the
production meshes — 16×16 (256 ranks) and 2×16×16 (512 ranks, two pods)
— as one rank of the port's meshed step, and hold its per-rank memory
against one card's 80 GB.

Nothing is allocated and nothing runs: the step is built on meta tensors
at one rank's shapes (``launch.lowering``) and counted on fake tensors
(``analysis.cert.costs``), so a 512-rank mesh costs what a 1-rank one
does, and neither a card nor a process group is needed.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh single --out results.jsonl
    python -m repro_torch.launch.dryrun --all --mesh multi  --out results_mp.jsonl

Every record carries the per-rank bytes (``memory_analysis``) and
``fits``; with the analysis on (the default) also the roofline terms of
``launch.roofline.analyze_extrapolated``.  Shapes the registry skips by
design are ``skipped`` with the reason; any other failure is an ``error``
record and the exit code is 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicability
from repro_torch.distributed.mesh import LogicalMesh
from repro_torch.launch.lowering import build_lowered
from repro_torch.launch.mesh import MULTIPOD_SHAPE, PROD_SHAPE
from repro_torch.launch.roofline import H100_SXM, _memory, analyze_extrapolated


def production_mesh(kind: str) -> LogicalMesh:
    if kind == "multi":
        return LogicalMesh(MULTIPOD_SHAPE, ("pod", "data", "model"))
    return LogicalMesh(PROD_SHAPE, ("data", "model"))


def run_one(arch: str, shape: str, mesh_kind: str, overrides=None, fsdp=None, grad_accum=None,
            analysis: bool = True) -> dict:
    mesh = production_mesh(mesh_kind)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    ok, why = shape_applicability(cfg, SHAPES[shape])
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "chips": int(mesh.size)}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    try:
        # the full-depth step: its layout, policies and per-rank bytes at rest
        step = build_lowered(arch, shape, mesh, fsdp=fsdp, grad_accum=grad_accum,
                             cfg_overrides=overrides)
        t_lower = time.time() - t0
        if analysis:
            report = analyze_extrapolated(arch, shape, mesh, H100_SXM, cfg_overrides=overrides,
                                          fsdp=step.fsdp, grad_accum=step.grad_accum)
            row = report.as_row()
            row.update(analysis_s=round(time.time() - t0 - t_lower, 1))
            rec.update(row)
            rec["collectives"] = report.collectives
        else:
            mem, fits = _memory(step, 0.0, H100_SXM)
            rec.update(memory_analysis=mem, fits=fits, kind=step.kind,
                       note="no analysis: activations not estimated")
        rec.update(status="ok", lower_s=round(t_lower, 1), fsdp=step.fsdp,
                   grad_accum=step.grad_accum)
        mem = rec["memory_analysis"]
        print(f"  per rank {mem['total'] / 1e9:.3f} GB (arguments {mem['arguments'] / 1e9:.3f}, "
              f"gathered {mem['gathered'] / 1e9:.3f}, activations "
              f"{mem.get('activations_estimate', 0.0) / 1e9:.3f}); fits {rec['fits']}")
        if analysis:
            print(f"  {report.bound_summary()}")
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true", help="sweep all (arch × shape)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--fsdp", action="store_true", default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--no-analysis", action="store_true",
                    help="layout and per-rank bytes at rest only (no counting)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    if args.all:
        combos = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("need --arch and --shape, or --all")
        combos = [(args.arch, args.shape)]

    n_fail = 0
    for arch, shape in combos:
        print(f"== {arch} × {shape} [{args.mesh}] ==", flush=True)
        rec = run_one(arch, shape, args.mesh, overrides or None, fsdp=args.fsdp,
                      grad_accum=args.grad_accum, analysis=not args.no_analysis)
        print(f"  -> {rec['status']}" + (f" ({rec.get('reason') or rec.get('error', '')})"
                                         if rec["status"] != "ok" else ""), flush=True)
        if rec["status"] == "error":
            n_fail += 1
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
