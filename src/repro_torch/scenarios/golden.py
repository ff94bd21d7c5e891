"""Golden variation-report fixtures: serialize, compare, regenerate.

A replayed episode's ``VariationReport`` becomes a regression fixture:
``compare_reports`` walks the report structure and flags any drift
outside per-metric tolerance bands.  Structure (segment labels, tick
counts, stream sets, episode/seed) must match exactly; counts (frames,
misses, rung histograms, fusion drops) get a fractional band — rung
choices sit on controller thresholds where platform float differences in
proposal counts can legitimately flip a frame or two; latency statistics
and quality get relative/absolute bands.

Same-host, same-process replay is *byte*-identical (asserted separately
in the determinism tests); the bands exist so goldens checked in on one
machine hold on CI runners.

This is the port of the reference's ``repro/scenarios/golden.py``; it
reads the same ``tests/golden/`` fixtures.  Those were written with the
reference's detector weights, so a replay matches them exactly only on
those weights (``params=``); the CLI replays with the port's own seeded
weights and reports how far they land from the bands.

CLI::

    PYTHONPATH=src python -m repro_torch.scenarios --check [--dir tests/golden] [--out DIR] \
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.scenarios --regen --dir DIR [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional

import torch

from .catalog import get_episode
from .replay import ScenarioReplayer
from .trace import compile_trace

__all__ = [
    "GOLDEN_EPISODES",
    "GOLDEN_TICK_SCALE",
    "GOLDEN_CAPACITY",
    "Tolerance",
    "compare_reports",
    "golden_replay",
    "golden_path",
]

# episode name -> replay seed.  These two (one density episode, one
# weather episode) are the checked-in regression fixtures; the rest of
# the catalog is covered by the end-to-end smoke tests.
GOLDEN_EPISODES: dict[str, int] = {
    "urban_rush_hour": 7,
    "rain_onset_clear": 11,
}
# goldens replay at half tick scale so the CI step stays fast
GOLDEN_TICK_SCALE = 0.5
# canonical engine capacity for golden replays: the warm probe's batch
# size (and so the cost model's seed observation) depends on it, so every
# golden path — dedicated or shared scheduler — must use the same value
GOLDEN_CAPACITY = 4


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """Per-metric drift bands for golden comparison."""

    rel: float = 0.35          # relative band on latency stats (p50/p99 ms)
    abs_ms: float = 1.5        # absolute floor for latency bands
    rate: float = 0.12         # absolute band on rates/ratios (miss_rate, cv)
    quality: float = 0.15      # absolute band on quality scores
    count_frac: float = 0.25   # fractional band on integer counts
    count_abs: int = 2         # absolute floor for count bands


# leaf-name → band class.  Anything not listed (and not a structural
# exact-match key) falls back to "count" when integral, "rate" otherwise.
_MS_KEYS = {"p50_ms", "p99_ms", "mean_delay_ms"}
_RATE_KEYS = {"miss_rate", "cv", "clock_s", "t_start"}
_QUALITY_KEYS = {"mean_quality"}
_EXACT_KEYS = {"episode", "seed", "n_ticks", "label", "ticks"}
# statistics that are None exactly when their group is empty: a within-band
# count drift across the empty boundary (e.g. fusion events 1 → 0) flips
# them between None and a number, so None↔number is not structural here —
# the underlying count has its own band and catches real drift
_SOFT_KEYS = _MS_KEYS | _RATE_KEYS | _QUALITY_KEYS
# dicts keyed by rung name: a within-band frame flip can add/remove a key
# entirely (a rung the golden never used in that segment), so compare over
# the key union with missing entries as 0 instead of failing structurally
_HIST_KEYS = {"rung_hist", "rungs"}


def _band(key: str, want: float, tol: Tolerance) -> float:
    if key in _MS_KEYS:
        return max(tol.abs_ms, tol.rel * abs(want))
    if key in _QUALITY_KEYS:
        return tol.quality
    if key in _RATE_KEYS:
        return max(tol.rate, tol.rel * abs(want))
    # counts: frames, drops, misses, rung histogram entries, fusion events
    return max(tol.count_abs, tol.count_frac * abs(want))


def compare_reports(got: dict, want: dict,
                    tol: Optional[Tolerance] = None) -> list[str]:
    """All tolerance-band violations between two report dicts, as
    human-readable ``path: detail`` strings (empty list = within bands)."""
    if tol is None:
        tol = Tolerance()
    problems: list[str] = []

    def walk(g, w, path: str, key: str) -> None:
        if isinstance(w, dict):
            if not isinstance(g, dict):
                problems.append(f"{path}: expected object, got {type(g).__name__}")
                return
            if key in _HIST_KEYS:
                for k in sorted(set(w) | set(g)):
                    walk(g.get(k, 0), w.get(k, 0), f"{path}.{k}", k)
                return
            missing = set(w) - set(g)
            extra = set(g) - set(w)
            if missing:
                problems.append(f"{path}: missing keys {sorted(missing)}")
            if extra:
                problems.append(f"{path}: unexpected keys {sorted(extra)}")
            for k in sorted(set(w) & set(g)):
                walk(g[k], w[k], f"{path}.{k}", k)
        elif isinstance(w, list):
            if not isinstance(g, list) or len(g) != len(w):
                problems.append(
                    f"{path}: length {len(g) if isinstance(g, list) else '?'} "
                    f"!= {len(w)}")
                return
            for i, (gi, wi) in enumerate(zip(g, w)):
                walk(gi, wi, f"{path}[{i}]", key)
        elif w is None or g is None:
            # soft statistics are None exactly when their group is empty;
            # the group's (banded) count is the real regression signal
            if g is not w and key not in _SOFT_KEYS:
                problems.append(f"{path}: {g!r} != {w!r}")
        elif isinstance(w, bool) or isinstance(w, str):
            if g != w:
                problems.append(f"{path}: {g!r} != {w!r}")
        elif isinstance(w, (int, float)):
            if key in _EXACT_KEYS:
                if g != w:
                    problems.append(f"{path}: {g!r} != {w!r} (exact)")
                return
            band = _band(key, float(w), tol)
            if abs(float(g) - float(w)) > band:
                problems.append(
                    f"{path}: {g} is outside {w} ± {band:.6g}")
        else:  # pragma: no cover - report dicts only hold JSON scalars
            problems.append(f"{path}: unsupported golden type {type(w).__name__}")

    walk(got, want, "report", "")
    return problems


def golden_replay(name: str, scheduler=None, seed: Optional[int] = None,
                  sentinel=None, obs=None, params=None, device=None):
    """Replay a golden episode under the canonical golden configuration
    (fixed seed, half tick scale, default replay ladder, fixed engine
    capacity).  Returns ``(VariationReport, scheduler)`` so callers can
    chain episodes through one built scheduler; a passed-in
    ``scheduler`` must have been built at ``GOLDEN_CAPACITY``.

    ``sentinel`` (any context manager) guards the steady-state replay
    loop — see ``ScenarioReplayer.run``.  ``obs`` (a
    ``repro_torch.obs.Observatory``) traces the replay on the episode's
    virtual timeline; attaching one never changes the report.
    ``params`` and ``device`` build the first scheduler (see
    ``ScenarioReplayer``); a reused one brings its own."""
    if seed is None:
        seed = GOLDEN_EPISODES[name]
    trace = compile_trace(get_episode(name), seed=seed,
                          tick_scale=GOLDEN_TICK_SCALE)
    replayer = ScenarioReplayer(
        trace, scheduler=scheduler,
        capacity=GOLDEN_CAPACITY if scheduler is None else None,
        obs=obs, params=params, device=device)
    return replayer.run(sentinel=sentinel), replayer.scheduler


def golden_path(directory, name: str) -> Path:
    return Path(directory) / f"{name}.json"


def _default_golden_dir() -> Path:
    # repo-root tests/golden, resolved relative to this file
    # (src/repro_torch/scenarios/golden.py)
    return Path(__file__).resolve().parents[3] / "tests" / "golden"


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay golden episodes and diff against fixtures.")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--check", action="store_true",
                      help="replay + compare against checked-in goldens")
    mode.add_argument("--regen", action="store_true",
                      help="replay + rewrite the golden fixtures")
    ap.add_argument("--dir", default=None,
                    help="golden fixture directory (default tests/golden)")
    ap.add_argument("--out", default=None,
                    help="also write the replayed reports here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    if args.regen and not args.dir:
        # tests/golden holds the reference's fixtures; the port never
        # rewrites them in place
        ap.error("--regen needs --dir: the default fixtures are the reference's")
    gdir = Path(args.dir) if args.dir else _default_golden_dir()
    gdir.mkdir(parents=True, exist_ok=True)
    out = Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)

    scheduler = None
    failures = 0
    for name in GOLDEN_EPISODES:
        # one canonical replay path; the first call builds the
        # scheduler, the rest reuse it
        report, scheduler = golden_replay(
            name, scheduler=scheduler,
            device=args.device if scheduler is None else None)
        path = golden_path(gdir, name)
        if out:
            report.save(out / f"{name}.report.json")
        if args.regen:
            report.save(path)
            print(f"[golden] wrote {path}")
            continue
        if not path.exists():
            print(f"[golden] MISSING fixture {path} (run --regen)")
            failures += 1
            continue
        want = json.loads(path.read_text())
        problems = compare_reports(report.to_dict(), want)
        if problems:
            failures += 1
            print(f"[golden] {name}: {len(problems)} violation(s)")
            for p in problems:
                print(f"  - {p}")
        else:
            print(f"[golden] {name}: within tolerance "
                  f"({report.totals()['frames']} frames, "
                  f"{len(report.segments)} segments)")
    if failures:
        print(f"[golden] FAILED: {failures} episode(s) out of tolerance")
        return 1
    if args.regen:
        print(f"[golden] rewrote {len(GOLDEN_EPISODES)} fixture(s) in {gdir}")
    else:
        print("[golden] all episodes within tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
