"""Exporters: Chrome ``trace_event`` JSON (Perfetto-loadable) + schema
validation.

Mapping from our span model to the trace-event format:

* each *stream* (camera / tenant / episode) becomes a **process** (pid),
  named with a ``process_name`` metadata event so Perfetto shows
  ``cam0``, ``tenant3`` etc. as row groups;
* the span's ``track`` becomes the **thread** (tid), so overlapped
  pipelined ticks (depth k → k parallel tracks) render on parallel rows
  instead of producing malformed nested overlaps;
* closed spans become complete events (``ph: "X"``, ``ts``/``dur`` in
  microseconds); zero-duration spans become thread-scoped instants
  (``ph: "i"``, ``s: "t"``);
* axis / rung / tick / batch tags ride in ``args`` and show in the
  Perfetto detail pane.

``validate_chrome_trace`` is the checker the CI smoke runs on the
exported artifact: structural trace-event-schema validation, not a
renderer round trip.
"""
from __future__ import annotations

import json
from typing import Iterable, Sequence

from .span import Span

__all__ = ["to_chrome_trace", "write_chrome_trace", "validate_chrome_trace"]

_US = 1e6  # trace-event timestamps are microseconds


def _pid_map(spans: Sequence[Span]) -> dict[str, int]:
    streams = sorted({s.stream or "main" for s in spans})
    return {name: i + 1 for i, name in enumerate(streams)}


def to_chrome_trace(spans: Iterable[Span],
                    process_label: str = "repro") -> dict:
    """Build a ``{"traceEvents": [...]}`` document from spans."""
    spans = list(spans)
    pids = _pid_map(spans)
    events: list[dict] = []
    for name, pid in pids.items():
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"{process_label}/{name}"},
        })
    for s in spans:
        pid = pids[s.stream or "main"]
        args = {"axis": s.axis, "tick": s.tick, "rung": s.rung,
                "batch_size": s.batch_size, "seq": s.seq,
                "parent": s.parent}
        if s.shard >= 0:
            args["shard"] = s.shard
        if s.t1 > s.t0:
            events.append({
                "ph": "X", "name": s.name, "cat": s.axis,
                "pid": pid, "tid": s.track,
                "ts": round(s.t0 * _US, 3),
                "dur": round((s.t1 - s.t0) * _US, 3),
                "args": args,
            })
        else:
            events.append({
                "ph": "i", "name": s.name, "cat": s.axis,
                "pid": pid, "tid": s.track, "s": "t",
                "ts": round(s.t0 * _US, 3),
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: Iterable[Span], path: str,
                       process_label: str = "repro") -> dict:
    doc = to_chrome_trace(spans, process_label=process_label)
    with open(path, "w") as fh:
        json.dump(doc, fh, sort_keys=True)
    return doc


_REQUIRED = {"ph", "name", "pid", "tid"}
_KNOWN_PH = {"X", "B", "E", "i", "I", "M", "C", "b", "e", "n", "s", "t", "f"}


def validate_chrome_trace(doc: dict) -> list[str]:
    """Return a list of schema violations (empty == valid).

    Checks the JSON-object form of the trace-event format: a
    ``traceEvents`` array whose entries carry the required keys, known
    phase codes, numeric non-negative ``ts``/``dur``, integer pid/tid,
    and instant events with a valid scope.
    """
    errors: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents array"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        missing = _REQUIRED - ev.keys()
        if missing:
            errors.append(f"{where}: missing keys {sorted(missing)}")
            continue
        ph = ev["ph"]
        if ph not in _KNOWN_PH:
            errors.append(f"{where}: unknown phase {ph!r}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            errors.append(f"{where}: name must be a non-empty string")
        for key in ("pid", "tid"):
            if not isinstance(ev[key], int):
                errors.append(f"{where}: {key} must be an int")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errors.append(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: dur must be a non-negative number")
        if ph == "i" and ev.get("s") not in (None, "t", "p", "g"):
            errors.append(f"{where}: instant scope must be t/p/g")
    return errors
