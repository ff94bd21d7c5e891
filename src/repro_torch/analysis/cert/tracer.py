"""Signature-recording tracer: drive the *real* engine host path over the
envelope while its step is replaced by a recorder.

Counting a program alone (``costs.count_program``) certifies the
program, but a new capture is caused by the *host logic around* it: a
shape-dependent branch in ``engine.tick`` that steps a differently shaped
batch.  So the harness instruments the executor
(``PipelinedExecutor.instrument``) with :class:`ProgramRecorder` wrappers
and runs the genuine engine host path — ``compile``, ``join``/``leave``,
``tick``, ``probe`` — over every envelope point, at every declared shard
count:

* each recorder takes the **signature** (dtype and shape of every tensor
  argument) of every call and counts the program on fake tensors once per
  new signature (no arithmetic runs);
* it returns zeros shaped as the program's outputs, so the host logic
  downstream (drain, the vectorized post) runs for real on correctly
  shaped data (``execute=True`` runs the real step instead and counts
  nothing, as the card's sweep does, so the engine captures and replays
  it);
* after warmup the recorders are **frozen**: an envelope point that
  presents a signature not already seen is a violation, recorded with the
  (rung, occupancy, event) context that produced it.

Because the real ``tick`` path runs, a shape-dependent branch injected
into a copy of ``batched/engine.py`` is caught here, where a program-only
count would certify the unmodified step and miss it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

from .costs import Counts, count_program, program_io_bytes
from .envelope import DTYPES, InputEnvelope, KernelPoint, RungPoint

__all__ = ["aval_signature", "ProgramRecorder", "ProgramSummary", "RungTrace",
           "certify_rung", "trace_ladder_rung", "trace_kernel", "program_name"]

_SHORT = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
          torch.bfloat16: "bf16", torch.int64: "i64", torch.int32: "i32", torch.int16: "i16",
          torch.int8: "i8", torch.uint8: "u8", torch.bool: "pred"}


def _aval_str(x) -> str:
    dims = ",".join(str(int(d)) for d in x.shape)
    return f"{_SHORT.get(x.dtype, str(x.dtype))}[{dims}]"


def aval_signature(args) -> str:
    """Canonical signature of a tree of tensors: dtype and shape per
    tensor, in flatten order, in the reference's format
    (``(f32[8,96,320,3])``)."""
    leaves = [x for x in tree_flatten(args)[0] if isinstance(x, torch.Tensor)]
    return "(" + ", ".join(_aval_str(x) for x in leaves) + ")"


class ProgramRecorder:
    """Stand-in for one program: records signatures, counts each new one
    on fake tensors, and returns zeros of its outputs (or, with
    ``execute``, records signatures only and returns the program's real
    outputs)."""

    def __init__(self, name: str, fn: Callable, execute: bool = False) -> None:
        self.name = name
        self._fn = fn
        self.execute = execute
        self.signatures: list[str] = []
        self.counts: dict[str, Counts] = {}
        self.io: dict[str, tuple[float, float]] = {}
        self._out: dict[str, Any] = {}
        self.calls = 0
        self.frozen = False
        self.context = "warmup"
        self.violations: list[tuple[str, str]] = []   # (signature, context)

    def freeze(self) -> None:
        """End of warmup: every signature from here on must already be
        known, or it is a new capture the engine would pay at runtime."""
        self.frozen = True

    def __call__(self, *args):
        self.calls += 1
        sig = aval_signature(args)
        if sig not in self.counts:
            if self.frozen:
                self.violations.append((sig, self.context))
            if self.execute:
                # the card's sweep: signatures only (the CPU's sweep counts)
                self.counts[sig], self.io[sig] = Counts(), (0.0, 0.0)
                self.signatures.append(sig)
                return self._fn(*args)
            counts, out = count_program(self._fn, *args)
            self.counts[sig] = counts
            self.io[sig] = program_io_bytes(args, out)
            self._out[sig] = tree_map(
                lambda t: (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t, out)
            self.signatures.append(sig)
        if self.execute:
            return self._fn(*args)
        device = next(x for x in tree_flatten(args)[0] if isinstance(x, torch.Tensor)).device
        return tree_map(lambda s: torch.zeros(s[0], dtype=s[1], device=device),
                        self._out[sig], is_leaf=lambda s: isinstance(s, tuple) and len(s) == 2
                        and isinstance(s[1], torch.dtype))


@dataclasses.dataclass
class ProgramSummary:
    """One counted program's static certificate entry."""

    name: str
    signatures: list
    counts: Counts
    in_bytes: float
    out_bytes: float
    mutated_inputs: Optional[tuple]      # traced in-place writes per input
    declared_mutation: tuple             # the input positions the program declares
    calls: int
    violations: list

    def to_dict(self) -> dict:
        return {
            "signatures": list(self.signatures),
            "in_bytes": self.in_bytes,
            "out_bytes": self.out_bytes,
            "mutated_inputs": (list(self.mutated_inputs)
                               if self.mutated_inputs is not None else None),
            "declared_mutation": list(self.declared_mutation),
            "calls": self.calls,
            "violations": [list(v) for v in self.violations],
            **self.counts.to_dict(),
        }


@dataclasses.dataclass
class RungTrace:
    """All programs of one batched rung after the envelope sweep."""

    rung: str
    programs: dict                      # name -> ProgramSummary
    violations: list                    # flattened (program, sig, context)
    step_captures: int = 0
    shards: int = 1


def _summarize(name: str, rec: ProgramRecorder, declared: tuple) -> ProgramSummary:
    counts = Counts()
    in_b = out_b = 0.0
    mutated = None
    for sig in rec.signatures:
        c = rec.counts[sig]
        counts.merge(c)
        i, o = rec.io[sig]
        in_b, out_b = max(in_b, i), max(out_b, o)
        mutated = tuple(c.mutated) if mutated is None else tuple(
            a or b for a, b in zip(mutated, c.mutated))
    return ProgramSummary(
        name=name, signatures=list(rec.signatures), counts=counts, in_bytes=in_b,
        out_bytes=out_b, mutated_inputs=mutated, declared_mutation=tuple(declared),
        calls=rec.calls, violations=list(rec.violations))


def program_name(rung: str, shards: int, short: str) -> str:
    """``two_stage/step`` at one shard, ``two_stage@data2/step`` at two."""
    return f"{rung}/{short}" if shards == 1 else f"{rung}@data{shards}/{short}"


def certify_rung(point: RungPoint, env: InputEnvelope, engine_cls=None, shards: int = 1,
                 device: str | torch.device = "cpu", execute: bool = False) -> RungTrace:
    """Sweep one rung's engine across the occupancy × churn envelope at
    ``shards`` data shards (a mesh repeating ``device``).

    ``engine_cls`` defaults to the shipped ``BatchedPerceptionEngine``;
    the injection test passes a mutated copy instead.  ``execute`` runs
    the real step behind the recorders (the card's sweep: the engine
    captures and replays it)."""
    if engine_cls is None:
        from repro_torch.batched.engine import BatchedPerceptionEngine
        engine_cls = BatchedPerceptionEngine
    from repro_torch.launch.mesh import make_local_mesh

    kw = {}
    if point.scale != 1.0:
        kw["scale"] = point.scale
    if not point.pad:
        kw["pad"] = point.pad
    if shards > 1:
        kw["mesh"] = make_local_mesh(data=shards, devices=[device] * shards)
    eng = engine_cls(point.pipeline, capacity=env.capacity, image_shape=tuple(env.image_shape),
                     device=device, **kw)
    recorders = eng.executor.instrument(
        lambda name, fn: ProgramRecorder(program_name(point.name, shards, name), fn, execute))

    def ctx(c: str) -> None:
        for r in recorders.values():
            r.context = c

    eng.compile()                       # warmup builds every shard's step
    for r in recorders.values():
        r.freeze()

    frame = np.zeros(tuple(env.image_shape), np.float32)
    seated: list[str] = []
    for occ in env.occupancies:
        while len(seated) < occ:
            sid = f"cam{len(seated)}"
            ctx(f"occ{occ}/join:{sid}")
            eng.join(sid)
            seated.append(sid)
        while len(seated) > occ:
            sid = seated.pop()
            ctx(f"occ{occ}/leave:{sid}")
            eng.leave(sid)
        ctx(f"occ{occ}/tick")
        eng.tick({sid: frame for sid in seated})
        if occ >= 2:
            # a camera that skipped this tick must not change any signature
            ctx(f"occ{occ}/tick_partial")
            eng.tick({seated[0]: frame})
        if env.churn and occ >= 2:
            sid = seated.pop(0)
            ctx(f"occ{occ}/churn_leave:{sid}")
            eng.leave(sid)                        # slot blanked in place
            ctx(f"occ{occ}/tick_after_leave")
            eng.tick({s: frame for s in seated})
            ctx(f"occ{occ}/churn_rejoin:{sid}")
            eng.join(sid)
            seated.append(sid)
            ctx(f"occ{occ}/tick_after_rejoin")
            eng.tick({s: frame for s in seated})
    # the scheduler's calibration probe (a full-capacity step outside the pipeline)
    ctx("probe")
    eng.probe([frame])

    declared = getattr(eng.executor, "DECLARED_MUTATIONS", {})
    programs = {rec.name: _summarize(rec.name, rec, declared.get(short, ()))
                for short, rec in recorders.items()}
    violations = [(rec.name, sig, where) for rec in recorders.values()
                  for sig, where in rec.violations]
    return RungTrace(rung=point.name, programs=programs, violations=violations,
                     step_captures=eng.executor.step_captures, shards=shards)


def _single(name: str, fn: Callable, args: tuple) -> ProgramSummary:
    counts, out = count_program(fn, *args)
    i, o = program_io_bytes(args, out)
    return ProgramSummary(name=name, signatures=[aval_signature(args)], counts=counts,
                          in_bytes=i, out_bytes=o, mutated_inputs=tuple(counts.mutated),
                          declared_mutation=(), calls=1, violations=[])


def trace_ladder_rung(point: RungPoint, env: InputEnvelope) -> ProgramSummary:
    """Count one anytime-ladder single-frame pipeline at its effective
    (λ-scaled, 8-px-snapped) input shape."""
    from repro_torch.perception.pipelines import build_pipeline, preprocess

    built = build_pipeline(point.pipeline, scale=point.scale, pad=point.pad, device="cpu")
    shape = preprocess(np.zeros(tuple(env.image_shape), np.float32), point.scale,
                       point.pad).shape
    return _single(f"ladder/{point.name}/infer", built.infer,
                   (torch.empty(shape, dtype=torch.float32, device="meta"),))


def trace_kernel(point: KernelPoint) -> ProgramSummary:
    """Count one kernel entry point at its canonical shapes: its declared
    cost (``kernels/cost.py``)."""
    from repro_torch import kernels

    fn = getattr(kernels, point.name)
    args = tuple(torch.empty(tuple(shape), dtype=DTYPES[dt], device="meta")
                 for dt, shape in point.args)
    return _single(f"kernels/{point.name}", fn, args)
