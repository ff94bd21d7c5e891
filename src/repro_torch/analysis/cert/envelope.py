"""The declared input envelope: every (rung × batch-size × occupancy)
point the serving schedulers can produce, plus the single-frame ladder
rungs and the kernels at their canonical certification shapes.

The envelope is the certifier's universe of discourse.  Capture-freedom
is only meaningful *relative to a set of inputs*: the claim the
certificate commits is "after warmup, no envelope point presents a new
tensor signature to any hot-path program".  Everything in the envelope is
static data — shapes, dtypes, occupancy grids — so its hash pins the
claim: a change that widens the reachable input set (a new rung, a new
batch size, a capacity change) changes the hash and forces an explicit
``--regen``.  ``describe()`` serialises byte for byte as the reference's
does, so the two envelopes hash alike.

Occupancies (1..capacity) drive the *certification* sweep: one engine
per rung at fixed ``capacity``, join/leave churn between ticks, at every
declared shard count.  ``batch_sizes`` drive the *cost table*: an engine
at capacity *b*, all slots dirty, whose step replay the card measures.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import torch

from repro_torch.perception.data import H, W

__all__ = ["RungPoint", "KernelPoint", "InputEnvelope", "default_envelope", "envelope_hash",
           "DTYPES"]

# dtype shorthand used in envelope specs and signatures
DTYPES = {
    "f32": torch.float32,
    "f16": torch.float16,
    "bf16": torch.bfloat16,
    "i32": torch.int32,
    "i64": torch.int64,
    "pred": torch.bool,
}


@dataclasses.dataclass(frozen=True)
class RungPoint:
    """One pipeline variant in the envelope."""

    name: str
    pipeline: str
    scale: float = 1.0
    pad: bool = True

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class KernelPoint:
    """One kernel entry point at its canonical certification shapes.

    ``args`` is a tuple of ``(dtype_short, shape)`` pairs, one per
    positional argument of the ``repro_torch.kernels`` entry point.
    """

    name: str
    args: tuple

    def to_dict(self) -> dict:
        return {"name": self.name, "args": [[d, list(s)] for d, s in self.args]}


@dataclasses.dataclass(frozen=True)
class InputEnvelope:
    """The full declared input set the certifier sweeps."""

    capacity: int
    occupancies: tuple          # engine certification sweep (1..capacity)
    batch_sizes: tuple          # cost-table batch sizes
    image_shape: tuple
    rungs: tuple                # RungPoint — batched engine rungs
    ladder_rungs: tuple         # RungPoint — anytime single-frame rungs
    kernels: tuple              # KernelPoint
    churn: bool = True          # exercise join/leave between ticks
    # fleet sharding: the data-axis shard counts the serving meshes may
    # take.  Each shard steps its own block of capacity/K slots, so each K
    # is swept on its own engine and certified as its own program
    fleet_shards: tuple = (1, 2)

    def describe(self) -> dict:
        """Canonical JSON-serializable description (hash input)."""
        return {
            "capacity": self.capacity,
            "occupancies": list(self.occupancies),
            "batch_sizes": list(self.batch_sizes),
            "image_shape": list(self.image_shape),
            "rungs": [r.to_dict() for r in self.rungs],
            "ladder_rungs": [r.to_dict() for r in self.ladder_rungs],
            "kernels": [k.to_dict() for k in self.kernels],
            "churn": self.churn,
            "fleet_shards": list(self.fleet_shards),
        }


def envelope_hash(env: InputEnvelope) -> str:
    blob = json.dumps(env.describe(), sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def default_envelope() -> InputEnvelope:
    """The shipped system's envelope.

    * Batched rungs: the three rungs the batched benchmark serves (the
      ladder's top plus the cheap bounds), scale 1.0, padded input.
    * Ladder rungs: ``anytime.default_rungs`` — the λ-scaled pad=False
      single-frame pipelines the contract controller can select.
    * Kernels: canonical shapes from ``repro_torch.kernels.CERT_SHAPES``.
    """
    from repro_torch.anytime.ladder import default_rungs
    from repro_torch.kernels import CERT_SHAPES

    capacity = 8
    return InputEnvelope(
        capacity=capacity,
        occupancies=tuple(range(1, capacity + 1)),
        batch_sizes=(1, 2, 4, 8),
        image_shape=(H, W, 3),
        rungs=(
            RungPoint("two_stage", "two_stage"),
            RungPoint("one_stage", "one_stage"),
            RungPoint("early_exit", "early_exit"),
        ),
        ladder_rungs=tuple(
            RungPoint(r.name, r.pipeline, scale=r.scale, pad=False) for r in default_rungs()),
        kernels=tuple(
            KernelPoint(name, tuple((d, tuple(s)) for d, s in args))
            for name, args in sorted(CERT_SHAPES.items())),
    )
