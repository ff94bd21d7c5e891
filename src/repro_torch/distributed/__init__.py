"""Distribution helpers (the part of the reference's ``repro.distributed``
that the camera fleet needs): how many slot-batch shards a mesh provides
and the slot batch's split over them.  The logical-axis rulesets for
sharded training come with that slice (ROADMAP.md Queue 1 step 8)."""
from .sharding import axis_size, data_shards, slot_batch_spec

__all__ = ["axis_size", "data_shards", "slot_batch_spec"]
