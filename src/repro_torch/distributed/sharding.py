"""Mesh-aware helpers of the serving fleet (the port of ``axis_size``,
``data_shards`` and ``slot_batch_spec`` of the reference's
``repro/distributed/sharding.py``).

A mesh is anything with ``.shape`` (axis name → size) and ``.axis_names``,
such as ``repro_torch.launch.mesh.Mesh``.  The slot batch's spec is a plain
tuple of mesh axis names, one per sharded leading dim: ``("data",)`` when
the slots split over the data axis, ``()`` when they are not split.
"""
from __future__ import annotations

import math

__all__ = ["axis_size", "data_shards", "slot_batch_spec"]


def axis_size(mesh, phys) -> int:
    """Devices along a mesh axis, a tuple of axes (their product), or
    ``None`` (1)."""
    if phys is None:
        return 1
    if isinstance(phys, (tuple, list)):
        return math.prod(mesh.shape[a] for a in phys)
    return mesh.shape[phys]


def data_shards(mesh) -> int:
    """Number of slot-batch shards a mesh provides: the size of its
    ``data`` axis (1 for no mesh / no data axis)."""
    if mesh is None or "data" not in mesh.axis_names:
        return 1
    return int(mesh.shape["data"])


def slot_batch_spec(mesh, capacity: int) -> tuple[str, ...]:
    """The split of the serving stack's padded slot batch
    ``(capacity, H, W, C)``: slots over the ``data`` axis, feature dims
    whole.  Every output of the batched step leads with the slot dim and
    splits the same way.

    Raises when ``capacity`` does not divide over the data axis — the
    fleet seats streams by contiguous per-shard slot blocks, so a ragged
    split would misattribute slots to devices.
    """
    n = data_shards(mesh)
    if n <= 1:
        return ()
    if capacity % n != 0:
        raise ValueError(
            f"capacity {capacity} must be divisible by the data axis "
            f"({n} shards) so every shard owns an equal slot block")
    return ("data",)
