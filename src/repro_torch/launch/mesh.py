"""Meshes: the camera fleet's local device meshes (the port of
``make_local_mesh`` and ``parse_mesh_spec`` of the reference's
``repro/launch/mesh.py``), the production mesh shapes and the training
mesh over a process group.

A ``Mesh`` names its axes (``("data", "model")``), their sizes
(``mesh.shape["data"]``) and its devices, an array shaped (data, model) of
``torch.device``.  The fleet runs one shard of the slot batch per data row,
on that row's first device.  A device may appear more than once: a
``data=2`` mesh over ``["cuda:0", "cuda:0"]`` runs two shards on one card,
each on its own CUDA stream — the port's counterpart of the reference's
``--xla_force_host_platform_device_count`` — and ``["cpu", "cpu"]`` runs
two shards on the CPU.

``PROD_SHAPE`` and ``MULTIPOD_SHAPE`` are the reference's production
layouts, (data=16, model=16) and (pod=2, data=16, model=16): the logical
layouts the sharding rules are computed for.  ``LogicalMesh`` holds such a
layout with no devices; ``TrainMesh`` lays the ranks of an initialized
``torch.distributed`` process group out on one (both defined in
``distributed/mesh.py``).  ``make_train_mesh`` builds a training mesh of
any shape, ``make_production_mesh`` one at the production shapes, which
raises, naming the ranks it needs, in a world of another size.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..distributed.mesh import LogicalMesh, TrainMesh
from ..perception.detector import canonical_device, resolve_device

__all__ = ["Mesh", "make_local_mesh", "parse_mesh_spec", "LogicalMesh", "TrainMesh",
           "make_train_mesh", "make_production_mesh", "PROD_SHAPE", "MULTIPOD_SHAPE"]

PROD_SHAPE = (16, 16)            # 256 ranks: (data, model)
MULTIPOD_SHAPE = (2, 16, 16)     # 512 ranks: (pod, data, model)


class Mesh:
    """Axis names, sizes and the (data, model) array of devices."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...] = ("data", "model")):
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devices.shape} for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_local_mesh(data: int = 1, model: int = 1, *, device: str | torch.device = "cuda",
                    devices: Optional[Sequence[str | torch.device]] = None) -> Mesh:
    """A mesh over local devices: ``devices`` as given (repeats allowed),
    or with ``devices=None`` every visible device of ``device``'s type
    (``torch.cuda.device_count()`` cards for ``cuda``, one for ``cpu``).

    An oversubscribed request is factored down to the largest feasible
    shape that preserves *both* axes: ``model`` is the rigid axis (it
    encodes how the program itself is partitioned, so silently shrinking
    it would change every sharded layout), while ``data`` is elastic and
    shrinks to ``n // model``.  ``data=4, model=4`` on 8 devices yields
    ``(2, 4)`` — never ``(8, 1)``.  When ``model`` alone exceeds the
    device count it cannot be honored at any data width; that is an
    error, not a silent collapse.  A CUDA device without a card raises, as
    every entry point of the port does.
    """
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} model={model}")
    if devices is None:
        kind = resolve_device(device)
        n_dev = torch.cuda.device_count() if kind.type == "cuda" else 1
        pool = [torch.device(kind.type, i) if kind.type == "cuda" else kind
                for i in range(n_dev)]
    else:
        pool = [canonical_device(d) for d in devices]
    n = len(pool)
    if model > n:
        raise ValueError(
            f"mesh model={model} cannot be honored: only {n} device(s) "
            f"available (need at least `model` devices; a device list may "
            f"name one device more than once, e.g. devices=['cuda:0', 'cuda:0'] "
            f"or --mesh-devices cuda:0,cuda:0)")
    if data * model > n:
        data = max(1, n // model)
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(pool[:data * model]):
        grid[i // model, i % model] = d
    return Mesh(grid)


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """Parse a CLI mesh spec like ``data=4`` or ``data=4,model=2`` into
    keyword arguments for :func:`make_local_mesh`."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in ("data", "model"):
            raise ValueError(f"unknown mesh axis {name!r} in {spec!r} "
                             f"(expected data=K[,model=M])")
        try:
            out[name] = int(val)
        except ValueError:
            raise ValueError(f"bad mesh axis size {val!r} in {spec!r}") from None
    if not out:
        raise ValueError(f"empty mesh spec {spec!r}")
    return out


def make_train_mesh(data: int = 1, model: int = 1, *, pod: Optional[int] = None,
                    device: str | torch.device = "cuda") -> TrainMesh:
    """A (data, model) training mesh, or (pod, data, model) with ``pod``,
    over the initialized process group (none is needed for 1 x 1).  A
    CUDA device without a card raises."""
    device = resolve_device(device)
    if pod is None:
        return TrainMesh((data, model), ("data", "model"), device)
    return TrainMesh((pod, data, model), ("pod", "data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> TrainMesh:
    """The target deployment mesh over the process group: (data=16,
    model=16), or (pod=2, data=16, model=16) across two pods.  The ``pod``
    axis composes with ``data`` for batch sharding.  Raises in a world of
    another size than 256 (512) ranks; it never shrinks the mesh."""
    shape = MULTIPOD_SHAPE if multi_pod else PROD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return TrainMesh(shape, axes, resolve_device(device))
