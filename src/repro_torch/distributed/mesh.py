"""Training meshes: a logical layout of named axes (``LogicalMesh``, what
the sharding rules are computed for) and the ranks of an initialized
``torch.distributed`` process group laid out on one (``TrainMesh``: one
rank per position, row-major, the last axis fastest, with a process group
for every set of its axes).  ``launch/mesh.py`` builds them
(``make_train_mesh``, ``make_production_mesh``) and re-exports both.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["LogicalMesh", "TrainMesh"]


class LogicalMesh:
    """Axis names and sizes, no devices: what the sharding rules need."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names) or any(int(n) < 1 for n in shape):
            raise ValueError(f"mesh shape {tuple(shape)} for axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(n) for a, n in zip(self.axis_names, shape)}
        self.size = math.prod(self.shape.values())

    def _describe(self) -> str:
        return "(" + ", ".join(f"{a}={n}" for a, n in self.shape.items()) + ")"

    def __repr__(self) -> str:
        return f"{type(self).__name__}{self._describe()}"


class TrainMesh(LogicalMesh):
    """The ranks of the process group laid out on (data, model) or
    (pod, data, model); this rank computes on ``device``.

    Rank ``r`` sits at the row-major coordinates of ``r`` (``coords``).
    ``group(axes)`` is the process group of the ranks that differ from this
    one only along ``axes`` (``None`` where those axes hold one rank: no
    collective is needed), its members ordered row-major over ``axes``
    in mesh order, so a split over ``("pod", "data")`` is pod-major.  A
    mesh of one position needs no process group; any other needs an
    initialized one of exactly ``size`` ranks."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: str | torch.device):
        super().__init__(shape, axis_names)
        self.device = torch.device(device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.size or (self.size > 1 and not dist.is_initialized()):
            raise ValueError(
                f"the mesh {self._describe()} needs a process group of {self.size} ranks "
                f"(one per position); this process's world has {world} "
                + ("rank" if world == 1 else "ranks")
                + ("" if dist.is_initialized() else " (no process group is initialized: "
                   "run under torchrun with --nproc-per-node)"))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        sizes = tuple(self.shape.values())
        self.coords = {a: int(i) for a, i in zip(self.axis_names,
                                                 np.unravel_index(self.rank, sizes))}
        self._groups: dict[tuple[str, ...], object] = {}
        if self.size > 1:
            # every rank creates every group, in the same order
            grid = np.arange(self.size).reshape(sizes)
            for k in range(1, len(sizes) + 1):
                for axes in itertools.combinations(self.axis_names, k):
                    if math.prod(self.shape[a] for a in axes) == 1:
                        continue
                    keep = [self.axis_names.index(a) for a in axes]
                    rest = [i for i in range(len(sizes)) if i not in keep]
                    parts = np.transpose(grid, rest + keep).reshape(-1, math.prod(
                        sizes[i] for i in keep))
                    mine, _ = dist.new_subgroups_by_enumeration(
                        [[int(r) for r in p] for p in parts])
                    self._groups[axes] = mine

    def _canon(self, axes) -> tuple[str, ...]:
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group along ``axes`` (a name or names), or None
        where they hold one rank."""
        return self._groups.get(self._canon(axes))

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._canon(axes))

    def index(self, axes) -> int:
        """This rank's index along ``axes`` taken in the order given (the
        first major): its block's index in a dim split over them."""
        axes = () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group(self.axis_names))
