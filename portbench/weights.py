"""The benchmark's weights: drawn on the device from the seed, leaf by leaf in
sorted key order with one ``torch.Generator``, in the dtype they are served
in, by the layout of the family's reference (``reference/<family>.py``).
The same seed on the same device gives the same weights, so the reference
draws them again after the window instead of keeping a copy.

Inits (``INITS``): ``("normal", fan_in)`` N(0, 1/fan_in); ``("std", s)``
N(0, s²); ``("ones",)``; ``("uniform", lo, hi)``.
"""
from __future__ import annotations

import math
from typing import Iterator

import torch

from .reference.common import nest

INITS = ("normal", "std", "ones", "uniform")


def specs(layout: dict, path: tuple = ()) -> Iterator[tuple[tuple, tuple, tuple]]:
    """(key path, shape, init) of every leaf, in sorted key order."""
    for k in sorted(layout):
        v = layout[k]
        if isinstance(v, dict):
            yield from specs(v, path + (k,))
        else:
            yield path + (k,), tuple(v[0]), tuple(v[1])


def _leaf(shape: tuple, init: tuple, gen: torch.Generator, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    kind = init[0]
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind in ("normal", "std"):
        std = 1.0 / math.sqrt(init[1]) if kind == "normal" else init[1]
        return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)
    if kind != "uniform":
        raise ValueError(f"unknown init {init!r}; have {INITS}")
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return (u * (init[2] - init[1]) + init[1]).to(dtype)


def draw(layout: dict, seed: int, dtype: torch.dtype, device: str | torch.device) -> dict:
    """A nested dict of the layout's leaves, drawn from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return nest((path, _leaf(shape, init, gen, dtype, device))
                for path, shape, init in specs(layout))

