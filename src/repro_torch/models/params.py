"""Parameter machinery: declarative specs → initialized nested dicts of
tensors, layer-stacked variants, counts, and the weight bridge from the
reference package.

Parameters are plain nested dicts of tensors with the reference pytree's
keys, shapes and layouts (stacked ``layer`` axis first, ``(d, H, Dh)`` /
``(H, Dh, d)`` projections), so ``from_numpy`` carries the reference's
weights across unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

__all__ = [
    "ParamSpec",
    "axes_tree",
    "init_params",
    "stack_specs",
    "count_params",
    "count_params_from_specs",
    "from_numpy",
    "resolve_dtype",
]


def resolve_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (config strings) or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]     # logical axis name per dim (None = replicated)
    init: str = "normal"             # normal | zeros | ones | embed | scaled
    scale: float = 1.0               # extra multiplier on the init std

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def _fan_in(shape: tuple[int, ...]) -> int:
    # all but the last dim are treated as inputs for projection-style params
    if len(shape) <= 1:
        return max(shape[0] if shape else 1, 1)
    return max(math.prod(shape[:-1]), 1)


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device, sl: Optional[tuple] = None) -> torch.Tensor:
    """The reference's distributions (``repro/models/params.py::_init_leaf``);
    the samples differ, since torch cannot reproduce JAX's threefry.  A
    layer-stacked leaf is drawn one layer at a time, so the f32 draw in
    flight is one layer's (at granite-20b's width the stacked MLP ``up``
    drawn whole would be a 31 GB f32 temporary beside the weights).  With
    ``sl`` (a slice per dim; the layer dim whole) only that block is kept,
    of the same draws."""
    shape = spec.shape if sl is None else tuple(len(range(*s.indices(n)))
                                                for s, n in zip(sl, spec.shape))
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init == "embed":
        std = 1.0 * spec.scale
    elif spec.init in ("normal", "scaled"):
        std = spec.scale / math.sqrt(_fan_in(spec.shape))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    if spec.axes[:1] != ("layer",):
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
        return x.mul_(std).to(dtype) if sl is None else x[sl].mul_(std).to(dtype, copy=True)
    if sl is not None and shape[0] != spec.shape[0]:
        raise ValueError(f"a block of a layer-stacked leaf {spec.shape} must keep every layer")
    out = torch.empty(shape, dtype=dtype, device=device)
    for layer in out:
        x = torch.randn(spec.shape[1:], generator=gen, dtype=torch.float32, device=device)
        layer.copy_((x if sl is None else x[sl[1:]]).mul_(std))
    return out


def init_params(specs: Mapping[str, Any], gen: torch.Generator,
                dtype: torch.dtype, device: str | torch.device,
                block: Optional[Callable[[tuple, ParamSpec], Optional[tuple]]] = None) -> dict:
    """Initialize a nested spec dict into a matching dict of tensors on
    ``device``, drawing from ``gen`` (which must live on that device) in
    sorted key order, so the same specs and seed give the same weights.
    ``block(path, spec)``: the slices of each leaf to keep (None: whole);
    the draws are the whole leaf's, so a block equals that part of the
    whole init."""
    device = torch.device(device)

    def walk(node: Mapping[str, Any], path: tuple) -> dict:
        out = {}
        for name in sorted(node):
            sub = node[name]
            if isinstance(sub, ParamSpec):
                sl = None if block is None else block(path + (name,), sub)
                out[name] = _init_leaf(sub, gen, dtype, device, sl)
            else:
                out[name] = walk(sub, path + (name,))
        return out

    return walk(specs, ())


def axes_tree(specs: Mapping[str, Any]) -> dict:
    """The mirror tree of logical-axis tuples (one name or None per dim)."""
    def walk(node: Any) -> Any:
        if isinstance(node, ParamSpec):
            return node.axes
        return {k: walk(v) for k, v in node.items()}

    return walk(specs)


def stack_specs(specs: Mapping[str, Any], n_layers: int) -> dict:
    """Prepend a ``layer`` dimension to every spec (the reference's
    stacked-weights layout; the port loops over it in Python)."""
    def walk(node: Any) -> Any:
        if isinstance(node, ParamSpec):
            return ParamSpec(
                shape=(n_layers, *node.shape),
                axes=("layer", *node.axes),
                init=node.init,
                scale=node.scale,
            )
        return {k: walk(v) for k, v in node.items()}

    return walk(specs)


def _leaves(tree: Any):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def count_params(params: Mapping[str, Any]) -> int:
    return sum(int(x.numel()) for x in _leaves(params))


def count_params_from_specs(specs: Mapping[str, Any]) -> int:
    total = 0
    for spec in _leaves(specs):
        total += math.prod(spec.shape)
    return total


def from_numpy(tree: Mapping[str, Any], device: str | torch.device,
               dtype: Optional[str | torch.dtype] = None) -> dict:
    """The weight bridge: a nested dict of numpy arrays (the reference's
    params after ``jax.tree.map(np.asarray, ...)``) → the same nested dict
    of tensors on ``device``.  ``dtype=None`` keeps each array's dtype;
    bfloat16 arrays (ml_dtypes) go through float32, which holds them
    exactly."""
    device = torch.device(device)
    dt = None if dtype is None else resolve_dtype(dtype)

    def conv(a: Any) -> torch.Tensor:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))   # a writable copy
        return t.to(device=device, dtype=dt if dt is not None else t.dtype)

    def walk(node: Mapping[str, Any]) -> dict:
        return {k: walk(v) if isinstance(v, Mapping) else conv(v)
                for k, v in node.items()}

    return walk(tree)
