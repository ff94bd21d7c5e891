"""Where a leaf lives on a training mesh, by its spec: the rank's block,
the gather to full, and the gradient's reduction to the block.

A leaf of full shape ``(n_0, …)`` under a spec ``(e_0, …)`` (one entry per
dim: a mesh axis, a tuple of axes, or None) is split along dim ``i`` into
``prod(size(a) for a in e_i)`` equal blocks; the rank holds block number
``mesh.index(e_i)`` of each dim (mixed radix over ``e_i`` in its order,
the first axis major: ``("pod", "data")`` is pod-major).  Axes of size 1
split nothing.  A dim that does not divide raises, naming the leaf: a
split is never quietly dropped.

``mesh`` is a ``distributed.mesh.TrainMesh`` (axis sizes, this rank's
coordinates, a process group per set of axes).  Every collective runs
inside a ``torch.profiler.record_function`` range named
``collective:<op>``, so a profile of a step gives the collectives' share
of it.  Gradients reduce in f32 and are cast back to their dtype.  gloo
runs all three collectives on CUDA tensors too (torch 2.11 on the H100),
so two ranks on one card use it where NCCL refuses them.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

__all__ = ["Sharding", "entries", "check_spec", "block_shape", "full_shape", "split_axes",
           "block_slices", "take_block", "gather", "reduce_grad"]


def all_gather_flat(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``all_gather_into_tensor`` (named ``all_gather_single`` in newer
    torch, where the old name warns)."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def reduce_scatter_flat(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``reduce_scatter_tensor`` (``reduce_scatter_single`` in newer torch)."""
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


class Sharding(NamedTuple):
    """A tree's layout: the mesh and a spec tree shaped like the tree."""
    mesh: Any
    specs: Any


def entries(spec: tuple, mesh) -> tuple[tuple[str, ...], ...]:
    """Each dim's splitting axes (a tuple, in the spec's order), without
    the axes of size 1."""
    out = []
    for e in spec:
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        out.append(tuple(a for a in axes if mesh.shape[a] > 1))
    return tuple(out)


def check_spec(spec: tuple, shape: tuple, mesh, what: str = "leaf") -> None:
    """Raise unless ``spec`` fits ``shape``: one entry per dim, known axes,
    no axis twice, and every split dim divisible by its axes' product."""
    if len(spec) != len(shape):
        raise ValueError(f"{what}: spec {spec} for shape {tuple(shape)}")
    seen = []
    for e in spec:
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        for a in axes:
            if a not in mesh.shape or a in seen:
                raise ValueError(f"{what}: spec {spec} names axis {a!r} "
                                 + ("twice" if a in seen else f"not in the mesh {mesh}"))
            seen.append(a)
    for i, (n, e) in enumerate(zip(shape, entries(spec, mesh))):
        k = math.prod(mesh.shape[a] for a in e)
        if n % k:
            raise ValueError(f"{what}: dim {i} of shape {tuple(shape)} ({n}) does not divide "
                             f"over {e} ({k} ranks) under spec {spec}")


def block_shape(shape: tuple, spec: tuple, mesh) -> tuple[int, ...]:
    return tuple(n // math.prod(mesh.shape[a] for a in e)
                 for n, e in zip(shape, entries(spec, mesh)))


def full_shape(block: tuple, spec: tuple, mesh) -> tuple[int, ...]:
    return tuple(n * math.prod(mesh.shape[a] for a in e)
                 for n, e in zip(block, entries(spec, mesh)))


def split_axes(spec: tuple, mesh) -> tuple[str, ...]:
    """The axes (of size > 1) that split the leaf, in mesh order: the
    ranks along them hold its other blocks."""
    used = {a for e in entries(spec, mesh) for a in e}
    return tuple(a for a in mesh.axis_names if a in used)


def _slices(shape: tuple, ents: tuple, mesh) -> tuple[slice, ...]:
    out = []
    for n, e in zip(shape, ents):
        b = n // math.prod(mesh.shape[a] for a in e)
        i = mesh.index(e)
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def block_slices(shape: tuple, spec: tuple, mesh) -> tuple[slice, ...]:
    """The rank's block of a leaf of ``shape``, as a slice per dim."""
    return _slices(tuple(shape), entries(spec, mesh), mesh)


def take_block(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The rank's block of ``full`` (a copy where it is a part)."""
    ents = entries(spec, mesh)
    if not any(ents):
        return full
    return full[_slices(tuple(full.shape), ents, mesh)].clone()


def gather(block: torch.Tensor, spec: tuple, shape: tuple, mesh) -> torch.Tensor:
    """The full leaf of ``shape`` from every rank's block (``block``
    itself where nothing splits it)."""
    axes = split_axes(spec, mesh)
    if not axes:
        return block
    group = mesh.group(axes)
    n = math.prod(mesh.shape[a] for a in axes)
    flat = block.contiguous().reshape(-1)
    out = torch.empty(n * flat.numel(), dtype=block.dtype, device=block.device)
    with record_function("collective:all_gather"):
        all_gather_flat(out, flat, group)
    g = out.reshape(*[mesh.shape[a] for a in axes], *block.shape)
    perm = []
    for i, e in enumerate(entries(spec, mesh)):
        perm += [axes.index(a) for a in e] + [len(axes) + i]
    return g.permute(perm).reshape(shape)


def reduce_grad(grad: torch.Tensor, spec: tuple, mesh,
                data_axes: tuple[str, ...]) -> torch.Tensor:
    """The sum of ``grad`` (this rank's full-shape gradient) over the ranks
    along ``data_axes``, restricted to the rank's block, in ``grad``'s
    dtype.  The sum is taken in f32: by reduce-scatter where a dim's split
    begins with the data axes (``embed`` under FSDP), else by all-reduce;
    the splits along other axes (``model``) are local slices."""
    data = tuple(a for a in mesh.axis_names if a in data_axes and mesh.shape[a] > 1)
    group = mesh.group(data)
    if group is None:
        return take_block(grad, spec, mesh)
    ents = entries(spec, mesh)
    lead = next((i for i, e in enumerate(ents) if e[:len(data)] == data), None)
    if lead is None:
        x = grad.float()
        with record_function("collective:all_reduce"):
            dist.all_reduce(x, group=group)
        return take_block(x, spec, mesh).to(grad.dtype)
    nd = math.prod(mesh.shape[a] for a in data)
    # one f32 copy, the split dim first
    xm = grad.movedim(lead, 0).to(torch.float32, memory_format=torch.contiguous_format)
    out = torch.empty((xm.shape[0] // nd, *xm.shape[1:]), dtype=xm.dtype, device=xm.device)
    with record_function("collective:reduce_scatter"):
        reduce_scatter_flat(out, xm, group)
    del xm
    part = out.movedim(0, lead)
    rest = list(ents)
    rest[lead] = ents[lead][len(data):]
    sl = _slices(tuple(part.shape), tuple(rest), mesh)
    return part[sl].to(grad.dtype).contiguous()
