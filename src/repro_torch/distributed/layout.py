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
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

__all__ = ["Sharding", "entries", "check_spec", "block_shape", "full_shape", "split_axes",
           "block_slices", "take_block", "gather", "gather_start", "reduce_grad",
           "reduce_grads"]


def all_gather_flat(out: torch.Tensor, inp: torch.Tensor, group, async_op: bool = False):
    """``all_gather_into_tensor`` (named ``all_gather_single`` in newer
    torch, where the old name warns); with ``async_op`` its work handle."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    return fn(out, inp, group=group, async_op=async_op)


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
    return gather_start([block], [spec], [shape], mesh)()[0]


def gather_start(blocks: list, specs: list, shapes: list, mesh,
                 async_op: bool = False) -> Callable[[], list]:
    """``gather`` of several leaves split over the same axes, in one
    all-gather of their blocks side by side, and in two halves: the
    all-gather is issued now (with ``async_op`` it runs while the caller
    computes), and the returned function waits for it and cuts each full
    leaf out of it."""
    axes = split_axes(specs[0], mesh)
    if any(split_axes(sp, mesh) != axes for sp in specs):
        raise ValueError(f"gather_start: leaves split over other axes than {axes}: {specs}")
    if not axes:
        return lambda: list(blocks)
    group = mesh.group(axes)
    n = math.prod(mesh.shape[a] for a in axes)
    flat = torch.cat([b.contiguous().reshape(-1) for b in blocks])
    out = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    with record_function("collective:all_gather"):
        work = all_gather_flat(out, flat, group, async_op=async_op)
    del flat

    def wait() -> list:
        if work is not None and async_op:
            with record_function("collective:wait"):
                work.wait()
        rows, full, off = out.view(n, -1), [], 0
        for b, spec, shape in zip(blocks, specs, shapes):
            g = rows[:, off:off + b.numel()].reshape(*[mesh.shape[a] for a in axes], *b.shape)
            perm = []
            for i, e in enumerate(entries(spec, mesh)):
                perm += [axes.index(a) for a in e] + [len(axes) + i]
            full.append(g.permute(perm).reshape(shape))
            off += b.numel()
        return full

    return wait


def reduce_grad(grad: torch.Tensor, spec: tuple, mesh,
                data_axes: tuple[str, ...]) -> torch.Tensor:
    """The sum of ``grad`` (this rank's full-shape gradient) over the ranks
    along ``data_axes``, restricted to the rank's block, in ``grad``'s
    dtype (``reduce_grads`` of one leaf)."""
    return reduce_grads([grad], [spec], mesh, data_axes)[0]


def reduce_grads(grads: list, specs: list, mesh, data_axes: tuple[str, ...]) -> list:
    """``reduce_grad`` of several leaves, in one collective per kind.  The
    sum is taken in f32: by one reduce-scatter for the leaves with a dim
    whose split begins with the data axes (``embed`` under FSDP), each
    leaf copied to f32 (that dim first) into its columns of one buffer of
    rank-major rows; by one all-reduce of one f32 buffer for the others;
    the splits along other axes (``model``) are local slices.  One leaf
    of f32 is reduced in place of its copy."""
    data = tuple(a for a in mesh.axis_names if a in data_axes and mesh.shape[a] > 1)
    group = mesh.group(data)
    if group is None:
        return [take_block(g, sp, mesh) for g, sp in zip(grads, specs)]
    nd = math.prod(mesh.shape[a] for a in data)
    out: list = [None] * len(grads)
    whole, split = [], []
    for i, sp in enumerate(specs):
        ents = entries(sp, mesh)
        lead = next((d for d, e in enumerate(ents) if e[:len(data)] == data), None)
        (whole if lead is None else split).append((i, lead, ents))
    if whole:
        if len(whole) == 1:
            x = grads[whole[0][0]].float().reshape(-1)
        else:
            x = torch.empty(sum(grads[i].numel() for i, _, _ in whole), dtype=torch.float32,
                            device=grads[0].device)
            off = 0
            for i, _, _ in whole:
                x[off:off + grads[i].numel()].view(grads[i].shape).copy_(grads[i])
                off += grads[i].numel()
        with record_function("collective:all_reduce"):
            dist.all_reduce(x, group=group)
        off = 0
        for i, _, _ in whole:
            g = grads[i]
            part = x[off:off + g.numel()].view(g.shape)
            out[i] = take_block(part, specs[i], mesh).to(g.dtype)
            off += g.numel()
    if split:
        # the split dim first, nd blocks of it a row: rank r's part of every
        # leaf in row r
        moved = [grads[i].movedim(lead, 0) for i, lead, _ in split]
        if len(moved) == 1:
            xm = moved[0].to(torch.float32, memory_format=torch.contiguous_format)
        else:
            cols = [m.numel() // nd for m in moved]
            xm = torch.empty((nd, sum(cols)), dtype=torch.float32, device=grads[0].device)
            off = 0
            for m, k in zip(moved, cols):
                xm[:, off:off + k].view(nd, *m.unflatten(0, (nd, -1)).shape[1:]).copy_(
                    m.unflatten(0, (nd, -1)))
                off += k
        red = torch.empty(xm.numel() // nd, dtype=torch.float32, device=xm.device)
        with record_function("collective:reduce_scatter"):
            reduce_scatter_flat(red, xm.reshape(-1), group)
        del xm, moved
        off = 0
        for i, lead, ents in split:
            moved = grads[i].movedim(lead, 0).shape
            k = grads[i].numel() // nd
            part = red[off:off + k].view(moved[0] // nd, *moved[1:]).movedim(0, lead)
            rest = list(ents)
            rest[lead] = ents[lead][len(data):]
            sl = _slices(tuple(part.shape), tuple(rest), mesh)
            out[i] = part[sl].to(grads[i].dtype).contiguous()
            off += k
    return out
