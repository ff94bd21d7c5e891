"""Checkpointing in the reference's on-disk format
(``repro/train/checkpoint.py``), for trees of tensors.

``{path}/step_{step:08d}/`` holds ``manifest.json`` (step, and each leaf's
shape and dtype) and ``arrays.npz`` (one array per leaf, keyed by its
``/``-joined tree path with ``/`` written as ``|``; bfloat16, which npz
cannot hold, stored as its uint16 bits).  A step is written into a
``.tmp`` directory and renamed into place, and the ``latest`` pointer is
replaced atomically, so a crash never leaves a half-written step behind
it.  A checkpoint written by either package loads into the other.

A sharded state (a tree of each rank's blocks, with its
``layout.Sharding``: the training mesh and a spec tree shaped like the
tree, ``Trainer.state_sharding()``) is saved whole: every rank takes part
in gathering each leaf and rank 0 writes the full tree, in the same format.
Loading with a ``Sharding`` reads the full leaves on every rank and keeps
each rank's block.  So a sharded run's checkpoint loads into the
one-device trainer, and the other way round.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.distributed import layout

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def _flatten(tree: Any) -> dict[str, Any]:
    """Leaves by tree path, in the reference's walk order: dict keys
    sorted, NamedTuple fields by name, list/tuple items by index."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}")
        elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        elif hasattr(node, "_fields"):  # NamedTuple
            for name in node._fields:
                walk(getattr(node, name), f"{prefix}/{name}")
        else:
            flat[prefix] = node

    walk(tree, "")
    return flat


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _spec_map(tree: Any, sharding) -> dict[str, Any]:
    """Each leaf path of ``tree`` → its spec in ``sharding.specs`` (a tree
    shaped like ``tree`` whose leaves are spec tuples)."""
    out = {}

    def walk(node, spec, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], spec[k], f"{prefix}/{k}")
        elif hasattr(node, "_fields"):
            for name in node._fields:
                walk(getattr(node, name), getattr(spec, name), f"{prefix}/{name}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, spec[i], f"{prefix}/{i}")
        else:
            out[prefix] = spec

    walk(tree, sharding.specs, "")
    return out


def save_checkpoint(path: str, step: int, tree: Any, sharding: Any = None) -> str:
    """Atomically write ``{path}/step_{step:08d}`` and update ``latest``.
    With ``sharding`` (``tree`` holds this rank's blocks) every rank
    gathers each leaf, rank 0 writes, and every rank returns once the step
    is in place."""
    step_dir = os.path.join(path, f"step_{step:08d}")
    writer = sharding is None or sharding.mesh.rank == 0
    arrays = {}
    manifest = {"step": step, "leaves": {}}
    specs = _spec_map(tree, sharding) if sharding is not None else {}
    for k, leaf in _flatten(tree).items():
        if sharding is not None:
            block = leaf.detach()
            full = layout.full_shape(tuple(block.shape), specs[k], sharding.mesh)
            leaf = layout.gather(block, specs[k], full, sharding.mesh)
        if not writer:
            continue
        arr, dtype = _to_numpy(leaf)
        manifest["leaves"][k] = {"shape": list(arr.shape), "dtype": dtype}
        arrays[k.replace("/", "|")] = arr
    if not writer:
        sharding.mesh.barrier()
        return step_dir
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    np.savez(os.path.join(tmp_dir, _ARRAYS), **arrays)
    with open(os.path.join(tmp_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    with open(os.path.join(path, "latest.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(path, "latest.tmp"), os.path.join(path, "latest"))
    if sharding is not None:
        sharding.mesh.barrier()
    return step_dir


def latest_step(path: str) -> int | None:
    p = os.path.join(path, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of the manifest's dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def load_checkpoint(path: str, template: Any, step: int | None = None,
                    sharding: Any = None) -> Any:
    """Restore into the structure of ``template`` (validating shapes); each
    leaf comes back in the checkpoint's dtype on the template leaf's
    device.  With ``sharding`` the template holds this rank's blocks: each
    stored leaf must have the full shape they make, and the rank keeps its
    block of it."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    step_dir = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(step_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    out = {}
    specs = _spec_map(template, sharding) if sharding is not None else {}
    with np.load(os.path.join(step_dir, _ARRAYS)) as data:
        for k, tmpl in _flatten(template).items():
            meta = manifest["leaves"].get(k)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {k}")
            want = list(np.shape(tmpl))
            if sharding is not None:
                layout.check_spec(specs[k], tuple(meta["shape"]), sharding.mesh, k)
                want = list(layout.block_shape(tuple(meta["shape"]), specs[k], sharding.mesh))
                if want != list(np.shape(tmpl)):
                    raise ValueError(f"{k}: the checkpoint's {meta['shape']} makes blocks of "
                                     f"{want} under {specs[k]}, the template holds "
                                     f"{list(np.shape(tmpl))}")
            elif want != meta["shape"]:
                raise ValueError(f"{k}: shape {meta['shape']} != template {want}")
            t = _from_numpy(data[k.replace("/", "|")], meta["dtype"])
            if sharding is not None:
                t = layout.take_block(t, specs[k], sharding.mesh)
            device = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
            out[k] = t.to(device)

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(node[k], f"{prefix}/{k}") for k in node}
        if hasattr(node, "_fields"):
            return type(node)(
                *(rebuild(getattr(node, n), f"{prefix}/{n}") for n in node._fields)
            )
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{prefix}/{i}") for i, v in enumerate(node))
        return out[prefix]

    return rebuild(template, "")
