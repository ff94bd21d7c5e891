"""Checkpointing in the reference's on-disk format
(``repro/train/checkpoint.py``), for trees of tensors.

``{path}/step_{step:08d}/`` holds ``manifest.json`` (step, and each leaf's
shape and dtype) and ``arrays.npz`` (one array per leaf, keyed by its
``/``-joined tree path with ``/`` written as ``|``; bfloat16, which npz
cannot hold, stored as its uint16 bits).  A step is written into a
``.tmp`` directory and renamed into place, and the ``latest`` pointer is
replaced atomically, so a crash never leaves a half-written step behind
it.  A checkpoint written by either package loads into the other.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

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


def save_checkpoint(path: str, step: int, tree: Any) -> str:
    """Atomically write ``{path}/step_{step:08d}`` and update ``latest``."""
    step_dir = os.path.join(path, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "leaves": {}}
    for k, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        manifest["leaves"][k] = {"shape": list(arr.shape), "dtype": dtype}
        arrays[k.replace("/", "|")] = arr
    np.savez(os.path.join(tmp_dir, _ARRAYS), **arrays)
    with open(os.path.join(tmp_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    with open(os.path.join(path, "latest.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(path, "latest.tmp"), os.path.join(path, "latest"))
    return step_dir


def latest_step(path: str) -> int | None:
    p = os.path.join(path, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _from_numpy(arr: np.ndarray, dtype: str, like: Any) -> torch.Tensor:
    """A stored array as a tensor of the manifest's dtype, on the device
    of the template's leaf (the CPU for a non-tensor leaf)."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def load_checkpoint(path: str, template: Any, step: int | None = None) -> Any:
    """Restore into the structure of ``template`` (validating shapes); each
    leaf comes back in the checkpoint's dtype on the template leaf's
    device."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    step_dir = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(step_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(step_dir, _ARRAYS)) as data:
        for k, tmpl in _flatten(template).items():
            meta = manifest["leaves"].get(k)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {k}")
            if list(np.shape(tmpl)) != meta["shape"]:
                raise ValueError(f"{k}: shape {meta['shape']} != template {list(np.shape(tmpl))}")
            out[k] = _from_numpy(data[k.replace("/", "|")], meta["dtype"], tmpl)

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
