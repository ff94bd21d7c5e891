"""Logical-axis sharding (the port of the reference's
``repro/distributed/sharding.py``): map model logical axes onto mesh axes.

Models annotate every parameter dimension with a logical name (``embed``,
``heads``, ``mlp``, ``expert``, ``vocab``, ``layer``, …).  A ``Ruleset``
maps those names onto physical mesh axes.  The default production ruleset:

    batch    → ("pod", "data")    activations / token batches
    heads    → "model"            attention heads
    kv_heads → "model" iff num_kv_heads divides the model axis, else
               replicated (MaxText convention for GQA/MQA deficits)
    mlp      → "model"            FFN hidden
    expert   → "model"            experts
    vocab    → "model"            embedding/LM head
    embed    → the data axes under FSDP, else replicated
    layer/head_dim/seq/state → replicated

A spec is a plain tuple with one entry per dimension: a mesh axis name, a
tuple of names (split over their product, the first one major), or
``None`` (whole).  It equals ``tuple(PartitionSpec(...))`` of the
reference.  A mesh is anything with ``.shape`` (axis name → size) and
``.axis_names``: the fleet's ``launch.mesh.Mesh``, a ``TrainMesh`` or a
``LogicalMesh`` with no devices (``distributed/mesh.py``); ``mesh_shape``
also reads a torch ``DeviceMesh``.  ``default_rules`` checks config
widths only; the layout (``distributed/layout.py``) checks every spec
against its leaf's shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

__all__ = [
    "Ruleset",
    "default_rules",
    "specs_from_axes",
    "shard_params_spec",
    "batch_specs",
    "decode_state_spec",
    "is_spec",
    "mesh_shape",
    "axis_size",
    "data_shards",
    "slot_batch_spec",
]


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name → size.  A torch ``DeviceMesh`` keeps its sizes in a tuple
    ``.shape`` beside ``mesh_dim_names``; every other mesh here maps names
    to sizes in ``.shape`` itself."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, phys) -> int:
    """Devices along a mesh axis, a tuple of axes (their product), or
    ``None`` (1)."""
    if phys is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(phys, (tuple, list)):
        return math.prod(shape[a] for a in phys)
    return shape[phys]


def is_spec(x: Any) -> bool:
    """A tuple of logical or mesh axis entries (a leaf of an axes tree or
    a spec tree), as opposed to a container of them."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(isinstance(a, str)
                                                                         for a in e))
        for e in x)


@dataclasses.dataclass(frozen=True)
class Ruleset:
    """logical axis name → mesh axis (or tuple of mesh axes, or None)."""

    rules: tuple[tuple[str, Any], ...]

    def lookup(self, logical: Optional[str]):
        if logical is None:
            return None
        for name, phys in self.rules:
            if name == logical:
                return phys
        return None

    def spec(self, axes: tuple) -> tuple:
        return tuple(self.lookup(a) for a in axes)

    def with_overrides(self, **overrides) -> "Ruleset":
        d = dict(self.rules)
        d.update(overrides)
        return Ruleset(tuple(d.items()))


def default_rules(cfg, mesh, *, fsdp: bool = False) -> Ruleset:
    """The production ruleset for a (…, "data", "model") mesh.

    ``fsdp=True`` additionally shards the ``embed`` dimension over the data
    axes (fully-sharded data parallel; gradients reduce-scatter instead of
    all-reduce).
    """
    axis_names = _axis_names(mesh)
    shape = mesh_shape(mesh)
    data_axes = tuple(a for a in axis_names if a in ("pod", "data"))
    data = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)
    model = "model" if "model" in axis_names else None
    msize = shape["model"] if model else 1

    kv_heads = model if (model and cfg.num_kv_heads % msize == 0) else None
    heads = model if (model and cfg.num_heads % msize == 0) else None
    expert = model if (model and cfg.num_experts and cfg.num_experts % msize == 0) else None
    # a spec cannot use the same mesh axis twice: when experts split over
    # `model`, the expert-FFN hidden dim must stay whole
    mlp = model if (model and cfg.d_ff % msize == 0 and expert is None) else None
    vocab = model if (model and cfg.padded_vocab % msize == 0) else None
    embed = None
    if fsdp and data is not None and cfg.d_model % axis_size(mesh, data) == 0:
        embed = data

    rules = (
        ("batch", data),
        ("embed", embed),
        ("heads", heads),
        ("kv_heads", kv_heads),
        ("head_dim", None),
        ("mlp", mlp),
        ("expert", expert),
        ("vocab", vocab),
        ("layer", None),
        ("seq", None),
        ("state", None),
    )
    return Ruleset(rules)


def specs_from_axes(rules: Ruleset, axes_tree: Any) -> Any:
    """Map a tree (nested dicts) of logical-axis tuples to specs."""
    if is_spec(axes_tree):
        return rules.spec(axes_tree)
    return {k: specs_from_axes(rules, v) for k, v in axes_tree.items()}


def shard_params_spec(model, rules: Ruleset) -> Any:
    """The spec tree of a Model's parameters."""
    return specs_from_axes(rules, model.axes())


def _map_leaves(fn, tree: Any) -> Any:
    """``fn`` over the leaves (objects with ``.shape``) of nested dicts,
    NamedTuples, lists and tuples; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def data_shards(mesh) -> int:
    """Number of slot-batch shards a mesh provides: the size of its
    ``data`` axis (1 for no mesh / no data axis)."""
    if mesh is None or "data" not in _axis_names(mesh):
        return 1
    return int(mesh_shape(mesh)["data"])


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


def _data_or_replicated(mesh, rules: Ruleset, dim: int):
    """The data split for a batch-like dim, or None if it doesn't divide
    (e.g. a global batch of 1)."""
    data = rules.lookup("batch")
    if data is not None and dim % axis_size(mesh, data) == 0:
        return data
    # try a prefix of the data axes (e.g. just "pod")
    if isinstance(data, tuple):
        for cut in range(len(data) - 1, 0, -1):
            sub = data[:cut]
            if dim % axis_size(mesh, sub) == 0:
                return sub if len(sub) > 1 else sub[0]
    return None


def batch_specs(cfg, mesh, rules: Ruleset, batch_tree: Mapping[str, Any]) -> Any:
    """Specs for a train/prefill/decode input batch: leading batch dim on
    the data axes (when divisible), everything else whole."""

    def leaf_spec(leaf) -> tuple:
        shp = tuple(leaf.shape)
        if not shp:
            return ()
        data = _data_or_replicated(mesh, rules, shp[0])
        return (data, *([None] * (len(shp) - 1)))

    return _map_leaves(leaf_spec, batch_tree)


def decode_state_spec(cfg, mesh, rules: Ruleset, state_shapes: Any) -> Any:
    """Specs for the decode state (a tree of tensors, or of anything with
    ``.shape``).

    KV caches (L, B, C, K, D): batch on data, kv_heads on model (the slots
    instead for an MQA/GQA deficit).  SSM / RWKV recurrent states
    (L, B, H, P, N): batch on data, heads on model when divisible.  Conv
    tails (L, B, w, d_inner): channel dim on model.  Shift states
    (L, B, d): batch on data.
    """
    kv = rules.lookup("kv_heads")
    model_ax = rules.lookup("mlp")
    msize = axis_size(mesh, model_ax)

    def dispatch(leaf) -> tuple:
        shp = tuple(leaf.shape)
        nd = len(shp)
        if nd <= 1:
            return (None,) * nd
        data = _data_or_replicated(mesh, rules, shp[1])
        if nd == 5 and shp[-2] == cfg.num_kv_heads and shp[-1] == cfg.head_dim:
            # KV cache (L, B, slots, K, D).  When kv_heads cannot split over
            # the model axis (GQA/MQA deficit), split the slots instead
            # (flash-decode: the softmax partitions over the context)
            slots = None
            if kv is None and model_ax is not None and shp[2] % msize == 0:
                slots = model_ax
            return (None, data, slots, kv, None)
        if nd == 5:
            m = model_ax if (model_ax and shp[2] % msize == 0) else None
            return (None, data, m, None, None)                 # SSM h / RWKV wkv
        if nd == 4 and shp[-1] == cfg.d_inner:
            m = model_ax if (model_ax and shp[-1] % msize == 0) else None
            return (None, data, None, m)                       # conv tail
        if nd == 3:
            return (None, data, None)                          # shift states
        return (None,) * nd

    return _map_leaves(dispatch, state_shapes)
