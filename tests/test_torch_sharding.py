"""The port's sharding rules (``repro_torch.distributed.sharding``,
``Model.axes``, ``launch/mesh.py``'s production shapes) against the
reference's, on the CPU with no process group.

The reference's spec functions run on a ``jax.sharding.AbstractMesh``,
which has no devices, so every arch is compared at its production widths
on the six mesh shapes below (the production (16, 16) and (2, 16, 16) and
four small ones).  The port's side runs on its own ``LogicalMesh`` of the
same shape.  A port spec is a tuple with one entry per dimension and must
equal ``tuple()`` of the reference's ``PartitionSpec``, exactly.  The
layout's block arithmetic (``distributed/layout.py``) is checked here on a
stub mesh whose coordinates the test sets, rank by rank; its collectives
run in ``tests/test_torch_sharded_train.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as jax_sh  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.distributed import (Ruleset, batch_specs, decode_state_spec,  # noqa: E402
                                     default_rules, shard_params_spec, specs_from_axes)
from repro_torch.distributed import layout  # noqa: E402
from repro_torch.distributed.sharding import _data_or_replicated, mesh_shape  # noqa: E402
from repro_torch.launch.mesh import (MULTIPOD_SHAPE, PROD_SHAPE, LogicalMesh,  # noqa: E402
                                     make_production_mesh, make_train_mesh)
from repro_torch.models import Model  # noqa: E402

MESHES = [(16, 16), (2, 16, 16), (2, 1), (1, 2), (2, 2), (4, 2)]
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _meshes(shape):
    return AbstractMesh(shape, _names(shape)), LogicalMesh(shape, _names(shape))


def _ref_tuples(tree):
    """A reference spec tree with each PartitionSpec as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _flat(tree, path=()):
    """(path, leaf) of nested dicts and NamedTuples, spec tuples as leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _flat(getattr(tree, name), path + (name,))
    else:
        yield path, tree


def test_archs_are_the_references():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_axes_equal_reference(arch):
    want = JaxModel(jax_get_config(arch)).axes()
    got = Model(get_config(arch)).axes()
    assert dict(_flat(got)) == dict(_flat(want))
    specs = dict(_flat(Model(get_config(arch)).specs()))
    assert all(len(got_axes) == len(specs[path].shape) for path, got_axes in _flat(got))


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_default_rules_and_param_specs_equal_reference(arch, shape, fsdp):
    amesh, lmesh = _meshes(shape)
    jrules = jax_sh.default_rules(jax_get_config(arch), amesh, fsdp=fsdp)
    rules = default_rules(get_config(arch), lmesh, fsdp=fsdp)
    assert rules.rules == jrules.rules
    want = _ref_tuples(jax_sh.shard_params_spec(JaxModel(jax_get_config(arch)), jrules))
    got = shard_params_spec(Model(get_config(arch)), rules)
    assert dict(_flat(got)) == dict(_flat(want))


def _batches(arch):
    """Batch trees (as ShapeDtypeStructs) with leading dims 1 (replicated),
    2 (the pod prefix on the multipod mesh), 6 (divides no data axis of
    size 4 or 16) and 32."""
    cfg = jax_get_config(arch)
    out = []
    for b in (1, 2, 6, 32):
        if cfg.family == "audio":
            tree = {"frames": (b, 64, cfg.frontend_dim), "labels": (b, 64)}
        elif cfg.family == "vlm":
            tree = {"tokens": (b, 64), "patch_embeds": (b, cfg.frontend_tokens, cfg.frontend_dim)}
        else:
            tree = {"tokens": (b, 64)}
        out.append({k: jax.ShapeDtypeStruct(v, np.float32) for k, v in tree.items()})
    return out


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["qwen3-4b", "internvl2-1b", "hubert-xlarge"])
def test_batch_specs_equal_reference(arch, shape):
    amesh, lmesh = _meshes(shape)
    jrules = jax_sh.default_rules(jax_get_config(arch), amesh)
    rules = default_rules(get_config(arch), lmesh)
    for tree in _batches(arch):
        want = _ref_tuples(jax_sh.batch_specs(jax_get_config(arch), amesh, jrules, tree))
        got = batch_specs(get_config(arch), lmesh, rules, tree)
        assert got == want, (tree, got, want)


def test_batch_specs_replicate_a_batch_of_one_and_fall_back_to_the_pod_prefix():
    """The two fallbacks of ``_data_or_replicated``, spelled out."""
    cfg = get_config("qwen3-4b")
    lmesh = LogicalMesh(MULTIPOD_SHAPE, ("pod", "data", "model"))
    rules = default_rules(cfg, lmesh)
    assert rules.lookup("batch") == ("pod", "data")
    spec = lambda b: batch_specs(cfg, lmesh, rules, {"t": torch.empty(b, 8)})["t"]  # noqa: E731
    assert spec(1) == (None, None)          # a global batch of 1: whole on every rank
    assert spec(2) == ("pod", None)         # 2 rows: split over pod only
    assert spec(64) == (("pod", "data"), None)
    assert _data_or_replicated(lmesh, rules, 6) == "pod"
    assert batch_specs(cfg, lmesh, rules, {"s": torch.empty(())}) == {"s": ()}


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", sorted(a for a in ARCHS if get_config(a).supports_decode))
def test_decode_state_spec_equal_reference(arch, shape):
    """On the reference's decode-state shapes from ``jax.eval_shape``
    (a batch of 32, context 256: both divide every data axis here)."""
    amesh, lmesh = _meshes(shape)
    jcfg = jax_get_config(arch)
    jrules = jax_sh.default_rules(jcfg, amesh)
    rules = default_rules(get_config(arch), lmesh)
    shapes = jax.eval_shape(lambda: JaxModel(jcfg).init_decode_state(32, 256))
    want = _ref_tuples(jax_sh.decode_state_spec(jcfg, amesh, jrules, shapes))
    got = decode_state_spec(get_config(arch), lmesh, rules, shapes)
    assert jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple) and not hasattr(
        x, "_fields")) == jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple)
                                          and not hasattr(x, "_fields"))
    # and on the port's own decode state (meta tensors), leaf by leaf
    port_state = Model(get_config(arch)).init_decode_state(32, 256, device="meta")
    mine = decode_state_spec(get_config(arch), lmesh, rules, port_state)
    ref_leaves = dict(_flat(_ref_tuples(jax_sh.decode_state_spec(jcfg, amesh, jrules, shapes))))
    for path, spec in _flat(mine):
        if spec is not None:
            assert spec == ref_leaves[path], path


def test_production_shapes_and_the_world_they_need():
    assert PROD_SHAPE == jax_mesh.PROD_SHAPE == (16, 16)
    assert MULTIPOD_SHAPE == jax_mesh.MULTIPOD_SHAPE == (2, 16, 16)
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs a process group of {n} ranks"):
            make_production_mesh(multi_pod=multi, device="cpu")
    with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
        make_train_mesh(data=2, device="cpu")
    one = make_train_mesh(device="cpu")
    assert one.shape == {"data": 1, "model": 1} and one.rank == 0 and one.group("data") is None


def test_ruleset_lookup_spec_and_overrides_equal_reference():
    jcfg, cfg = jax_get_config("qwen3-4b"), get_config("qwen3-4b")
    amesh, lmesh = _meshes((2, 2))
    jr = jax_sh.default_rules(jcfg, amesh, fsdp=True)
    r = default_rules(cfg, lmesh, fsdp=True)
    over = dict(heads=None, mlp="data", embed=("data", "model"), extra="model")
    assert r.with_overrides(**over).rules == jr.with_overrides(**over).rules
    assert r.with_overrides(**over).lookup("extra") == "model"
    assert r.lookup(None) is None and r.lookup("nope") is None
    axes = ("layer", "embed", "heads", None)
    assert r.spec(axes) == tuple(jr.spec(axes))
    tree = {"a": ("embed", "mlp"), "b": {"c": ("vocab",)}}
    assert specs_from_axes(r, tree) == _ref_tuples(jax_sh.specs_from_axes(jr, tree))
    assert isinstance(r, Ruleset)


def test_mesh_shape_reads_a_device_mesh_by_its_dim_names():
    """A torch DeviceMesh keeps its sizes in a tuple ``.shape`` beside
    ``mesh_dim_names``; the rules read it through ``mesh_shape``."""
    class DeviceMeshLike:
        mesh_dim_names = ("data", "model")
        shape = (4, 2)

    assert mesh_shape(DeviceMeshLike()) == {"data": 4, "model": 2}
    cfg = get_config("olmoe-1b-7b")
    assert default_rules(cfg, DeviceMeshLike(), fsdp=True) == default_rules(
        cfg, LogicalMesh((4, 2), ("data", "model")), fsdp=True)


class _Stub:
    """A mesh with set coordinates and no process group (block arithmetic
    only)."""

    def __init__(self, shape, names, rank):
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.coords = dict(zip(names, map(int, np.unravel_index(rank, shape))))

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


@pytest.mark.parametrize("spec", [(("pod", "data"), "model", None), ("model", ("pod", "data"), None),
                                  (("data", "pod"), None, "model"), (None, None, None),
                                  ("data", None, ("model", "pod"))])
def test_take_block_tiles_the_leaf_in_the_specs_order(spec):
    """Every rank's block, put back where its index says (mixed radix over
    each dim's axes, the first major), rebuilds the leaf exactly once."""
    shape, names = (2, 2, 2), ("pod", "data", "model")
    full = torch.arange(8 * 4 * 8, dtype=torch.float32).reshape(8, 4, 8)
    seen = torch.zeros_like(full)
    for rank in range(math.prod(shape)):
        m = _Stub(shape, names, rank)
        layout.check_spec(spec, tuple(full.shape), m)
        blk = layout.take_block(full, spec, m)
        assert tuple(blk.shape) == layout.block_shape(tuple(full.shape), spec, m)
        assert layout.full_shape(tuple(blk.shape), spec, m) == tuple(full.shape)
        sl = layout._slices(tuple(full.shape), layout.entries(spec, m), m)
        assert torch.equal(full[sl], blk)
        seen[sl] += 1
    used = {a for e in spec if e for a in ((e,) if isinstance(e, str) else e)}
    assert torch.equal(seen, torch.full_like(full, math.prod(shape) // math.prod(
        shape[names.index(a)] for a in used)))
    # pod-major: on ("pod", "data") rank (pod=1, data=0) holds block 2 of 4
    m = _Stub(shape, names, 4)
    assert m.coords == {"pod": 1, "data": 0, "model": 0} and m.index(("pod", "data")) == 2


def test_check_spec_raises_on_a_split_that_does_not_divide():
    m = _Stub((2, 2), ("data", "model"), 0)
    with pytest.raises(ValueError, match=r"layers/attn/wk: dim 2 of shape \(2, 256, 1, 32\)"):
        layout.check_spec((None, None, "model", None), (2, 256, 1, 32), m, "layers/attn/wk")
    with pytest.raises(ValueError, match="names axis 'model' twice"):
        layout.check_spec(("model", "model"), (4, 4), m)
    with pytest.raises(ValueError, match="not in the mesh"):
        layout.check_spec(("pod",), (4,), m)
    with pytest.raises(ValueError, match="spec"):
        layout.check_spec(("data",), (4, 4), m)
    layout.check_spec((None, "data"), (3, 4), m)
