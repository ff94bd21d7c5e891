"""The port's roofline, lowering and dry-run (``repro_torch.launch``)
and its shape catalogue (``repro_torch.configs``) against the reference on
the CPU.

Shared with the reference, for all ten archs × four shapes: ``SHAPES``,
``shape_applicability``, ``input_specs``, ``decode_state_specs`` (shapes
and dtypes), ``active_params``, ``model_flops`` and ``auto_policies``
(× both production meshes).  The lowering at a smoke size of qwen3-4b:
the prefill, decode and train steps' matrix products outside the kernels
equal the reference's ``dot_general`` outside attention (the products
without batch dims) exactly, and the totals with each kernel counted by
its declared products stand within ``TOTAL_BAND`` of the reference's.  The
lowering's collective table equals what two gloo ranks pass to
``distributed/layout.py``'s collectives in one step (qwen3-4b with FSDP
and at data=1 x model=2, rwkv6-3b at data=1 x model=2).  The counting hook
raises on a real tensor.  The dry-run skips by design with the
reference's reason and writes per-rank bytes and ``fits`` (the
tensor-parallel serving step holds the rank's blocks and gathers nothing
without FSDP).
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.analysis.cert import costs as jax_costs  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.configs import shape_applicability as jax_applicability  # noqa: E402
from repro.configs.registry import decode_state_specs as jax_decode_state_specs  # noqa: E402
from repro.launch import lowering as jax_lowering  # noqa: E402
from repro.launch import roofline as jax_roofline  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.train.loop import make_train_step as jax_train_step  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.analysis.cert.costs import Counts, counting  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, InputShape, decode_state_specs,  # noqa: E402
                                 get_config, input_specs, shape_applicability)
from repro_torch.distributed import default_rules, layout, shard_params_spec  # noqa: E402
from repro_torch.distributed.mesh import LogicalMesh  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.lowering import auto_policies, build_lowered  # noqa: E402
from repro_torch.launch.roofline import active_params, model_flops  # noqa: E402
from repro_torch.models import Model  # noqa: E402

import torch_sharded_ranks  # noqa: E402

ARCH_IDS = sorted(ARCHS)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
MATMUL = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot")
# smoke qwen3-4b at B x S (prefill/train) and B over an S cache (decode)
B, S = 2, 64
# the total products, port over reference (the port's extra loss-chunk
# recomputation apart): prefill and decode count the same products (the
# reference's dense attention over every pair, the kernels' declared
# products as written); a train step's flash backward recomputes
# S = Q·Kᵀ (five products against the reference's four), so the port
# counts 7/6 of the reference's attention products
TOTAL_BAND = {"prefill": (1.0, 1.0), "decode": (1.0, 1.0), "train": (1.0, 1.1)}


def _smoke(arch: str = "qwen3-4b") -> dict:
    """``arch``'s smoke config as overrides of its full one."""
    cfg = get_config(arch, smoke=True)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


# ------------------------------------------------ the shape catalogue --

def test_shapes_are_the_reference_s():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shp in SHAPES.items():
        ref = JAX_SHAPES[name]
        assert (shp.name, shp.seq_len, shp.global_batch, shp.kind) == \
            (ref.name, ref.seq_len, ref.global_batch, ref.kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicability_and_input_specs_are_the_reference_s(arch):
    cfg, ref_cfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        assert shape_applicability(cfg, SHAPES[name]) == \
            jax_applicability(ref_cfg, JAX_SHAPES[name])
        got, want = input_specs(cfg, name), jax_input_specs(ref_cfg, name)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert (tuple(got[k].shape), _dtype(got[k])) == (tuple(want[k].shape),
                                                             str(want[k].dtype)), (name, k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_specs_are_the_reference_s(arch):
    cfg, ref_cfg = get_config(arch), jax_get_config(arch)
    for name in ("decode_32k", "long_500k"):
        if not shape_applicability(cfg, SHAPES[name])[0]:
            continue
        got = sorted((tuple(t.shape), _dtype(t)) for t in _tensors(decode_state_specs(cfg, name)))
        want = sorted((tuple(x.shape), str(x.dtype))
                      for x in jax.tree.leaves(jax_decode_state_specs(ref_cfg, name)))
        assert got == want, name
        assert all(t.device.type == "meta" for t in _tensors(decode_state_specs(cfg, name)))


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_model_flops_and_policies_are_the_reference_s(arch):
    cfg, ref_cfg = get_config(arch), jax_get_config(arch)
    model, ref_model = Model(cfg), JaxModel(ref_cfg)
    assert active_params(cfg, model) == jax_roofline.active_params(ref_cfg, ref_model)
    for name in SHAPES:
        assert model_flops(cfg, name) == jax_roofline.model_flops(ref_cfg, name), name
        for shape, axes in MESHES.values():
            got = auto_policies(cfg, model, LogicalMesh(shape, axes), SHAPES[name], None, None)
            want = jax_lowering.auto_policies(ref_cfg, ref_model, AbstractMesh(shape, axes),
                                              JAX_SHAPES[name], None, None)
            assert got == want, (name, shape)


# ------------------------------------------------------- the lowering --

def _ref_counts(fn, *args) -> tuple[float, float]:
    """(dot_general flops without batch dims, with them) of the reference's
    jaxpr of ``fn``: its attention's products carry batch dims (batch, KV
    head), every other product none."""
    closed = jax.make_jaxpr(fn)(*args)
    total = jax_costs.count_jaxpr(closed).by_prim.get("dot_general", 0.0)
    real = jax_costs._dot_general_flops

    def unbatched(eqn):
        return 0.0 if eqn.params["dimension_numbers"][1][0] else real(eqn)

    jax_costs._dot_general_flops = unbatched
    try:
        outside = jax_costs.count_jaxpr(closed).by_prim.get("dot_general", 0.0)
    finally:
        jax_costs._dot_general_flops = real
    return outside, total - outside


@pytest.fixture(scope="module")
def smoke_steps():
    cfg, ref_cfg = get_config("qwen3-4b", smoke=True), jax_get_config("qwen3-4b", smoke=True)
    ref_model = JaxModel(ref_cfg)
    p = jax.eval_shape(lambda: ref_model.init(jax.random.PRNGKey(0)))
    one = LogicalMesh((1, 1), ("data", "model"))
    out = {}
    for kind, shape in (("prefill", InputShape("p", S, B, "prefill")),
                        ("decode", InputShape("d", S, B, "decode")),
                        ("train", InputShape("t", S, B, "train"))):
        counts, _ = build_lowered("qwen3-4b", shape, one, cfg_overrides=_smoke(), fsdp=False,
                                  grad_accum=1).count()
        tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
        if kind == "prefill":
            ref = _ref_counts(lambda p, b: ref_model.prefill(p, b), p, {"tokens": tok})
        elif kind == "decode":
            st = jax.eval_shape(lambda: ref_model.init_decode_state(B, S))
            ref = _ref_counts(lambda p, s, t: ref_model.decode_step(p, s, t), p, st,
                              jax.ShapeDtypeStruct((B,), jnp.int32))
        else:
            opt = jax.eval_shape(jax_adamw_init, p)
            ref = _ref_counts(jax_train_step(ref_model, JaxAdamW(), 1), p, opt, {"tokens": tok})
        out[kind] = (counts, ref)
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_lowered_smoke_steps_count_the_reference_s_products(smoke_steps, kind):
    counts, (ref_outside, ref_attention) = smoke_steps[kind]
    mm = sum(counts.by_prim.get(k, 0.0) for k in MATMUL)
    extra = 0.0
    if kind == "train":
        # the port checkpoints each loss chunk (Model._chunked_ce), so its
        # backward recomputes the chunk's logits: one more head product
        # over the S - 1 targets than the reference's unchecked chunks
        cfg = get_config("qwen3-4b", smoke=True)
        extra = 2.0 * B * (S - 1) * cfg.d_model * cfg.vocab_size
    assert mm == ref_outside + extra
    kern = sum(v for k, v in counts.by_prim.items() if k.startswith("kernel_matmul:"))
    assert kern > 0 and counts.kernels
    lo, hi = TOTAL_BAND[kind]
    assert lo <= (mm - extra + kern) / (ref_outside + ref_attention) <= hi
    if kind == "train":
        assert kern / ref_attention == pytest.approx(7 / 6)
    assert counts.host_prims == [] and counts.unknown == []


def test_lowered_train_step_counts_each_kernel_once_per_call(smoke_steps):
    counts, _ = smoke_steps["train"]
    layers = get_config("qwen3-4b", smoke=True).num_layers
    assert counts.kernels == {"flash_attention": layers, "flash_attention_bwd": layers}
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)


@pytest.mark.parametrize("arch,scan", [("rwkv6-3b", "rwkv6_wkv"), ("zamba2-2.7b", "mamba2_ssd")])
def test_lowered_scan_train_steps_count_the_backward_kernels(arch, scan):
    """A scan family's train step (smoke, B x S) counts each scan call's
    backward as the card runs it: once per layer, by the backward kernel's
    declared cost (``kernels/cost.py``'s gradient cost at the model's
    chunk), and no aten op of the chunked form."""
    from repro_torch.kernels.cost import call_cost

    cfg = get_config(arch, smoke=True)
    one = LogicalMesh((1, 1), ("data", "model"))
    counts, _ = build_lowered(arch, InputShape("t", S, B, "train"), one,
                              cfg_overrides=_smoke(arch), fsdp=False, grad_accum=1).count()
    layers = cfg.num_layers
    assert counts.kernels[scan] == counts.kernels[f"{scan}_bwd"] == layers
    if scan == "rwkv6_wkv":
        h, dk = cfg.num_heads, cfg.d_model // cfg.num_heads
        shapes = [(B, S, h, dk)] * 4 + [(h, dk)]
        kw = {"grad_chunk": math.gcd(S, cfg.ssm_chunk)}
    else:
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        shapes = [(B, S, h, p), (B, S, h), (h,), (B, S, n), (B, S, n)]
        kw = {"chunk": cfg.ssm_chunk}
    want = call_cost(f"{scan}_bwd", [torch.empty(sh) for sh in shapes], kw)
    assert counts.by_prim[f"kernel:{scan}_bwd"] == layers * want.flops
    assert "cumsum" not in counts.by_prim and counts.host_prims == []


def test_counting_hook_raises_on_a_real_tensor():
    q = torch.zeros(1, 8, 2, 16)
    with counting(Counts()):
        with pytest.raises(RuntimeError, match="real tensor"):
            kernels.flash_attention(q, q, q)
    assert kernels.ops.count_hook is None
    assert kernels.flash_attention(q, q, q).shape == q.shape


COLLECTIVE_JOBS = {"fsdp": dict(kind="collectives", arch="qwen3-4b", mesh=dict(data=2),
                                fsdp=True, batch=4, seq=S),
                   "model2": dict(kind="collectives", arch="qwen3-4b",
                                  mesh=dict(data=1, model=2), fsdp=False, batch=4, seq=S),
                   "rwkv6-model2": dict(kind="collectives", arch="rwkv6-3b",
                                        mesh=dict(data=1, model=2), fsdp=False, batch=4, seq=S)}


def test_collective_table_is_what_two_gloo_ranks_pass(tmp_path):
    """qwen3-4b with FSDP at data=2 and at data=1 x model=2, and rwkv6-3b
    (ssm) at data=1 x model=2: the lowering's table equals what each rank
    passes.  rwkv6-3b gathers no leaf: its one all-gather a layer is the
    channel mix's sigmoid gate, (B, S, d) f32."""
    ranks = run_ranks(torch_sharded_ranks.run_jobs, 2, init_file=str(tmp_path / "pg"),
                      args=(list(COLLECTIVE_JOBS.values()),), threads=1, timeout=300)
    for i, (name, job) in enumerate(COLLECTIVE_JOBS.items()):
        m = job["mesh"]
        mesh = LogicalMesh((m["data"], m.get("model", 1)), ("data", "model"))
        step = build_lowered(job["arch"], InputShape("t", S, job["batch"], "train"), mesh,
                             cfg_overrides=_smoke(job["arch"]), fsdp=job["fsdp"], grad_accum=1)
        _, table = step.count()
        assert ranks[0][i] == ranks[1][i] == table, name
    assert set(ranks[0][0]) == {"all_gather", "reduce_scatter", "all_reduce"}
    cfg, rows = get_config("rwkv6-3b", smoke=True), COLLECTIVE_JOBS["rwkv6-model2"]["batch"]
    assert step.gathered["params"] == 0.0
    assert ranks[0][2]["all_gather"] == {
        "count": cfg.num_layers, "bytes": float(cfg.num_layers * rows * S * cfg.d_model * 4)}


# ---------------------------------------------------------- the dry-run --

def test_dryrun_skips_by_design_and_records_per_rank_bytes(tmp_path):
    rec = dryrun.run_one("hubert-xlarge", "decode_32k", "single")
    assert rec["status"] == "skipped" and rec["reason"] == "encoder-only: no decode step"
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k", "--mesh", "multi",
                        "--no-analysis", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["chips"] == 512 and rec["fits"] is True
    mem = rec["memory_analysis"]
    assert mem["total"] == pytest.approx(mem["arguments"] + mem["gathered"])
    # tensor-parallel serving: the step computes on the rank's blocks (bf16)
    # and, without FSDP, gathers nothing
    cfg = get_config("qwen3-4b")
    mesh = LogicalMesh((2, 16, 16), ("pod", "data", "model"))
    spec = dict(_walk_tree(shard_params_spec(Model(cfg), default_rules(cfg, mesh))))
    blocks = sum(math.prod(layout.block_shape(leaf.shape, spec[k], mesh))
                 for k, leaf in _walk_tree(Model(cfg).specs()))
    assert mem["gathered_params"] == 0.0
    assert mem["arguments_params"] == pytest.approx(2.0 * blocks)
    # 16 ranks along model: a rank holds ~1/10 (K/V stay whole under the kv deficit)
    assert blocks < Model(cfg).num_params() / 8


def _walk_tree(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_tree(tree[k], path + (k,))
    else:
        yield path, tree


def test_dryrun_analysis_record_carries_the_roofline():
    rec = dryrun.run_one("internvl2-1b", "prefill_32k", "single")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert 0.0 < rec["useful_fraction"] < 1.0 and rec["fits"] is True
    assert rec["collectives"]["all_gather"]["count"] > 0
    assert np.isfinite(rec["compute_s"]) and rec["kernels"]["flash_attention"] > 0
