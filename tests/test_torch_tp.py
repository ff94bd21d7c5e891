"""Tensor-parallel compute over ``model`` (``repro_torch.distributed.tp``)
on the CPU, without a process group: the decode partials' merge by
log-sum-exp on the plain decode attention, the KV heads a rank's q heads
use under a kv deficit, the leaf-by-leaf block init, the decode state at
a rank's shapes, and the lowered steps' counted products, which show that
the split is real: summed over the two ranks of a model=2 mesh they equal
one rank's count plus the products the ruleset leaves replicated, and no
leaf split over ``model`` is gathered.  The steps on real ranks (against
the one-device trajectory and the reference's Model) are in
``tests/test_torch_sharded_train.py``.
"""
from __future__ import annotations

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.distributed import default_rules, layout, shard_params_spec  # noqa: E402
from repro_torch.distributed.mesh import LogicalMesh  # noqa: E402
from repro_torch.distributed.tp import ModelParallel, merge_partials, split_spec  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.lowering import build_lowered, rank_view  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import _kv_for_heads  # noqa: E402
from repro_torch.train.optimizer import _walk  # noqa: E402

MATMUL = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot")
B, S = 2, 64


def _smoke(arch: str) -> dict:
    cfg = get_config(arch, smoke=True)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


# ------------------------------------------------ the decode merge --

def _decode_inputs(c=32, filled=13, window=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, 8, 16, generator=g)
    kc, vc = torch.randn(2, 2, c, 2, 16, generator=g).unbind(0)
    pos = torch.full((c,), -1, dtype=torch.int32)
    pos[:filled] = torch.arange(filled, dtype=torch.int32)
    return q, kc, vc, pos, torch.tensor(filled - 1, dtype=torch.int32)


def _stacked(t: torch.Tensor, op: str) -> torch.Tensor:
    """The reduction over ranks stacked along dim 0."""
    return t.amax(0) if op == "max" else t.sum(0)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("window", [None, 6])
def test_lse_merge_of_slot_ranges_equals_the_whole_cache(ranks, window):
    """The plain decode over each of ``ranks`` slot ranges of a 32-slot
    cache with 13 tokens (the last ranges all empty: lse -inf), merged by
    ``merge_partials``, equals the plain decode over the whole cache; the
    merged log-sum-exp equals the whole one."""
    q, kc, vc, pos, npos = _decode_inputs()
    want, want_lse = ref.decode_attention_ref(q, kc, vc, pos, npos, window, lse=True)
    n = kc.shape[1] // ranks
    parts = [ref.decode_attention_ref(q, kc[:, r * n:(r + 1) * n], vc[:, r * n:(r + 1) * n],
                                      pos[r * n:(r + 1) * n], npos, window, lse=True)
             for r in range(ranks)]
    outs, lses = torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
    assert torch.isinf(lses[-1]).all() and (lses[-1] < 0).all()        # an empty range
    got = merge_partials(outs, lses, _stacked)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(torch.logsumexp(lses, 0), want_lse, atol=1e-6, rtol=1e-6)


def test_decode_lse_of_the_plain_version():
    """``decode_attention(..., lse=True)`` on CPU tensors: the same output
    as without, and each row's natural log-sum-exp of the allowed scaled
    scores (f64 written out); -inf where no slot is allowed."""
    q, kc, vc, pos, npos = _decode_inputs(filled=9)
    out, lse = kernels.decode_attention(q, kc, vc, pos, npos, lse=True)
    torch.testing.assert_close(out, kernels.decode_attention(q, kc, vc, pos, npos), rtol=0,
                               atol=0)
    assert lse.shape == (2, 8) and lse.dtype == torch.float32
    k64 = kc.double().repeat_interleave(4, dim=2)[:, :9]                 # (B, 9, H, D)
    scores = torch.einsum("bhd,bthd->bht", q.double(), k64) / math.sqrt(16)
    torch.testing.assert_close(lse.double(), torch.logsumexp(scores, -1), atol=1e-5, rtol=1e-6)
    empty = torch.full_like(pos, -1)
    _, lse = kernels.decode_attention(q, kc, vc, empty, npos, lse=True)
    assert torch.isneginf(lse).all()


# ----------------------------------------- a rank's heads and blocks --

@pytest.mark.parametrize("h0,hl,group,want", [
    (2, 2, 8, [0]),             # part of one group (qwen3-4b at model=16)
    (24, 24, 48, [0]),          # MQA (granite-20b at model=2)
    (6, 6, 4, [1, 1, 2, 2, 2, 2]),   # neither: one KV head per q head
])
def test_kv_heads_for_a_rank_s_q_heads(h0, hl, group, want):
    k = torch.arange(12, dtype=torch.float32)[None, :, None].expand(3, 12, 5)
    got = _kv_for_heads(k, h0, hl, group)
    assert got[0, :, 0].tolist() == want
    assert hl % got.shape[-2] == 0


def test_ssm_and_hybrid_families_take_no_model_parallel():
    tp = ModelParallel(None, 0, 2)
    for arch in ("rwkv6-3b", "zamba2-2.7b"):
        with pytest.raises(ValueError, match="tensor-parallel compute covers"):
            Model(get_config(arch, smoke=True), tp)
    Model(get_config("rwkv6-3b", smoke=True), ModelParallel(None, 0, 1))


def test_split_spec_keeps_the_tp_axes_over_model():
    mesh = LogicalMesh((2, 2), ("data", "model"))
    assert split_spec(("layer", "embed", "heads", "head_dim"), (None, "data", "model", None),
                      mesh) == ((None, None, "model", None), (None, "data", None, None))
    assert split_spec(("embed", "mlp"), ("model", None), mesh) == ((None, None), ("model", None))
    with pytest.raises(ValueError, match="over 'model' alone"):
        split_spec(("vocab", "embed"), (("data", "model"), None), mesh)


@pytest.mark.parametrize("rank", [0, 1])
def test_init_blocks_are_the_blocks_of_the_whole_init(rank):
    model = Model(get_config("olmoe-1b-7b", smoke=True))
    view = rank_view(LogicalMesh((1, 2), ("data", "model")), rank)
    spec = shard_params_spec(model, default_rules(model.cfg, view))
    whole = model.init(3, "cpu")
    blocks = model.init_blocks(3, "cpu", spec, view)
    split = 0
    for (k, b), (_, w), (_, sp) in zip(_walk(blocks), _walk(whole), _walk(spec)):
        assert torch.equal(b, layout.take_block(w, sp, view)), k
        split += b.numel() < w.numel()
    assert split >= 6


@pytest.mark.parametrize("arch,slots,kv", [("qwen3-4b", 8, 1), ("olmoe-1b-7b", 16, 2)])
def test_decode_state_at_the_rank_s_shapes(arch, slots, kv):
    """qwen3-4b smoke (one KV head): the 16 slots split; olmoe-1b-7b: the
    KV heads; the ring's positions whole and empty."""
    model = Model(get_config(arch, smoke=True))
    view = rank_view(LogicalMesh((1, 2), ("data", "model")), 1)
    st = model.init_decode_state(4, 16, "cpu", mesh=view, rules=default_rules(model.cfg, view))
    assert tuple(st.kv.k.shape) == (2, 4, slots, kv, 32) == tuple(st.kv.v.shape)
    assert st.kv.positions.tolist() == [-1] * 16 and int(st.kv.next_pos) == 0


# -------------------------------------------- the split is real --

def _count(arch, mesh, rank=0, fsdp=False):
    shape = InputShape("t", S, B, "train")
    step = build_lowered(arch, shape, LogicalMesh(*mesh), cfg_overrides=_smoke(arch),
                         fsdp=fsdp, grad_accum=1, rank=rank)
    counts, table = step.count()
    return sum(counts.by_prim.get(k, 0.0) for k in MATMUL), table, step


@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b"])
def test_rank_summed_products_are_one_rank_s_plus_the_replicated(arch):
    """At data=1 x model=2 the two ranks' matrix products (outside the
    kernels) sum to one rank's plus what the ruleset leaves replicated, a
    layer each: qwen3-4b's K/V projections under its kv deficit (x·wk and
    x·wv, and their two backward products each), olmoe-1b-7b's router (its
    forward and two backward products).  The train step's collectives are
    all-reduces: no leaf is gathered."""
    cfg = get_config(arch, smoke=True)
    one, _, _ = _count(arch, ((1, 1), ("data", "model")))
    ranks = [_count(arch, ((1, 2), ("data", "model")), r) for r in range(2)]
    t = B * S
    if arch == "qwen3-4b":
        per_layer = 3 * 2 * (2.0 * t * cfg.d_model * cfg.num_kv_heads * cfg.head_dim)
    else:
        per_layer = 3 * (2.0 * t * cfg.d_model * cfg.num_experts)
    replicated = cfg.num_layers * per_layer
    assert sum(r[0] for r in ranks) == one + replicated
    assert ranks[0][0] < one
    for _, table, _ in ranks:
        assert set(table) == {"all_reduce"}, table


def test_fsdp_gathers_only_over_the_data_axes():
    """data=2 x model=2 with FSDP: the step's all-gathers bring each leaf
    split over ``data`` to the rank's block over ``model``, never to full."""
    _, table, step = _count("qwen3-4b", ((2, 2), ("data", "model")), fsdp=True)
    full = sum(math.prod(s.shape) for _, s in _walk(Model(get_config(
        "qwen3-4b", smoke=True)).specs())) * 4
    assert table["all_gather"]["bytes"] == step.gathered["params"]
    assert 0 < step.gathered["params"] < full / 1.9
