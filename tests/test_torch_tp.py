"""Tensor-parallel compute over ``model`` (``repro_torch.distributed.tp``)
on the CPU, without a process group: the decode partials' merge by
log-sum-exp on the plain decode attention, the KV heads a rank's q heads
use under a kv deficit, the split RMSNorm and an RWKV6 layer (heads and
``mlp`` split or whole) on ranks that are threads of one process, the
layout's model blocks of every family, the leaf-by-leaf
block init, the decode state at a rank's shapes, a Mamba2 block that is
no whole number of heads, and the lowered steps' counted products, which
show that the split is real: summed over the two ranks of a model=2 mesh
they equal one rank's count plus the products the ruleset leaves
replicated, and no leaf split over ``model`` is gathered.  The steps on real ranks (against
the one-device trajectory and the reference's Model) are in
``tests/test_torch_sharded_train.py``.
"""
from __future__ import annotations

import dataclasses
import math
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.distributed import default_rules, layout, shard_params_spec  # noqa: E402
from repro_torch.distributed.mesh import LogicalMesh  # noqa: E402
from repro_torch.distributed.tp import ModelParallel, merge_partials, rmsnorm_split, \
    split_spec  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.lowering import build_lowered, rank_view  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import _kv_for_heads  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.distributed.sharding import specs_from_axes  # noqa: E402
from repro_torch.models.mamba2 import mamba2_block  # noqa: E402
from repro_torch.models.params import axes_tree  # noqa: E402
from repro_torch.models.rwkv6 import rwkv6_block, rwkv6_decode_step, rwkv6_specs  # noqa: E402
from repro_torch.train.loop import MeshedLayout, _shapes  # noqa: E402
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


# ------------------------------------------------- the split RMSNorm --

class _Threads(ModelParallel):
    """A model axis whose ranks are threads of this process: ``all_reduce``
    sums (or maxes) the ranks' tensors in rank order through a board."""

    def __init__(self, index: int, size: int, board: list, barrier: threading.Barrier):
        super().__init__(None, index, size)
        self.board, self.barrier = board, barrier

    def all_reduce(self, x, op="sum"):
        self.board[self.index] = x.float()
        self.barrier.wait()
        parts = torch.stack(list(self.board))
        out = (parts.sum(0) if op == "sum" else parts.amax(0)).to(x.dtype)
        self.barrier.wait()
        return out

    def all_gather_last(self, x):
        self.board[self.index] = x
        self.barrier.wait()
        out = torch.cat(list(self.board), dim=-1)
        self.barrier.wait()
        return out


def _on_threads(n: int, fn) -> list:
    """``fn(tp)`` on ``n`` thread ranks; their results in rank order."""
    board, barrier, out = [None] * n, threading.Barrier(n), [None] * n

    def run(i):
        out[i] = fn(_Threads(i, n, board, barrier))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@pytest.mark.parametrize("ranks", [2, 4])
def test_split_rmsnorm_equals_the_whole_norm(ranks):
    """Each rank's block of a (2, 5, 64) f32 activation normed over all 64
    columns by ``rmsnorm_split`` (the sum of squares over the ranks, the
    replicated scale entered and cut) equals its columns of ``rmsnorm``;
    with the loss summed over the ranks (a cotangent on each rank's
    columns) every rank's input gradient is its columns of the whole one,
    and the scale's gradient is the whole one on every rank."""
    g = torch.Generator().manual_seed(2)
    y = torch.randn(2, 5, 64, generator=g) * 3
    scale = 1 + 0.1 * torch.randn(64, generator=g)
    cot = torch.randn(2, 5, 64, generator=g)
    yw, sw = y.clone().requires_grad_(), scale.clone().requires_grad_()
    want = rmsnorm({"scale": sw}, yw, 1e-5)
    gy, gs = torch.autograd.grad((want * cot).sum(), (yw, sw))
    n = 64 // ranks

    def rank(tp):
        cols = slice(tp.index * n, (tp.index + 1) * n)
        yl, sl = y[..., cols].clone().requires_grad_(), scale.clone().requires_grad_()
        got = rmsnorm_split(sl, yl, 1e-5, tp, 64)
        return (got.detach(), *torch.autograd.grad((got * cot[..., cols]).sum(), (yl, sl)))

    tol = dict(rtol=1e-5, atol=1e-6)        # f32: the squares summed in another order
    for i, (got, g_y, g_s) in enumerate(_on_threads(ranks, rank)):
        cols = slice(i * n, (i + 1) * n)
        torch.testing.assert_close(got, want.detach()[..., cols], **tol)
        torch.testing.assert_close(g_y, gy[..., cols], **tol)
        torch.testing.assert_close(g_s, gs, **tol)


@pytest.mark.parametrize("heads,mlp", [("model", "model"), (None, "model"), ("model", None)])
def test_rwkv6_layer_on_thread_ranks_equals_the_whole_layer(heads, mlp):
    """A layer of smoke rwkv6-3b (4 heads of 64, d_ff 512) with its leaves
    cut for two thread ranks as the ruleset cuts them with ``heads`` and
    ``mlp`` mapped as given: heads and mlp split (model 2), heads whole
    (rwkv6-3b's 40 heads at model 16), mlp whole.  Each rank's output of
    the full-sequence layer equals the whole layer's, its gradients of x
    and of every leaf (a split leaf's: its block) the whole ones, and one
    decode step from a nonzero state gives the whole step's output, WKV
    state (the rank's heads) and shift rows."""
    cfg = get_config("rwkv6-3b", smoke=True)
    specs = rwkv6_specs(cfg)
    view = LogicalMesh((1, 2), ("data", "model"))
    rules = default_rules(cfg, view).with_overrides(heads=heads, mlp=mlp)
    leaf_specs = dict(_walk(specs_from_axes(rules, axes_tree(specs))))
    g = torch.Generator().manual_seed(4)
    whole = {k: torch.randn(ps.shape, generator=g) * (0.5 if k[-1].startswith("mu") else 0.2)
             for k, ps in _walk(specs)}
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    cot = torch.randn(2, 16, cfg.d_model, generator=g)
    h, dk = cfg.num_heads, cfg.d_model // cfg.num_heads
    s0 = torch.randn(2, h, dk, dk, generator=g) * 0.1
    shift = torch.randn(2, 2, cfg.d_model, generator=g)

    def layer(leaves, tp, state):
        tree = _nest(leaves)
        xw = x.clone().requires_grad_()
        out = rwkv6_block(tree, xw, cfg, tp)
        grads = torch.autograd.grad((out * cot).sum(), [xw] + list(leaves.values()))
        with torch.no_grad():
            s, st, sc = state
            step = rwkv6_decode_step(tree, x[:, :1], cfg, s, st, sc, tp)
        return out.detach(), dict(zip(["x"] + list(leaves), grads)), step, state

    want = layer({k: v.clone().requires_grad_() for k, v in whole.items()}, None,
                 (s0.clone(), shift[0].clone(), shift[1].clone()))

    def rank(tp):
        rv = rank_view(view, tp.index)
        mine = {k: layout.take_block(v, leaf_specs[k], rv).clone().requires_grad_()
                for k, v in whole.items()}
        hl = mine[("time", "wr")].shape[1]
        s = s0[:, tp.index * hl:(tp.index + 1) * hl] if hl < h else s0
        return layer(mine, tp, (s.clone(), shift[0].clone(), shift[1].clone()))

    def close(got, ref, what):                # f32 sums over the ranks in another order
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), what

    for i, (out, grads, step, state) in enumerate(_on_threads(2, rank)):
        rv = rank_view(view, i)
        close(out, want[0], "out")
        close(grads["x"], want[1]["x"], "x")
        for k in whole:
            close(grads[k], layout.take_block(want[1][k], leaf_specs[k], rv), k)
        close(step, want[2], "decode")
        hl = state[0].shape[1]
        close(state[0], want[3][0][:, i * hl:(i + 1) * hl] if hl < h else want[3][0], "s")
        assert torch.equal(state[1], want[3][1])        # the normed input: no split before it
        close(state[2], want[3][2], "shift_c")


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def test_mamba2_block_of_no_whole_heads_raises():
    """A rank's d_inner block must be whole SSM heads: smoke zamba2-2.7b's
    d_inner of 512 in heads of 64 over a model axis of 16 gives 32
    columns a rank."""
    cfg = get_config("zamba2-2.7b", smoke=True).replace(ssm_head_dim=64)
    params = {"in_x": torch.zeros(cfg.d_model, cfg.d_inner // 16)}
    with pytest.raises(ValueError, match=r"d_inner block of 32 \(d_inner 512 over a model "
                                         r"axis of 16\) is not a whole number of SSM heads "
                                         r"of width 64"):
        mamba2_block(params, torch.zeros(1, 32, cfg.d_model), cfg, ModelParallel(None, 3, 16))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_meshed_layout_keeps_the_model_blocks_of_every_family(arch):
    """data=2 x model=2 with FSDP: the ssm and hybrid models compute on
    their blocks (``Model(cfg, tp)``), each leaf the layout hands them is
    its block over ``model`` with only the data split gathered, and the
    leaves split over ``model`` include every TP axis the ruleset maps."""
    cfg = get_config(arch, smoke=True)
    view = rank_view(LogicalMesh((2, 2), ("data", "model")), 3)
    model = Model(cfg)
    spec = shard_params_spec(model, default_rules(cfg, view, fsdp=True))
    lay = MeshedLayout(model, view, spec)
    assert lay.net.tp is not None and (lay.net.tp.index, lay.net.tp.size) == (1, 2)
    axes, shapes = dict(_walk(model.axes())), _shapes(model)
    split, gathered = set(), 0
    for path, sp, rest, local in lay.items:
        assert local == tuple(n // 2 if e == "model" else n
                              for n, e in zip(shapes[path], sp)), path
        assert rest == tuple(None if e == "model" else e for e in sp), path
        split |= {a for a, e in zip(axes[path], sp) if e == "model"}
        gathered += "data" in rest
    assert gathered > 0
    assert split == ({"heads", "mlp", "vocab"} if arch == "rwkv6-3b"
                     else {"heads", "kv_heads", "mlp", "vocab"})


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


@pytest.mark.parametrize("arch,want", [
    ("qwen3-4b", {"kv.k": (2, 4, 8, 1, 32)}),
    ("olmoe-1b-7b", {"kv.k": (2, 4, 16, 2, 32)}),
    ("rwkv6-3b", {"rwkv.s": (2, 4, 2, 64, 64), "rwkv.shift_t": (2, 4, 256),
                  "rwkv.shift_c": (2, 4, 256)}),
    ("zamba2-2.7b", {"kv.k": (1, 4, 16, 2, 32), "ssm.h": (2, 4, 8, 32, 16),
                     "ssm.conv": (2, 4, 3, 256)}),
])
def test_decode_state_at_the_rank_s_shapes(arch, want):
    """Rank 1 of data=1 x model=2, batch 4, a 16-slot ring: qwen3-4b smoke
    (one KV head) splits the slots; olmoe-1b-7b the KV heads; rwkv6-3b the
    WKV state's heads (the shift rows whole); zamba2-2.7b the shared
    block's KV heads, the SSD state's heads and the conv tail's d_inner;
    the ring's positions whole and empty."""
    model = Model(get_config(arch, smoke=True))
    view = rank_view(LogicalMesh((1, 2), ("data", "model")), 1)
    st = model.init_decode_state(4, 16, "cpu", mesh=view, rules=default_rules(model.cfg, view))
    for key, shape in want.items():
        part, leaf = key.split(".")
        assert tuple(getattr(getattr(st, part), leaf).shape) == shape, key
    if st.kv is not None:
        assert tuple(st.kv.v.shape) == want["kv.k"]
        assert st.kv.positions.tolist() == [-1] * 16 and int(st.kv.next_pos) == 0


# -------------------------------------------- the split is real --

def _count(arch, mesh, rank=0, fsdp=False):
    shape = InputShape("t", S, B, "train")
    step = build_lowered(arch, shape, LogicalMesh(*mesh), cfg_overrides=_smoke(arch),
                         fsdp=fsdp, grad_accum=1, rank=rank)
    counts, table = step.count()
    return sum(counts.by_prim.get(k, 0.0) for k in MATMUL), table, step


@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b", "rwkv6-3b", "zamba2-2.7b"])
def test_rank_summed_products_are_one_rank_s_plus_the_replicated(arch):
    """At data=1 x model=2 the two ranks' matrix products (outside the
    kernels) sum to one rank's plus what the ruleset leaves replicated,
    each in its forward and two backward products: qwen3-4b's K/V
    projections under its kv deficit (x·wk and x·wv) a layer, olmoe-1b-7b's
    router a layer, rwkv6-3b's decay LoRA (x·w_lora_a) a layer, and a
    zamba2-2.7b Mamba2 layer's B and C projections (x·in_b, x·in_c); the
    SSD gradient is its backward kernel's, counted by its declared cost
    outside these products.  No leaf is gathered: the train step's
    collectives are all-reduces, and rwkv6-3b's all-gathers are the channel
    mix's gate, (B, S, d) a layer."""
    cfg = get_config(arch, smoke=True)
    one, _, _ = _count(arch, ((1, 1), ("data", "model")))
    ranks = [_count(arch, ((1, 2), ("data", "model")), r) for r in range(2)]
    t = B * S
    if arch == "qwen3-4b":
        per_layer = 3 * 2 * (2.0 * t * cfg.d_model * cfg.num_kv_heads * cfg.head_dim)
    elif arch == "olmoe-1b-7b":
        per_layer = 3 * (2.0 * t * cfg.d_model * cfg.num_experts)
    elif arch == "rwkv6-3b":
        per_layer = 3 * (2.0 * t * cfg.d_model * 64)
    else:
        per_layer = 3 * 2 * (2.0 * t * cfg.d_model * cfg.ssm_state)
    replicated = cfg.num_layers * per_layer
    assert sum(r[0] for r in ranks) == one + replicated
    assert ranks[0][0] < one
    for _, table, step in ranks:
        assert step.gathered["params"] == 0.0
        if arch == "rwkv6-3b":
            assert table.pop("all_gather") == {
                "count": cfg.num_layers, "bytes": float(cfg.num_layers * t * cfg.d_model * 4)}
        assert set(table) == {"all_reduce"}, table


def test_fsdp_gathers_only_over_the_data_axes():
    """data=2 x model=2 with FSDP: the step's all-gathers bring each unit's
    leaves split over ``data`` to the rank's block over ``model``, never
    to full: their bytes are each unit's gathered bytes times the gathers
    the step makes of it (once in the forward, once more in the backward
    for a layer), and the most a step holds at once is less than half the
    model."""
    _, table, step = _count("qwen3-4b", ((2, 2), ("data", "model")), fsdp=True)
    full = sum(math.prod(s.shape) for _, s in _walk(Model(get_config(
        "qwen3-4b", smoke=True)).specs())) * 4
    plan = step.feed
    assert table["all_gather"]["bytes"] == sum(u.gathered * plan.gathers[name]
                                               for name, u in plan.units.items())
    assert plan.gathers == {name: 2 if u.stack else 1 for name, u in plan.units.items()}
    assert plan.reductions == dict.fromkeys(plan.units, 1)
    assert 0 < step.gathered["params"] == plan.high < full / 1.9
