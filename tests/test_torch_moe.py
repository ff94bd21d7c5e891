"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference (``repro/models/moe.py``), on the CPU in float32.

Five routing regimes on the same numpy inputs: drop-free capacity, a
capacity that drops (the router biased towards one expert), one that every
expert overflows at first and second choices alike, a token count
that forces the group-size shrink, and an exact tie between two experts
at the top-k boundary.  Expert ids and kept choices must be equal (where
an id differs, the two probabilities must be equal to f32 rounding);
outputs agree within 1e-5 and each aux value within 1e-6.  The reference
does not return its routing, so ``_jax_routing`` writes its lines
(``moe.py:66-78``) out in JAX and is itself held to the reference's
``drop_fraction``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

OUT = dict(atol=1e-5, rtol=1e-5)
AUX = dict(atol=1e-6, rtol=1e-6)
F32_EPS = float(np.finfo(np.float32).eps)

BASE = dict(name="moe-test", family="moe", num_layers=1, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=48, vocab_size=64, num_experts=4,
            num_experts_per_tok=2, dtype="float32", param_dtype="float32")


def _case(name):
    """(config fields, x (B,S,d), params as numpy) of one routing regime."""
    rng = np.random.default_rng(sum(map(ord, name)))
    d, f, e = BASE["d_model"], BASE["d_ff"], BASE["num_experts"]
    params = {
        "router": (rng.standard_normal((d, e)) * 0.5 / np.sqrt(d)).astype(np.float32),
        "gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
        "up": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
        "down": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32),
    }
    if name == "drop_free":
        fields, shape = dict(capacity_factor=4.0, moe_group_size=16), (2, 16)
    elif name == "dropping":
        # a constant first feature and a router row that favours expert 0:
        # nearly every token picks it, past the capacity of 20 per group
        fields, shape = dict(capacity_factor=1.25, moe_group_size=32), (2, 32)
        params["router"][0] = [1.5, 0.0, 0.0, -1.5]
    elif name == "overflow":
        # capacity 8 against a mean load of 16: every expert overflows, at
        # first and second choices alike, so the (token, choice) order of
        # the capacity cumsum decides which choices stay
        fields, shape = dict(capacity_factor=0.5, moe_group_size=32), (2, 32)
    elif name == "shrink":
        # 21 tokens: the group of 16 shrinks to 7 (three groups)
        fields, shape = dict(capacity_factor=1.25, moe_group_size=16), (3, 7)
    else:  # tie
        # dyadic inputs (every product and sum exact in f32, so both
        # frameworks' logits are exact) and two equal router columns:
        # experts 1 and 2 tie exactly at the top-2 boundary
        fields, shape = dict(capacity_factor=4.0, moe_group_size=16), (2, 16)
        r = rng.integers(-4, 5, (d, e)) / 64.0
        r[:, 2] = r[:, 1]
        r[0] = [2.0, 1.0, 1.0, -2.0]
        params["router"] = r.astype(np.float32)
    x = rng.standard_normal((*shape, d)).astype(np.float32)
    if name == "tie":
        x = (rng.integers(-8, 9, (*shape, d)) / 8.0).astype(np.float32)
    if name in ("dropping", "tie"):
        x[..., 0] = 2.0
    return fields, x, params


def _jax_routing(router, xt, cfg):
    """The reference's routing lines (``moe.py:66-78``) in JAX."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    g, t, _ = xt.shape
    cap = jmoe.expert_capacity(t, cfg)
    logits = jnp.einsum("gtd,de->gte", xt, router).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_w, top_ids = jax.lax.top_k(probs, k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    oh = jax.nn.one_hot(top_ids, e, dtype=jnp.int32)
    pos = ((jnp.cumsum(oh.reshape(g, t * k, e), axis=1) - 1).reshape(g, t, k, e) * oh).sum(-1)
    keep = (pos < cap) & (top_w > 0)
    return np.asarray(probs), np.asarray(top_ids), np.asarray(keep)


def _assert_same_routing(got, jprobs, jids, jkeep):
    ids = got.top_ids.numpy()
    probs = got.probs.numpy()
    differ = (ids != jids).any(-1)
    for g, t in zip(*np.nonzero(differ)):
        # a differing decision is allowed only between probabilities that
        # are equal to f32 rounding
        p_got = np.sort(probs[g, t, ids[g, t]])
        p_want = np.sort(jprobs[g, t, jids[g, t]])
        np.testing.assert_allclose(p_got, p_want, atol=4 * F32_EPS, rtol=4 * F32_EPS)
    np.testing.assert_array_equal(got.keep.numpy()[~differ], jkeep[~differ])
    return int(differ.sum())


@pytest.mark.parametrize("case", ["drop_free", "dropping", "overflow", "shrink", "tie"])
def test_moe_block_matches_reference(case):
    fields, x, params = _case(case)
    jcfg = JaxModelConfig(**BASE, **fields)
    tcfg = ModelConfig(**BASE, **fields)
    want, jaux = jmoe.moe_block({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(x), jcfg)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    got, taux = tmoe.moe_block(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)
    assert set(taux) == set(jaux) == {"load_balance_loss", "router_z_loss", "drop_fraction"}
    for k in jaux:
        assert taux[k].dtype == torch.float32 and taux[k].shape == ()
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), **AUX)

    t_total = x.shape[0] * x.shape[1]
    tpg = tmoe.group_size(t_total, tcfg)
    xt = x.reshape(t_total // tpg, tpg, -1)
    jprobs, jids, jkeep = _jax_routing(jnp.asarray(params["router"]), jnp.asarray(xt), jcfg)
    np.testing.assert_allclose(1.0 - jkeep.mean(), float(jaux["drop_fraction"]), atol=1e-7)
    routing = tmoe.route(tp["router"], torch.from_numpy(xt), tcfg)
    assert routing.capacity == jmoe.expert_capacity(tpg, jcfg)
    _assert_same_routing(routing, jprobs, jids, jkeep)

    drop = taux["drop_fraction"].item()
    if case == "dropping":
        assert drop > 0.05
        # capacity is taken in token order: a group's dropped choices are
        # its latest tokens' choices of the overloaded expert
        keep, ids = routing.keep.numpy(), routing.top_ids.numpy()
        for g in range(keep.shape[0]):
            dropped_t = np.nonzero(~keep[g].all(-1))[0]
            kept_0 = np.nonzero(((ids[g] == 0) & keep[g]).any(-1))[0]
            assert dropped_t.min() > kept_0.max()
    elif case == "overflow":
        assert drop > 0.3
    elif case == "shrink":
        assert (tpg, xt.shape[0]) == (7, 3)
    elif case == "tie":
        assert drop == 0.0
        assert np.array_equal(jprobs[..., 1], jprobs[..., 2])
        assert torch.equal(routing.probs[..., 1], routing.probs[..., 2])
        ids = routing.top_ids.numpy()
        # expert 0 first, then the lower index of the tied pair, always
        assert (ids[..., 0] == 0).all() and (ids[..., 1] == 1).all()
        np.testing.assert_array_equal(ids, jids)
    else:
        assert drop == 0.0


def test_group_size_and_capacity_equal_the_reference():
    for gs, cf in ((512, 1.25), (16, 1.0), (32, 4.0)):
        fields = dict(moe_group_size=gs, capacity_factor=cf, num_experts=64,
                      num_experts_per_tok=8)
        jcfg = JaxModelConfig(**{**BASE, **fields})
        tcfg = ModelConfig(**{**BASE, **fields})
        for t_total in (1, 2, 4, 7, 42, 512, 4096, 4097):
            tpg = tmoe.group_size(t_total, tcfg)
            want = min(gs, t_total)
            while t_total % want:
                want -= 1
            assert tpg == want
            assert tmoe.expert_capacity(tpg, tcfg) == jmoe.expert_capacity(tpg, jcfg)


def test_specs_equal_the_reference():
    cfg = dict(BASE, num_experts=8)
    jspec = jmoe.moe_specs(JaxModelConfig(**cfg))
    tspec = tmoe.moe_specs(ModelConfig(**cfg))
    assert {k: dataclasses.astuple(v) for k, v in tspec.items()} == \
        {k: dataclasses.astuple(v) for k, v in jspec.items()}


def test_dropped_choice_has_a_zero_slot_row():
    """Index C (a dropped choice) gives an all-zero one-hot row, so it
    neither dispatches nor combines (``jax.nn.one_hot`` out of range)."""
    fields, x, params = _case("dropping")
    cfg = ModelConfig(**BASE, **fields)
    xt = torch.from_numpy(x.reshape(2, 32, -1))
    r = tmoe.route(torch.from_numpy(params["router"]), xt, cfg)
    dispatch, combine = tmoe.dispatch_and_combine(r, cfg.num_experts, torch.float32)
    per_token = dispatch.sum((-1, -2))
    np.testing.assert_array_equal(per_token.numpy(), r.keep.sum(-1).numpy())
    assert dispatch.sum(1).max() == 1.0       # a slot of a group holds one token
    np.testing.assert_allclose(combine.sum((-1, -2)).numpy(),
                               (r.top_w * r.keep).sum(-1).numpy(), atol=1e-6)


@given(st.integers(min_value=2, max_value=64), st.integers(min_value=0, max_value=10**6))
@settings(max_examples=20, deadline=None)
def test_moe_dispatch_conservation(tokens, seed):
    """With generous capacity, every (token, choice) is dispatched exactly
    once and combine weights sum to 1 per token
    (``tests/test_properties.py::test_moe_dispatch_conservation``)."""
    cfg = ModelConfig(
        name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
        num_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64, num_experts=4,
        num_experts_per_tok=2, capacity_factor=8.0, moe_group_size=16,
        dtype="float32", param_dtype="float32",
    )
    gen = torch.Generator().manual_seed(seed)
    params = init_params(tmoe.moe_specs(cfg), gen, torch.float32, "cpu")
    x = torch.randn((1, tokens, 16), generator=gen)
    out, aux = tmoe.moe_block(params, x, cfg)
    assert out.shape == x.shape
    assert float(aux["drop_fraction"]) < 1e-6
    assert bool(torch.isfinite(out).all())
    tpg = tmoe.group_size(tokens, cfg)
    r = tmoe.route(params["router"], x.reshape(tokens // tpg, tpg, 16), cfg)
    dispatch, combine = tmoe.dispatch_and_combine(r, cfg.num_experts, torch.float32)
    np.testing.assert_array_equal(dispatch.sum((-1, -2)).numpy(), cfg.num_experts_per_tok)
    np.testing.assert_allclose(combine.sum((-1, -2)).numpy(), 1.0, atol=1e-6)
