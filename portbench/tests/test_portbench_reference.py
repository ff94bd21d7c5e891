"""The plain references against the program's CPU path at a tiny size, and
the controls that the comparison has to fail."""
from __future__ import annotations

import json

import pytest
import torch

from tiny_cells import TINY

from portbench import harness, weights
from portbench.reference import ssm
from portbench.reference.common import Numerics, adamw, leaves

FAMILIES = {"ssm-tiny": ssm}
F32_BAND = 1e-4       # f32 on both sides: the same arithmetic in another order


def _setup(name: str, dtype: str):
    from repro_torch.models import Model

    cfg = json.loads((TINY / "configs" / f"{name}.json").read_text())
    cfg.update(dtype=dtype, param_dtype=dtype)
    ref = FAMILIES[name]
    model = Model(harness.model_config(cfg))
    harness.check_layout(model, ref.layout(cfg))
    params = weights.draw(ref.layout(cfg), 7, getattr(torch, dtype), "cpu")
    toks = torch.randint(0, cfg["vocab_size"], (2, 64),
                         generator=torch.Generator().manual_seed(1)).int()
    return cfg, ref, model, params, toks


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("name", list(FAMILIES))
def test_reference_forward_loss_and_gradients_match_the_port(name):
    cfg, ref, model, params, toks = _setup(name, "float32")
    with torch.no_grad():
        got = model.prefill(params, {"tokens": toks})
        want = ref.last_logits(Numerics(), params, toks, cfg)
    assert _rel(got, want) < F32_BAND
    for _, p in leaves(params):
        p.requires_grad_(True)
    ps = [p for _, p in leaves(params)]
    loss_p, _ = model.loss(params, {"tokens": toks})
    loss_r = ref.loss(Numerics(), params, toks, cfg)
    assert abs(float(loss_p) - float(loss_r)) < F32_BAND * abs(float(loss_r))
    gp = torch.autograd.grad(loss_p, ps)
    gr = torch.autograd.grad(loss_r, ps)
    for (path, _), a, b in zip(leaves(params), gp, gr):
        assert _rel(a, b) < F32_BAND * 10, path


@pytest.mark.parametrize("name", list(FAMILIES))
def test_lower_precision_fails_the_band(name):
    """The outputs cast to bf16, or computed with fp8 products (the
    benchmark's control), fall outside the band the port holds."""
    cfg, ref, model, params, toks = _setup(name, "float32")
    with torch.no_grad():
        want = ref.last_logits(Numerics(), params, toks, cfg)
        fp8 = ref.last_logits(Numerics(fp8=True), params, toks, cfg)
    assert _rel(want.bfloat16(), want) > F32_BAND
    assert _rel(fp8, want) > 100 * F32_BAND


def test_weight_decay_rule_is_the_programs():
    """The reference's AdamW decays the leaves the program's does."""
    from repro_torch.train.optimizer import _decay_mask

    from portbench.reference.common import decays

    cfg = json.loads((TINY / "configs" / "ssm-tiny.json").read_text())
    p = weights.draw(ssm.layout(cfg), 1, torch.float32, "cpu")
    for path, leaf in leaves(p):
        assert decays(path, leaf) == _decay_mask(path, leaf), path


def test_reference_adamw_matches_the_programs():
    """Three steps of the reference's AdamW against the program's on the
    same gradients, f32 weights stored in f32."""
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update

    mix = json.loads((TINY / "traffic" / "train-tiny.json").read_text())
    cfg = json.loads((TINY / "configs" / "ssm-tiny.json").read_text())
    a = weights.draw(ssm.layout(cfg), 3, torch.float32, "cpu")
    b = weights.draw(ssm.layout(cfg), 3, torch.float32, "cpu")
    opt = AdamWConfig(**mix["opt"])
    state, ref_state = adamw_init(a), {}
    gen = torch.Generator().manual_seed(5)
    for step in range(1, 4):
        g = {}
        for path, leaf in leaves(a):
            node = g
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.randn(leaf.shape, generator=gen) * 0.3
        a, state, m = adamw_update(opt, a, g, state)
        gn = adamw(b, g, ref_state, mix["opt"], step, torch.float32)
        assert abs(float(m["grad_norm"]) - gn) < 1e-5 * gn
    for (path, x), (_, y) in zip(leaves(a), leaves(b)):
        assert torch.allclose(x, y, rtol=1e-6, atol=1e-7), path
