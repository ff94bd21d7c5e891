"""The port's serving slice (qwen3-4b, dense family) against the JAX
reference, on the same bridged weights and the same numpy inputs.

All comparisons run in float32 on the CPU, where the port's attention
takes its kernels' plain versions.  Tolerances: layers 1e-5 (elementwise
math and one matrix product); model logits 1e-4 absolute and relative,
since the two frameworks sum the matrix products of every layer in a
different order; greedy tokens exactly.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.runtime import Engine as JaxEngine, ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import Model, from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.runtime import Engine, ServeConfig, make_prefill_step  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LOGITS = dict(atol=1e-4, rtol=1e-4)
LAYER = dict(atol=1e-5, rtol=1e-5)
B = 2


def _configs(variant):
    jcfg = jax_get_config("qwen3-4b", smoke=True)
    tcfg = get_config("qwen3-4b", smoke=True)
    if variant == "gqa":
        jcfg = jcfg.replace(num_heads=4, num_kv_heads=2)
        tcfg = tcfg.replace(num_heads=4, num_kv_heads=2)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["mqa", "gqa"])
def bridged(request):
    """(jax cfg, jax model, jax params, port cfg, port model, port params)."""
    jcfg, tcfg = _configs(request.param)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, tcfg, Model(tcfg), tparams


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ------------------------------------------------------ configs / params ---
def test_config_matches_reference_field_for_field():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config("qwen3-4b", smoke=smoke)) == \
            dataclasses.asdict(jax_get_config("qwen3-4b", smoke=smoke))


def test_specs_and_param_count_match_reference():
    jm, tm = JaxModel(jax_get_config("qwen3-4b")), Model(get_config("qwen3-4b"))
    assert tm.num_params() == jm.num_params()
    jshapes = jax.tree.map(lambda s: s.shape, jm.specs(),
                           is_leaf=lambda x: hasattr(x, "shape"))
    tshapes = jax.tree.map(lambda s: s.shape, tm.specs(),
                           is_leaf=lambda x: hasattr(x, "shape"))
    assert jshapes == tshapes


def test_init_is_seeded_with_reference_distributions():
    m = Model(get_config("qwen3-4b", smoke=True))
    a, b = m.init(seed=3, device="cpu"), m.init(seed=3, device="cpu")
    c = m.init(seed=4, device="cpu")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"], c["layers"]["attn"]["wq"])
    cfg = m.cfg
    # the reference's fan-in: every dim but the last of the stacked shape
    wq = a["layers"]["attn"]["wq"]
    std = float(np.prod(wq.shape[:-1])) ** -0.5
    assert abs(wq.std().item() - std) < 0.05 * std
    emb = a["embed"]["table"]
    assert abs(emb.std().item() - 0.02) < 0.002
    assert torch.equal(a["final_ln"]["scale"], torch.ones(cfg.d_model))
    assert m.num_params(a) == m.num_params()


def test_from_numpy_round_trip(bridged):
    _, _, jparams, _, _, tparams = bridged
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat_j:
        node = tparams
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.float32 and node.device.type == "cpu"
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_from_numpy_casts_and_keeps_bfloat16():
    bf = np.asarray(jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16))
    out = from_numpy({"a": {"b": bf}, "c": np.ones(2, np.float32)}, "cpu", "bfloat16")
    assert out["a"]["b"].dtype == torch.bfloat16 and out["c"].dtype == torch.bfloat16
    assert out["a"]["b"].float().tolist() == [1.5, -2.25, 3.0]


# ---------------------------------------------------------------- layers ---
def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-5).numpy(),
        np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)), **LAYER)

    pos = np.arange(3, 11, dtype=np.int32)
    tc, ts = TL.rope(torch.from_numpy(pos), 32, 1e6)
    jc, js = JL.rope(jnp.asarray(pos), 32, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **LAYER)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **LAYER)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jc, js)), **LAYER)

    h = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w = {k: (rng.standard_normal(s) / 8).astype(np.float32)
         for k, s in (("up", (64, 96)), ("gate", (64, 96)), ("down", (96, 64)))}
    for gated in (True, False):
        ww = w if gated else {k: v for k, v in w.items() if k != "gate"}
        np.testing.assert_allclose(
            TL.mlp({k: torch.from_numpy(v) for k, v in ww.items()}, torch.from_numpy(h)).numpy(),
            np.asarray(JL.mlp({k: jnp.asarray(v) for k, v in ww.items()}, jnp.asarray(h))),
            **LAYER)

    table = rng.standard_normal((50, 64)).astype(np.float32)
    toks = _tokens(1, (2, 5), 50)
    np.testing.assert_array_equal(
        TL.embed({"table": torch.from_numpy(table)}, torch.from_numpy(toks)).numpy(),
        np.asarray(JL.embed({"table": jnp.asarray(table)}, jnp.asarray(toks))))
    np.testing.assert_allclose(
        TL.unembed({"table": torch.from_numpy(table)}, torch.from_numpy(h)).numpy(),
        np.asarray(JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(h))), **LAYER)


# ------------------------------------------------------ forward / prefill ---
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("seq", [64, 128])
def test_forward_and_prefill_match_reference(bridged, attn_impl, seq):
    jcfg, _, jparams, _, tmodel, tparams = bridged
    jmodel = JaxModel(jcfg.replace(attn_impl=attn_impl))
    toks = _tokens(seq, (B, seq), jcfg.vocab_size)
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert aux == {} and got.shape == (B, seq, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)

    last = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1], **LOGITS)
    step = make_prefill_step(tmodel)(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(step.numpy(), got.numpy())


# ---------------------------------------------------------------- decode ---
@pytest.mark.parametrize("context", [16, 12])   # 12: the ring slot wraps
def test_decode_step_logits_and_cache_match_reference(bridged, context):
    jcfg, jmodel, jparams, _, tmodel, tparams = bridged
    n = 16
    toks = _tokens(7, (B, n), jcfg.vocab_size)
    jstate = jmodel.init_decode_state(B, context)
    tstate = tmodel.init_decode_state(B, context, device="cpu")
    jstep = jax.jit(jmodel.decode_step)
    mid = None
    for t in range(n):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(toks[:, t]))
        tl, tstate = tmodel.decode_step(tparams, tstate, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        if t == n // 2:
            mid = ([x.clone() for x in tstate.kv], jax.tree.map(np.asarray, jstate.kv))
    for got, want in zip(mid[0], mid[1]):
        np.testing.assert_allclose(got.numpy(), want, **LOGITS)
    for got, want in zip(tstate.kv, jstate.kv):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    assert int(tstate.kv.next_pos) == n


def test_decode_matches_prefill_last_position(bridged):
    """Token-by-token decode reproduces the prefill's last-position logits
    (both attention kernels' plain versions, end to end)."""
    jcfg, _, _, _, tmodel, tparams = bridged
    toks = _tokens(11, (B, 24), jcfg.vocab_size)
    state = tmodel.init_decode_state(B, 24, device="cpu")
    for t in range(toks.shape[1]):
        lg, state = tmodel.decode_step(tparams, state, torch.from_numpy(toks[:, t]))
    pre = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lg.numpy(), pre.numpy(), **LOGITS)


def test_engine_generate_matches_reference_tokens(bridged):
    jcfg, jmodel, jparams, _, tmodel, tparams = bridged
    prompt = _tokens(5, (B, 8), jcfg.vocab_size)
    jeng = JaxEngine(jmodel, JaxServeConfig(batch=B, context=32))
    want, _ = jeng.generate(jparams, prompt, max_new_tokens=8)
    before = launch_counts()
    teng = Engine(tmodel, ServeConfig(batch=B, context=32), device="cpu")
    got, rec = teng.generate(tparams, prompt, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    assert launch_counts() == before          # CPU tensors never launch
    assert rec.stages() == ["read", "inference", "post_processing"]
    rep = teng.report()
    assert rep["jobs"] == 8 - 1 and np.isfinite(rep["mean_s"])


def test_engine_rejects_bad_prompts():
    tm = Model(get_config("qwen3-4b", smoke=True))
    eng = Engine(tm, ServeConfig(batch=2, context=8), device="cpu")
    with pytest.raises(ValueError, match="batch"):
        eng.generate({}, np.zeros((3, 2), np.int32), 1)
    with pytest.raises(ValueError, match="at least one token"):
        eng.generate({}, np.zeros((2, 0), np.int32), 1)


def test_serve_config_fields_match_the_reference():
    """Same field names, order and defaults, so a positional third argument
    means ``temperature`` on both sides (it is unused on both)."""
    fields = [(f.name, f.default) for f in dataclasses.fields(ServeConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JaxServeConfig)]
    got, want = ServeConfig(2, 32, 0.0), JaxServeConfig(2, 32, 0.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) == {
        "batch": 2, "context": 32, "temperature": 0.0, "warmup_steps": 1}
    assert ServeConfig(batch=2, context=8, temperature=0.7).temperature == 0.7


def test_unported_family_raises():
    with pytest.raises(NotImplementedError, match="later slice"):
        Model(get_config("qwen3-4b").replace(family="moe", num_experts=4))


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--batch", "2",
                "--context", "16", "--prompt-len", "3", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "inference" in out


# --------------------------------------------------------- independence ---
def _port_files():
    return (sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "tools").glob("*.py")))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
