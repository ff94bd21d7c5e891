"""The port's recurrent serving slice (rwkv6-3b, family ssm; zamba2-2.7b,
family hybrid) against the JAX reference, on the same bridged weights and
the same numpy inputs.

Variants: the smoke configs of both archs, zamba2 smoke at 4 layers, so
that two sites of the shared attention block run with their separate KV
caches, and rwkv6 smoke at the full config's ssm_chunk of 64, whose
reference chunks at S = 96, 48 and 37 the WKV kernel's check refuses.  All comparisons run in float32 on the CPU, where the port's
scans and attention take their kernels' plain versions.  Tolerances:
logits and decode states 1e-4 absolute and relative (the two frameworks
sum every layer's matrix products, and the scans, in different orders);
decode against the forward's last position 5e-3 / 1e-3 as
``tests/test_smoke_archs.py:87-103`` holds the reference; greedy tokens
exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.runtime import Engine as JaxEngine, ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import Model, from_numpy  # noqa: E402
from repro_torch.runtime import Engine, ServeConfig  # noqa: E402

ARCHS = ("rwkv6-3b", "zamba2-2.7b")
VARIANTS = {"rwkv6": ("rwkv6-3b", {}), "zamba2": ("zamba2-2.7b", {}),
            "zamba2-2sites": ("zamba2-2.7b", {"num_layers": 4}),
            "rwkv6-chunk64": ("rwkv6-3b", {"ssm_chunk": 64})}
LOGITS = dict(atol=1e-4, rtol=1e-4)
B = 2


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def bridged(request):
    """(jax cfg, jax model, jax params, port model, port params)."""
    arch, kw = VARIANTS[request.param]
    jcfg = jax_get_config(arch, smoke=True).replace(**kw)
    tcfg = get_config(arch, smoke=True).replace(**kw)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, Model(tcfg), tparams


def _state_leaves(state):
    """{name: array} of every decode-state leaf of a port or reference
    state (union of kv, ssm, rwkv; the absent fields skipped)."""
    out = {}
    for field in ("kv", "ssm", "rwkv"):
        sub = getattr(state, field)
        if sub is None or (isinstance(sub, dict) and not sub):
            continue
        for name, leaf in sub._asdict().items():
            out[f"{field}.{name}"] = (leaf.numpy() if isinstance(leaf, torch.Tensor)
                                      else np.asarray(leaf))
    return out


# ------------------------------------------------------ configs / params ---
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference_field_for_field(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_specs_and_param_count_match_reference(arch, smoke):
    jm, tm = JaxModel(jax_get_config(arch, smoke=smoke)), Model(get_config(arch, smoke=smoke))
    assert tm.num_params() == jm.num_params()
    assert tm.n_attn_sites() == jm.n_attn_sites()
    jshapes = jax.tree.map(lambda s: s.shape, jm.specs(), is_leaf=lambda x: hasattr(x, "shape"))
    tshapes = jax.tree.map(lambda s: s.shape, tm.specs(), is_leaf=lambda x: hasattr(x, "shape"))
    assert jshapes == tshapes


def test_from_numpy_round_trip(bridged):
    _, _, jparams, _, tparams = bridged
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.float32 and node.shape == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_init_is_seeded_and_stacked_like_reference(bridged):
    """Seeded weights with the reference's tree; the hybrid layers stacked
    twice, (sites, attn_every, ...), with the reference's fan-in over both
    stack axes."""
    jcfg, _, jparams, tmodel, _ = bridged
    a, b = tmodel.init(seed=3, device="cpu"), tmodel.init(seed=3, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, jparams)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, a))
    for (_, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(a),
                              jax.tree_util.tree_leaves_with_path(b)):
        assert torch.equal(x, y)
    if jcfg.family == "hybrid":
        w = a["layers"]["mixer"]["in_x"]
        assert w.shape[:2] == (tmodel.n_attn_sites(), jcfg.attn_every)
        std = float(np.prod(w.shape[:-1])) ** -0.5
        assert abs(w.std().item() - std) < 0.05 * std


# ------------------------------------------------------ forward / prefill ---
@pytest.mark.parametrize("seq", [64, 128])
def test_forward_and_prefill_match_reference(bridged, seq):
    jcfg, jmodel, jparams, tmodel, tparams = bridged
    toks = _tokens(seq, (B, seq), jcfg.vocab_size)
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert aux == {} and got.shape == (B, seq, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    last = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1], **LOGITS)


@pytest.mark.parametrize("seq", [96, 48, 37])
def test_prefill_serves_the_lengths_the_reference_serves(bridged, seq):
    """At S = 96, 48 and 37 the reference's rwkv6 chunk (the largest
    divisor of S up to ssm_chunk) is 48, 48 and 37, which the WKV kernel's
    check refuses; the port picks its own chunk and returns the reference's
    logits.  The hybrid raises on both sides where S is not a multiple of
    ssm_chunk."""
    jcfg, jmodel, jparams, tmodel, tparams = bridged
    toks = _tokens(seq, (B, seq), jcfg.vocab_size)
    if jcfg.family == "hybrid" and seq % jcfg.ssm_chunk:
        with pytest.raises(ValueError):
            jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
        with pytest.raises(ValueError):
            tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
        return
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    last = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1], **LOGITS)


def test_hybrid_prefill_needs_whole_chunks():
    """The reference passes ssm_chunk straight to the SSD scan, so a
    sequence that is not a multiple of it raises; so does the port."""
    jm, tm = JaxModel(jax_get_config("zamba2-2.7b", smoke=True)), \
        Model(get_config("zamba2-2.7b", smoke=True))
    toks = _tokens(1, (1, 48), 512)
    with pytest.raises(ValueError):
        jm.forward(jm.init(jax.random.PRNGKey(0)), {"tokens": jnp.asarray(toks)})
    with pytest.raises(ValueError):
        tm.prefill(tm.init(seed=0, device="cpu"), {"tokens": torch.from_numpy(toks)})


# ---------------------------------------------------------------- decode ---
def test_decode_step_logits_and_states_match_reference(bridged):
    jcfg, jmodel, jparams, tmodel, tparams = bridged
    n, context = 16, 12          # 12: the attention ring slot wraps (hybrid)
    toks = _tokens(7, (B, n), jcfg.vocab_size)
    jstate = jmodel.init_decode_state(B, context)
    tstate = tmodel.init_decode_state(B, context, device="cpu")
    assert sorted(_state_leaves(tstate)) == sorted(_state_leaves(jstate))
    jstep = jax.jit(jmodel.decode_step)
    for t in range(n):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(toks[:, t]))
        tl, tstate = tmodel.decode_step(tparams, tstate, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    want = _state_leaves(jstate)
    for name, got in _state_leaves(tstate).items():
        np.testing.assert_allclose(got, want[name], **LOGITS, err_msg=name)


def test_decode_matches_forward(bridged):
    """Token-by-token decode (the O(1) recurrences and the decode
    attention) reproduces the full-sequence forward (the scan kernels'
    plain versions and flash attention) at every position."""
    jcfg, _, _, tmodel, tparams = bridged
    s = 32
    toks = _tokens(11, (B, s), jcfg.vocab_size)
    full, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    state = tmodel.init_decode_state(B, s, device="cpu")
    outs = []
    for t in range(s):
        lg, state = tmodel.decode_step(tparams, state, torch.from_numpy(toks[:, t]))
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), atol=5e-3, rtol=1e-3)


def test_engine_generate_matches_reference_tokens(bridged):
    jcfg, jmodel, jparams, tmodel, tparams = bridged
    prompt = _tokens(5, (B, 8), jcfg.vocab_size)
    want, _ = JaxEngine(jmodel, JaxServeConfig(batch=B, context=32)).generate(
        jparams, prompt, max_new_tokens=8)
    before = launch_counts()
    teng = Engine(tmodel, ServeConfig(batch=B, context=32), device="cpu")
    got, rec = teng.generate(tparams, prompt, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    assert launch_counts() == before          # CPU tensors never launch
    assert rec.stages() == ["read", "inference", "post_processing"]
    assert teng.report()["jobs"] == 8 - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(capsys, arch):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--context", "16", "--prompt-len", "3", "--tokens", "3"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out
    assert "generated (2, 3) tokens" in out and "inference" in out
