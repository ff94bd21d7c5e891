"""The moe, vlm and audio families and the seven archs of the last port
slice (mixtral-8x22b, yi-6b, internvl2-1b, qwen2-7b, granite-20b,
olmoe-1b-7b, hubert-xlarge) against the JAX reference.

Configs and parameter specs are compared for all ten archs at full width
and smoke size, from specs only (nothing is allocated).  The smoke models
run in float32 on the CPU on weights bridged from the reference's ``init``
(``from_numpy``), with the same seeded numpy inputs through both
packages.  Tolerances: logits 1e-4 absolute and relative (the frameworks
sum the layers' products in different orders), the MoE aux values 1e-6,
the front ends 1e-5 (one product and elementwise math), decode against
forward the reference's own 5e-3 / 1e-3 (``tests/test_smoke_archs.py``);
greedy tokens exactly.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import runtime as rrt  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.runtime import Engine as JaxEngine, ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import Model, from_numpy  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    AlwaysAdmit,
    Engine,
    MultiTenantConfig,
    MultiTenantEngine,
    RequestQueue,
    ServeConfig,
    poisson_workload,
)

LOGITS = dict(atol=1e-4, rtol=1e-4)
AUX = dict(atol=1e-6, rtol=1e-6)
FRONTEND = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 64
NEW_ARCHS = ("mixtral-8x22b", "yi-6b", "internvl2-1b", "qwen2-7b", "granite-20b",
             "olmoe-1b-7b", "hubert-xlarge")
DECODE_ARCHS = tuple(a for a in NEW_ARCHS if a != "hubert-xlarge")


@functools.lru_cache(maxsize=None)
def _bridge(arch):
    """(jax model, jax params, port model, port params) at smoke size."""
    jmodel = JaxModel(jax_get_config(arch, smoke=True))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, Model(get_config(arch, smoke=True)), tparams


def _batch(cfg, seed, b=B, s=S):
    """Seeded numpy inputs of the arch's family (``tests/test_smoke_archs.py``'s
    shapes): frames for audio, patch embeddings then text for vlm."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)}
    toks = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        p = cfg.frontend_tokens
        toks = {"tokens": toks["tokens"][:, : s - p],
                "patch_embeds": rng.standard_normal((b, p, cfg.frontend_dim)).astype(np.float32)}
    return toks


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _shapes(specs):
    return jax.tree.map(lambda s: tuple(s.shape), specs, is_leaf=lambda x: hasattr(x, "shape"))


# ------------------------------------------------------ configs / specs ---
def test_registry_lists_the_reference_s_archs_in_its_order():
    assert list(ARCHS) == list(JAX_ARCHS)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_and_param_count_match_reference(arch, smoke):
    jm = JaxModel(jax_get_config(arch, smoke=smoke))
    tm = Model(get_config(arch, smoke=smoke))
    assert _shapes(tm.specs()) == _shapes(jm.specs())
    jleaves = jax.tree.leaves(jm.specs(), is_leaf=lambda x: hasattr(x, "shape"))
    tleaves = jax.tree.leaves(tm.specs(), is_leaf=lambda x: hasattr(x, "shape"))
    assert [(s.axes, s.init, s.scale) for s in tleaves] == \
        [(s.axes, s.init, s.scale) for s in jleaves]
    assert tm.num_params() == jm.num_params()


# ------------------------------------------------------ forward / prefill ---
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_and_prefill_match_reference(arch):
    jmodel, jparams, tmodel, tparams = _bridge(arch)
    cfg = tmodel.cfg
    batch = _batch(cfg, 3)
    want, jaux = jax.jit(jmodel.forward)(jparams, _jax(batch))
    got, taux = tmodel.forward(tparams, _torch(batch))
    assert got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    assert set(taux) == set(jaux)
    assert bool(taux) == (cfg.family == "moe")
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), **AUX, err_msg=k)
    last = tmodel.prefill(tparams, _torch(batch))
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1], **LOGITS)


@pytest.mark.parametrize("arch", ["internvl2-1b", "hubert-xlarge"])
def test_frontends_match_reference(arch):
    """The VLM's projector (w1, tanh GELU, w2) over the patch embeddings
    then the text, and the audio frame projection plus the f32 sinusoidal
    table, against the reference's ``_embed_inputs``."""
    jmodel, jparams, tmodel, tparams = _bridge(arch)
    batch = _batch(tmodel.cfg, 5)
    want, positions = jmodel._embed_inputs(jparams, _jax(batch))
    got = tmodel._embed_inputs(tparams, _torch(batch))
    assert got.shape == want.shape and got.shape[1] == S and len(positions) == S
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FRONTEND)


def test_audio_encoder_has_no_decode():
    jmodel, _, tmodel, _ = _bridge("hubert-xlarge")
    assert tmodel.cfg.encoder_only and not tmodel.cfg.supports_decode
    with pytest.raises(ValueError, match="encoder-only"):
        jmodel.init_decode_state(B, 16)
    with pytest.raises(ValueError, match="encoder-only"):
        tmodel.init_decode_state(B, 16, device="cpu")


# ---------------------------------------------------------------- decode ---
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_logits_and_cache_match_reference(arch):
    """32 steps into a 24-slot cache (the ring wraps) against the
    reference's ``decode_step``: logits every step, the cache at the end."""
    jmodel, jparams, tmodel, tparams = _bridge(arch)
    n, context = 32, 24
    toks = np.random.default_rng(7).integers(0, tmodel.cfg.vocab_size, (B, n)).astype(np.int32)
    jstate = jmodel.init_decode_state(B, context)
    tstate = tmodel.init_decode_state(B, context, device="cpu")
    jstep = jax.jit(jmodel.decode_step)
    for t in range(n):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(toks[:, t]))
        tl, tstate = tmodel.decode_step(tparams, tstate, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    for got, want in zip(tstate.kv, jstate.kv):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    assert int(tstate.kv.next_pos) == n


@pytest.mark.parametrize("arch", [a for a in DECODE_ARCHS if a != "internvl2-1b"])
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the full-sequence forward at every
    position (the VLM prefills a prefix of patches, so it is left out, as
    in the reference's test)."""
    _, _, tmodel, tparams = _bridge(arch)
    s = 32
    toks = np.random.default_rng(11).integers(0, tmodel.cfg.vocab_size, (B, s))
    toks = torch.from_numpy(toks.astype(np.int32))
    full, _ = tmodel.forward(tparams, {"tokens": toks})
    state = tmodel.init_decode_state(B, s, device="cpu")
    outs = []
    for t in range(s):
        lg, state = tmodel.decode_step(tparams, state, toks[:, t])
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), atol=5e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_engine_generate_matches_reference_tokens(arch):
    jmodel, jparams, tmodel, tparams = _bridge(arch)
    prompt = np.random.default_rng(5).integers(0, tmodel.cfg.vocab_size, (B, 8)).astype(np.int32)
    want, _ = JaxEngine(jmodel, JaxServeConfig(batch=B, context=32)).generate(
        jparams, prompt, max_new_tokens=8)
    before = launch_counts()
    got, rec = Engine(tmodel, ServeConfig(batch=B, context=32), device="cpu").generate(
        tparams, prompt, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    assert launch_counts() == before          # CPU tensors never launch
    assert rec.stages() == ["read", "inference", "post_processing"]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "internvl2-1b"])
def test_multi_tenant_tokens_match_reference(arch):
    """The multi-tenant runtime serves moe and (text-only) vlm unchanged:
    a queued Poisson workload under AlwaysAdmit gives the reference's
    per-tenant tokens, slots and ramp steps."""
    jmodel, jparams, tmodel, tparams = _bridge(arch)
    work = dict(rate_hz=100.0, vocab_size=tmodel.cfg.vocab_size, prompt_len=4,
                max_new_tokens=5, seed=3)

    def run(engine, requests, queue):
        for r in requests:
            queue.push(r)
        engine.compile()
        engine.drain(queue)
        return [(t.req.tenant, t.slot, list(map(int, t.generated)), t.ramp_steps)
                for t in engine.finished]

    want = run(rrt.MultiTenantEngine(jmodel, jparams, rrt.MultiTenantConfig(3, 32),
                                     admission=rrt.AlwaysAdmit()),
               rrt.poisson_workload(6, **work), rrt.RequestQueue())
    got = run(MultiTenantEngine(tmodel, tparams, MultiTenantConfig(3, 32),
                                admission=AlwaysAdmit(), device="cpu"),
              poisson_workload(6, **work), RequestQueue())
    assert got == want and len(got) == 6


# ------------------------------------------------------------- serve CLI ---
def test_serve_cli_refuses_an_encoder_only_arch():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="hubert-xlarge-smoke is encoder-only: no decode step"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


def test_serve_cli_generates_with_olmoe_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--batch", "2",
                "--context", "16", "--prompt-len", "3", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=olmoe-1b-7b-smoke" in out
    assert "generated (2, 3) tokens" in out and "inference" in out
