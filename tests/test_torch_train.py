"""The port's training path (``repro_torch.train``, ``Model.loss``,
``launch/train.py``) against the JAX reference, on the CPU.

The oracle is the reference jitted without a mesh: ``model.loss``,
``jax.value_and_grad`` of it, ``adamw_update`` and ``make_train_step``.
(The reference's ``Trainer`` builds a mesh, and with this JAX version its
sharded embedding gather raises ``ShardingTypeError``; that is the
reference's own ``tests/test_system.py::test_trainer_runs_and_loss_decreases``
failure, which the port does not reproduce.)  Weights come from the
reference's ``init`` and are bridged with ``from_numpy``; batches from
``make_batch_np``, which the two packages draw bit for bit alike.  Every
comparison is at f32, at smoke size.

Tolerances, each with its reason:
- data, the decay mask, checkpoints: exact (the same NumPy draws, the same
  predicate, the same bytes);
- the schedule, the loss and its metrics: 1e-6 absolute, 1e-5 relative
  (f32 scalars, the same operations summed in different orders);
- each gradient leaf: 1e-4 relative and 1e-4 of the leaf's largest
  magnitude absolute (f32 sums over positions, heads and layers taken in
  different orders; measured at most 1.2e-5 of a largest element of 7.1);
- AdamW on identical inputs: 1e-6 absolute, 1e-5 relative;
- a train step, whose gradients differ in the last bits: AdamW's first
  step divides g by sqrt(g²) + eps, so its update is about ±lr whatever
  |g| is, and where |g| (after clipping) is near eps = 1e-8 a difference
  in the last bits of g moves the update by up to lr.  Elements whose
  clipped reference gradient is above 1e-4 are held at 1e-6 absolute and
  1e-5 relative; every other element only to lie within 2·lr of the
  reference's value and to have moved by at most lr·(1 + wd·|p|);
- the 8-step loss trajectory: 1e-4 relative a step (both runs take the
  same steps from the same weights; measured below 1e-5).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.train import data as jax_data  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import Model, from_numpy  # noqa: E402
from repro_torch.models.params import ParamSpec  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig,
    AdamWState,
    DataConfig,
    PrefetchIterator,
    adamw_update,
    cosine_schedule,
    make_batch_np,
    synthetic_batches,
)
from repro_torch.train.optimizer import _decay_mask, _walk, global_norm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SCALAR = dict(atol=1e-6, rtol=1e-5)
GRAD_RTOL = 1e-4
B, S = 2, 64


def _bridge(arch, **replace):
    """(jax model, jax params, port model, port params) at smoke size, the
    port's params bridged from the reference's init."""
    jcfg = jax_get_config(arch, smoke=True).replace(**replace)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, Model(get_config(arch, smoke=True).replace(**replace)), tparams


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    """{path: numpy array} of a nested dict of tensors or jax arrays."""
    return {path: np.asarray(leaf.detach() if isinstance(leaf, torch.Tensor) else leaf)
            for path, leaf in _walk(tree)}


def _grad_close(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _requires_grad(params):
    for _, p in _walk(params):
        p.requires_grad_(True)
    return params


# ------------------------------------------------------------------ data ----
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("step", [0, 1, 7])
def test_make_batch_np_is_the_reference_bit_for_bit(arch, step):
    data = DataConfig(batch=3, seq_len=48, seed=5)
    got = make_batch_np(get_config(arch, smoke=True), data, step)
    want = jax_data.make_batch_np(jax_get_config(arch, smoke=True),
                                  jax_data.DataConfig(batch=3, seq_len=48, seed=5), step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert np.array_equal(got[k], want[k])


def test_synthetic_batches_and_prefetch_follow_the_steps():
    cfg = get_config("qwen3-4b", smoke=True)
    data = DataConfig(batch=2, seq_len=16)
    ticks = iter(range(100))
    it = PrefetchIterator(synthetic_batches(cfg, data, start_step=3), depth=2,
                          clock=lambda: float(next(ticks)))
    for step in (3, 4, 5):
        assert np.array_equal(next(it)["tokens"], make_batch_np(cfg, data, step)["tokens"])
    assert it.produce_times and all(t == 1.0 for t in it.produce_times)


# ------------------------------------------------------------- optimizer ----
def _meta_tree(specs):
    return {k: _meta_tree(v) if isinstance(v, dict) else torch.empty(v.shape, device="meta")
            for k, v in specs.items()} if not isinstance(specs, ParamSpec) else None


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decay_mask_matches_reference_leaf_for_leaf(arch):
    """On every arch's full-width tree (from shapes only)."""
    jmodel = JaxModel(jax_get_config(arch))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    want = {tuple(p.key for p in path): m for path, m in jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map_with_path(jax_opt._decay_mask, shapes))[0]}
    got = {path: _decay_mask(path, leaf)
           for path, leaf in _walk(_meta_tree(Model(get_config(arch)).specs()))}
    assert got == want
    assert any(got.values()) and not all(got.values())


def test_cosine_schedule_matches_reference():
    cfg = dict(lr=3e-3, warmup_steps=5, total_steps=30, min_lr_ratio=0.1)
    steps = np.arange(41, dtype=np.int32)
    want = np.asarray(jax.vmap(jax_opt.cosine_schedule(jax_opt.AdamWConfig(**cfg)))(
        jnp.asarray(steps)))
    got = cosine_schedule(AdamWConfig(**cfg))(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, **SCALAR)
    assert got[0] == 0.0 and got.argmax() == 5


def _opt_inputs(grad_scale, seed=3):
    """Bridged qwen3 smoke params, gradients and a state after 3 steps
    (random moments), the same arrays for both packages."""
    _, jparams, _, _ = _bridge("qwen3-4b")
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jparams)
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * grad_scale).astype(np.float32),
                         params)
    mu = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32), params)
    nu = jax.tree.map(lambda p: (rng.random(p.shape) * 1e-5).astype(np.float32), params)
    return params, grads, mu, nu


@pytest.mark.parametrize("grad_scale,clipped", [(1.0, True), (1e-4, False)])
def test_adamw_update_matches_reference(grad_scale, clipped):
    params, grads, mu, nu = _opt_inputs(grad_scale)
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jstate = jax_opt.AdamWState(step=jnp.asarray(3, jnp.int32), mu=jax.tree.map(jnp.asarray, mu),
                                nu=jax.tree.map(jnp.asarray, nu),
                                loss_scale=jnp.ones((), jnp.float32))
    jp, js, jm = jax.jit(lambda p, g, s: jax_opt.adamw_update(jax_opt.AdamWConfig(**cfg), p, g, s))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads), jstate)
    tstate = AdamWState(step=torch.tensor(3, dtype=torch.int32), mu=from_numpy(mu, "cpu"),
                        nu=from_numpy(nu, "cpu"), loss_scale=torch.ones(()))
    tp, ts, tm = adamw_update(AdamWConfig(**cfg), from_numpy(params, "cpu"),
                              from_numpy(grads, "cpu"), tstate)
    assert (float(jm["grad_norm"]) > 1.0) == clipped
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **SCALAR)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **SCALAR)
    assert int(ts.step) == int(js.step) == 4 and ts.step.dtype == torch.int32
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        w = _flat(jax.tree.map(np.asarray, want))
        for path, g in _flat(got).items():
            np.testing.assert_allclose(g, w[path], **SCALAR, err_msg=str(path))


def test_adamw_takes_big_leaves_in_pieces(monkeypatch):
    """The piecewise update (a layer at a time for stacked leaves) gives
    the same bits as the whole-leaf update, with clipping off: the norm,
    summed piece by piece, differs in its last bits."""
    from repro_torch.train import optimizer
    params, grads, mu, nu = _opt_inputs(1e-4, seed=4)
    out = []
    for piece in (1 << 24, 64):
        monkeypatch.setattr(optimizer, "PIECE", piece)
        st = AdamWState(torch.tensor(1, dtype=torch.int32), from_numpy(mu, "cpu"),
                        from_numpy(nu, "cpu"), torch.ones(()))
        p, st, m = adamw_update(AdamWConfig(), from_numpy(params, "cpu"),
                                from_numpy(grads, "cpu"), st)
        out.append((_flat(p), _flat(st.nu), float(m["grad_norm"])))
    np.testing.assert_allclose(out[0][2], out[1][2], rtol=1e-6)
    for path in out[0][0]:
        np.testing.assert_array_equal(out[0][0][path], out[1][0][path])
        np.testing.assert_array_equal(out[0][1][path], out[1][1][path])
    assert float(global_norm(from_numpy(grads, "cpu"))) == pytest.approx(out[0][2], rel=1e-6)


# ------------------------------------------------------------------ loss ----
def _loss_and_grads(arch, data=DataConfig(batch=B, seq_len=S), step=0, **replace):
    jmodel, jparams, tmodel, tparams = _bridge(arch, **replace)
    batch = jax_data.make_batch_np(jmodel.cfg, jax_data.DataConfig(data.batch, data.seq_len), step)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, _jax(batch))
    tparams = _requires_grad(tparams)
    tl, tm = tmodel.loss(tparams, _torch(batch))
    tg = torch.autograd.grad(tl, [p for _, p in _walk(tparams)])
    tm = {k: v.detach() for k, v in tm.items()}
    return (float(jl), jm, _flat(jax.tree.map(np.asarray, jg))), (tl.detach(), tm, tg, tparams), batch


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_every_gradient_match_reference(arch):
    """All ten archs (the ssm and hybrid families through the scans'
    autograd Functions: the step recurrences forward, the chunked forms'
    gradients):
    internvl2's batch has patch embeddings and text, hubert's masked labels
    (8% of frames, the rest -1)."""
    (jl, jm, jg), (tl, tm, tg, tparams), batch = _loss_and_grads(arch)
    np.testing.assert_allclose(float(tl), jl, **SCALAR)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **SCALAR, err_msg=k)
    paths = [path for path, _ in _walk(tparams)]
    assert sorted(paths) == sorted(jg)
    for path, g in zip(paths, tg):
        _grad_close(g.numpy(), jg[path], str(path))
    if arch == "hubert-xlarge":
        assert 0 < (batch["labels"] >= 0).sum() < batch["labels"].size
    if arch == "internvl2-1b":
        assert "patch_embeds" in batch


@pytest.mark.parametrize("arch,loss_chunk", [("qwen3-4b", 10), ("internvl2-1b", 7),
                                             ("hubert-xlarge", 24)])
def test_chunked_ce_with_a_chunk_that_does_not_divide_s(arch, loss_chunk):
    """loss_chunk below S and not a divisor of it: the chunk shrinks to a
    divisor (63 → 9 for qwen3's 63 targets), as in the reference."""
    (jl, _, jg), (tl, _, tg, tparams), _ = _loss_and_grads(arch, loss_chunk=loss_chunk)
    np.testing.assert_allclose(float(tl), jl, **SCALAR)
    for (path, _), g in zip(_walk(tparams), tg):
        _grad_close(g.numpy(), jg[path], str(path))


@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b", "rwkv6-3b", "zamba2-2.7b"])
def test_remat_gives_the_reference_gradients(arch):
    """With remat on (each layer, or each hybrid site, recomputed in the
    backward) the gradients still equal the reference's, which remats too."""
    (jl, _, jg), (tl, _, tg, tparams), _ = _loss_and_grads(arch, remat=True)
    np.testing.assert_allclose(float(tl), jl, **SCALAR)
    for (path, _), g in zip(_walk(tparams), tg):
        _grad_close(g.numpy(), jg[path], str(path))


def test_loss_without_grad_equals_loss_with_grad():
    _, _, tmodel, tparams = _bridge("qwen3-4b", remat=True, loss_chunk=16)
    batch = _torch(make_batch_np(tmodel.cfg, DataConfig(B, S), 0))
    with torch.inference_mode():
        a, _ = tmodel.loss(tparams, batch)
    b, _ = tmodel.loss(_requires_grad(tparams), batch)
    assert float(a) == float(b) and b.requires_grad
