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
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import data as jax_data  # noqa: E402
from repro.train import loop as jax_loop  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import Model, from_numpy  # noqa: E402
from repro_torch.models.params import ParamSpec  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig,
    AdamWState,
    DataConfig,
    PrefetchIterator,
    TrainConfig,
    Trainer,
    adamw_init,
    adamw_update,
    cosine_schedule,
    latest_step,
    load_checkpoint,
    make_batch_np,
    make_train_step,
    save_checkpoint,
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


# ------------------------------------------------------------ train step ----
def _step_close(got_p, want_p, old_p, want_g, clip, lr, wd):
    """Elements whose clipped reference gradient is above 1e-4 at the
    stated tolerance; the rest within 2·lr and moved at most lr·(1+wd|p|)
    (see the module docstring)."""
    for path, w in want_p.items():
        g, old = got_p[path], old_p[path]
        big = np.abs(want_g[path]) * clip > 1e-4
        np.testing.assert_allclose(g[big], w[big], **SCALAR, err_msg=str(path))
        small = ~big
        bound = lr * (1 + wd * np.abs(old[small])) * (1 + 1e-5) + 1e-7
        assert np.all(np.abs(g[small] - w[small]) <= 2 * bound), path
        assert np.all(np.abs(g[small] - old[small]) <= bound), path


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(grad_accum):
    jmodel, jparams, tmodel, tparams = _bridge("qwen3-4b")
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=30)
    batch = jax_data.make_batch_np(jmodel.cfg, jax_data.DataConfig(4, S), 0)
    old = _flat(jax.tree.map(np.asarray, jparams))
    jstep = jax.jit(jax_loop.make_train_step(jmodel, jax_opt.AdamWConfig(**opt), grad_accum))
    jp, _, jm = jstep(jparams, jax_opt.adamw_init(jparams), _jax(batch))
    # the reference's gradient, for the element split
    _, jg = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, _jax(batch))
    if grad_accum > 1:
        halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()} for i in range(2)]
        gs = [jax.grad(lambda p, b: jmodel.loss(p, b)[0])(jparams, _jax(h)) for h in halves]
        jg = jax.tree.map(lambda a, b: (a + b) / 2, *gs)
    tparams = _requires_grad(tparams)
    tp, ts, tm = make_train_step(tmodel, AdamWConfig(**opt), grad_accum)(
        tparams, adamw_init(tparams), _torch(batch))
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **SCALAR, err_msg=k)
    assert int(ts.step) == 1
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    _step_close(_flat(tp), _flat(jax.tree.map(np.asarray, jp)), old,
                _flat(jax.tree.map(np.asarray, jg)), clip, float(jm["lr"]), 0.1)


def test_eight_step_trajectory_matches_reference():
    """tests/test_system.py:122's config (qwen3-4b smoke, 2 layers, vocab
    128, d_ff 128; AdamW lr 3e-3, warmup 2, 30 total steps; batches of
    4 × 64) through the port's Trainer.fit and the reference's
    make_train_step jitted without a mesh, from the same weights."""
    rep = dict(num_layers=2, vocab_size=128, d_ff=128)
    jmodel, jparams, tmodel, tparams = _bridge("qwen3-4b", **rep)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=30)
    data = DataConfig(batch=4, seq_len=64)
    jstep = jax.jit(jax_loop.make_train_step(jmodel, jax_opt.AdamWConfig(**opt)))
    want, jstate = [], jax_opt.adamw_init(jparams)
    for i, b in zip(range(8), jax_data.synthetic_batches(jmodel.cfg, jax_data.DataConfig(4, 64))):
        jparams, jstate, m = jstep(jparams, jstate, _jax(b))
        want.append(float(m["loss"]))
    trainer = Trainer(tmodel, "cpu", TrainConfig(opt=AdamWConfig(**opt), log_every=1))
    got = []
    tparams = _requires_grad(tparams)
    trainer.fit(tparams, adamw_init(tparams), synthetic_batches(tmodel.cfg, data), steps=8,
                log=lambda i, m: got.append(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] and want[-1] < want[0]
    assert len(trainer.recorder.records) == 7
    s = trainer.latency_summary()
    assert s.n == 7 and s.mean > 0


def test_trainer_init_and_refusals():
    model = Model(get_config("qwen3-4b", smoke=True))
    trainer = Trainer(model, "cpu")
    params, state = trainer.init(0)
    assert all(p.requires_grad for _, p in _walk(params))
    assert int(state.step) == 0 and float(state.loss_scale) == 1.0
    # rules= and fsdp= lay the params out over a training mesh; a device is not one
    for kw in (dict(fsdp=True), dict(rules=object())):
        with pytest.raises(TypeError, match=r"pass a TrainMesh .*make_train_mesh.*not the "
                                            r"device 'cpu'"):
            Trainer(model, "cpu", **kw)


# ------------------------------------------------------------ checkpoint ----
def _ckpt_tree(jparams):
    """params (f32 and one bf16 leaf) and an AdamW state after a step."""
    params = jax.tree.map(np.asarray, jparams)
    params["final_ln"]["scale"] = params["final_ln"]["scale"].astype(jnp.bfloat16)
    rng = np.random.default_rng(9)
    mu = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    return params, mu


def test_checkpoint_saved_by_port_loads_in_reference(tmp_path):
    _, jparams, _, _ = _bridge("qwen3-4b")
    params, mu = _ckpt_tree(jparams)
    tstate = AdamWState(torch.tensor(7, dtype=torch.int32), from_numpy(mu, "cpu"),
                        from_numpy(mu, "cpu"), torch.ones(()))
    d = save_checkpoint(str(tmp_path), 7, {"params": from_numpy(params, "cpu"), "opt": tstate})
    assert d.endswith("step_00000007") and latest_step(str(tmp_path)) == 7
    assert jax_ckpt.latest_step(str(tmp_path)) == 7
    template = {"params": jax.tree.map(jnp.asarray, params),
                "opt": jax_opt.AdamWState(jnp.zeros((), jnp.int32), jax.tree.map(jnp.asarray, mu),
                                          jax.tree.map(jnp.asarray, mu), jnp.ones(()))}
    back = jax_ckpt.load_checkpoint(str(tmp_path), template)
    assert int(back["opt"].step) == 7 and np.asarray(back["opt"].step).dtype == np.int32
    assert np.asarray(back["params"]["final_ln"]["scale"]).dtype == jnp.bfloat16
    for path, w in _flat(params).items():
        got = np.asarray(_walk_get(back["params"], path))
        assert got.dtype == w.dtype and np.array_equal(got, w), path
    for path, w in _flat(mu).items():
        assert np.array_equal(np.asarray(_walk_get(back["opt"].nu, path)), w)


def _walk_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_checkpoint_saved_by_reference_loads_in_port(tmp_path):
    _, jparams, _, _ = _bridge("qwen3-4b")
    params, mu = _ckpt_tree(jparams)
    jstate = jax_opt.AdamWState(jnp.asarray(5, jnp.int32), jax.tree.map(jnp.asarray, mu),
                                jax.tree.map(jnp.asarray, mu), jnp.ones((), jnp.float32))
    jax_ckpt.save_checkpoint(str(tmp_path), 5, {"params": jax.tree.map(jnp.asarray, params),
                                                "opt": jstate})
    tparams = from_numpy(params, "cpu")
    template = {"params": tparams, "opt": adamw_init(tparams)}
    back = load_checkpoint(str(tmp_path), template)
    assert isinstance(back["opt"], AdamWState)
    assert back["opt"].step.dtype == torch.int32 and int(back["opt"].step) == 5
    assert back["params"]["final_ln"]["scale"].dtype == torch.bfloat16
    for path, w in _flat(params).items():
        got = _walk_get(back["params"], path)
        if got.dtype == torch.bfloat16:
            assert np.array_equal(got.float().numpy(), w.astype(np.float32)), path
        else:
            assert np.array_equal(got.numpy(), w), path
    for path, w in _flat(mu).items():
        assert np.array_equal(_walk_get(back["opt"].mu, path).numpy(), w)
    with pytest.raises(ValueError, match="shape"):
        bad = {"params": dict(tparams, final_ln={"scale": torch.zeros(3)}),
               "opt": template["opt"]}
        load_checkpoint(str(tmp_path), bad)


def test_checkpoint_round_trip_and_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), {"a": torch.zeros(2)})
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.bfloat16), torch.tensor(3, dtype=torch.int32)]}
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, {"a": tree["a"] * 2, "b": tree["b"]})
    assert latest_step(str(tmp_path)) == 2
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    back = load_checkpoint(str(tmp_path), tree, step=1)
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"][0], tree["b"][0])
    assert torch.equal(load_checkpoint(str(tmp_path), tree)["a"], tree["a"] * 2)


# ------------------------------------------------------------------- CLI ----
def test_train_cli_runs_on_cpu(capsys, tmp_path):
    train_cli.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--steps", "3",
                    "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen3-4b-smoke params=") and out[0].endswith("family=dense")
    steps = [line for line in out if line.startswith("step ") and "loss=" in line]
    assert [line.split()[1] for line in steps] == ["0", "2"]
    assert all("lr=" in line and "gnorm=" in line for line in steps)
    assert any(line.startswith("step latency: mean=") and "cv=" in line and "p99=" in line
               for line in out)
    assert out[-1] == f"saved: {tmp_path / 'step_00000003'}"


def test_train_module_entry_point_on_cpu():
    """``python -m repro_torch.launch.train --arch qwen3-4b --smoke
    --device cpu --steps 3`` in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-4b",
                          "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
                          "--seq", "64"], capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "family=dense" in res.stdout and "step latency" in res.stdout


@pytest.mark.parametrize("argv,msg", [
    (["--mesh", "single"], "needs a process group of 256 ranks"),
    (["--mesh", "multi"], "needs a process group of 512 ranks"),
    (["--fsdp", "--steps", "2", "--batch", "2", "--seq", "64"], None)])
def test_train_cli_refuses_what_is_not_ported(capsys, argv, msg):
    """The production meshes need 256 and 512 ranks: in one process the CLI
    exits naming them.  ``--fsdp`` on the local mesh (1 x 1) trains."""
    if msg is None:
        train_cli.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu", *argv])
        out = capsys.readouterr().out
        assert "step     1 loss=" in out and "step latency" in out
        return
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu", *argv])
    assert exc.value.code == 2 and msg in capsys.readouterr().err


def test_train_cli_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_cli.main(["--arch", "qwen3-4b", "--smoke", "--steps", "1"])
