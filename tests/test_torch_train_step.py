"""The port's train step, checkpoints and training CLI (``repro_torch.train``,
``launch/train.py``) against the JAX reference, on the CPU: the second
half of ``tests/test_torch_train.py`` (its data, optimizer and loss
sections stay there), whose module docstring gives the oracle and every
tolerance.  Helpers come from that module.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import data as jax_data  # noqa: E402
from repro.train import loop as jax_loop  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402

from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import Model, from_numpy  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig,
    AdamWState,
    DataConfig,
    TrainConfig,
    Trainer,
    adamw_init,
    latest_step,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
    synthetic_batches,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.train.optimizer import _walk  # noqa: E402

from test_torch_train import (  # noqa: E402
    REPO, SCALAR, S, _bridge, _flat, _jax, _requires_grad, _torch)


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
