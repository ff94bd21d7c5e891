"""The rank side of ``tests/test_torch_sharded_train.py``: jobs that each
rank of a spawned gloo group runs in turn (``run_jobs``).

This module imports torch, numpy and the port only: the children it runs
in import neither ``jax`` nor ``repro``; the test computes the one-device
and reference trajectories in its own process.  A job is a dict:

- ``train``: ``arch`` (smoke config, f32) on ``mesh`` (make_train_mesh
  keywords) with ``fsdp``, the ruleset's ``overrides``, ``grad_accum``,
  ``batch`` x ``seq`` global
  batches of ``make_batch_np`` and ``steps`` AdamW steps at ``opt``, from
  seed 0 or from full ``params`` (NumPy, the reference's weights);
  returns every step's metrics, the rank's coordinates, its init blocks,
  its feed's counters for the last step (``distributed/fsdp.py``; None
  without one) and (rank 0) the full parameters gathered at init and at
  the end; with ``save`` it then saves a checkpoint there from the ranks'
  blocks;
- ``load``: loads the one-device checkpoint at ``path`` into a sharded
  template and returns the rank's blocks and the gathered full params;
- ``split``: ``split_rows_run`` of the job, the one-process counterpart
  of a data-parallel ``train`` job on the same rows;
- ``reduce``: ``layout.reduce_grad`` of a bf16 gradient (seeded by the
  rank) over the data ranks, split along dim 0 (reduce-scatter) and
  whole (all-reduce), with the rank's input;
- ``raises``: the errors the sharded trainer must raise here;
- ``collectives``: one ``train`` step (seed 0) with counters around
  ``layout``'s collectives and ``dist.all_reduce``: each op's calls and
  result bytes on the rank (``launch.lowering``'s table, measured);
- ``tp_ref``: tensor-parallel compute on ``mesh`` from full ``params``
  (NumPy, the reference's weights) cut to the rank's blocks: ``Model.loss``
  of ``batch`` and every gradient leaf gathered to full (rank 0); with a
  ``prompt``, also the meshed prefill's next-token logits, and ``prompt``
  fed through the meshed decode step into a ``context``-slot state
  followed by ``new`` greedy tokens (every step's logits and token), with
  the shapes of the rank's decode state and, where it has a KV cache, the
  ring's positions after the prompt and at the end;
- ``fsdp_serve``: serving through the feed with FSDP on ``mesh``, from the
  rank's seed-0 blocks: the meshed prefill's next-token logits of the
  rank's rows of ``batch``, then its rows of ``prompt`` through the meshed
  decode step into a ``context``-slot state and ``new`` greedy tokens
  (every step's logits and token), with the prefill's and a decode step's
  feed counters.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed import default_rules, layout, shard_params_spec
from repro_torch.launch.lowering import make_sharded_decode_step, make_sharded_prefill
from repro_torch.launch.mesh import make_production_mesh, make_train_mesh
from repro_torch.models import Model, from_numpy
from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig, Trainer, adamw_init,
                               adamw_update, load_checkpoint, save_checkpoint, synthetic_batches)
from repro_torch.train.data import to_device
from repro_torch.train.loop import MeshedLayout, _rebuild
from repro_torch.train.optimizer import _walk


def _np(tree) -> dict:
    return {"/".join(k): v.detach().cpu().numpy().copy() for k, v in _walk(tree)}


def _train(rank: int, job: dict) -> dict:
    model = Model(get_config(job["arch"], smoke=True))
    mesh = make_train_mesh(device="cpu", **job["mesh"])
    rules = default_rules(model.cfg, mesh, fsdp=job.get("fsdp", False)).with_overrides(
        **job.get("overrides", {}))
    tr = Trainer(model, mesh, TrainConfig(opt=AdamWConfig(**job["opt"]), log_every=1,
                                          grad_accum=job.get("grad_accum", 1)), rules=rules)
    if "params" in job:
        params, state = tr.shard(from_numpy(job["params"], "cpu"))
    else:
        params, state = tr.init(0)
    out = {"coords": mesh.coords, "init": _np(params)}
    full0 = _np(tr.full_params(params))
    metrics = []
    params, state = tr.fit(params, state, synthetic_batches(
        model.cfg, DataConfig(job["batch"], job["seq"])), job["steps"], log=lambda i, m:
        metrics.append(m))
    out["metrics"] = metrics
    out["feed"] = tr.feed.summary() if tr.feed is not None else None
    out["resident"] = sum(t.numel() * t.element_size() for t in
                          [p for _, p in _walk(params)] + [m for _, m in _walk(state.mu)]
                          + [v for _, v in _walk(state.nu)])
    full = _np(tr.full_params(params))
    if "save" in job:
        save_checkpoint(job["save"], job["steps"], {"params": params, "opt": state},
                        sharding=tr.state_sharding())
        mu = _np(tr.full_params(state.mu))          # a collective: every rank gathers
        out["mu"] = mu if rank == 0 else None
    if rank == 0:
        out["full_init"], out["full"] = full0, full
    return out


def split_rows_run(rank: int, job: dict) -> dict:
    """A data-parallel ``train`` job (``mesh`` with ``data`` only, no moe,
    no grad_accum) written out in one process with no layout: each step
    takes the global batch's ``data`` row blocks in rank order, weights
    each block's CE by its share of the targets, takes its gradient and
    sums the blocks' gradients in rank order, then runs the one-device
    AdamW update on the full parameters.  Returns every step's loss and
    the final parameters."""
    model = Model(get_config(job["arch"], smoke=True))
    opt = AdamWConfig(**job["opt"])
    n = job["mesh"]["data"]
    params = model.init(0, device="cpu")
    leaves = [p.requires_grad_(True) for _, p in _walk(params)]
    state = adamw_init(params)
    losses = []
    batches = synthetic_batches(model.cfg, DataConfig(job["batch"], job["seq"]))
    for _ in range(job["steps"]):
        batch = to_device(next(batches), "cpu")
        rows = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[r] for k, v in batch.items()}
                for r in range(n)]
        counts = torch.stack([model.ce_targets(x) for x in rows])
        weights = counts / torch.clamp(counts.sum(), min=1.0)
        grads, loss = None, None
        for w, x in zip(weights, rows):
            with torch.enable_grad():
                obj = w * model.loss(params, x)[1]["ce"]
                g = torch.autograd.grad(obj, leaves)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            loss = obj.detach() if loss is None else loss + obj.detach()
        params, state, _ = adamw_update(opt, params, _rebuild(params, iter(grads)), state)
        losses.append(float(loss))
    return {"losses": losses, "final": _np(params)}


def _reduce(rank: int, job: dict) -> dict:
    mesh = make_train_mesh(device="cpu", **job["mesh"])
    g = torch.Generator().manual_seed(rank)
    # scales over three decades, so that rounding at each addition shows
    x = (torch.randn(job["shape"], generator=g)
         * torch.logspace(-2, 1, job["shape"][-1])).to(torch.bfloat16)
    return {"coords": mesh.coords, "input": x.float().numpy(),
            "split": layout.reduce_grad(x, ("data", None), mesh, ("data",)).float().numpy(),
            "whole": layout.reduce_grad(x, (None, None), mesh, ("data",)).float().numpy()}


def _load(rank: int, job: dict) -> dict:
    model = Model(get_config(job["arch"], smoke=True))
    mesh = make_train_mesh(device="cpu", **job["mesh"])
    tr = Trainer(model, mesh, TrainConfig(), fsdp=job.get("fsdp", False))
    params, state = tr.init(5)                       # a template with other values
    back = load_checkpoint(job["path"], {"params": params, "opt": state},
                           sharding=tr.state_sharding())
    return {"coords": mesh.coords, "blocks": _np(back["params"]), "step": int(back["opt"].step),
            "full": _np(tr.full_params(back["params"])),
            "mu": _np(tr.full_params(back["opt"].mu))}


def _raises(rank: int, job: dict) -> dict:
    msgs = {}
    model = Model(get_config("qwen3-4b", smoke=True))
    mesh = make_train_mesh(data=2, device="cpu")
    rules = default_rules(model.cfg, mesh).with_overrides(kv_heads="data")
    try:
        Trainer(model, mesh, rules=rules)
    except ValueError as e:
        msgs["split"] = str(e)
    moe = Model(get_config("olmoe-1b-7b", smoke=True))
    tr = Trainer(moe, mesh)
    params, state = tr.init(0)
    try:
        tr.fit(params, state, synthetic_batches(moe.cfg, DataConfig(2, 48)), 1)
    except ValueError as e:
        msgs["moe"] = str(e)
    try:
        make_production_mesh(device="cpu")
    except ValueError as e:
        msgs["world"] = str(e)
    return msgs


def _collectives(rank: int, job: dict) -> dict:
    model = Model(get_config(job["arch"], smoke=True))
    mesh = make_train_mesh(device="cpu", **job["mesh"])
    tr = Trainer(model, mesh, TrainConfig(grad_accum=job.get("grad_accum", 1)),
                 fsdp=job.get("fsdp", False))
    params, state = tr.init(0)
    table: dict = {}
    real = (layout.all_gather_flat, layout.reduce_scatter_flat, dist.all_reduce)

    def counted(op, fn):
        def call(t, *a, **kw):
            rec = table.setdefault(op, {"count": 0, "bytes": 0.0})
            rec["count"] += 1
            rec["bytes"] += float(t.numel() * t.element_size())
            return fn(t, *a, **kw)
        return call

    layout.all_gather_flat = counted("all_gather", real[0])
    layout.reduce_scatter_flat = counted("reduce_scatter", real[1])
    dist.all_reduce = counted("all_reduce", real[2])
    try:
        tr.fit(params, state, synthetic_batches(model.cfg, DataConfig(job["batch"],
                                                                      job["seq"])), 1)
    finally:
        layout.all_gather_flat, layout.reduce_scatter_flat, dist.all_reduce = real
    return table


def _tp_ref(rank: int, job: dict) -> dict:
    model = Model(get_config(job["arch"], smoke=True))
    mesh = make_train_mesh(device="cpu", **job["mesh"])
    rules = default_rules(model.cfg, mesh)
    spec = shard_params_spec(model, rules)
    full = from_numpy(job["params"], "cpu")
    blocks = _rebuild(full, iter(layout.take_block(p, sp, mesh)
                                 for (_, p), (_, sp) in zip(_walk(full), _walk(spec))))
    lay = MeshedLayout(model, mesh, spec)
    # data=1: the blocks are the leaves the model takes
    leaves = [p.detach().requires_grad_() for _, p in _walk(blocks)]
    batch = to_device(job["batch"], "cpu")
    loss, metrics = lay.net.loss(_rebuild(blocks, iter(leaves)), batch)
    grads = torch.autograd.grad(loss, leaves)
    out = {"loss": float(loss.detach()), "metrics": {k: float(v.detach())
                                                     for k, v in metrics.items()}}
    full_grads = {"/".join(path): layout.gather(g, sp, tuple(full_leaf.shape), mesh).numpy()
                  for (path, sp, _, _), g, (_, full_leaf) in zip(lay.items, grads, _walk(full))}
    if rank == 0:
        out["grads"] = full_grads
    if "prompt" not in job:
        return out
    out["prefill"] = make_sharded_prefill(model, mesh, spec)(blocks, batch).numpy()
    prompt = torch.from_numpy(job["prompt"])
    state = model.init_decode_state(prompt.shape[0], job["context"], "cpu", mesh=mesh,
                                    rules=rules)
    step = make_sharded_decode_step(model, mesh, spec)
    logits, tokens = [], []
    for i in range(prompt.shape[1]):
        tok, lg, state = step(blocks, state, prompt[:, i])
    if state.kv is not None:
        out["prompt_positions"] = state.kv.positions.numpy().copy()
    for _ in range(job["new"]):
        logits.append(lg.numpy())
        tokens.append(tok.numpy())
        tok, lg, state = step(blocks, state, tok)
    out.update(logits=logits, tokens=tokens,
               state={f"{part}.{name}": tuple(getattr(getattr(state, part), name).shape)
                      for part in ("kv", "ssm", "rwkv") if getattr(state, part) is not None
                      for name in getattr(state, part)._fields})
    if state.kv is not None:
        out.update(cache=tuple(state.kv.k.shape), positions=state.kv.positions.numpy())
    return out


def _fsdp_serve(rank: int, job: dict) -> dict:
    model = Model(get_config(job["arch"], smoke=True))
    mesh = make_train_mesh(device="cpu", **job["mesh"])
    rules = default_rules(model.cfg, mesh, fsdp=True)
    spec = shard_params_spec(model, rules)
    params = model.init_blocks(0, "cpu", spec, mesh)
    n, i = mesh.shape["data"], mesh.coords["data"]
    rows = job["batch"]["tokens"].shape[0] // n
    mine = slice(i * rows, (i + 1) * rows)
    prefill = make_sharded_prefill(model, mesh, spec)
    out = {"prefill": prefill(params, {"tokens": torch.from_numpy(
        job["batch"]["tokens"][mine])}).numpy(), "prefill_feed": prefill.feed.summary()}
    prompt = torch.from_numpy(job["prompt"][mine])
    state = model.init_decode_state(job["prompt"].shape[0], job["context"], "cpu", mesh=mesh,
                                    rules=rules)
    step = make_sharded_decode_step(model, mesh, spec)
    for t in range(prompt.shape[1]):
        tok, lg, state = step(params, state, prompt[:, t])
    out["decode_feed"] = step.feed.summary()
    logits, tokens = [], []
    for _ in range(job["new"]):
        logits.append(lg.numpy())
        tokens.append(tok.numpy())
        tok, lg, state = step(params, state, tok)
    return dict(out, logits=logits, tokens=tokens, rows=(mine.start, mine.stop))


JOBS = {"train": _train, "split": split_rows_run, "reduce": _reduce, "load": _load,
        "raises": _raises, "collectives": _collectives, "tp_ref": _tp_ref,
        "fsdp_serve": _fsdp_serve}


def run_jobs(rank: int, jobs: list) -> list:
    """Each job's result on this rank, in order."""
    return [JOBS[job["kind"]](rank, job) for job in jobs]
