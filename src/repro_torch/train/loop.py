"""Training loop (``repro/train/loop.py`` in PyTorch): a train step with
gradient accumulation, and a trainer that records every step's wall time
through the paper's instrumentation stack (a ``TimelineRecorder``), so
deadline policies and c_v are first-class training metrics too.

The reference jits the step with mesh shardings; the port runs it eagerly,
on one device or on the ranks of a training mesh.  The gradient comes from
``torch.autograd.grad`` of ``Model.loss``: on the card through the flash
attention kernels' forward and backward and the scans' forward and
backward kernels, on the CPU through the plain versions.

On a mesh (``distributed.mesh.TrainMesh``) parameters, gradients and AdamW
moments are laid out by the reference's ruleset (``default_rules``, with
``embed`` over the data axes under FSDP): each rank keeps its blocks
(``distributed/layout.py``).  The model computes tensor-parallel over
``model`` (``Model(cfg, tp)``, ``distributed/tp.py``): a leaf split over
``model`` by a rule the layer computes on (heads, kv_heads, mlp, expert,
vocab) stays the rank's block.  Over data ranks the model draws its
leaves through a feed (``Model(cfg, tp, feed)``, ``distributed/fsdp.py``):
each unit (a layer, a table) gathered where it is used (FSDP's ``embed``
split), one ahead, and its gradient reduced over the data ranks to the
rank's blocks (in f32, cast back) by the backward as soon as it is
complete, into block-gradient buffers.  A step runs ``Model.loss`` and its
backward on the rank's rows of the batch and updates its blocks and
moments; a replicated leaf's gradient is already whole and equal on every
model rank.  It gives the
one-device trajectory: each rank's cross-entropy gradient is weighted by
its share of the global target count (hubert's masked frames differ per
rank), the MoE aux terms (means over equal group counts) by one over the
data ranks, and the clip's norm is global.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.core.timing import StageTimer, TimelineRecorder, fence
from repro_torch.distributed import layout
from repro_torch.distributed.fsdp import Feed
from repro_torch.distributed.layout import Sharding
from repro_torch.distributed.mesh import TrainMesh
from repro_torch.distributed.sharding import Ruleset, default_rules, shard_params_spec
from repro_torch.distributed.tp import ModelParallel, split_spec
from repro_torch.models import Model
from repro_torch.models.moe import group_size
from .data import batch_rows, to_device
from .optimizer import AdamWConfig, AdamWState, _walk, adamw_init, adamw_update, global_norm

__all__ = ["TrainConfig", "Trainer", "make_train_step", "make_sharded_train_step",
           "MeshedLayout"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    grad_accum: int = 1
    log_every: int = 10


def _rebuild(tree: Any, leaves: Iterator[torch.Tensor]) -> Any:
    """A tree shaped like ``tree`` holding ``leaves`` in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def make_train_step(model: Model, opt_cfg: AdamWConfig, grad_accum: int = 1) -> Callable:
    """The train step ``(params, opt_state, batch) → (params, opt_state,
    metrics)``; it updates ``params`` and the moments in place.

    With ``grad_accum > 1`` the batch is split into microbatches along the
    batch dim, run one after another; their gradients are summed in f32
    and divided by ``grad_accum``, the loss and the metrics are their
    means."""

    def grads_of(params: dict, batch: dict) -> tuple[torch.Tensor, dict, list]:
        leaves = [p for _, p in _walk(params)]
        with torch.enable_grad():
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        if grad_accum <= 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
                     for k, v in batch.items()}
            gsum, losses, ms = None, [], []
            for i in range(grad_accum):
                l, m, g = grads_of(params, {k: v[i] for k, v in micro.items()})
                if gsum is None:
                    gsum = [x.float() for x in g]
                else:
                    for acc, x in zip(gsum, g):
                        acc.add_(x)
                losses.append(l)
                ms.append(m)
            grads = [g / grad_accum for g in gsum]
            loss = torch.stack(losses).sum() / grad_accum
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, _rebuild(params, iter(grads)), opt_state)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        with torch.profiler.record_function("collective:all_reduce"):
            dist.all_reduce(x, group=group)
    return x


class MeshedLayout:
    """How a meshed step uses the rank's parameter blocks: ``net`` is the
    model that computes on them (``Model(cfg, tp)`` on a model axis, else
    ``model``), and each leaf's ``rest`` spec (the splits the feed
    gathers) and ``local`` shape (the leaf as ``net`` takes it: the rank's
    block over ``model`` along the dims the layer computes on, whole
    elsewhere)."""

    def __init__(self, model: Model, mesh: TrainMesh, param_spec: dict) -> None:
        tp = ModelParallel.of(mesh)
        self.net = dataclasses.replace(model, tp=tp) if tp is not None else model
        self.mesh = mesh
        shapes = _shapes(model)
        axes = dict(_walk(model.axes()))
        self.items = []          # (path, spec, rest, local shape)
        for path, spec in _walk(param_spec):
            layout.check_spec(spec, shapes[path], mesh, "/".join(path))
            keep, rest = split_spec(axes[path], spec, mesh)
            self.items.append((path, spec, rest,
                               layout.block_shape(shapes[path], keep, mesh)))

    def feed(self, kind: str, data_axes: tuple = ()) -> Optional[Feed]:
        """The feed of a ``kind`` step (``fsdp.Feed.of``), with ``net``
        drawing its leaves through it; None (``net`` as it is) where the
        step needs none."""
        feed = Feed.of(self, self.mesh, self.net.cfg, kind, data_axes)
        if feed is not None:
            self.net = dataclasses.replace(self.net, feed=feed)
        return feed


def make_sharded_train_step(model: Model, opt_cfg: AdamWConfig, mesh: TrainMesh,
                            rules: Ruleset, param_spec: dict, grad_accum: int = 1) -> Callable:
    """The train step on a mesh: ``(param blocks, opt_state of blocks,
    this rank's rows) → (param blocks, opt_state, metrics)``, updating the
    blocks and moments in place.  Metrics are the global ones: ``loss`` and
    ``ce`` over all ranks' targets, the MoE aux the mean over the data
    ranks, as the one-device step on the whole batch gives them; with
    ``grad_accum > 1`` their means over the microbatches."""
    data = rules.lookup("batch")
    data_axes = () if data is None else ((data,) if isinstance(data, str) else tuple(data))
    dgroup = mesh.group(data_axes)
    n_data = mesh.axis_size(data_axes)
    lay = MeshedLayout(model, mesh, param_spec)
    feed = lay.feed("train", data_axes)
    net = lay.net
    norm_groups = {}
    for path, spec, _, _ in lay.items:
        node = norm_groups
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = mesh.group(layout.split_axes(spec, mesh))

    def one(params: dict, leaves: list, mb: dict, weight: torch.Tensor):
        """One microbatch: its objective, weighted CE and aux; the
        gradients of ``leaves`` (no feed), or none: the feed's backward
        reduces them into its buffers."""
        with torch.enable_grad():
            loss, metrics = net.loss(params, mb)
            ce = metrics["ce"]
            obj = weight * ce
            if "load_balance_loss" in metrics:
                # the MoE aux terms: means over the rank's groups, as many
                # on every rank, so the global value is their mean
                obj = obj + (loss - ce) / n_data
            if feed is not None:
                feed.backward()
                leaves = [feed.anchor]
            grads = torch.autograd.grad(obj, leaves)
        aux = {k: v.detach() / n_data for k, v in metrics.items() if k not in ("ce", "loss")}
        return obj.detach(), (weight * ce).detach(), aux, list(grads)

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        if grad_accum <= 1:
            micro = [batch]
        else:
            split = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
                     for k, v in batch.items()}
            micro = [{k: v[i] for k, v in split.items()} for i in range(grad_accum)]
        counts = torch.stack([model.ce_targets(mb) for mb in micro])
        totals = _all_reduce(counts.clone(), dgroup)
        weights = counts / torch.clamp(totals, min=1.0)
        objs, ces, auxs = [], [], []
        if feed is None:
            # one data rank: the blocks are the leaves (summed in f32 over
            # microbatches), with nothing to gather or reduce
            leaves = [p.detach().requires_grad_() for _, p in _walk(params)]
            full = _rebuild(params, iter(leaves))
            gsum = None
            for i, mb in enumerate(micro):
                o, c, a, g = one(full, leaves, mb, weights[i])
                if grad_accum <= 1:
                    gsum = g
                elif gsum is None:
                    gsum = [x.float() for x in g]
                else:
                    for acc, x in zip(gsum, g):
                        acc.add_(x)
                objs.append(o)
                ces.append(c)
                auxs.append(a)
            del full, leaves
            blocks = gsum if grad_accum <= 1 else [g / grad_accum for g in gsum]
        else:
            # the block-gradient buffers: the leaves' dtype, f32 to accumulate
            blocks = [torch.zeros(p.shape, device=p.device,
                                  dtype=p.dtype if grad_accum <= 1 else torch.float32)
                      for _, p in _walk(params)]
            feed.reset()
            for i, mb in enumerate(micro):
                with feed.step(params, blocks, accumulate=grad_accum > 1):
                    o, c, a, _ = one(params, [], mb, weights[i])
                objs.append(o)
                ces.append(c)
                auxs.append(a)
            if grad_accum > 1:
                for b in blocks:
                    b.div_(grad_accum)
        keys = sorted(auxs[0])
        vec = torch.stack([torch.stack(objs), torch.stack(ces)]
                          + [torch.stack([a[k] for a in auxs]) for k in keys])
        vec = _all_reduce(vec, dgroup)
        if grad_accum <= 1:
            loss, ce = vec[0, 0], vec[1, 0]
            metrics = {k: vec[2 + j, 0] for j, k in enumerate(keys)}
        else:
            loss, ce = vec[0].sum() / grad_accum, vec[1].mean()
            metrics = {k: vec[2 + j].mean() for j, k in enumerate(keys)}
        metrics["ce"] = ce
        gtree = _rebuild(params, iter(blocks))
        gnorm = global_norm(gtree, norm_groups)
        params, opt_state, opt_metrics = adamw_update(opt_cfg, params, gtree, opt_state,
                                                      gnorm=gnorm)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    train_step.feed = feed
    return train_step


def _shapes(model: Model) -> dict:
    """Each parameter's full shape by key path."""
    return {path: tuple(spec.shape) for path, spec in _walk(model.specs())}


class Trainer:
    """Trains on one device, or on the ranks of a training mesh.

    ``Trainer(model, device)``: weights and optimizer state on the device;
    each batch moves there (from pinned memory for a card).
    ``Trainer(model, mesh)`` with a ``distributed.mesh.TrainMesh``: as the
    reference's meshed trainer, ``rules or default_rules(cfg, mesh,
    fsdp=fsdp)`` lays the parameters and moments out; each rank holds its
    blocks on ``mesh.device``, takes its rows of each global batch
    (``batch_rows``) and runs ``make_sharded_train_step``; ``rules`` and
    ``fsdp`` need a mesh; ``feed`` is the step's ``distributed.fsdp.Feed``
    (None without data ranks, or off a mesh), whose counters describe the
    step just run.  Either way every step's wall time goes to a
    ``TimelineRecorder`` (the paper's instrumentation stack)."""

    def __init__(self, model: Model, device: str | torch.device | TrainMesh = "cuda",
                 train_cfg: Optional[TrainConfig] = None, rules: Optional[Ruleset] = None,
                 fsdp: bool = False) -> None:
        self.model = model
        self.cfg = train_cfg if train_cfg is not None else TrainConfig()
        self.recorder = TimelineRecorder()
        if isinstance(device, TrainMesh):
            self.mesh = device
            self.device = device.device
            self.rules = rules or default_rules(model.cfg, device, fsdp=fsdp)
            self.param_spec = shard_params_spec(model, self.rules)
            self._shapes = _shapes(model)
            self._step_fn = make_sharded_train_step(model, self.cfg.opt, device, self.rules,
                                                    self.param_spec, self.cfg.grad_accum)
            self.feed = self._step_fn.feed
            return
        if rules is not None or fsdp:
            raise TypeError("rules= and fsdp= lay the parameters out over a training mesh: "
                            "pass a TrainMesh (repro_torch.launch.mesh.make_train_mesh), not "
                            f"the device {str(device)!r}")
        self.mesh = self.feed = None
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') needs a CUDA device; pass device='cpu' "
                               "to train on the CPU")
        self._step_fn = make_train_step(model, self.cfg.opt, self.cfg.grad_accum)

    def init(self, seed: int = 0) -> tuple[dict, AdamWState]:
        """Seeded weights on the device, each leaf requiring grad, and a
        fresh optimizer state; on a mesh each rank's blocks of the
        one-device init for ``seed``, drawn leaf by leaf
        (``Model.init_blocks``: the rank never holds the whole model)."""
        if self.mesh is not None:
            blocks = self.model.init_blocks(seed, self.device, self.param_spec, self.mesh)
            return blocks, adamw_init(blocks)
        params = self.model.init(seed, device=self.device)
        for _, p in _walk(params):
            p.requires_grad_(True)
        return params, adamw_init(params)

    def shard(self, params: dict) -> tuple[dict, AdamWState]:
        """This rank's blocks of full ``params`` (moved to the mesh's
        device) and a fresh optimizer state for them."""
        blocks = {}
        for path, spec in _walk(self.param_spec):
            full = _get(params, path)
            layout.check_spec(spec, tuple(full.shape), self.mesh, "/".join(path))
            b = layout.take_block(full.detach().to(self.device), spec, self.mesh)
            node = blocks
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = b
        return blocks, adamw_init(blocks)

    def full_params(self, params: dict) -> dict:
        """The full parameters gathered from every rank's blocks (each rank
        takes part; every rank gets them)."""
        return _rebuild(params, iter(
            layout.gather(p, spec, self._shapes[path], self.mesh)
            for (path, spec), (_, p) in zip(_walk(self.param_spec), _walk(params))))

    def state_sharding(self) -> Sharding:
        """The layout of ``{"params": params, "opt": opt_state}`` (the tree
        the launcher checkpoints) for ``save_checkpoint`` and
        ``load_checkpoint``."""
        ps = self.param_spec
        return Sharding(self.mesh, {"params": ps, "opt": AdamWState(step=(), mu=ps, nu=ps,
                                                                     loss_scale=())})

    def _local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch.  For moe, raises where a rank's microbatch tokens do not
        make whole global dispatch groups (its routing would differ from
        the global batch's)."""
        rows = batch_rows(batch, self.mesh, self.rules, self.cfg.grad_accum)
        if self.model.cfg.family == "moe":
            ga = self.cfg.grad_accum
            b, s = batch["tokens"].shape[:2]
            b_r = rows["tokens"].shape[0]
            t, t_r = (b // ga) * s, (b_r // ga) * s
            if group_size(t, self.model.cfg) != group_size(t_r, self.model.cfg):
                raise ValueError(
                    f"moe dispatch groups: a rank's microbatch of {b_r // ga} x {s} tokens "
                    f"({t_r}) routes in groups of {group_size(t_r, self.model.cfg)}, the "
                    f"global microbatch of {b // ga} x {s} ({t}) in groups of "
                    f"{group_size(t, self.model.cfg)} (moe_group_size "
                    f"{self.model.cfg.moe_group_size}): capacity, drops and the load-balance "
                    f"loss would differ from the global batch's")
        return rows

    def fit(self, params: dict, opt_state: AdamWState, batches: Iterator[Any], steps: int,
            log: Callable[[int, dict], None] | None = None) -> tuple[dict, AdamWState]:
        """``steps`` train steps on ``batches`` (dicts of NumPy arrays or
        tensors; on a mesh the global batches, the same on every rank).
        Each step is timed as the ``train_step`` stage up to a fence on its
        loss; step 0 (kernel builds and warm-up, where the reference
        compiles) is not recorded.  ``log(i, metrics as floats)`` every
        ``log_every`` steps and at the last."""
        for i in range(steps):
            batch = next(batches)
            if self.mesh is not None:
                batch = self._local_batch(batch)
            batch = to_device(batch, self.device)
            timer = StageTimer()
            with timer.stage("train_step"):
                params, opt_state, metrics = self._step_fn(params, opt_state, batch)
                fence(metrics["loss"])
            rec = timer.finish()
            if i > 0:
                self.recorder.add(rec)
            if log and (i % self.cfg.log_every == 0 or i == steps - 1):
                log(i, {k: float(v) for k, v in metrics.items()})
        return params, opt_state

    def latency_summary(self):
        return self.recorder.summary("train_step")


def _get(tree: dict, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree
