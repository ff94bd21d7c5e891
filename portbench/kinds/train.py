"""Traffic kind ``train``: the program's training step
(``train.loop.make_train_step``: ``Model.loss`` under autograd with remat,
the hand-written backward kernels, AdamW in place with f32 moments on bf16
weights), fed by the program's prefetch thread (``PrefetchIterator``, a
pinned copy to the card) with the Zipf batches of the frozen generator.

Set-up builds the step, its model and optimizer state once, from the
seed, and drives it through its first ``checked_steps`` steps (distinct
batches), which are what is judged; the window then runs the same object
on until ``seconds`` have passed and its last step has finished.  The rate
is every token of every step in the window over all of its time.  With
``trace`` the window's first ``traced_steps`` steps run under
``torch.profiler``.

Judged against the plain reference, which follows the same steps in
float32 from the same weights and batches (rounding its weights to the
configuration's dtype after each update, as the configuration stores
them):

* ``loss_gap``: each step's loss, the largest relative gap;
* ``grad_gap``: the first gradient as the optimizer gets it (its first
  moment after one step, over (1 - b1) and the clip the program applied),
  by the worst leaf: the gap between the two sides' norms of a leaf over
  the reference's norm of that leaf or of the median leaf, the larger;
* ``grad_err``: that gradient element by element, on ``SAMPLE`` elements
  of each leaf drawn from the seed: the worst leaf's norm of the
  difference over its reference norm or the median leaf's, the larger;
* ``delta_gap``: the parameters' change over the checked steps, by the
  worst leaf as ``grad_gap``; leaves whose reference gradient is under a
  thousandth of the median leaf's are left out (their change is round-off).
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from portbench import harness, timeline, weights, work
from portbench.reference.common import Numerics, adamw, exact_f32, leaves, nest
from portbench.traffic_gen import train_batch

QUIET_GRAD = 1e-3
SAMPLE = 65536       # elements of each leaf's first gradient compared one by one


def _sample_index(seed: int, leaf_no: int, n: int, device: torch.device) -> torch.Tensor:
    """The elements of a leaf of ``n`` whose first gradient is compared: the
    same on both sides, drawn from the seed."""
    gen = torch.Generator().manual_seed(seed * 1009 + leaf_no)
    return torch.randint(0, n, (min(n, SAMPLE),), generator=gen).to(device)


def _batches(cell, seed: int):
    cfg, mix = cell.config, cell.traffic
    step = 0
    while True:
        yield {"tokens": train_batch(seed, step, cfg["vocab_size"], mix["batch"],
                                     mix["seq_len"], mix["zipf_alpha"])}
        step += 1


class Job:
    """The program's training step, its state and its feed."""

    def __init__(self, cell, seed: int, device: torch.device) -> None:
        from repro_torch.models import Model
        from repro_torch.train import AdamWConfig, PrefetchIterator, adamw_init, make_train_step

        cfg = cell.config
        self.cell, self.seed, self.device = cell, seed, device
        self.model = Model(harness.model_config(cfg))
        self.layout = cell.reference.layout(cfg)
        harness.check_layout(self.model, self.layout)
        cell.n_params = work.n_params({p: s for p, s, _ in weights.specs(self.layout)})
        self.params = weights.draw(self.layout, seed, getattr(torch, cfg["dtype"]), device)
        for _, p in leaves(self.params):
            p.requires_grad_(True)
        self.opt = AdamWConfig(**cell.traffic["opt"])
        self.opt_state = adamw_init(self.params)
        self.step_fn = make_train_step(self.model, self.opt)
        self.feed = PrefetchIterator(_batches(cell, seed), depth=cell.traffic["prefetch"])

    def step(self) -> dict:
        from repro_torch.train.data import to_device

        batch = to_device(next(self.feed), self.device)
        self.params, self.opt_state, m = self.step_fn(self.params, self.opt_state, batch)
        return m

    def checked_steps(self, n: int) -> dict:
        """The first ``n`` steps, with what is judged of them."""
        losses, grads, samples = [], {}, {}
        for t in range(n):
            m = self.step()
            losses.append(float(m["loss"]))
            if t == 0:
                scale = 1.0 / (1 - self.opt.b1) / min(
                    1.0, self.opt.grad_clip / max(float(m["grad_norm"]), 1e-9))
                for i, (path, mu) in enumerate(leaves(self.opt_state.mu)):
                    grads[path] = float(mu.norm()) * scale
                    idx = _sample_index(self.seed, i, mu.numel(), self.device)
                    samples[path] = (mu.flatten()[idx] * scale).cpu()
        p0 = weights.draw(self.layout, self.seed, getattr(torch, self.cell.config["dtype"]),
                          self.device)
        delta = {}
        for (path, p), (_, q) in zip(leaves(self.params), leaves(p0)):
            delta[path] = _diff_norm(p.detach(), q)
        del p0
        harness.free(self.device)
        return {"losses": losses, "grads": grads, "samples": samples, "delta": delta}

    def window(self, seconds: float, traced: int = 0):
        """(steps, window seconds, trace) of the timed steps."""
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        prof, trace, spans, losses = (profile(activities=acts) if traced else None), None, [], []
        if prof is not None:
            prof.__enter__()
        shape = {"batch": self.cell.traffic["batch"], "length": self.cell.traffic["seq_len"]}
        start = time.perf_counter_ns()
        n = 0
        while True:
            t0 = time.perf_counter_ns()
            if n < traced:
                with record_function(timeline.SPAN_PREFIX + "step"):
                    losses.append(float(self.step()["loss"]))
            else:
                losses.append(float(self.step()["loss"]))
            t1 = time.perf_counter_ns()
            if n < traced:
                spans.append(timeline.Span("step", t0, t1, shape))
                if n + 1 == traced:
                    prof.__exit__(None, None, None)
                    trace = timeline.from_profiler(prof, spans)
            n += 1
            if t1 - start >= seconds * 1e9 and n >= traced:
                return losses, (t1 - start) * 1e-9, trace


def _diff_norm(p: torch.Tensor, q: torch.Tensor) -> float:
    """‖p − q‖ in f32, a layer at a time for a stacked leaf."""
    if p.dim() < 3:
        return float((p.float() - q.float()).norm())
    return float(torch.stack([(a.float() - b.float()).norm() for a, b in zip(p, q)]).norm())


def reference(cell, seed: int, device: torch.device, n: int, numerics: Numerics) -> dict:
    """The reference's ``n`` steps from the seed's weights and batches: the
    same record as ``Job.checked_steps``, and the leaves' first gradient
    norms (for the quiet-leaf rule)."""
    cfg, mix = cell.config, cell.traffic
    layout = cell.reference.layout(cfg)
    dtype = getattr(torch, cfg["dtype"])
    p32 = nest((path, p.float().requires_grad_(True))
               for path, p in leaves(weights.draw(layout, seed, dtype, device)))
    harness.free(device)
    opt = dict(cell.traffic["opt"])
    state: dict = {}
    losses, grads, samples = [], {}, {}
    with exact_f32():
        for t in range(n):
            toks = torch.from_numpy(train_batch(seed, t, cfg["vocab_size"], mix["batch"],
                                                mix["seq_len"], mix["zipf_alpha"])).to(device)
            with torch.enable_grad():
                loss = cell.reference.loss(numerics, p32, toks, cfg)
                paths, ps = zip(*leaves(p32))
                gs = torch.autograd.grad(loss, ps)
            losses.append(float(loss.detach()))
            if t == 0:
                for i, (path, g) in enumerate(zip(paths, gs)):
                    grads[path] = float(g.norm())
                    samples[path] = g.flatten()[_sample_index(seed, i, g.numel(), device)].cpu()
            gtree = nest(zip(paths, gs))
            del gs, loss
            with torch.no_grad():
                adamw(p32, gtree, state, opt, t + 1, dtype)
            del gtree
    del state
    harness.free(device)
    p0 = weights.draw(layout, seed, dtype, device)
    delta = {path: _diff_norm(p.detach(), q) for (path, p), (_, q) in zip(leaves(p32), leaves(p0))}
    del p0, p32
    harness.free(device)
    return {"losses": losses, "grads": grads, "samples": samples, "delta": delta}


def _worst_leaf(prog: dict, ref: dict, keep: Optional[set] = None,
                zero_prog: bool = False) -> float:
    """The worst leaf's gap |prog − ref| (``zero_prog``: prog is already the
    gap) over the reference's norm of that leaf or the median leaf's."""
    paths = [p for p in ref if keep is None or p in keep]
    norms = sorted(ref[p] for p in paths)
    median = norms[len(norms) // 2]
    return max((prog[p] if zero_prog else abs(prog[p] - ref[p])) / max(ref[p], median)
               for p in paths)


def readings(prog: dict, ref: dict) -> dict:
    gnorms = sorted(ref["grads"].values())
    median = gnorms[len(gnorms) // 2]
    moving = {p for p, g in ref["grads"].items() if g >= QUIET_GRAD * median}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": _worst_leaf(prog["grads"], ref["grads"]),
        "grad_err": _worst_leaf({p: float((prog["samples"][p] - s).norm())
                                 for p, s in ref["samples"].items()},
                                {p: float(s.norm()) for p, s in ref["samples"].items()},
                                zero_prog=True),
        "delta_gap": _worst_leaf(prog["delta"], ref["delta"], moving),
    }


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float) -> dict:
    mix = cell.traffic
    n = mix["checked_steps"]
    job = Job(cell, seed, device)
    checked = job.checked_steps(n)
    setup_s = time.perf_counter() - t0
    losses, window_s, tr = job.window(seconds, mix["traced_steps"] if trace else 0)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del job
    harness.free(device)
    ref = reference(cell, seed, device, n, Numerics())
    steps = len(losses)
    failed = sum(1 for v in checked["losses"] + losses if v != v or abs(v) == float("inf"))
    return {"end_to_end": {"setup_s": setup_s,
                           "train_tokens_per_s": steps * mix["batch"] * mix["seq_len"] / window_s},
            "attempted": n + steps, "failed": failed, "readings": readings(checked, ref),
            "memory_peak_bytes": peak, "trace": tr}
