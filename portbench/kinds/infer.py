"""Traffic kind ``infer``: one client in a closed loop sends a prompt of
``batch`` rows, waits until the next-token logits of every row are on the
host (``Model.prefill``, no grad), and sends the next.

A request's latency runs from its issue (before its tokens go to the card)
to its logits on the host.  The window opens after set-up (the weights
drawn on the card, every length of the mix served once) and closes at the
first completion ``seconds`` or more after it opens that ends a cycle of
the mix (so every seed serves the same lengths): the rate is every
prompt token of every request over all of that time, the tail the 95th
percentile (nearest rank) of every request's latency.  With ``trace`` the
first ``traced_requests`` requests run under ``torch.profiler``.

Judged after the window: a sample drawn from the seed of the finished
requests, the longest first, against the plain reference's last-position
logits in float32 on the same weights and tokens (``logit_rms``: the
difference's norm over the reference's centred norm; ``logit_max``: the
largest difference over the reference's standard deviation; the worst row
of the sample for each).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from portbench import harness, timeline, weights, work
from portbench.reference.common import Numerics, exact_f32
from portbench.traffic_gen import Requests


@dataclasses.dataclass
class Served:
    latencies_ns: list
    lengths: list
    outputs: list            # (batch, vocab) f32 logits on the host, by request
    window_s: float
    trace: Optional[timeline.Trace]


def prepare(cell, seed: int, device: torch.device):
    """(model, params, requests): the program's model, the benchmark's
    weights for it, the mix's requests."""
    from repro_torch.models import Model

    cfg = cell.config
    model = Model(harness.model_config(cfg))
    layout = cell.reference.layout(cfg)
    harness.check_layout(model, layout)
    cell.n_params = work.n_params({p: s for p, s, _ in weights.specs(layout)})
    params = weights.draw(layout, seed, getattr(torch, cfg["dtype"]), device)
    return model, params, Requests(cell.traffic, seed, cfg["vocab_size"])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm(model, params, reqs: Requests, device: torch.device) -> None:
    """Serve every length of the mix once."""
    with torch.inference_mode():
        for length in reqs.lengths():
            toks = torch.from_numpy(reqs.tokens_of_length(length)).to(device)
            model.prefill(params, {"tokens": toks}).float().cpu()
    _sync(device)


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


def serve(model, params, reqs: Requests, device: torch.device, seconds: float,
          traced: int = 0) -> Served:
    """The window: requests in a closed loop until ``seconds`` have passed
    and the cycle in flight is whole, so that every seed's window holds the
    same lengths (at least ``traced`` requests, the first ``traced`` under
    the profiler)."""
    from torch.profiler import record_function

    lat, lengths, outs, spans = [], [], [], []
    prof, trace = (_profiler(device) if traced else None), None
    if prof is not None:
        prof.__enter__()
    start = time.perf_counter_ns()
    i = 0
    with torch.inference_mode():
        while True:
            toks = reqs.tokens(i)
            mark = record_function(timeline.SPAN_PREFIX + "request") if i < traced \
                else contextlib.nullcontext()
            t_issue = time.perf_counter_ns()
            with mark:
                y = model.prefill(params, {"tokens": torch.from_numpy(toks).to(device)})
                y = y.float().cpu()
            t_done = time.perf_counter_ns()
            lat.append(t_done - t_issue)
            lengths.append(toks.shape[1])
            outs.append(y)
            if i < traced:
                spans.append(timeline.Span("request", t_issue, t_done,
                                           {"batch": toks.shape[0], "length": toks.shape[1]}))
                if i + 1 == traced:
                    prof.__exit__(None, None, None)
                    trace = timeline.from_profiler(prof, spans)
            i += 1
            if t_done - start >= seconds * 1e9 and i >= traced and i % reqs.cycle == 0:
                break
    return Served(lat, lengths, outs, (t_done - start) * 1e-9, trace)


def p95_ms(latencies_ns: list) -> float:
    """The 95th percentile by nearest rank, in ms."""
    s = sorted(latencies_ns)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)] * 1e-6


def end_to_end(served: Served, batch: int) -> dict:
    tokens = batch * sum(served.lengths)
    return {"infer_tokens_per_s": tokens / served.window_s,
            "infer_p95_ms": p95_ms(served.latencies_ns)}


def sample(lengths: list, seed: int, k: int) -> list[int]:
    """k finished requests drawn from the seed, the (last) longest first."""
    longest = max(range(len(lengths)), key=lambda i: (lengths[i], i))
    rest = [i for i in range(len(lengths)) if i != longest]
    rng = np.random.default_rng([seed, 4])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[j] for j in sorted(pick)]


def reference_logits(cell, seed: int, device: torch.device, reqs: Requests, idx: list,
                     numerics: Numerics) -> dict:
    """The reference's last-position logits (f32, on the host) of requests
    ``idx``, on the weights drawn again from the seed."""
    cfg = cell.config
    p = weights.draw(cell.reference.layout(cfg), seed, getattr(torch, cfg["dtype"]), device)
    p32 = _to_f32(p)
    out = {}
    with exact_f32(), torch.no_grad():
        for i in idx:
            toks = torch.from_numpy(reqs.tokens(i)).to(device)
            out[i] = cell.reference.last_logits(numerics, p32, toks, cfg).cpu()
    del p32
    harness.free(device)
    return out


def _to_f32(tree: dict) -> dict:
    """An f32 copy of a tree, each leaf dropped from ``tree`` as it is cast."""
    out = {}
    for k in list(tree):
        v = tree.pop(k)
        out[k] = _to_f32(v) if isinstance(v, dict) else v.float()
        del v
    return out


def readings(outputs: dict, refs: dict) -> dict:
    rms = mx = 0.0
    for i, r in refs.items():
        o = outputs[i]
        for row in range(r.shape[0]):
            d = (o[row] - r[row]).double()
            c = (r[row] - r[row].mean()).double()
            rms = max(rms, float(d.norm() / c.norm()))
            mx = max(mx, float(d.abs().max() / r[row].double().std()))
    return {"logit_rms": rms, "logit_max": mx}


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float) -> dict:
    mix = cell.traffic
    model, params, reqs = prepare(cell, seed, device)
    warm(model, params, reqs, device)
    setup_s = time.perf_counter() - t0
    served = serve(model, params, reqs, device, seconds, mix["traced_requests"] if trace else 0)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del model, params
    harness.free(device)
    failed = sum(1 for y in served.outputs if not torch.isfinite(y).all())
    idx = sample(served.lengths, seed, mix["check_requests"])
    refs = reference_logits(cell, seed, device, reqs, idx, Numerics())
    e2e = end_to_end(served, mix["batch"])
    e2e["setup_s"] = setup_s
    return {"end_to_end": e2e, "attempted": len(served.outputs), "failed": failed,
            "readings": readings({i: served.outputs[i] for i in idx}, refs),
            "memory_peak_bytes": peak, "trace": served.trace}
