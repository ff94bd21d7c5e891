"""Serving launcher: single-stream instrumented decoding, the
multi-tenant continuous-batching runtime under a Poisson arrival stream,
or the camera-fleet perception scheduler at one shard.

Single stream::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --batch 4 --context 1024 --prompt-len 64 --tokens 32

(``--arch`` takes every ported arch: qwen3-4b, rwkv6-3b, zamba2-2.7b.)

Multi-tenant load generator (``--streams N``): N tenants arrive as a
Poisson process on the bus broker's simulated clock, are admitted into
``--batch`` padded slots (deadline-aware admission unless
``--admission none``), and the run prints a per-tenant report — mean,
CV, p99, miss rate per stream; ``--anytime`` degrades a stream's SLO down
``--degrade-factors`` before shedding it::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --batch 8 --context 1024 --prompt-len 64 --streams 16

Camera fleet (``--fleet``): N camera streams served by the rung-bucket
scheduler under deterministic virtual time, on one device (``--mesh``
and ``--chaos`` are not ported yet)::

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet --streams 8 \
        --ticks 40 --json-out fleet.json

Runs on CUDA unless ``--device cpu`` is given (a CPU run is for checking
control flow at ``--smoke`` size; its times are not the card's).
Decode weights are random, from a ``torch.Generator`` seeded with 0; the
fleet's detector weights from one seeded with 7.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.bus import Broker, CopyTransport, SimClock
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.deadline import KalmanDeadline, MeanDeadline, PercentileDeadline, \
    WorstObserved
from repro_torch.models import Model
from repro_torch.runtime import (
    AdmissionController,
    AlwaysAdmit,
    Engine,
    MultiTenantConfig,
    MultiTenantEngine,
    RequestQueue,
    ServeConfig,
    poisson_workload,
)

POLICY = {
    "worst": WorstObserved,
    "mean": lambda: MeanDeadline(margin=1.5),
    "p95": lambda: PercentileDeadline(q=95.0),
    "kalman": KalmanDeadline,
}


def serve_single(args, cfg, model, params) -> None:
    eng = Engine(
        model,
        ServeConfig(batch=args.batch, context=args.context),
        deadline_policy=POLICY[args.deadline](),
        device=args.device,
    )
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    out, rec = eng.generate(params, prompt, max_new_tokens=args.tokens)
    print(f"generated {out.shape} tokens; first row: {out[0, :12]}")
    rep = eng.report()
    print("serving report:",
          " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in rep.items()))
    for row in rec.breakdown_table():
        print(f"  {row['stage']:>16s}: mean={row['mean']*1e3:7.3f}ms cv={row['cv']:.3f}")


def serve_multi_tenant(args, cfg, model, params) -> None:
    clock = SimClock()
    obs = dashboard = None
    if args.obs:
        from repro_torch.obs import Observatory
        obs = Observatory()
        dashboard = obs.dashboard(period=args.obs_period)
    broker = Broker(transport=CopyTransport(), seed=0)
    queue = RequestQueue()
    # callback-only subscription: every envelope goes straight into the
    # RequestQueue, nothing is double-retained, dropped stays truthful
    broker.subscribe("requests", callback=lambda env: queue.push(env.payload),
                     queue_size=0)

    degrade = args.degrade_factors_parsed if args.anytime else ()
    workload = poisson_workload(
        args.streams,
        rate_hz=args.arrival_rate,
        vocab_size=cfg.vocab_size,
        prompt_len=args.prompt_len,
        max_new_tokens=args.tokens,
        deadline_s=args.slo_ms * 1e-3 if args.slo_ms is not None else None,
        seed=0,
        degrade_factors=degrade,
    )
    for req in workload:
        broker.publish("requests", req, size_bytes=4 * req.prompt.size,
                       now=req.arrival_s)

    admission = (
        AlwaysAdmit() if args.admission == "none"
        else AdmissionController(confidence=0.95)
    )
    eng = MultiTenantEngine(
        model, params,
        MultiTenantConfig(capacity=args.batch, context=args.context),
        admission=admission,
        policy_factory=lambda req: POLICY[args.deadline](),
        anytime=args.anytime,
        obs=obs,
        device=args.device,
    )
    eng.compile()
    eng.drain(queue, clock=clock, source=broker,
              on_step=(lambda _steps: dashboard.step())
              if dashboard is not None else None)
    if dashboard is not None:
        dashboard.render()               # final state, even on short runs
        if args.trace_out:
            obs.write_trace(args.trace_out, process_label="serve")
            print(f"wrote Chrome trace to {args.trace_out} "
                  f"({obs.tracer.n_recorded} spans, "
                  f"{obs.tracer.dropped} dropped)")

    agg = eng.aggregate_report()
    print(
        f"served {agg['streams']} streams ({agg['shed_streams']} shed, "
        f"{agg['degraded_streams']} degraded) in "
        f"{agg['steps']} steps over {clock.time():.3f}s simulated; "
        f"traces={agg['traces']}"
    )
    print(
        f"step latency: mean={agg['step_mean_s']*1e3:.3f}ms "
        f"cv={agg['step_cv']:.3f} p99={agg['step_p99_s']*1e3:.3f}ms; "
        f"jobs={agg['jobs']} miss_rate={agg['miss_rate']:.3f}"
    )
    print(f"{'tenant':>10s} {'status':>9s} {'jobs':>5s} {'mean_ms':>8s} {'cv':>6s} "
          f"{'p99_ms':>8s} {'miss%':>6s}")
    for row in eng.per_tenant_report():
        print(
            f"{row['tenant']:>10s} {row['status']:>9s} {row['jobs']:>5d} "
            f"{row['mean_s']*1e3:8.3f} {row['cv']:6.3f} {row['p99_s']*1e3:8.3f} "
            f"{row['miss_rate']*100:6.2f}"
        )
    delays = broker.delays.get("requests", [])
    if delays:
        print(
            f"transport: {len(delays)} deliveries, mean "
            f"{np.mean(delays)*1e6:.1f}us, p99 {np.percentile(delays, 99)*1e6:.1f}us"
        )


def serve_fleet(args) -> dict:
    """Camera-fleet mode: rung-bucket scheduling of ``--streams`` camera
    streams on one device, ticked under deterministic virtual time
    (seeded ``ModeledStageCost``).  Returns the JSON report."""
    from repro_torch.batched.scheduler import RungBucketScheduler
    from repro_torch.perception.data import SceneConfig, generate_scene
    from repro_torch.scenarios.replay import ModeledStageCost, replay_ladder

    cap = max(args.batch, args.streams)
    clock = SimClock()
    ladder = replay_ladder()
    cost = ModeledStageCost(ladder, seed=0)
    sched = RungBucketScheduler(ladder, capacity=cap, clock=clock,
                                stage_cost=cost, device=args.device)
    obs = None
    if args.obs:
        from repro_torch.obs import Observatory
        obs = Observatory()
        obs.bind_clock(clock)
        sched.set_obs(obs)
    sched.warm(SceneConfig(scenario="city", seed=7))
    budget_s = args.slo_ms * 1e-3 if args.slo_ms is not None else 0.03
    sids = [f"cam{i:02d}" for i in range(args.streams)]
    for sid in sids:
        sched.add_stream(sid, budget_s)

    rng = np.random.default_rng(0)
    frames = 0
    t_wall = time.perf_counter()
    for t in range(args.ticks):
        scenes = {
            sid: generate_scene(
                SceneConfig(scenario="city", rain_mm_per_hour=float(
                    rng.choice([0.0, 0.0, 4.0])), seed=i), t)
            for i, sid in enumerate(sids)}
        res = sched.tick(scenes)
        frames += len(res.outputs)
    wall_s = time.perf_counter() - t_wall
    virtual_s = clock.time()

    occupancy = {name: eng.shard_occupancy()
                 for name, eng in sched.engines.items() if eng.n_active}
    traces = {name: eng.trace_count for name, eng in sched.engines.items()}
    doc = {
        "mesh": None,
        "devices": torch.cuda.device_count(),
        "n_shards": 1,
        "capacity": cap,
        "streams": args.streams,
        "ticks": args.ticks,
        "frames": frames,
        "virtual_s": virtual_s,
        "frames_per_vs": frames / virtual_s if virtual_s > 0 else None,
        "wall_s": wall_s,
        "trace_counts": traces,
        "shard_occupancy": occupancy,
        "report": sched.report(),
    }
    print(f"fleet: {args.streams} streams x {args.ticks} ticks on 1 shard "
          f"({args.device}): {frames} frames in {virtual_s*1e3:.1f}ms virtual "
          f"({doc['frames_per_vs']:.1f} frames/s), wall {wall_s:.2f}s")
    for name, occ in occupancy.items():
        print(f"  {name}: shard occupancy {occ} (traces={traces[name]})")
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True, allow_nan=False)
        print(f"wrote fleet report to {args.json_out}")
    if obs is not None and args.trace_out:
        obs.write_trace(args.trace_out, process_label="fleet")
        print(f"wrote Chrome trace to {args.trace_out} "
              f"({obs.tracer.n_recorded} spans)")
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None,
                    help="decode model architecture (required unless --fleet)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch size (multi-tenant: static slot capacity)")
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--deadline", choices=sorted(POLICY), default="mean")
    ap.add_argument("--streams", type=int, default=0,
                    help="multi-tenant mode: serve N Poisson-arriving streams"
                         " (with --fleet: N camera streams)")
    ap.add_argument("--fleet", action="store_true",
                    help="camera-fleet mode: rung-bucket perception "
                         "scheduling of --streams cameras on one device")
    ap.add_argument("--mesh", default=None,
                    help="fleet mesh spec (not ported yet: multi-device fleet)")
    ap.add_argument("--ticks", type=int, default=40,
                    help="fleet mode: number of scheduler ticks to run")
    ap.add_argument("--json-out", default=None,
                    help="fleet mode: write the machine-readable run report here")
    ap.add_argument("--chaos", default=None, metavar="PLAN",
                    help="fleet mode: fault injection (not ported yet)")
    ap.add_argument("--arrival-rate", type=float, default=100.0,
                    help="multi-tenant Poisson arrival rate (streams/s, simulated)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-token SLO; enables deadline-aware shedding")
    ap.add_argument("--admission", choices=["none", "predictive"],
                    default="predictive")
    ap.add_argument("--anytime", action="store_true",
                    help="degrade-before-shed: a stream about to be shed is "
                         "retried down its SLO-relaxation ladder first")
    ap.add_argument("--degrade-factors", default="1.5,2.5",
                    help="comma-separated SLO relaxation factors tried (in "
                         "order) by --anytime before shedding")
    ap.add_argument("--obs", action="store_true",
                    help="attach the observability layer: periodic text "
                         "dashboard over per-tenant latency metrics "
                         "(multi-tenant mode)")
    ap.add_argument("--obs-period", type=int, default=50,
                    help="dashboard render period in engine steps")
    ap.add_argument("--trace-out", default=None,
                    help="with --obs: write the Chrome trace_event JSON "
                         "(Perfetto-loadable) here at end of run")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    if (args.trace_out or args.obs_period != ap.get_default("obs_period")) \
            and not args.obs:
        ap.error("--trace-out/--obs-period have no effect without --obs")
    if args.obs and args.streams <= 0:
        ap.error("--obs needs multi-tenant mode (--streams N) or --fleet")
    if args.mesh is not None:
        ap.error("--mesh: the multi-device fleet is not ported yet "
                 "(ROADMAP.md Queue 1 step 8)")
    if args.chaos is not None:
        ap.error("--chaos: fault injection is not ported yet "
                 "(ROADMAP.md Queue 1 step 7)")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    if args.fleet:
        if args.streams <= 0:
            ap.error("--fleet needs --streams N (camera stream count)")
        if args.arch is not None:
            ap.error("--fleet serves the perception ladder, not a decode "
                     "arch; drop --arch")
        serve_fleet(args)
        return
    if args.json_out is not None:
        ap.error("--json-out only applies to --fleet")
    if args.arch is None:
        ap.error("--arch is required (unless --fleet)")

    if args.anytime and args.admission == "none":
        ap.error("--anytime needs the predictive admission controller "
                 "(an always-admit engine never sheds, so there is nothing "
                 "to degrade); drop --admission none")
    if args.anytime and args.slo_ms is None:
        ap.error("--anytime degrades per-token SLOs before shedding; "
                 "set --slo-ms")
    if args.degrade_factors != ap.get_default("degrade_factors") and not args.anytime:
        ap.error("--degrade-factors has no effect without --anytime")
    try:
        args.degrade_factors_parsed = tuple(
            float(f) for f in args.degrade_factors.split(",") if f.strip()
        )
    except ValueError:
        ap.error("--degrade-factors must be comma-separated numbers "
                 f"(got {args.degrade_factors!r})")
    if args.anytime and not args.degrade_factors_parsed:
        ap.error("--anytime needs at least one --degrade-factors entry")

    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    params = model.init(seed=0, device=args.device)
    print(f"arch={cfg.name} params={model.num_params()/1e6:.1f}M device={args.device}")
    if args.streams > 0:
        serve_multi_tenant(args, cfg, model, params)
    else:
        serve_single(args, cfg, model, params)


if __name__ == "__main__":
    main()
