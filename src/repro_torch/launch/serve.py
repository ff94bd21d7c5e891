"""Serving launcher: single-stream instrumented decoding, the
multi-tenant continuous-batching runtime under a Poisson arrival stream,
or the camera-fleet perception scheduler, its slot batches sharded over a mesh.

Single stream::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --batch 4 --context 1024 --prompt-len 64 --tokens 32

(``--arch`` takes every arch of the registry; hubert-xlarge is
encoder-only and exits before building the model, as in the reference.)

Multi-tenant load generator (``--streams N``): N tenants arrive as a
Poisson process on the bus broker's simulated clock, are admitted into
``--batch`` padded slots (deadline-aware admission unless
``--admission none``), and the run prints a per-tenant report — mean,
CV, p99, miss rate per stream; ``--anytime`` degrades a stream's SLO down
``--degrade-factors`` before shedding it::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --batch 8 --context 1024 --prompt-len 64 --streams 16

Camera fleet (``--fleet``): N camera streams served by the rung-bucket
scheduler under deterministic virtual time, the slot batches sharded over
``--mesh``'s data axis (``--mesh-devices`` names the mesh's devices, one
may repeat: two shards on one card); ``--chaos PLAN`` injects faults from a
``FaultPlan`` JSON file or a chaos episode (``repro_torch.chaos``) and arms
the scheduler's resilience paths::

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet --streams 8 \
        --ticks 40 --json-out fleet.json [--chaos sensor_stall_storm]
    PYTHONPATH=src python -m repro_torch.launch.serve --fleet --streams 8 \
        --mesh data=2 --mesh-devices cuda:0,cuda:0 --chaos shard_loss_rush_hour

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


def _chaos_plan(spec: str, sids: list, n_ticks: int, n_shards: int):
    """``--chaos``'s ``FaultPlan``: a plan JSON file, or a chaos episode's
    spec compiled over the fleet's streams and ticks at its seed (an
    episode that wants more data shards than the fleet has exits)."""
    import os

    from repro_torch.chaos import FaultPlan, compile_plan, get_chaos_episode
    if os.path.exists(spec):
        return FaultPlan.load(spec)
    try:
        ep = get_chaos_episode(spec)
    except KeyError:
        raise SystemExit(f"--chaos: {spec!r} is neither a FaultPlan JSON file nor a "
                         f"known chaos episode") from None
    if ep.mesh_data > n_shards:
        raise SystemExit(f"--chaos: episode {ep.name!r} wants {ep.mesh_data} data shards, the "
                         f"fleet has {n_shards}: pass --mesh data={ep.mesh_data} (and "
                         f"--mesh-devices to name one device more than once)")
    return compile_plan(ep.spec, sids, n_ticks, seed=ep.seed)


def serve_fleet(args) -> dict:
    """Camera-fleet mode: rung-bucket scheduling of ``--streams`` camera
    streams, slot batches sharded over ``--mesh``'s data axis, ticked under
    deterministic virtual time (seeded ``ModeledStageCost``), with
    ``--chaos``'s faults injected when given.  Returns the JSON report."""
    from repro_torch.batched.scheduler import RungBucketScheduler
    from repro_torch.distributed.sharding import data_shards
    from repro_torch.launch.mesh import make_local_mesh, parse_mesh_spec
    from repro_torch.perception.data import SceneConfig, generate_scene
    from repro_torch.scenarios.replay import ModeledStageCost, replay_ladder

    mesh = None
    if args.mesh:
        devices = args.mesh_devices.split(",") if args.mesh_devices else None
        mesh = make_local_mesh(**parse_mesh_spec(args.mesh), device=args.device,
                               devices=devices)
    n_shards = data_shards(mesh)
    cap = max(args.batch, args.streams)
    if cap % n_shards:
        cap += n_shards - cap % n_shards
    sids = [f"cam{i:02d}" for i in range(args.streams)]
    plan = _chaos_plan(args.chaos, sids, args.ticks, n_shards) if args.chaos else None
    clock = SimClock()
    ladder = replay_ladder()
    cost = ModeledStageCost(ladder, seed=0)
    sched = RungBucketScheduler(ladder, capacity=cap, clock=clock,
                                stage_cost=cost, device=args.device, mesh=mesh)
    obs = None
    if args.obs:
        from repro_torch.obs import Observatory
        obs = Observatory()
        obs.bind_clock(clock)
        sched.set_obs(obs)
    sched.warm(SceneConfig(scenario="city", seed=7))
    budget_s = args.slo_ms * 1e-3 if args.slo_ms is not None else 0.03
    for sid in sids:
        sched.add_stream(sid, budget_s)

    injector = ledger = None
    if plan is not None:
        from repro_torch.chaos import ChaosLedger, FaultInjector, FleetResilience
        ledger = ChaosLedger(obs=obs)
        injector = FaultInjector(plan, ledger=ledger)
        sched.attach_resilience(FleetResilience(ledger=ledger))
        print(f"chaos: plan {plan.name!r} armed "
              f"({len(plan.events)} fault event(s) over {plan.n_ticks} ticks)")

    rng = np.random.default_rng(0)
    frames = 0
    t_wall = time.perf_counter()
    for t in range(args.ticks):
        scenes = {
            sid: generate_scene(
                SceneConfig(scenario="city", rain_mm_per_hour=float(
                    rng.choice([0.0, 0.0, 4.0])), seed=i), t)
            for i, sid in enumerate(sids)}
        if injector is not None:
            cost.contention = injector.latency_scale(t)
            injector.pre_tick(t, sched)
            scenes = injector.filter_scenes(t, scenes)
        res = sched.tick(scenes)
        frames += len(res.outputs)
    wall_s = time.perf_counter() - t_wall
    virtual_s = clock.time()

    occupancy = {name: eng.shard_occupancy()
                 for name, eng in sched.engines.items() if eng.n_active}
    traces = {name: eng.trace_count for name, eng in sched.engines.items()}
    doc = {
        "mesh": args.mesh or None,
        "mesh_devices": [str(d) for d in mesh.devices.flat] if mesh is not None else None,
        "devices": torch.cuda.device_count(),
        "n_shards": n_shards,
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
    if ledger is not None:
        doc["chaos"] = ledger.to_dict()
    print(f"fleet: {args.streams} streams x {args.ticks} ticks on {n_shards} shard(s) "
          f"({args.device if mesh is None else mesh}): {frames} frames in "
          f"{virtual_s*1e3:.1f}ms virtual "
          f"({doc['frames_per_vs']:.1f} frames/s), wall {wall_s:.2f}s")
    if ledger is not None:
        counts = ledger.counts()
        print("chaos ledger: " + (" ".join(
            f"{k}={v}" for k, v in counts.items()) or "no events"))
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
                         "scheduling of --streams cameras, slot batches "
                         "sharded over --mesh")
    ap.add_argument("--mesh", default=None,
                    help="fleet mesh spec, e.g. 'data=2' or 'data=2,model=1' "
                         "(omit for a single device)")
    ap.add_argument("--mesh-devices", default=None,
                    help="with --mesh: comma-separated devices of the mesh, "
                         "repeats allowed (e.g. cuda:0,cuda:0); default every "
                         "visible device of --device's type")
    ap.add_argument("--ticks", type=int, default=40,
                    help="fleet mode: number of scheduler ticks to run")
    ap.add_argument("--json-out", default=None,
                    help="fleet mode: write the machine-readable run report here")
    ap.add_argument("--chaos", default=None, metavar="PLAN",
                    help="fleet mode: inject faults from PLAN — a FaultPlan "
                         "JSON file (repro_torch.chaos) or a chaos-episode "
                         "name (e.g. sensor_stall_storm); arms the "
                         "watchdog/failover resilience machinery")
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
    if args.mesh is not None and not args.fleet:
        ap.error("--mesh only applies to --fleet")
    if args.mesh_devices is not None and args.mesh is None:
        ap.error("--mesh-devices needs --mesh")
    if args.chaos is not None and not args.fleet:
        ap.error("--chaos only applies to --fleet")
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
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    model = Model(cfg)
    params = model.init(seed=0, device=args.device)
    print(f"arch={cfg.name} params={model.num_params()/1e6:.1f}M device={args.device}")
    if args.streams > 0:
        serve_multi_tenant(args, cfg, model, params)
    else:
        serve_single(args, cfg, model, params)


if __name__ == "__main__":
    main()
