"""GCN serving launcher: full-graph, single-node, batched-query and
async-runtime scenarios on the port's FlexVector SpMM kernels, on the card.

Usage:
  python -m repro_torch.launch.serve_gcn --dataset pubmed --impl cuda \
      --requests 64 --batch 8 --fanout 16
  python -m repro_torch.launch.serve_gcn --dataset cora --requests 32 \
      --reduced                          # smoke configuration (hidden 16)
  python -m repro_torch.launch.serve_gcn --dataset pubmed --impl cuda \
      --autoplan --precision auto        # cost-model plans and precisions
  python -m repro_torch.launch.serve_gcn --dataset pubmed --impl cuda \
      --runtime-async --deadline-ms 200 --qps 150 \
      --trace-json build/traces.json --metrics-prom build/metrics.prom
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve_gcn \
      --dataset pubmed --impl cuda --mesh 2   # the serving mesh
  python -m repro_torch.launch.serve_gcn --fleet-config fleet.json

The port of ``repro.launch.serve_gcn``: scenarios ``full``, ``node`` and
``batch``, the batch open-loop through the async runtime with
``--runtime-async``, traces, metrics and measured plan latencies with the
``repro_torch.obs`` flags, the serving mesh with ``--mesh N`` and the
multi-tenant fleet with ``--fleet-config``.

Under ``--mesh N`` every rank runs this command: the process group comes
from the launcher's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``, as ``torchrun`` sets them), over
NCCL when every rank has a card of its own and over gloo otherwise (two
ranks may share one card); a caller that joined a group before ``main``
serves over that one.  Rank 0 runs the scenarios and prints the report;
the other ranks follow its batched forwards.  A rank's collective waits
at most ``MESH_TIMEOUT`` for the others, so a follower left idle that
long by rank 0 errors out.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.serve import ServeEngine

#: How long a rank of a process group joined for ``--mesh`` waits in one
#: collective (a follower for rank 0's next forward) before it errors out.
MESH_TIMEOUT = datetime.timedelta(minutes=10)


def build_engine(args, device=None, feedback=None, mesh=None) -> ServeEngine:
    growth = None
    if args.ladder_growth:
        growth = ("auto" if args.ladder_growth == "auto"
                  else float(args.ladder_growth))
    return ServeEngine.from_dataset(
        args.dataset,
        hidden_dim=16 if args.reduced else args.hidden,
        spmm_impl=args.impl,
        fanout=args.fanout,
        max_batch=args.batch,
        max_seeds=max(args.seeds_per_request, 1),
        base_bucket_nodes=args.bucket_base,
        autoplan=args.autoplan,
        ladder_growth=growth,
        precision=args.precision,
        accuracy_budget=args.accuracy_budget,
        feedback=feedback,
        mesh=mesh,
        device=device,
    )


def join_mesh(args, device=None):
    """The ``--mesh`` data mesh over the launcher's process group (joined
    here unless the caller joined one); returns ``(mesh, joined here)``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_data_mesh

    joined = False
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(
                f"--mesh {args.mesh} runs one process per rank under a "
                f"launcher that sets RANK and WORLD_SIZE (torchrun)")
        world = int(os.environ.get("WORLD_SIZE", args.mesh))
        on_cards = (device is None or torch.device(device).type == "cuda") \
            and torch.cuda.device_count() >= world
        dist.init_process_group("nccl" if on_cards else "gloo",
                                timeout=MESH_TIMEOUT)
        joined = True
    return make_data_mesh(args.mesh, device=device), joined


def make_tracer(args):
    """One Tracer when any trace/metrics export is requested, else None —
    tracing off keeps the serving hot path exactly as before."""
    if not (args.trace_json or args.metrics_prom):
        return None
    from repro_torch.obs import Tracer

    return Tracer()


def export_observability(args, tracer, metrics) -> None:
    """Write the requested trace/metrics artifacts after a run."""
    from repro_torch.obs import (write_metrics_json, write_prometheus,
                                 write_traces_json)

    if tracer is not None and args.trace_json:
        n = write_traces_json(args.trace_json, tracer.drain())
        print(f"[obs] {n} traces written to {args.trace_json}")
    if args.metrics_prom:
        write_prometheus(args.metrics_prom, metrics)
        print(f"[obs] prometheus metrics written to {args.metrics_prom}")
    if args.metrics_json:
        write_metrics_json(args.metrics_json, metrics)
        print(f"[metrics] snapshot written to {args.metrics_json}")


def run_async_scenario(engine: ServeEngine, requests, args) -> None:
    """Open-loop Poisson load through the deadline-aware runtime
    (``repro_torch.runtime.loadgen``), reporting the SLO picture from the
    metrics registry."""
    from repro_torch.runtime import run_open_loop

    tracer = make_tracer(args)
    with engine.runtime(capacity=args.queue_capacity, tracer=tracer) as rt:
        wall = run_open_loop(
            rt,
            requests,
            qps=args.qps,
            deadline_s=args.deadline_ms / 1e3,
            rng=np.random.default_rng(1),
        )

    snap = rt.metrics.snapshot()
    c = snap["counters"]
    e2e = snap["latency_ms"]["e2e_s"]
    goodput = c["slo_met"] / max(wall, 1e-9)
    shed = c["rejected_queue_full"] + c["rejected_infeasible"] \
        + c["shed_expired"]
    print(
        f"async: offered {c['submitted']} @ {args.qps:.0f} qps, "
        f"completed {c['completed']}, "
        f"shed {shed} (rate {snap['derived']['shed_rate']:.3f}); "
        f"e2e p50 {e2e['p50']:.2f} ms p99 {e2e['p99']:.2f} ms; "
        f"SLO({args.deadline_ms:.0f}ms) attainment "
        f"{snap['derived']['slo_attainment']:.3f}, "
        f"goodput {goodput:.1f} req/s; batches "
        f"full={c['batches_full']} deadline={c['batches_deadline']}"
    )
    if engine.feedback is not None and args.plan_feedback:
        engine.feedback.save(args.plan_feedback)
        print(f"[obs] {len(engine.feedback)} measured plan latencies "
              f"saved to {args.plan_feedback}")
    export_observability(args, tracer, rt.metrics)


def run_fleet_scenario(args, device=None) -> None:
    """Multi-tenant fleet serving from a ``--fleet-config`` JSON file.

    The file follows :func:`repro_torch.fleet.fleet_from_config`'s schema
    plus an optional ``loads`` section driving open-loop traffic::

        {"servables": [{"kind": "gcn", "key": "cora", "dataset": "cora",
                        "hidden_dim": 16, "fanout": 8},
                       {"kind": "gcn", "key": "citeseer",
                        "dataset": "citeseer", "spmm_impl": "cuda"}],
         "capacity_units": 8.0,
         "tenants": [{"name": "hot", "qps": 50, "burst": 8,
                      "deadline_s": 0.2},
                     {"name": "cold", "priority": 1, "deadline_s": 0.2}],
         "weights": {"cora": 1.0, "citeseer": 1.0},
         "loads": [{"tenant": "hot", "servable": "cora", "qps": 80,
                    "requests": 64, "deadline_ms": 200},
                   {"tenant": "cold", "servable": "citeseer", "qps": 5,
                    "requests": 16, "deadline_ms": 200}]}

    A servable of kind ``lm`` raises (ROADMAP A13).
    """
    import json

    from repro_torch.fleet import (GcnServable, TenantLoad,
                                   fleet_from_config, run_open_loop_mix)
    from repro_torch.runtime.metrics import labeled

    with open(args.fleet_config) as f:
        config = json.load(f)
    tracer = make_tracer(args)
    rt = fleet_from_config(config, tracer=tracer, device=device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for key in rt.manager.keys():
        rt.manager.resolve(key)   # load + warm before the clock starts
    print(f"[fleet] {rt.manager.loads} servables loaded in "
          f"{time.perf_counter() - t0:.1f}s: {rt.manager.keys()}")

    loads = []
    for spec in config.get("loads", []):
        sv = rt.manager.servable(spec["servable"])
        if not isinstance(sv, GcnServable):
            raise ValueError(
                f"no payload generator for servable {spec['servable']!r}")
        n = int(spec.get("requests", args.requests))
        n_nodes = sv.engine.graph.n_nodes
        payloads = [
            rng.choice(n_nodes,
                       size=rng.integers(1, args.seeds_per_request + 1),
                       replace=False)
            for _ in range(n)
        ]
        loads.append(TenantLoad(
            tenant=spec["tenant"],
            servable=spec["servable"],
            payloads=payloads,
            qps=float(spec["qps"]),
            deadline_s=float(spec.get("deadline_ms", args.deadline_ms)) / 1e3,
        ))

    with rt:
        wall = run_open_loop_mix(rt, loads, rng=np.random.default_rng(1))

    snap = rt.metrics.snapshot()
    c = snap["counters"]
    print(
        f"fleet: offered {c['submitted']} over {wall:.2f}s, "
        f"completed {c['completed']}, shed rate "
        f"{snap['derived']['shed_rate']:.3f} "
        f"(quota={c['rejected_quota']} inflight={c['rejected_inflight']} "
        f"queue={c['rejected_queue_full']} expired={c['shed_expired']}); "
        f"SLO attainment {snap['derived']['slo_attainment']:.3f}; "
        f"loads {rt.manager.loads} unloads {rt.manager.unloads}"
    )
    for load in loads:
        t = load.tenant
        met = c.get(labeled("slo_met", tenant=t), 0)
        missed = c.get(labeled("slo_missed", tenant=t), 0)
        quota = c.get(labeled("rejected_quota", tenant=t), 0)
        e2e = snap["latency_ms"].get(labeled("e2e_s", tenant=t),
                                     {"p50": 0.0, "p99": 0.0})
        print(f"  tenant {t} -> {load.servable}: slo {met}/{met + missed} "
              f"met, quota-shed {quota}, e2e p50 {e2e['p50']:.2f} ms "
              f"p99 {e2e['p99']:.2f} ms")
    export_observability(args, tracer, rt.metrics)


def main(argv: Optional[Sequence[str]] = None, device=None) -> None:
    """Run the CLI on ``argv`` (the process's arguments by default).

    ``device`` is for callers in Python (the tests pass ``"cpu"``); from
    the shell the engine always runs on the card.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seeds-per-request", type=int, default=4)
    ap.add_argument("--fanout", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--bucket-base", type=int, default=256)
    ap.add_argument("--warmup-max-nodes", type=int, default=0,
                    help="skip warmup of bucket rungs above this node count; "
                         "0 = let the engine derive the reachable bound from "
                         "fanout/hops (uncapped fanout warms every rung)")
    ap.add_argument("--impl", default="reference",
                    choices=["reference", "cuda", "cuda_sparse"])
    ap.add_argument("--precision", default="f32",
                    choices=["f32", "bf16", "int8", "auto"],
                    help="serving numerics: bf16/int8 store the ELL values "
                         "and weights at that width (f32 accumulate); auto "
                         "measures the full-graph logit error per precision "
                         "at warmup and picks the cheapest one within "
                         "--accuracy-budget per bucket rung")
    ap.add_argument("--accuracy-budget", type=float, default=0.05,
                    help="max relative logit error a non-f32 precision may "
                         "introduce before --precision auto rejects it")
    ap.add_argument("--autoplan", action="store_true",
                    help="pick each bucket rung's per-layer plans (impl, "
                         "block sizes, fusion) and the full-graph plan with "
                         "the repro_torch.plan cost model at warmup")
    ap.add_argument("--ladder-growth", default=None,
                    help="bucket ladder growth factor (float), or 'auto' "
                         "for the cost-model search; default: 4, or auto "
                         "when --autoplan is set")
    ap.add_argument("--scenario", default="all",
                    choices=["all", "full", "node", "batch"])
    ap.add_argument("--reduced", action="store_true",
                    help="small hidden dim (smoke configuration)")
    ap.add_argument("--runtime-async", action="store_true",
                    help="drive the batched scenario through the async "
                         "deadline-aware repro_torch.runtime worker loop "
                         "(open-loop Poisson arrivals) instead of the "
                         "synchronous query_batch facade")
    ap.add_argument("--deadline-ms", type=float, default=200.0,
                    help="per-request SLO for --runtime-async (absolute "
                         "deadline = arrival + this)")
    ap.add_argument("--qps", type=float, default=100.0,
                    help="offered load for --runtime-async (Poisson "
                         "arrival rate, requests/s)")
    ap.add_argument("--queue-capacity", type=int, default=256,
                    help="bounded queue size for --runtime-async "
                         "(admission sheds beyond it)")
    ap.add_argument("--metrics-json", default=None,
                    help="write the runtime metrics snapshot to this path "
                         "after --runtime-async")
    ap.add_argument("--trace-json", default=None,
                    help="turn on repro_torch.obs request tracing and write "
                         "the drained traces (JSON) to this path after the "
                         "async run")
    ap.add_argument("--metrics-prom", default=None,
                    help="write the metrics snapshot in Prometheus text "
                         "exposition format to this path after the async "
                         "run")
    ap.add_argument("--plan-feedback", default=None,
                    help="path of a repro_torch.obs PlanFeedback store: "
                         "loaded before warmup (measured latencies steer "
                         "--autoplan) and re-saved with this run's "
                         "measurements after --runtime-async")
    ap.add_argument("--mesh", type=int, default=1,
                    help="width of the data mesh to shard batched query "
                         "chunks over (1 = no mesh); every rank of the "
                         "launcher's process group runs this command, rank "
                         "0 leads and prints")
    ap.add_argument("--fleet-config", default=None,
                    help="JSON file describing a multi-tenant servable "
                         "fleet (GCN servables + tenant policies + loads); "
                         "runs the fleet scenario instead of the "
                         "single-engine ones")
    args = ap.parse_args(argv)

    if args.fleet_config:
        run_fleet_scenario(args, device=device)
        return

    mesh, joined = None, False
    if args.mesh > 1:
        mesh, joined = join_mesh(args, device=device)
    try:
        serve(args, device, mesh)
    finally:
        import torch.distributed as dist

        # a forward that failed part-way has torn the group down already
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def serve(args, device, mesh) -> None:
    """The single-engine scenarios; under a mesh rank 0 runs them and the
    other ranks follow."""
    leader = mesh is None or mesh.get_rank() == 0
    feedback = None
    if args.plan_feedback:
        from repro_torch.obs import PlanFeedback

        feedback = PlanFeedback.load(args.plan_feedback)
        if leader:
            print(f"[obs] plan feedback loaded from {args.plan_feedback}: "
                  f"{len(feedback)} measured (bucket, plan) entries")
    engine = build_engine(args, device=device, feedback=feedback, mesh=mesh)
    t0 = time.perf_counter()
    built = engine.warmup(max_nodes=args.warmup_max_nodes or None)
    if not leader:
        engine.follow()
        return
    try:
        report(args, engine, built, t0)
    finally:
        engine.stop_followers()


def report(args, engine: ServeEngine, built: int, t0: float) -> None:
    """Rank 0's scenarios and report, after warmup."""
    reg = engine.registry.stats
    plan = engine.batcher.plan
    impl_note = plan.effective_impl + (
        f" (degraded from {plan.impl})" if plan.degraded else "")
    print(f"[warmup] {built} bucket executables compiled in "
          f"{time.perf_counter() - t0:.1f}s; ladder "
          f"{[(b.nodes, b.rows) for b in engine.batcher.ladder.entries]}; "
          f"impl {impl_note}; mesh data={args.mesh}; device {engine.device}; "
          f"registry builds={reg.builds} disk_hits={reg.disk_hits}")
    if args.precision != "f32":
        errs = {p: round(e, 5)
                for p, e in sorted(engine.precision_errors.items())}
        picks = {b.rows: engine.batcher.precision_for_bucket(b)
                 for b in engine.batcher.ladder.entries}
        print(f"[precision] requested {args.precision} "
              f"(budget {args.accuracy_budget}); measured errors {errs}; "
              f"per-rung picks {picks}; "
              f"full-graph {engine.resolved_precision}")
    if args.autoplan:
        # the per-layer plans each warmed rung runs
        for (bucket, _), layer_plans in sorted(
                engine.batcher._layer_plans.items()):
            chain = " -> ".join(
                f"L{i}:{p.effective_impl}/{p.block_rows}x{p.block_k}"
                f"x{p.block_f}{'/fused' if p.fused else ''}"
                for i, p in enumerate(layer_plans))
            print(f"[autoplan] bucket ({bucket.nodes}, {bucket.rows}) "
                  f"layers: {chain}")

    rng = np.random.default_rng(0)
    n_nodes = engine.graph.n_nodes
    requests = [
        rng.choice(n_nodes, size=rng.integers(1, args.seeds_per_request + 1),
                   replace=False)
        for _ in range(args.requests)
    ]

    if args.scenario in ("all", "full"):
        for _ in range(3):
            engine.full_forward()
        print(engine.report("full").line())

    if args.scenario in ("all", "node"):
        t0 = time.perf_counter()
        for seeds in requests:
            engine.query(seeds)
        print(engine.report("query", wall_s=time.perf_counter() - t0).line())

    if args.scenario in ("all", "batch"):
        if args.runtime_async:
            run_async_scenario(engine, requests, args)
        else:
            t0 = time.perf_counter()
            engine.query_batch(requests)
            print(engine.report(
                "batch", wall_s=time.perf_counter() - t0).line())

    print(f"[post-warmup compiles] {engine.compile_count - built} "
          f"(warmup built {built}); batcher calls {engine.batcher.calls}; "
          f"registry mem_hits={reg.mem_hits} builds={reg.builds}")


if __name__ == "__main__":
    main()
