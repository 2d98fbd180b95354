"""GCN serving launcher: full-graph, single-node and batched-query
scenarios on the port's FlexVector SpMM kernels, on the card.

Usage:
  python -m repro_torch.launch.serve_gcn --dataset pubmed --impl cuda \
      --requests 64 --batch 8 --fanout 16
  python -m repro_torch.launch.serve_gcn --dataset cora --requests 32 \
      --reduced                          # smoke configuration (hidden 16)
  python -m repro_torch.launch.serve_gcn --dataset pubmed --impl cuda \
      --autoplan --precision auto        # cost-model plans and precisions

The port of ``repro.launch.serve_gcn`` (scenarios ``full``, ``node`` and
``batch``).  The async runtime scenario and the fleet are not ported yet.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.serve import ServeEngine


def build_engine(args, device=None) -> ServeEngine:
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
        device=device,
    )


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
                         "runtime (ROADMAP item A10, not ported yet)")
    ap.add_argument("--mesh", type=int, default=1,
                    help="width of the data mesh to shard batched query "
                         "chunks over (ROADMAP item A9b, not ported yet)")
    ap.add_argument("--fleet-config", default=None,
                    help="multi-tenant fleet scenario (ROADMAP item A12, not "
                         "ported yet)")
    args = ap.parse_args(argv)

    if args.mesh > 1:
        raise NotImplementedError(
            "--mesh: sharding batched query chunks over ranks is ROADMAP "
            "item A9b (the serving mesh), not ported yet")
    if args.fleet_config:
        raise NotImplementedError(
            "--fleet-config: the servable fleet is ROADMAP item A12, not "
            "ported yet")
    if args.runtime_async:
        raise NotImplementedError(
            "--runtime-async: the async runtime is ROADMAP item A10, not "
            "ported yet")

    engine = build_engine(args, device=device)
    t0 = time.perf_counter()
    built = engine.warmup(max_nodes=args.warmup_max_nodes or None)
    reg = engine.registry.stats
    plan = engine.batcher.plan
    impl_note = plan.effective_impl + (
        f" (degraded from {plan.impl})" if plan.degraded else "")
    print(f"[warmup] {built} bucket executables compiled in "
          f"{time.perf_counter() - t0:.1f}s; ladder "
          f"{[(b.nodes, b.rows) for b in engine.batcher.ladder.entries]}; "
          f"impl {impl_note}; device {engine.device}; "
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
        t0 = time.perf_counter()
        engine.query_batch(requests)
        print(engine.report("batch", wall_s=time.perf_counter() - t0).line())

    print(f"[post-warmup compiles] {engine.compile_count - built} "
          f"(warmup built {built}); batcher calls {engine.batcher.calls}; "
          f"registry mem_hits={reg.mem_hits} builds={reg.builds}")


if __name__ == "__main__":
    main()
