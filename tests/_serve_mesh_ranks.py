"""Rank functions of the serving-mesh tests (torch and numpy only).

Run in spawned gloo ranks by ``_torch_dist.run_ranks``.  The toy graph is
``tests/_serve_parity.py``'s (400 nodes, 1,600 edges, 32 features, 5
classes, hidden 8, seed 7), built here with the port's own dataset
helpers so that a rank never imports JAX; the parameters come from the
parent as numpy.  Rank 0 serves a script through a meshed engine and
through an unmeshed one on the same inputs, the other ranks follow.
"""

import contextlib
import io

import numpy as np

SPEC = dict(nodes=400, edges=1_600, feature_dim=32, classes=5)
GEOMETRY = dict(fanout=4, max_seeds=4, max_batch=4, base_bucket_nodes=64)
#: (impl, precision, fused) of each engine a spawn serves
ENGINES = (("reference", "f32", None), ("cuda", "bf16", None),
           ("cuda", "int8", True))


def _toy():
    from repro_torch.graphs.datasets import (DatasetSpec, gcn_normalize,
                                             synthesize_adjacency)

    spec = DatasetSpec("toy", **SPEC)
    adj = gcn_normalize(synthesize_adjacency(spec, seed=7))
    feats = np.random.default_rng(7).standard_normal(
        (spec.nodes, spec.feature_dim)).astype(np.float32)
    return adj, feats


def _engine(params, impl, precision, fused, mesh=None):
    import warnings

    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.gcn import GCNConfig
    from repro_torch.serve import ServeEngine

    adj, feats = _toy()
    cfg = GCNConfig(in_dim=SPEC["feature_dim"], hidden_dim=8,
                    out_dim=SPEC["classes"], spmm_impl=impl)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return ServeEngine(adj, feats, cfg,
                           params=params_from_numpy(params, "cpu"),
                           precision=precision, fused=fused, device="cpu",
                           mesh=mesh, **GEOMETRY)


def _drive(rt):
    for _ in range(64):
        rt.loop.step()
        nxt = rt.scheduler.next_close_time()
        if nxt is None:
            break
        if nxt > rt.clock.now():
            rt.clock.set_time(nxt)
    rt.loop.drain()


def _script(engine, requests):
    """``query``, ``query_batch`` and a traced runtime scenario on a
    ``VirtualClock`` (deadlines 1-3 s, two priorities, a fixed 10 ms
    estimate): the answers, each batch's padded width, the trace dicts
    and the ledger the traced batches recorded."""
    from repro_torch.dist.collectives import LEDGER
    from repro_torch.obs import Tracer
    from repro_torch.runtime import FixedEstimator, VirtualClock

    widths = []
    run = engine.batcher.run

    def logged(params, reqs):
        widths.append(engine.batcher.pad_batch(len(reqs)))
        return run(params, reqs)

    engine.batcher.run = logged
    out = {"query": engine.query(requests[0]),
           "batch": engine.query_batch(requests)}
    clock = VirtualClock(start=100.0)
    tracer = Tracer(clock=clock)
    rt = engine.runtime(capacity=64, clock=clock,
                        estimator=FixedEstimator(0.01), tracer=tracer)
    LEDGER.reset()
    reqs = []
    for i, seeds in enumerate(requests):
        reqs.append(rt.submit(seeds, deadline_s=float(1 + i % 3),
                              priority=i % 2))
        clock.advance(0.1)
    _drive(rt)
    rt.shutdown()
    out["runtime"] = [np.asarray(r.future.result(timeout=10))
                      if r.future.exception(timeout=10) is None
                      else type(r.future.exception(timeout=0)).__name__
                      for r in reqs]
    out["ledger"] = LEDGER.snapshot()
    out["traces"] = [t.to_dict() for t in tracer.drain()]
    out["metrics"] = rt.metrics.snapshot()
    out["widths"] = widths
    del engine.batcher.run
    return out


def serve_mesh_rank(rank, world, params, requests):
    """Each engine of :data:`ENGINES` with ``mesh=`` on every rank; rank 0
    serves :func:`_script` through it and through an unmeshed engine,
    the others follow.  Returns per engine this rank's record."""
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(world, device="cpu")
    out = {}
    for impl, precision, fused in ENGINES:
        engine = _engine(params, impl, precision, fused, mesh=mesh)
        built = engine.warmup()
        rec = {"built": built}
        if rank == 0:
            rec["meshed"] = _script(engine, requests)
            engine.stop_followers()
            engine.stop_followers()       # idempotent
            plain = _engine(params, impl, precision, fused)
            plain.warmup()
            rec["plain"] = _script(plain, requests)
            rec["plain_built"] = plain.compile_count
        else:
            rec["followed"] = engine.follow()
        rec["compiles"] = engine.compile_count
        rec["calls"] = engine.batcher.calls
        rec["mesh_runs"] = dict(engine.batcher.mesh_runs)
        out[(impl, precision, fused)] = rec
    return out


def failing_forward_rank(rank, world, params, requests, failing):
    """A meshed engine whose rank ``failing`` raises in the replay of the
    first sharded forward, after the header and the scatter: rank 0
    serves ``query_batch``, the others follow.  Returns what each rank
    raised (type and message), when (``time.time()``), whether its group
    is still up, and, on rank 0, that ``stop_followers`` returned."""
    import time

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_data_mesh

    engine = _engine(params, "reference", "f32", None,
                     mesh=make_data_mesh(world, device="cpu"))
    engine.warmup()
    if rank == failing:
        def failing_replay(*args, **kw):
            raise RuntimeError(f"rank {rank} fails mid-forward on purpose")

        engine.batcher._replay = failing_replay
    rec = {"raised": None}
    try:
        if rank == 0:
            engine.query_batch(requests[:4])
        else:
            engine.follow()
    except Exception as e:          # noqa: BLE001 - recorded for the test
        rec["raised"] = (type(e).__name__, str(e))
    rec["at"] = time.time()
    rec["group_up"] = dist.is_initialized()
    if rank == 0:
        engine.stop_followers()
        rec["stopped"] = True
    return rec


def serve_cli_rank(rank, world):
    """``serve_gcn.main([... "--mesh", world], device="cpu")`` on every
    rank of the spawned group; returns what this rank printed."""
    from repro_torch.graphs import datasets
    from repro_torch.launch import serve_gcn

    datasets.DATASETS["toy"] = datasets.DatasetSpec("toy", **SPEC)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_gcn.main(["--dataset", "toy", "--reduced", "--requests", "12",
                        "--batch", "4", "--impl", "cuda", "--mesh",
                        str(world)], device="cpu")
    return buf.getvalue()
