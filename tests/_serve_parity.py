"""Serving engines of both packages over one toy graph, and one scripted
runtime scenario that drives either package's ``ServeRuntime`` on a
``VirtualClock``.

Shared by ``tests/test_torch_runtime.py`` and ``tests/test_torch_obs.py``
(CPU only: it imports the JAX package).  The toy graph is
``tests/test_serve.py``'s (400 nodes, 1,600 edges, 32 features, 5
classes, hidden 8), built from seed 7 with numpy; the reference's
parameters are carried to the port as numpy.  Engines take the geometry
of ``tests/test_runtime.py`` (fanout 4, ``max_seeds`` 4, ``max_batch`` 4,
base rung 64) and are warmed, so no executable is built, and nothing is
traced into the reference's ledger, while the scenario runs.
"""

import functools
import warnings

import jax
import numpy as np

from repro.graphs.datasets import (DatasetSpec, gcn_normalize,
                                   synthesize_adjacency)
from repro.models.gcn import GCNConfig as JConfig
from repro.models.gcn import init_params as j_init_params
from repro.serve import ServeEngine as JEngine
from repro_torch.core.sparse_formats import CSRMatrix as TCSR
from repro_torch.exec.plan import IMPL_NAMES
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.gcn import GCNConfig as TConfig
from repro_torch.serve import ServeEngine as TEngine

SPEC = DatasetSpec("toy", nodes=400, edges=1_600, feature_dim=32, classes=5)
GEOMETRY = dict(fanout=4, max_seeds=4, max_batch=4, base_bucket_nodes=64)
RTOL = 1e-5
PRECISIONS = ("f32", "bf16", "int8")
#: (port impl, fused) of the engines held against the reference's engine
#: of the same (mapped) impl and fusion.
ENGINES = (("reference", None), ("cuda", None), ("cuda", True))
J_IMPL = {v: k for k, v in IMPL_NAMES.items()}


@functools.lru_cache(maxsize=None)
def toy():
    """``(reference CSR, port CSR, features)`` of the toy graph."""
    j_adj = gcn_normalize(synthesize_adjacency(SPEC, seed=7))
    t_adj = TCSR(indptr=j_adj.indptr, indices=j_adj.indices,
                 data=j_adj.data, shape=j_adj.shape)
    feats = np.random.default_rng(7).standard_normal(
        (SPEC.nodes, SPEC.feature_dim)).astype(np.float32)
    return j_adj, t_adj, feats


def dims(**kw):
    return dict(dict(in_dim=SPEC.feature_dim, hidden_dim=8,
                     out_dim=SPEC.classes), **kw)


@functools.lru_cache(maxsize=None)
def params():
    jcfg = JConfig(**dims())
    return {name: {k: np.asarray(v) for k, v in layer.items()}
            for name, layer in j_init_params(jcfg,
                                             jax.random.PRNGKey(0)).items()}


def reference_engine(impl="reference", precision="f32", fused=None,
                     warm=True, **kw):
    """The JAX package's engine at the port's ``impl`` name."""
    j_adj, _, feats = toy()
    cfg = JConfig(**dims(spmm_impl=J_IMPL[impl]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        engine = JEngine(j_adj, feats, cfg, params=params(),
                         precision=precision, fused=fused,
                         **dict(GEOMETRY, **kw))
    if warm:
        engine.warmup()
    return engine


def port_engine(impl="reference", precision="f32", fused=None, warm=True,
                **kw):
    """The port's engine on the CPU."""
    _, t_adj, feats = toy()
    cfg = TConfig(**dims(spmm_impl=impl))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        engine = TEngine(t_adj, feats, cfg,
                         params=params_from_numpy(params(), "cpu"),
                         precision=precision, fused=fused, device="cpu",
                         **dict(GEOMETRY, **kw))
    if warm:
        engine.warmup()
    return engine


def requests(n=16, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.choice(SPEC.nodes, size=int(rng.integers(1, 5)),
                       replace=False) for _ in range(n)]


def rel_max_err(out, ref) -> float:
    out = np.asarray(out, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return (float(np.max(np.abs(out - ref)))
            / max(float(np.max(np.abs(ref))), 1e-30))


def drive(rt, rounds=64):
    """Step the loop at each close trigger, then drain what is left."""
    for _ in range(rounds):
        rt.loop.step()
        nxt = rt.scheduler.next_close_time()
        if nxt is None:
            break
        if nxt > rt.clock.now():
            rt.clock.set_time(nxt)
    rt.loop.drain()


def log_batches(rt) -> list:
    """Record ``(bucket, [seq], reason, closed_at)`` of every batch the
    runtime's loop executes."""
    log = []
    execute = rt.loop.execute

    def logged(batch):
        log.append(((batch.bucket.nodes, batch.bucket.rows),
                    [r.seq for r in batch.requests], batch.reason,
                    batch.closed_at))
        return execute(batch)

    rt.loop.execute = logged
    return log


def scenario(engine, R, *, tracer=None, feedback=None, n=16):
    """Mixed deadlines (1-3 s), two priority tiers and best-effort
    requests through ``engine.runtime`` on a ``VirtualClock`` at 100 s,
    with a fixed 10 ms execution estimate; the clock advances 0.1 s
    between submits, so the first requests' 1 s deadlines expire before
    the loop first polls and are shed.  Returns each request's output (or
    its exception's name), the batches, the metrics snapshot and the
    runtime."""
    clock = R.VirtualClock(start=100.0)
    if tracer is not None:
        tracer.clock = clock
    rt = engine.runtime(capacity=64, clock=clock,
                        estimator=R.FixedEstimator(0.01), tracer=tracer,
                        feedback=feedback)
    log = log_batches(rt)
    reqs = []
    for i, seeds in enumerate(requests(n)):
        deadline = None if i % 5 == 4 else float(1 + i % 3)
        reqs.append(rt.submit(seeds, deadline_s=deadline, priority=i % 2))
        clock.advance(0.1)
    drive(rt)
    outputs = []
    for r in reqs:
        exc = r.future.exception(timeout=10)
        outputs.append(type(exc).__name__ if exc is not None
                       else np.asarray(r.future.result(timeout=10)))
    rt.shutdown()
    return {"outputs": outputs, "batches": log,
            "metrics": rt.metrics.snapshot(), "runtime": rt,
            "requests": reqs}

