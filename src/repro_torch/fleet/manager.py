"""Fleet manager + runtime: many servables behind one close loop.

The port of ``repro.fleet.manager``.  :class:`FleetManager` owns the
servable registry and their residency: a registered servable is *known*
(routable) but loads lazily on first traffic, into a weighted LRU bounded
by ``capacity_units`` — the same :class:`~repro_torch.serve.cache.LruDict`
machinery the artifact registry uses.  Eviction calls the servable's
``unload`` (executables and their CUDA graph memory dropped); the next
request hot-loads it again.

:class:`FleetRuntime` is the multi-tenant analogue of
:class:`~repro_torch.runtime.loop.ServeRuntime`, built from the *same*
queue / scheduler / loop — the fleet changes what flows through them, not
how they work:

* every request's grouping key is a :class:`FleetBucket` ``(servable,
  inner bucket)``, so one queue and one scheduler handle heterogeneous
  shapes without ever mixing servables in a batch;
* :class:`FleetEstimator` dispatches cost queries to the owning
  servable's estimator, and the scheduler's ``profile_for`` resolves
  each servable's own batching geometry, so each servable's deadline
  triggers are priced and chunked exactly as its solo runtime would;
* a :class:`~repro_torch.runtime.scheduler.WeightedFairPicker` orders
  each poll's ready batches across servables so a hot servable with many
  ready buckets cannot monopolize the worker;
* tenant policy (:mod:`repro_torch.fleet.tenancy`) is enforced at
  submit, before queue admission, with per-tenant labeled metrics beside
  the fleet-wide counters.

With exactly one registered :class:`GcnServable` and no tenant limits,
every decision collapses to the single-engine path: same grouping, same
close times, same batch membership, same executables — the answers of
``ServeRuntime``.

Threads.  As in the reference, a load happens inside ``resolve``, which
both the submitting thread (admission) and the worker (``_run_batch``)
call; on the card a load captures CUDA graphs (in ``thread_local`` mode,
so the other thread's replays and readbacks go on).  Three locks keep
that sound without holding admission behind a capture:

* a bookkeeping lock around the LRU and the arrival rates, held only for
  dictionary work, so a submit for a resident servable never waits on a
  capture;
* a residency lock held across each load and the unloads it causes, so
  one servable is never loaded twice at once nor unloaded while it loads;
* one serving lock per servable, held by the worker from its residency
  check through the batch: an unload takes it, so a servable is never
  unloaded under a running batch, and a batch never finds its
  executables gone (which would capture outside ``load``).  A worker
  that finds its servable evicted after ``resolve`` resolves it again.

No thread waits for the residency lock while it holds a serving lock, and
the bookkeeping lock is never held while waiting for either.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

from repro_torch.fleet.servable import EwmaEstimator, Servable
from repro_torch.fleet.tenancy import (
    InflightLimitError,
    MethodDeniedError,
    QuotaExceededError,
    TenantPolicy,
    TenantTable,
)
from repro_torch.runtime.clock import Clock, RealClock
from repro_torch.runtime.loop import RuntimeLoop
from repro_torch.runtime.metrics import MetricsRegistry, labeled
from repro_torch.runtime.queue import (Request, RequestQueue,
                                       UnknownServableError)
from repro_torch.runtime.scheduler import (
    BatchProfile,
    BatchScheduler,
    ClosedBatch,
    WeightedFairPicker,
)
from repro_torch.serve.cache import LruDict


@dataclasses.dataclass(frozen=True)
class FleetBucket:
    """Composite grouping key: a servable's own bucket, namespaced by the
    servable — two servables' identical inner shapes stay separate
    groups, so a batch never spans servables."""

    servable: str
    inner: object


class FleetEstimator:
    """Routes (bucket, batch) cost queries to the owning servable."""

    def __init__(self, manager: "FleetManager"):
        self.manager = manager

    def estimate(self, bucket: FleetBucket, batch: int = 1) -> float:
        return self.manager.servable(bucket.servable).estimator.estimate(
            bucket.inner, batch)

    def observe(self, bucket: FleetBucket, batch: int,
                seconds: float) -> None:
        self.manager.servable(bucket.servable).estimator.observe(
            bucket.inner, batch, seconds)


class FleetManager:
    """Servable registry + residency budget (weighted LRU of loaded
    servables).

    ``predictive_unload`` (opt-in) replaces pure-LRU eviction with an
    arrival-rate-informed choice: each servable's instantaneous arrival
    rate (1 / inter-arrival gap, folded through the same
    :class:`~repro_torch.fleet.servable.EwmaEstimator` machinery the cost
    estimators use) breaks residency ties, so a bursty-but-recent
    servable is not evicted ahead of one whose traffic is dying.  The
    victim is the resident servable with the *lowest* smoothed arrival
    rate; equal rates fall back to LRU order, and with no recorded
    arrivals every rate is 0.0 — pure LRU, the historical behaviour.
    ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, *, capacity_units: float = 8.0,
                 predictive_unload: bool = False,
                 clock: Optional[Clock] = None):
        self._servables: Dict[str, Servable] = {}
        self._loaded = LruDict(capacity_units, on_evict=self._on_evict)
        self.loads = 0
        self.unloads = 0
        self.predictive_unload = predictive_unload
        self.clock = clock or RealClock()
        # Per-servable arrival rate (req/s): cold keys price 0.0, so a
        # never-routed servable is always the preferred victim.
        self._rates = EwmaEstimator(lambda key, batch: 0.0)
        self._last_arrival: Dict[str, float] = {}
        self._lock = threading.RLock()        # bookkeeping (module doc)
        self._residency = threading.Lock()    # loads and their unloads
        self._serving: Dict[str, threading.Lock] = {}
        self._evicted: List[tuple] = []       # LRU victims, not unloaded yet

    def register(self, servable: Servable) -> Servable:
        with self._lock:
            if servable.key in self._servables:
                raise ValueError(
                    f"servable {servable.key!r} already registered")
            self._servables[servable.key] = servable
            self._serving[servable.key] = threading.Lock()
        return servable

    def knows(self, key: str) -> bool:
        return key in self._servables

    def keys(self) -> List[str]:
        return list(self._servables)

    def servable(self, key: str) -> Servable:
        """Registry lookup only — no load, no recency touch."""
        sv = self._servables.get(key)
        if sv is None:
            raise UnknownServableError(
                f"graph_key {key!r} matches no known servable")
        return sv

    def loaded(self, key: str) -> bool:
        with self._lock:
            return key in self._loaded

    def serving(self, key: str) -> threading.Lock:
        """The lock a batch of ``key`` runs under; an unload of ``key``
        waits for it."""
        return self._serving[key]

    def resolve(self, key: str) -> Servable:
        """Route ``key`` to its servable, hot-loading under the budget.

        A first touch (or a touch after eviction) calls ``load()`` —
        capturing the servable's executable grid — and may evict resident
        servable(s) to stay within ``capacity_units``: the
        least-recently-used by default, the lowest-arrival-rate resident
        under ``predictive_unload``.  A resident servable is just a
        recency touch.
        """
        sv = self.servable(key)
        with self._lock:
            self._record_arrival(key)
            if key in self._loaded:
                self._loaded.get(key)      # touch recency
                return sv
        with self._residency:
            with self._lock:
                if key in self._loaded:    # loaded by another thread
                    self._loaded.get(key)
                    return sv
            sv.load()
            self.loads += 1
            with self._lock:
                if self.predictive_unload:
                    self._make_room(sv.cost_units())
                self._loaded.put(key, sv, weight=sv.cost_units())
                victims, self._evicted = self._evicted, []
            for victim_key, victim in victims:
                with self._serving[victim_key]:
                    victim.unload()
                self.unloads += 1
        return sv

    def arrival_rate(self, key: str) -> float:
        """Smoothed arrival rate (req/s) for ``key``; 0.0 before the
        second arrival (one arrival has no inter-arrival gap)."""
        with self._lock:
            return self._rates.estimate(key, 1)

    def _record_arrival(self, key: str) -> None:
        now = self.clock.now()
        last = self._last_arrival.get(key)
        if last is not None and now > last:
            self._rates.observe(key, 1, 1.0 / (now - last))
        self._last_arrival[key] = now

    def _make_room(self, weight: float) -> None:
        """Predictive eviction: pop the resident with the lowest smoothed
        arrival rate (LRU position breaks ties) until ``weight`` fits.

        ``LruDict.pop`` does not fire ``on_evict`` — it is a plain
        removal — so the victim is queued for its unload here; the later
        ``put`` then finds enough headroom and never triggers the LRU
        fallback path.
        """
        while (len(self._loaded) > 0
               and self._loaded.total_weight + weight
               > self._loaded.capacity):
            order = {k: i for i, k in enumerate(self._loaded.keys())}
            victim = min(order, key=lambda k: (self.arrival_rate(k),
                                               order[k]))
            evicted = self._loaded.pop(victim)
            self._loaded.evictions += 1
            self._on_evict(victim, evicted)

    def profile(self, key: str) -> BatchProfile:
        return self.servable(key).profile()

    def _on_evict(self, key: str, sv: Servable) -> None:
        """An eviction under the bookkeeping lock: the unload itself runs
        after it, under the victim's serving lock (``resolve``)."""
        self._evicted.append((key, sv))


class FleetRuntime:
    """Deadline-aware serving over a :class:`FleetManager` + tenants."""

    def __init__(
        self,
        manager: FleetManager,
        *,
        tenants: Optional[TenantTable] = None,
        capacity: Optional[int] = 256,
        clock: Optional[Clock] = None,
        metrics: Optional[MetricsRegistry] = None,
        max_wait_s: Optional[float] = 0.05,
        close_margin_s: Optional[float] = None,
        weights: Optional[Dict[str, float]] = None,
        tracer=None,
    ):
        self.manager = manager
        self.tenants = tenants or TenantTable()
        self.clock = clock or RealClock()
        self.metrics = metrics or MetricsRegistry()
        # Optional repro_torch.obs Tracer: every submit then yields one
        # complete trace (admission, queue wait, execute, per-layer spans),
        # same contract as ServeRuntime's.
        self.tracer = tracer
        self.estimator = FleetEstimator(manager)
        self.queue = RequestQueue(
            capacity=capacity,
            clock=self.clock,
            estimator=self.estimator,
            metrics=self.metrics,
            key_check=manager.knows,
        )
        if close_margin_s is None:
            close_margin_s = 0.0 if getattr(self.clock, "manual", False) \
                else 0.005
        # max_batch/batch_sizes are placeholders here: every bucket is a
        # FleetBucket and profile_for overrides both per servable.
        self.scheduler = BatchScheduler(
            self.queue,
            max_batch=8,
            max_wait_s=max_wait_s,
            close_margin_s=close_margin_s,
            profile_for=lambda fb: manager.profile(fb.servable),
            picker=WeightedFairPicker(
                flow_of=lambda b: b.bucket.servable, weights=weights),
        )
        self.loop = RuntimeLoop(
            self.scheduler, self._run_batch, name="repro-torch-fleet",
            batch_info=(self._batch_info if tracer is not None else None))

    # ------------------------------------------------------------------

    def _batch_info(self, batch: ClosedBatch) -> dict:
        """Plan attributes for traced batches.  GCN servables expose
        their engine; other kinds trace without plan attrs (``{}``)."""
        engine = getattr(
            self.manager.servable(batch.bucket.servable), "engine", None)
        if engine is None:
            return {}
        from repro_torch.obs.trace import engine_batch_info

        info = engine_batch_info(engine, batch.bucket.inner)
        info["attrs"] = dict(info["attrs"],
                             servable=batch.bucket.servable)
        return info

    def _run_batch(self, batch: ClosedBatch) -> List:
        key = batch.bucket.servable
        while True:
            sv = self.manager.resolve(key)
            with self.manager.serving(key):
                if not self.manager.loaded(key):
                    continue      # evicted since resolve: load it again
                if self.tracer is not None:
                    engine = getattr(sv, "engine", None)
                    if engine is not None:
                        # Host-side modeled DRAM ledgering (a replay makes
                        # no dispatch records); gated on tracing so
                        # untraced fleets leave the global LEDGER as is.
                        engine.batcher.record_batch_dram(
                            batch.bucket.inner,
                            self.scheduler.padded_width(
                                len(batch.requests), batch.bucket),
                            int(engine.features.shape[1]))
                return sv.run_batch([r.padded for r in batch.requests])

    def submit(
        self,
        servable: str,
        payload: Sequence[int],
        *,
        tenant: Optional[str] = None,
        deadline_s: Optional[float] = None,
        deadline: Optional[float] = None,
        priority: Optional[int] = None,
    ) -> Request:
        """Admit one request for ``servable`` under ``tenant``'s policy.

        ``priority``/``deadline`` default from the tenant's policy (its
        SLO class); explicit arguments override per request.  Raises an
        ``AdmissionError`` subclass on any rejection — unknown servable,
        tenant ACL/quota/inflight, queue full, infeasible deadline — and
        the same exception lands on the returned-future path, so both
        call shapes observe one verdict.
        """
        if deadline_s is not None and deadline is not None:
            raise ValueError("pass deadline_s (relative) or deadline "
                             "(absolute), not both")
        t0 = self.clock.now()
        trace = None
        if self.tracer is not None:
            trace = self.tracer.trace(
                "request", servable=servable, tenant=tenant,
                n_seeds=len(payload))
        if not self.manager.knows(servable):
            # Short-circuit before prepare(): there is no servable to
            # prepare against.  queue.submit() normally counts
            # "submitted"; this path never reaches it, so count here to
            # keep shed_rate's denominator honest.
            self.metrics.inc("submitted")
            self.metrics.inc("rejected_unknown_servable")
            if tenant is not None:
                self.metrics.inc(labeled(
                    "rejected_unknown_servable", tenant=tenant))
            if trace is not None:
                trace.finish(status="rejected_unknown_servable", at=t0)
            raise UnknownServableError(
                f"graph_key {servable!r} matches no known servable")
        try:
            # ACL before the token bucket: a denied call never burns the
            # tenant's quota.
            self.tenants.check_method(tenant, servable)
        except MethodDeniedError:
            self.metrics.inc("submitted")
            self.metrics.inc("rejected_acl")
            if tenant is not None:
                self.metrics.inc(labeled(
                    "rejected_acl", tenant=tenant, servable=servable))
            if trace is not None:
                trace.finish(status="rejected_acl", at=t0)
            raise
        pol = self.tenants.policy(tenant)
        if priority is None:
            priority = pol.priority
        if deadline_s is None and deadline is None:
            deadline_s = pol.deadline_s
        try:
            self.tenants.acquire(tenant, t0)
        except (QuotaExceededError, InflightLimitError) as e:
            counter = ("rejected_quota" if isinstance(e, QuotaExceededError)
                       else "rejected_inflight")
            self.metrics.inc("submitted")
            self.metrics.inc(counter)
            if tenant is not None:
                self.metrics.inc(labeled(counter, tenant=tenant))
            if trace is not None:
                trace.finish(status=counter, at=t0)
            raise
        sv = self.manager.resolve(servable)
        prepared = sv.prepare(payload)
        t_prep = self.clock.now()
        abs_deadline = (t0 + deadline_s if deadline_s is not None
                        else deadline)
        if trace is not None:
            trace.root.set(priority=priority, deadline=abs_deadline)
            trace.span("prepare", start=t0,
                       bucket=str(prepared.bucket)).finish(at=t_prep)
        req = Request(
            graph_key=servable,
            seeds=tuple(int(x) for x in payload),
            deadline=abs_deadline,
            priority=priority,
            tenant=tenant,
            trace=trace,
            bucket=FleetBucket(servable, prepared.bucket),
            padded=prepared,
            prep_s=t_prep - t0,
        )
        # The inflight slot returns when the future resolves by ANY path
        # — result, failure, shed, cancel — which is exactly the set of
        # events that fire done callbacks.
        req.future.add_done_callback(
            lambda _f, t=tenant: self.tenants.release(t))
        self.queue.submit(req)
        self.loop.notify()
        return req

    def cancel(self, request: Request) -> bool:
        ok = self.queue.cancel(request)
        if ok:
            self.loop.notify()
        return ok

    # ------------------------------------------------------------------

    def start(self) -> "FleetRuntime":
        self.loop.start()
        return self

    def drain(self) -> int:
        if self.loop.running:
            raise RuntimeError(
                "drain() is for the non-threaded mode; with the worker "
                "running, wait on the request futures instead")
        return self.loop.drain()

    def shutdown(self, timeout: Optional[float] = 5.0,
                 drain: bool = False) -> None:
        self.queue.close()
        if drain:
            self.loop.drain()
        self.loop.shutdown(timeout)
        with self.queue.lock:
            leftovers = [
                r for group in self.queue.groups().values() for r in group
            ]
            for r in leftovers:
                self.queue.cancel(r)

    def __enter__(self) -> "FleetRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()


# ---------------------------------------------------------------------------
# Config-driven construction (launch --fleet-config)
# ---------------------------------------------------------------------------


def build_servable(spec: dict, device=None) -> Servable:
    """One servable from a config dict: ``kind`` selects the wrapper.

    ``gcn``: ``{"kind": "gcn", "key": ..., "dataset": ..., "hidden_dim":
    ..., "spmm_impl": ..., "max_batch": ..., "fanout": ..., "cost": ...}``
    — dataset names resolve through ``repro_torch.graphs.load_dataset``.
    ``lm``: ``{"kind": "lm", "key": ..., "arch": ..., "seq_buckets":
    [...], "max_batch": ..., "cost": ...}`` — archs resolve through
    ``repro_torch.configs`` (reduced smoke-size by default).  Either runs
    on ``device`` (the card when None).
    """
    from repro_torch.fleet.servable import GcnServable, LmServable

    kind = spec.get("kind")
    if kind == "gcn":
        from repro_torch.serve.engine import ServeEngine

        engine_kw = {
            k: spec[k]
            for k in ("hidden_dim", "spmm_impl", "max_batch", "max_seeds",
                      "fanout", "hops", "base_bucket_nodes", "precision",
                      "accuracy_budget")
            if k in spec
        }
        engine = ServeEngine.from_dataset(spec["dataset"], device=device,
                                          **engine_kw)
        return GcnServable(engine, key=spec.get("key"),
                           cost=spec.get("cost"))
    if kind == "lm":
        lm_kw = {
            k: spec[k]
            for k in ("seq_buckets", "max_batch", "seed", "full_size")
            if k in spec
        }
        return LmServable(spec["arch"], key=spec.get("key"),
                          cost=spec.get("cost"), device=device, **lm_kw)
    raise ValueError(f"unknown servable kind {kind!r}")


def fleet_from_config(
    config: dict,
    *,
    clock: Optional[Clock] = None,
    metrics: Optional[MetricsRegistry] = None,
    tracer=None,
    device=None,
) -> FleetRuntime:
    """A runnable fleet from the ``--fleet-config`` JSON schema.

    ``{"servables": [spec, ...], "capacity_units": 8.0, "tenants":
    [{"name": ..., "priority": ..., "qps": ..., "burst": ...,
    "max_inflight": ..., "deadline_s": ..., "allowed_methods":
    [...]}, ...], "weights": {key: w, ...}, "queue_capacity": 256,
    "max_wait_s": 0.05}`` — every section optional except
    ``servables``.  Servables run on ``device`` (the card when None).
    """
    manager = FleetManager(
        capacity_units=float(config.get("capacity_units", 8.0)),
        predictive_unload=bool(config.get("predictive_unload", False)),
        clock=clock)
    for spec in config["servables"]:
        manager.register(build_servable(spec, device=device))
    tenants = TenantTable(
        policies=[TenantPolicy(**t) for t in config.get("tenants", [])])
    return FleetRuntime(
        manager,
        tenants=tenants,
        capacity=config.get("queue_capacity", 256),
        clock=clock,
        metrics=metrics,
        max_wait_s=config.get("max_wait_s", 0.05),
        weights=config.get("weights"),
        tracer=tracer,
    )
