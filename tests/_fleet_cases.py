"""Fleet scripts written once against a fleet module and its runtime
module, run through both packages (``repro.fleet`` + ``repro.runtime``,
``repro_torch.fleet`` + ``repro_torch.runtime``) on a ``VirtualClock``.

Each ``case_*`` is a pure case of ``tests/test_fleet.py`` (and one of
``predictive_unload``) over a :func:`fake_servable` that echoes its
payloads; it returns a transcript — batch membership, order and close
reasons, verdicts, per-tenant shed and reject accounting, inflight states,
``loads``/``unloads`` and every servable's load/unload/run log, and
``metrics.snapshot()`` — that must be the same in both packages.  Imports
numpy only; the packages come in as arguments.
"""

from importlib import import_module

import numpy as np

_FAKES = {}


def fake_servable(F, R):
    """The ``FakeServable`` of ``tests/test_fleet.py`` over ``F.Servable``:
    a fixed estimate, echoed payloads, and a log of its loads, unloads and
    batch sizes."""
    if F.__name__ in _FAKES:
        return _FAKES[F.__name__]
    BatchProfile = import_module(R.__name__ + ".scheduler").BatchProfile

    class FakeServable(F.Servable):
        def __init__(self, key, *, est=0.01, max_batch=4, cost=1.0,
                     bucket="b0"):
            self.key = key
            self.bucket_name = bucket
            self.max_batch_ = max_batch
            self._cost = cost
            self.loads = 0
            self.unloads = 0
            self.ran = []       # batch sizes, in execution order
            self.log = []       # ("load" | "unload" | batch size), in order

            class _Est:
                def estimate(self_, bucket_, batch=1):
                    return est

                def observe(self_, *a):
                    pass

            self._e = _Est()

        def load(self):
            self.loads += 1
            self.log.append("load")

        def unload(self):
            self.unloads += 1
            self.log.append("unload")

        @property
        def estimator(self):
            return self._e

        def profile(self):
            sizes, b = [1], 1
            while b < self.max_batch_:
                b = min(b * 2, self.max_batch_)
                sizes.append(b)
            return BatchProfile(self.max_batch_, tuple(sizes))

        def cost_units(self):
            return self._cost

        def prepare(self, payload):
            class P:
                pass

            p = P()
            p.bucket = self.bucket_name
            p.payload = tuple(int(x) for x in payload)
            return p

        def run_batch(self, prepared):
            self.ran.append(len(prepared))
            self.log.append(len(prepared))
            return [np.asarray(p.payload, np.float32) for p in prepared]

    _FAKES[F.__name__] = FakeServable
    return FakeServable


def fleet(F, R, *servables, tenants=(), capacity=64, weights=None,
          capacity_units=16.0, tracer=None, predictive_unload=False):
    """``(clock, manager, runtime, batch log)`` of a fleet over
    ``servables`` on a fresh ``VirtualClock``."""
    clock = R.VirtualClock()
    mgr = F.FleetManager(capacity_units=capacity_units, clock=clock,
                         predictive_unload=predictive_unload)
    for sv in servables:
        mgr.register(sv)
    rt = F.FleetRuntime(mgr, tenants=F.TenantTable(tenants), clock=clock,
                        capacity=capacity, weights=weights, tracer=tracer)
    return clock, mgr, rt, log_batches(rt)


def log_batches(rt) -> list:
    """``(servable, inner bucket, [seq], reason, closed_at)`` of every
    batch the runtime's loop executes (servable None outside a fleet)."""
    log = []
    execute = rt.loop.execute

    def logged(batch):
        log.append((getattr(batch.bucket, "servable", None),
                    getattr(batch.bucket, "inner", batch.bucket),
                    [r.seq for r in batch.requests], batch.reason,
                    batch.closed_at))
        return execute(batch)

    rt.loop.execute = logged
    return log


def verdict(fn, *args, **kw):
    """The name of what ``fn`` raised, or ``"ok"``."""
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — the verdict is the record
        return type(e).__name__
    return "ok"


def outcome(req):
    if req.future.cancelled():
        return "cancelled"
    if not req.future.done():
        return "pending"
    exc = req.future.exception(timeout=0)
    if exc is not None:
        return type(exc).__name__
    return np.asarray(req.future.result(timeout=0)).tolist()


def logs(*servables) -> dict:
    return {sv.key: (sv.loads, sv.unloads, list(sv.log))
            for sv in servables}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def case_two_servables(F, R):
    def run_once():
        Fake = fake_servable(F, R)
        a, b = Fake("a", est=0.01), Fake("b", est=0.05)
        clock, _, rt, log = fleet(F, R, a, b)
        rt.submit("a", [1], deadline_s=1.0)
        rt.submit("b", [2], deadline_s=1.0)
        events = []
        for _ in range(8):
            nxt = rt.scheduler.next_close_time()
            if nxt is None:
                break
            clock.set_time(max(nxt, clock.now()))
            for batch in rt.scheduler.poll():
                events.append((round(clock.now(), 6),
                               batch.bucket.servable,
                               len(batch.requests)))
                rt.loop.execute(batch)
        return events, log, rt.metrics.snapshot()

    return [run_once(), run_once()]


def case_no_mixed_buckets(F, R):
    Fake = fake_servable(F, R)
    a, b = Fake("a", bucket="same"), Fake("b", bucket="same")
    clock, _, rt, log = fleet(F, R, a, b)
    reqs = [rt.submit("a", [1]), rt.submit("b", [2])]
    groups = len(rt.queue.groups())
    rt.drain()
    return [groups, a.ran, b.ran, log, [outcome(r) for r in reqs],
            rt.metrics.snapshot()]


def case_per_servable_profile(F, R):
    Fake = fake_servable(F, R)
    a, b = Fake("a", max_batch=2), Fake("b", max_batch=4)
    clock, _, rt, _ = fleet(F, R, a, b)
    for i in range(2):
        rt.submit("a", [i])
        rt.submit("b", [i])
    closed = rt.scheduler.poll()
    return [[(c.bucket.servable, len(c.requests), c.reason) for c in closed],
            rt.queue.depth]


def case_weighted_fair_pick(F, R):
    picker = R.WeightedFairPicker(flow_of=lambda b: b,
                                  weights={"hot": 1.0, "cold": 1.0})
    first = picker.order(["hot", "hot", "hot", "cold", "hot"])
    picker = R.WeightedFairPicker(flow_of=lambda b: b[0],
                                  weights={"h": 2.0, "c": 1.0})
    picks = picker.order([("h", i) for i in range(20)]
                         + [("c", i) for i in range(20)])
    return [first, picks]


def case_quota(F, R):
    Fake = fake_servable(F, R)
    clock, _, rt, log = fleet(
        F, R, Fake("a"), tenants=[F.TenantPolicy("hot", qps=1.0, burst=2)])
    out = [verdict(rt.submit, "a", [0], tenant="hot"),
           verdict(rt.submit, "a", [1], tenant="hot")]
    out += [verdict(rt.submit, "a", [9], tenant="hot") for _ in range(3)]
    out.append(rt.tenants.state("hot"))
    clock.advance(1.0)
    out += [verdict(rt.submit, "a", [2], tenant="hot"),
            verdict(rt.submit, "a", [9], tenant="hot"),
            verdict(rt.submit, "a", [3], tenant="other"),
            verdict(rt.submit, "a", [4])]
    rt.drain()
    return out + [log, rt.tenants.state("hot"), rt.metrics.snapshot()]


def case_inflight_cap(F, R):
    Fake = fake_servable(F, R)
    clock, _, rt, log = fleet(
        F, R, Fake("a"), tenants=[F.TenantPolicy("t", max_inflight=2)])
    r1 = rt.submit("a", [0], tenant="t")
    rt.submit("a", [1], tenant="t")
    out = [verdict(rt.submit, "a", [2], tenant="t"),
           rt.tenants.state("t")]
    rt.drain()
    out += [outcome(r1), rt.tenants.state("t"),
            verdict(rt.submit, "a", [3], tenant="t")]
    return out + [log, rt.metrics.snapshot()]


def case_inflight_release(F, R):
    Fake = fake_servable(F, R)
    clock, _, rt, _ = fleet(
        F, R, Fake("a"), tenants=[F.TenantPolicy("t", max_inflight=1)])
    r = rt.submit("a", [0], tenant="t")
    out = [rt.cancel(r), rt.tenants.state("t"), outcome(r)]
    r2 = rt.submit("a", [1], tenant="t", deadline_s=0.5)
    clock.advance(2.0)
    rt.scheduler.poll()
    return out + [outcome(r2), rt.tenants.state("t"),
                  rt.metrics.snapshot()]


def case_slo_class(F, R):
    Fake = fake_servable(F, R)
    clock, _, rt, _ = fleet(
        F, R, Fake("a"),
        tenants=[F.TenantPolicy("gold", priority=2, deadline_s=1.5)])
    r = rt.submit("a", [0], tenant="gold")
    r2 = rt.submit("a", [1], tenant="gold", priority=0, deadline_s=9.0)
    r3 = rt.submit("a", [2], tenant="anon")
    return [(r.priority, r.deadline, r.tenant), (r2.priority, r2.deadline),
            (r3.priority, r3.deadline, r3.tenant), clock.now()]


def case_hot_vs_cold(F, R):
    Fake = fake_servable(F, R)
    clock, _, rt, log = fleet(
        F, R, Fake("a", est=0.01, max_batch=4),
        tenants=[F.TenantPolicy("hot", qps=1.0, burst=2),
                 F.TenantPolicy("cold", priority=1)],
        capacity=8)
    hot = [verdict(rt.submit, "a", [i], tenant="hot", deadline_s=5.0)
           for i in range(10)]
    cold = [rt.submit("a", [100 + i], tenant="cold", deadline_s=1.0)
            for i in range(3)]
    clock.advance(1.0)
    rt.drain()
    return [hot, [outcome(r) for r in cold], log, rt.metrics.snapshot()]


def case_unknown_servable(F, R):
    Fake = fake_servable(F, R)
    clock, mgr, rt, _ = fleet(F, R, Fake("a"))
    out = [verdict(rt.submit, "nope", [0], tenant="t"),
           rt.tenants.state("t"), verdict(mgr.servable, "ghost")]
    return out + [rt.metrics.snapshot()]


def case_lazy_load_lru(F, R):
    Fake = fake_servable(F, R)
    a, b, c = (Fake(k, cost=1.0) for k in "abc")
    mgr = F.FleetManager(capacity_units=2.0)
    for sv in (a, b, c):
        mgr.register(sv)
    out = [mgr.loaded("a"), a.loads]
    for key in "abacb":
        mgr.resolve(key)
        out.append((key, mgr.loads, mgr.unloads,
                    [mgr.loaded(k) for k in "abc"]))
    return out + [logs(a, b, c), mgr.keys()]


def case_weighted_costs(F, R):
    Fake = fake_servable(F, R)
    big, small = Fake("big", cost=3.0), Fake("small", cost=1.0)
    mgr = F.FleetManager(capacity_units=3.5)
    mgr.register(big)
    mgr.register(small)
    out = [verdict(mgr.register, Fake("big"))]
    mgr.resolve("big")
    mgr.resolve("small")
    out += [logs(big, small), mgr.loaded("big"), mgr.loaded("small"),
            verdict(mgr.servable, "ghost"), mgr.loads, mgr.unloads]
    return out


def case_serve_through_reload(F, R):
    Fake = fake_servable(F, R)
    a, b = Fake("a", cost=1.0), Fake("b", cost=1.0)
    clock, mgr, rt, log = fleet(F, R, a, b, capacity_units=1.0)
    reqs = []
    for key, x in (("a", 1), ("b", 2), ("a", 3)):
        reqs.append(rt.submit(key, [x]))
        rt.drain()
    return [[outcome(r) for r in reqs], logs(a, b), mgr.loads, mgr.unloads,
            log, rt.metrics.snapshot()]


def case_predictive_unload(F, R):
    """Capacity for two of three servables: ``a`` sees a burst of
    arrivals, then ``b`` one, so ``b`` is the most recently used and
    ``a`` the least.  Loading ``c`` evicts ``a`` under LRU and ``b`` (the
    lower arrival rate) under ``predictive_unload``."""
    Fake = fake_servable(F, R)
    out = []
    for predictive in (False, True):
        a, b, c = (Fake(k, cost=1.0) for k in "abc")
        clock, mgr, rt, log = fleet(F, R, a, b, c, capacity_units=2.0,
                                    predictive_unload=predictive)
        for i in range(3):
            clock.advance(0.1)
            rt.submit("a", [i])
        rt.drain()
        clock.advance(5.0)
        rt.submit("b", [9])
        rt.drain()
        clock.advance(0.1)
        rt.submit("c", [7])
        rt.drain()
        out.append([logs(a, b, c), [mgr.loaded(k) for k in "abc"],
                    [mgr.arrival_rate(k) for k in "abc"], mgr.loads,
                    mgr.unloads, log, rt.metrics.snapshot()])
    return out


CASES = {f.__name__[5:]: f for f in (
    case_two_servables, case_no_mixed_buckets, case_per_servable_profile,
    case_weighted_fair_pick, case_quota, case_inflight_cap,
    case_inflight_release, case_slo_class, case_hot_vs_cold,
    case_unknown_servable, case_lazy_load_lru, case_weighted_costs,
    case_serve_through_reload, case_predictive_unload)}
