"""Open-loop multi-tenant load generation against a :class:`FleetRuntime`.

The port of ``repro.fleet.loadgen``, the fleet analogue of
:func:`repro_torch.runtime.loadgen.run_open_loop`: each tenant's stream is
an independent seeded Poisson process, the streams are merged by arrival
time into one submission order, and a shed submission is counted, not
retried — open loop, so a hot tenant's overload actually overloads *its*
quota instead of throttling the generator.  The pre-warm below may load a
servable (capture its CUDA graphs) on the generator's thread.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.queue import AdmissionError


@dataclasses.dataclass
class TenantLoad:
    """One tenant's offered stream: payloads at Poisson ``qps`` against
    ``servable``, each carrying deadline ``arrival + deadline_s`` (None =
    the tenant policy's SLO class default)."""

    tenant: str
    servable: str
    payloads: Sequence[Sequence[int]]
    qps: float
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.qps <= 0:
            raise ValueError(f"qps must be > 0, got {self.qps}")


def run_open_loop_mix(
    rt,
    loads: Sequence[TenantLoad],
    *,
    rng: np.random.Generator,
    result_timeout_s: float = 120.0,
) -> float:
    """Offer every tenant's stream concurrently; returns wall seconds.

    Arrival schedules are pre-drawn per tenant and merged into one
    timeline, so the interleaving is a pure function of the seed.
    Admission verdicts (quota, inflight, queue, infeasible) land in the
    runtime's metrics registry under both fleet-wide and per-tenant
    labeled counters.
    """
    events: List[Tuple[float, TenantLoad, Sequence[int]]] = []
    for load in loads:
        gaps = rng.exponential(1.0 / load.qps, size=len(load.payloads))
        arrivals = np.cumsum(gaps)
        events.extend(
            (float(a), load, payload)
            for a, payload in zip(arrivals, load.payloads))
        # Pre-warm preparation so cold prep on the generator thread can't
        # masquerade as server-side lag (same rationale as the
        # single-runtime load generator).
        sv = rt.manager.resolve(load.servable)
        for payload in load.payloads:
            sv.prepare(payload)
    events.sort(key=lambda e: e[0])
    t_start = rt.clock.now()
    pending = []
    for offset, load, payload in events:
        lag = (t_start + offset) - rt.clock.now()
        if lag > 0:
            time.sleep(lag)
        try:
            pending.append(rt.submit(
                load.servable, payload,
                tenant=load.tenant,
                deadline=(t_start + offset + load.deadline_s
                          if load.deadline_s is not None else None),
            ))
        except AdmissionError:
            pass              # counted by the registry
    for req in pending:
        try:
            req.future.result(timeout=result_timeout_s)
        except Exception:
            pass              # shed while queued / failed; also counted
    return rt.clock.now() - t_start
