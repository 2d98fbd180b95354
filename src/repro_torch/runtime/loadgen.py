"""Open-loop Poisson load generation against a :class:`ServeRuntime`.

The load generator of ``launch.serve_gcn --runtime-async`` and of
``chip_smoke.py``'s async phase, so both measure the same thing by
construction.  Open loop means the generator never waits
for the server: arrival times are pre-drawn (seeded exponential
inter-arrival gaps at the offered QPS) and a submission that the server
sheds is counted, not retried — which is what lets overload actually
overload.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from repro_torch.runtime.queue import AdmissionError


def run_open_loop(
    rt,
    requests: Sequence[Sequence[int]],
    *,
    qps: float,
    deadline_s: float,
    rng: np.random.Generator,
    result_timeout_s: float = 60.0,
) -> float:
    """Offer ``requests`` at Poisson-``qps``; returns the wall seconds.

    Each request carries the absolute deadline ``arrival + deadline_s``.
    Admission rejections and queued-then-expired sheds are left to the
    runtime's metrics registry — the caller reads the outcome from
    ``rt.metrics.snapshot()``.
    """
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    gaps = rng.exponential(1.0 / qps, size=len(requests))
    # Pre-warm every request's subgraph extraction before the clock
    # starts: submit() re-prepares, but the sampler's registry caches by
    # request contents, so the in-loop prep collapses to a memory hit.
    # Without this, cold k-hop extraction on the generator thread at
    # sub-prep inter-arrival gaps would throttle the generator itself and
    # report its own lag as server shed-rate — the opposite of open loop.
    for seeds in requests:
        rt.engine._prepare(seeds)
    t_start = rt.clock.now()
    arrivals = t_start + np.cumsum(gaps)
    pending = []
    for seeds, arrival in zip(requests, arrivals):
        lag = arrival - rt.clock.now()
        if lag > 0:
            time.sleep(lag)
        try:
            pending.append(rt.submit(seeds, deadline=arrival + deadline_s))
        except AdmissionError:
            pass              # counted by the registry
    for req in pending:
        try:
            req.future.result(timeout=result_timeout_s)
        except Exception:
            pass              # shed while queued / failed; also counted
    return rt.clock.now() - t_start
