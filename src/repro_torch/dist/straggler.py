"""Straggler detection over per-replica step times.

A copy of ``repro.dist.straggler`` (numpy only), kept in the port so that
it imports nothing of the reference.

``StragglerMonitor`` consumes one wall-time vector per step and compares
each replica against the median of the replicas that are still alive:

* ``ratio >= warn_factor``  -> a ``warn`` verdict (logged upstream);
* ``ratio >= drop_factor`` for ``patience`` *consecutive* steps -> a
  ``drop`` verdict, after which the replica is excluded from the healthy
  median and from gradient averaging
  (``repro_torch.dist.collectives.masked_psum_mean`` consumes the
  ``dropped()`` mask as the ``alive`` vector).

A replica whose ratio recovers below ``warn_factor`` resets its patience
streak — transient slowness (GC pause, checkpoint write) never drops a
replica; only sustained drop-level slowness does.

Pass a ``MetricsRegistry`` (``metrics=``) and the monitor publishes its
internal state as gauges after every ``observe`` — per-replica step-time
EWMAs (``straggler_step_ewma_s{replica=i}``) and liveness
(``straggler_alive{replica=i}``) — so trainer and (future)
replica-router decisions are inspectable, not just acted on.  The
registry import is deferred to keep ``dist`` free of module-load
upward imports.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class StragglerVerdict:
    replica: int
    action: str          # "warn" | "drop"
    ratio: float         # step time / healthy-median step time


class StragglerMonitor:
    def __init__(self, n_replicas: int, warn_factor: float = 2.0,
                 drop_factor: float = 4.0, patience: int = 2, *,
                 metrics=None, ewma: float = 0.3):
        if drop_factor < warn_factor:
            raise ValueError("drop_factor must be >= warn_factor")
        if not 0.0 < ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {ewma}")
        self.n_replicas = n_replicas
        self.warn_factor = float(warn_factor)
        self.drop_factor = float(drop_factor)
        self.patience = int(patience)
        self.metrics = metrics
        self.ewma = float(ewma)
        self._streak = np.zeros(n_replicas, dtype=np.int64)
        self._dropped = np.zeros(n_replicas, dtype=bool)
        self._ewma_s = np.zeros(n_replicas, dtype=np.float64)
        self._seen = False

    def step_ewma_s(self) -> np.ndarray:
        """Per-replica EWMA of observed step seconds (0.0 until fed)."""
        return self._ewma_s.copy()

    def _publish(self) -> None:
        if self.metrics is None:
            return
        from repro_torch.runtime.metrics import labeled

        for r in range(self.n_replicas):
            self.metrics.set_gauge(
                labeled("straggler_step_ewma_s", replica=str(r)),
                float(self._ewma_s[r]))
            self.metrics.set_gauge(
                labeled("straggler_alive", replica=str(r)),
                0.0 if self._dropped[r] else 1.0)

    def observe(self, step_times: Sequence[float]) -> List[StragglerVerdict]:
        """Feed one per-replica step-time vector; returns new verdicts."""
        times = np.asarray(step_times, dtype=np.float64)
        if times.shape != (self.n_replicas,):
            raise ValueError(
                f"expected {self.n_replicas} step times, got {times.shape}")
        if self._seen:
            self._ewma_s = (1.0 - self.ewma) * self._ewma_s \
                + self.ewma * times
        else:
            self._ewma_s = times.copy()
            self._seen = True
        verdicts = self._judge(times)
        self._publish()
        return verdicts

    def _judge(self, times: np.ndarray) -> List[StragglerVerdict]:
        alive = ~self._dropped
        if not alive.any():
            return []
        baseline = float(np.median(times[alive]))
        if baseline <= 0.0:
            return []
        verdicts: List[StragglerVerdict] = []
        for r in np.nonzero(alive)[0]:
            ratio = float(times[r]) / baseline
            if ratio >= self.drop_factor:
                self._streak[r] += 1
                if self._streak[r] >= self.patience:
                    self._dropped[r] = True
                    verdicts.append(StragglerVerdict(int(r), "drop", ratio))
                else:
                    verdicts.append(StragglerVerdict(int(r), "warn", ratio))
            elif ratio >= self.warn_factor:
                # warn-level slowness neither advances nor resets the
                # drop streak; only recovery below warn_factor resets it
                verdicts.append(StragglerVerdict(int(r), "warn", ratio))
            else:
                self._streak[r] = 0
        return verdicts

    def dropped(self) -> np.ndarray:
        """Boolean mask of replicas dropped so far (True = dropped)."""
        return self._dropped.copy()

    def alive(self) -> np.ndarray:
        """Float mask (1.0 = alive) shaped for ``masked_psum_mean``."""
        return (~self._dropped).astype(np.float32)
