"""Deadline-aware batch closing over the bucketed request queue.

The scheduler owns one decision: *when does a bucket's group of queued
requests become a batch?*  Two triggers, both pure functions of the clock
and the queue:

* **full** — the group reaches ``max_batch`` (the micro-batcher's
  coalescing width): close immediately, batching cannot improve further;
* **deadline** — the group's most urgent request can wait no longer:
  close at ``earliest_deadline - est_exec(bucket, padded_batch)``, the
  latest instant at which the batch can still start and finish on time
  (``est_exec`` from the same
  :class:`~repro_torch.runtime.queue.BucketEstimator` admission uses).  Best-effort requests never trigger this; an optional
  ``max_wait_s`` bounds their sojourn instead.

Within a closing batch requests are ordered by
:meth:`~repro_torch.runtime.queue.Request.order_key` — priority tiers first,
earliest deadline next, arrival order last — and a group larger than
``max_batch`` closes its most urgent ``max_batch`` slice, leaving the
rest queued.  Requests whose deadline fully expired while queued (the
backlog pushed ``now`` past it before any close fired) are shed at poll
time with :class:`~repro_torch.runtime.queue.DeadlineExceededError` instead of
wasting a batch slot on a guaranteed SLO miss.

``poll`` is deterministic: given the same queue state and the same clock
reading it always closes the same batches in the same order (buckets in
first-seen order).  All the virtual-clock tests drive it directly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.clock import Clock
from repro_torch.runtime.metrics import MetricsRegistry, labeled
from repro_torch.runtime.queue import (DeadlineExceededError, Request,
                                       RequestQueue)


@dataclasses.dataclass
class ClosedBatch:
    """One bucket's batch, closed and ready for execution."""

    bucket: object
    requests: List[Request]
    closed_at: float
    reason: str              # "full" | "deadline" | "flush"


@dataclasses.dataclass(frozen=True)
class BatchProfile:
    """Per-bucket batching limits: the coalescing width and the padded
    executable ladder a bucket's group closes against.  The single-engine
    runtime has one profile for every bucket; a fleet resolves one per
    servable, so every servable's own micro-batcher geometry governs its
    buckets inside the one shared close loop."""

    max_batch: int
    batch_sizes: Tuple[int, ...]


def _pad_batch(sizes: Sequence[int], n: int) -> int:
    for b in sizes:
        if b >= n:
            return b
    return sizes[-1]


class WeightedFairPicker:
    """Deterministic stride scheduling over ready batches.

    When one poll closes batches from several flows (servables, in the
    fleet), the order they are handed to the worker is the order they
    execute — first-seen bucket order would let a hot flow with many
    ready buckets delay a cold flow's single batch every round.  Stride
    scheduling fixes that: each flow carries a *pass* value advanced by
    ``1/weight`` per batch picked, and the picker always takes the
    lowest-pass flow next, so over time flows execute in proportion to
    their weights regardless of how many buckets each keeps ready.

    Deterministic: pass state is explicit, ties break by position in the
    closed list (itself deterministic), and a flow first seen mid-run
    starts at the current virtual time instead of zero so it cannot
    monopolize the worker to "catch up".
    """

    def __init__(
        self,
        flow_of: Callable[[ClosedBatch], object],
        weights: Optional[Dict[object, float]] = None,
        default_weight: float = 1.0,
    ):
        self.flow_of = flow_of
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        self._pass: Dict[object, float] = {}
        self._vt = 0.0

    def weight(self, flow) -> float:
        w = float(self.weights.get(flow, self.default_weight))
        if w <= 0:
            raise ValueError(f"flow {flow!r} has non-positive weight {w}")
        return w

    def _pass_of(self, flow) -> float:
        if flow not in self._pass:
            self._pass[flow] = self._vt
        return self._pass[flow]

    def order(self, batches: List[ClosedBatch]) -> List[ClosedBatch]:
        if len(batches) < 2:
            for b in batches:           # singleton batches still advance
                self._advance(self.flow_of(b))
            return batches
        remaining = list(batches)
        out: List[ClosedBatch] = []
        while remaining:
            i = min(range(len(remaining)),
                    key=lambda j: (self._pass_of(self.flow_of(remaining[j])),
                                   j))
            batch = remaining.pop(i)
            self._advance(self.flow_of(batch))
            out.append(batch)
        return out

    def _advance(self, flow) -> None:
        p = self._pass_of(flow)
        self._vt = p
        self._pass[flow] = p + 1.0 / self.weight(flow)


class BatchScheduler:
    def __init__(
        self,
        queue: RequestQueue,
        *,
        max_batch: int,
        batch_sizes: Optional[Sequence[int]] = None,
        estimator=None,
        clock: Optional[Clock] = None,
        metrics: Optional[MetricsRegistry] = None,
        max_wait_s: Optional[float] = None,
        close_margin_s: float = 0.0,
        profile_for=None,
        picker: Optional[WeightedFairPicker] = None,
        margin_ewma: float = 0.2,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.queue = queue
        self.max_batch = int(max_batch)
        # The padded batch ladder the executables were warmed for: a group
        # of n requests runs as a pad_batch(n)-wide executable, so the
        # deadline trigger estimates at that width, not at n.
        self.batch_sizes = tuple(batch_sizes) if batch_sizes else tuple(
            sorted({min(2 ** i, max_batch)
                    for i in range(max_batch.bit_length() + 1)})
        )
        self.estimator = estimator or queue.estimator
        self.clock = clock or queue.clock
        self.metrics = metrics or queue.metrics
        self.max_wait_s = max_wait_s
        # Safety slack subtracted from every deadline trigger: the worker
        # wakes *at* the trigger plus scheduling jitter, so with a
        # microscopic exec estimate a zero-margin close would land past
        # the deadline and hard-expire the very request it was closing
        # for.  The constructor value is a *floor*: observed wake-up
        # lateness (fed by the worker loop through ``observe_wakeup``)
        # folds into an EWMA and the effective margin is
        # max(floor, ewma) — the margin adapts to the jitter this host
        # actually exhibits instead of trusting a constant.  Real-clock
        # runtimes pass a few milliseconds as the floor; the virtual
        # clock has no jitter and never observes, so tests keep the
        # exact 0.0 default.
        self.close_margin_s = float(close_margin_s)
        self.margin_ewma = float(margin_ewma)
        self._jitter_ewma_s = 0.0
        # ``profile_for(bucket) -> BatchProfile`` resolves per-bucket
        # batching limits (fleet: per-servable micro-batcher geometry);
        # None keeps the scheduler-wide max_batch/batch_sizes for every
        # bucket, which is the single-engine behavior, bit for bit.
        self.profile_for = profile_for
        # Orders each poll's ready batches across flows (weighted-fair in
        # the fleet); None keeps bucket-first-seen order.
        self.picker = picker

    # ------------------------------------------------------------------

    def _profile(self, bucket) -> BatchProfile:
        if self.profile_for is not None:
            prof = self.profile_for(bucket)
            if prof is not None:
                return prof
        return BatchProfile(self.max_batch, self.batch_sizes)

    def observe_wakeup(self, lateness_s: float) -> None:
        """Fold one observed worker wake-up lateness into the margin EWMA
        (called by the loop when a timed wait targeted at a close trigger
        lands past it)."""
        lateness = max(float(lateness_s), 0.0)
        self._jitter_ewma_s = ((1 - self.margin_ewma) * self._jitter_ewma_s
                               + self.margin_ewma * lateness)

    @property
    def effective_close_margin_s(self) -> float:
        """The margin deadline triggers actually subtract: the configured
        constant as a floor, raised by the EWMA of measured wake jitter."""
        return max(self.close_margin_s, self._jitter_ewma_s)

    def padded_width(self, n: int, bucket=None) -> int:
        """The executable width a batch of ``n`` requests actually runs at
        (the warmed power-of-two ladder) — also the key measured execution
        times are recorded under, so estimates and observations meet.
        ``bucket`` resolves a per-bucket ladder when profiles are set."""
        sizes = (self.batch_sizes if bucket is None
                 else self._profile(bucket).batch_sizes)
        return _pad_batch(sizes, n)

    def _est(self, bucket, n: int) -> float:
        if self.estimator is None:
            return 0.0
        return self.estimator.estimate(bucket, self.padded_width(n, bucket))

    def close_time(self, bucket, group: Sequence[Request]) -> float:
        """The instant this group's deadline trigger fires (inf = never)."""
        if not group:
            return math.inf
        if len(group) >= self._profile(bucket).max_batch:
            return -math.inf
        t = math.inf
        deadlines = [r.deadline for r in group if r.deadline is not None]
        if deadlines:
            t = (min(deadlines) - self._est(bucket, len(group))
                 - self.effective_close_margin_s)
        if self.max_wait_s is not None:
            # Sojourn bound for *best-effort* requests only: a deadline
            # carries its own close trigger, and capping it here would let
            # a short max_wait preempt deadline-aware coalescing.
            best_effort = [
                r.arrival for r in group if r.deadline is None]
            if best_effort:
                t = min(t, min(best_effort) + self.max_wait_s)
        return t

    def next_close_time(self) -> Optional[float]:
        """Earliest pending trigger across all groups (the worker loop's
        wait horizon); None when the queue is empty."""
        with self.queue.lock:
            times = [
                self.close_time(bucket, group)
                for bucket, group in self.queue.groups().items()
            ]
        return min(times) if times else None

    # ------------------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> List[ClosedBatch]:
        """Shed the unmeetable, close every fired trigger; deterministic."""
        now = self.clock.now() if now is None else now
        closed: List[ClosedBatch] = []
        with self.queue.lock:
            # Snapshot: closing mutates the group dict under iteration.
            for bucket, group in list(self.queue.groups().items()):
                self._shed_expired(bucket, group, now)
                max_batch = self._profile(bucket).max_batch
                while len(group) >= max_batch:
                    batch = sorted(
                        group, key=Request.order_key)[: max_batch]
                    self.queue.remove(batch)
                    self.metrics.inc("batches_full")
                    closed.append(ClosedBatch(bucket, batch, now, "full"))
                if group and now >= self.close_time(bucket, group):
                    batch = sorted(group, key=Request.order_key)
                    self.queue.remove(batch)
                    self.metrics.inc("batches_deadline")
                    closed.append(ClosedBatch(bucket, batch, now, "deadline"))
        if self.picker is not None:
            closed = self.picker.order(closed)
        return closed

    def flush(self, now: Optional[float] = None) -> List[ClosedBatch]:
        """Close everything queued, in max_batch chunks per bucket."""
        now = self.clock.now() if now is None else now
        closed: List[ClosedBatch] = []
        with self.queue.lock:
            for bucket, group in list(self.queue.groups().items()):
                ordered = sorted(group, key=Request.order_key)
                self.queue.remove(ordered)
                max_batch = self._profile(bucket).max_batch
                for lo in range(0, len(ordered), max_batch):
                    chunk = ordered[lo: lo + max_batch]
                    self.metrics.inc("batches_flush")
                    closed.append(ClosedBatch(bucket, chunk, now, "flush"))
        return closed

    # ------------------------------------------------------------------

    def _shed_expired(self, bucket, group: List[Request], now: float) -> None:
        """Fail queued requests whose deadline has fully expired.

        Expiry is strict (``now > deadline``), deliberately *looser* than
        the close trigger: the close at ``deadline - est`` fires first, so
        a poll landing marginally after that boundary still closes the
        batch (a near-miss executes and is accounted as ``slo_missed``)
        rather than shedding the most urgent request over scheduling
        jitter.  Only a request the loop never managed to close — backlog
        pushed ``now`` past its whole deadline — is shed, which under
        overload is what frees the queue for requests that can still win.
        """
        doomed = [
            r for r in group
            if r.deadline is not None and now > r.deadline
        ]
        if not doomed:
            return
        self.queue.remove(doomed)
        for r in doomed:
            self.metrics.inc("shed_expired")
            if r.tenant is not None:
                self.metrics.inc(labeled("shed_expired", tenant=r.tenant))
            if r.trace is not None:
                r.trace.span("queue_wait", start=r.arrival,
                             close_reason="shed_expired").finish(at=now)
                r.trace.finish(status="shed_expired", at=now)
            if not r.future.done():
                r.future.set_exception(DeadlineExceededError(
                    f"deadline {r.deadline:.6f} expired at {now:.6f}"))
