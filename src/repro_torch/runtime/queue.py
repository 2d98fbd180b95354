"""Bounded request queue with admission control and cancellation.

A :class:`Request` names the graph it queries, its seed nodes, an
**absolute** deadline on the runtime's clock (``None`` = best effort) and
a priority tier (higher = served first).  Admission happens at submit
time, before a request ever occupies queue space:

* **queue full** — the bounded queue is at capacity; shedding at the door
  under overload is what keeps queued requests meetable instead of
  letting every deadline rot in line;
* **deadline infeasible** — ``deadline - now`` is already smaller than
  the per-bucket execution-time estimate (:class:`BucketEstimator`,
  backed by ``repro_torch.plan.cost``), so the request could not finish
  on time even running alone — rejecting it immediately is strictly
  better than timing it out after it wasted a batch slot.

Rejections raise an :class:`AdmissionError` subclass *and* mark the
request's future with the same exception, so both submit-site callers and
future-holders observe one consistent verdict.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.clock import Clock, RealClock
from repro_torch.runtime.metrics import MetricsRegistry, labeled


class AdmissionError(RuntimeError):
    """A request rejected at the door (never entered the queue)."""


class QueueFullError(AdmissionError):
    pass


class DeadlineInfeasibleError(AdmissionError):
    pass


class QueueClosedError(AdmissionError):
    """The queue stopped accepting work (runtime shutting down)."""


class UnknownServableError(AdmissionError):
    """``Request.graph_key`` routes to no loaded/known servable.

    Raised at admission: a request naming an unknown graph used to
    enqueue anyway and run against whatever graph the engine held — a
    silently *wrong answer*.  Rejecting at the door turns it into a
    loud, immediate verdict at both the submit site and the future.
    """


class DeadlineExceededError(RuntimeError):
    """A queued request shed because its deadline became unmeetable."""


@dataclasses.dataclass(eq=False)
class Request:
    """One seed query travelling through the runtime.

    ``deadline`` is absolute clock time; ``priority`` tiers dominate
    deadlines (tier 1 closes before tier 0 regardless of urgency).  The
    scheduling key is :meth:`order_key`; ``seq`` breaks every tie, so
    equal-priority equal-deadline requests keep arrival order — which is
    what makes the synchronous ``query_batch`` facade bit-identical to
    the historical eager grouping.
    """

    graph_key: str
    seeds: Tuple[int, ...]
    deadline: Optional[float] = None
    priority: int = 0
    # Fleet routing metadata: the tenant the request bills against (None
    # outside multi-tenant serving).  Carried on the request so the loop
    # and scheduler can label completion/shed metrics per tenant without
    # any back-pointer to the tenancy table.
    tenant: Optional[str] = None

    # Optional repro_torch.obs.Trace following this request (duck-typed so the
    # runtime layer never imports obs; None = tracing off, zero cost).
    trace: object = None

    # Filled at admission (the engine prepares/pads before submitting).
    bucket: object = None
    padded: object = None
    arrival: float = 0.0
    seq: int = -1
    prep_s: float = 0.0
    future: Future = dataclasses.field(default_factory=Future)

    # Filled at completion (consumed by latency reports and the facade).
    wait_s: Optional[float] = None
    exec_s: Optional[float] = None

    def order_key(self) -> Tuple[float, float, int]:
        """EDF within priority tiers, arrival order as the tiebreak."""
        return (
            -self.priority,
            self.deadline if self.deadline is not None else math.inf,
            self.seq,
        )

    # NOTE: cancellation goes through RequestQueue.cancel / ServeRuntime
    # .cancel — they dequeue the request and keep the capacity bound and
    # metrics honest.  Cancelling only the future would leave a zombie
    # occupying queue space and executing for a discarded result, so this
    # class deliberately has no cancel() of its own.

    @property
    def cancelled(self) -> bool:
        return self.future.cancelled()


class BucketEstimator:
    """Per-(bucket, batch) execution-time estimate.

    Cold buckets are estimated from the cost model: the coalesced
    block-diagonal operand of a ``batch``-wide bucket chunk is a
    ``batch x rows`` ELL with the ladder's mean sub-row occupancy, and
    one GCN forward runs ``n_layers`` SpMMs over it
    (``repro_torch.plan.cost.bucket_forward_seconds``, the same arithmetic
    the ladder and precision picks use).  ``device`` is the cost model's
    :class:`~repro_torch.plan.cost.DeviceModel`, :data:`~repro_torch.plan.
    cost.H100` when None: the work of the port's aggregation kernels at
    rates fitted on an H100, plus the host time of the ops the dispatch
    launches.  It prices the SpMMs of a forward, not the combination, the
    stacking, the copies into a CUDA graph's buffers or the readback, so
    model estimates are scaled by ``calibration``, and every observed
    batch execution folds into a per-key EWMA: the estimate converges to
    measured reality while staying deterministic before the first
    observation.  Under ``device=cost.TPU_V5E`` every estimate equals the
    reference's.
    """

    def __init__(
        self,
        cfg,
        ladder,
        *,
        calibration: float = 1.0,
        ewma: float = 0.3,
        device=None,
    ):
        from repro_torch.plan import cost as cost_mod

        self.cfg = cfg
        self.ladder = ladder
        self.calibration = float(calibration)
        self.ewma = float(ewma)
        self.device = cost_mod.model_or_default(device)
        self._measured: Dict[Tuple[object, int], float] = {}
        self._model: Dict[Tuple[object, int], float] = {}

    def estimate(self, bucket, batch: int = 1) -> float:
        key = (bucket, int(batch))
        if key in self._measured:
            return self._measured[key]
        est = self._model.get(key)
        if est is None:
            est = self._model_estimate(bucket, int(batch))
            self._model[key] = est
        return est

    def observe(self, bucket, batch: int, seconds: float) -> None:
        key = (bucket, int(batch))
        prev = self._measured.get(key)
        self._measured[key] = (
            float(seconds) if prev is None
            else (1 - self.ewma) * prev + self.ewma * float(seconds)
        )

    def _model_estimate(self, bucket, batch: int) -> float:
        from repro_torch.plan.cost import bucket_forward_seconds

        cfg = self.cfg
        mean_nnz = getattr(self.ladder, "mean_row_nnz", 0.0) or cfg.tau / 2
        # Layer i's SpMM aggregates the combined features, so its F is
        # that layer's *output* width: hidden everywhere but the last
        # (the raw input feature width never reaches an SpMM).
        f_dims = [cfg.hidden_dim] * (cfg.n_layers - 1) + [cfg.out_dim]
        seconds = bucket_forward_seconds(
            rows=int(bucket.rows) * batch,
            n_out_rows=int(bucket.nodes) * batch,
            mean_row_nnz=mean_nnz,
            tau=cfg.tau,
            f_dims=f_dims,
            impl=cfg.spmm_impl,
            block_rows=cfg.block_rows,
            block_k=cfg.block_k,
            block_f=cfg.block_f,
            device=self.device,
        )
        return seconds * self.calibration


class FixedEstimator:
    """Constant estimate — deterministic scaffolding for scheduler tests."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)

    def estimate(self, bucket, batch: int = 1) -> float:
        return self.seconds

    def observe(self, bucket, batch: int, seconds: float) -> None:
        pass


class RequestQueue:
    """Bounded, bucket-grouped queue of admitted requests.

    Groups keep bucket-first-seen order and per-group arrival order; the
    scheduler reads them through :meth:`groups` and removes closed
    requests with :meth:`remove`.  ``capacity=None`` disables the bound
    (the synchronous facade path, which drains within the same call and
    must never shed).
    """

    def __init__(
        self,
        *,
        capacity: Optional[int] = 256,
        clock: Optional[Clock] = None,
        estimator=None,
        metrics: Optional[MetricsRegistry] = None,
        key_check: Optional[Callable[[str], bool]] = None,
    ):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        self.capacity = capacity
        self.clock = clock or RealClock()
        self.estimator = estimator
        self.metrics = metrics or MetricsRegistry()
        # Admission-time routing validation: ``key_check(graph_key)`` must
        # return True for the request to enter the queue.  The single-
        # engine runtime passes "is this my graph"; the fleet passes "is
        # this a registered servable".  None (the default) keeps the
        # historical accept-anything behavior for bare queues.
        self.key_check = key_check
        # Submissions land from caller threads while the worker loop polls
        # and removes; every structural access goes through this lock (an
        # RLock: the scheduler holds it across poll() while calling back
        # into remove()).
        self.lock = threading.RLock()
        self._groups: "Dict[object, List[Request]]" = {}
        self._seq = itertools.count()
        self._closed = False

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        with self.lock:
            return sum(len(g) for g in self._groups.values())

    @property
    def depth(self) -> int:
        return len(self)

    def groups(self) -> Dict[object, List[Request]]:
        """Live view: bucket -> queued requests, insertion-ordered."""
        return self._groups

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Stop admissions: every later :meth:`submit` is rejected with
        :class:`QueueClosedError`.  Already-queued requests are untouched
        — a graceful shutdown closes the door first, then drains what is
        inside.  Idempotent."""
        with self.lock:
            self._closed = True

    # ------------------------------------------------------------------

    def submit(self, request: Request) -> Request:
        """Admit ``request`` or raise an :class:`AdmissionError`.

        The request must arrive with its ``bucket``/``padded`` operands
        already attached (the engine prepares before submitting — the
        bucket is what the feasibility check estimates against).
        """
        now = self.clock.now()
        self.metrics.inc("submitted")
        if request.bucket is None:
            raise ValueError("request must be prepared (bucket) before submit")
        admission = None
        if request.trace is not None:
            admission = request.trace.span("admission", start=now)
        with self.lock:
            if self._closed:
                return self._reject(
                    request, QueueClosedError("queue is closed"),
                    "rejected_closed", admission, now)
            if self.key_check is not None and \
                    not self.key_check(request.graph_key):
                return self._reject(
                    request, UnknownServableError(
                        f"graph_key {request.graph_key!r} matches no "
                        f"known servable"),
                    "rejected_unknown_servable", admission, now)
            if self.capacity is not None and len(self) >= self.capacity:
                return self._reject(
                    request, QueueFullError(
                        f"queue at capacity ({self.capacity})"),
                    "rejected_queue_full", admission, now)
            if request.deadline is not None and self.estimator is not None:
                est = self.estimator.estimate(request.bucket, 1)
                if request.deadline - now < est:
                    return self._reject(
                        request, DeadlineInfeasibleError(
                            f"deadline in "
                            f"{max(request.deadline - now, 0.0):.6f}s "
                            f"< estimated exec {est:.6f}s for bucket "
                            f"{request.bucket}"),
                        "rejected_infeasible", admission, now)
            request.arrival = now
            request.seq = next(self._seq)
            self._groups.setdefault(request.bucket, []).append(request)
            self.metrics.inc("admitted")
            self.metrics.set_gauge("queue_depth", len(self))
            if admission is not None:
                admission.set(verdict="admitted", queue_depth=len(self))
                admission.finish(at=now)
        return request

    def _reject(self, request: Request, exc: AdmissionError,
                counter: str, admission=None,
                now: Optional[float] = None) -> Request:
        self.metrics.inc(counter)
        if request.tenant is not None:
            self.metrics.inc(labeled(counter, tenant=request.tenant))
        if admission is not None:
            admission.set(verdict=counter)
            admission.finish(at=now)
        if request.trace is not None:
            request.trace.finish(status=counter, at=now)
        request.future.set_exception(exc)
        raise exc

    # ------------------------------------------------------------------

    def cancel(self, request: Request) -> bool:
        """Cancel a queued request; False if already closed into a batch."""
        with self.lock:
            group = self._groups.get(request.bucket)
            if group is None or request not in group:
                return False
            if not request.future.cancel():
                return False
            group.remove(request)
            if not group:
                del self._groups[request.bucket]
            self.metrics.inc("cancelled")
            self.metrics.set_gauge("queue_depth", len(self))
            if request.trace is not None:
                request.trace.finish(status="cancelled",
                                     at=self.clock.now())
        return True

    def remove(self, requests: Sequence[Request]) -> None:
        """Drop closed/shed requests from their groups (scheduler-only)."""
        with self.lock:
            for r in requests:
                group = self._groups.get(r.bucket)
                if group is None:
                    continue
                try:
                    group.remove(r)
                except ValueError:
                    continue
                if not group:
                    del self._groups[r.bucket]
            self.metrics.set_gauge("queue_depth", len(self))
