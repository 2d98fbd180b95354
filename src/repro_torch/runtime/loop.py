"""Worker loop: drain closed batches through the warmed executables.

:class:`RuntimeLoop` turns the scheduler's pure ``poll`` into a running
service.  One daemon thread waits until the next close trigger (or a
submit notification), closes batches, and executes each through a
``runner`` callback, resolving every request's ``Future``:

* a batch that **raises** fails only its own requests' futures — the
  exception is attached to each of them — and the loop moves on to the
  next batch; nothing wedges;
* ``shutdown`` is idempotent and exception-safe: the first call stops
  and joins the thread, later calls are no-ops, and a crashed batch
  never prevents shutdown.

The loop is equally drivable *without* its thread: :meth:`step` performs
one poll-and-execute round inline, which is how the virtual-clock tests
and the synchronous facade use it.

:class:`ServeRuntime` assembles the whole subsystem around a
:class:`~repro_torch.serve.engine.ServeEngine`: queue + scheduler + loop +
metrics, with ``submit(seeds, deadline, priority) -> Request`` as the
async entry point.  Execution goes through the engine's micro-batcher —
the same executables the synchronous paths warmed (one CUDA graph per
(bucket, batch) on the card) — so no executable is built after warmup
(``engine.compile_count`` proves it).  Under :meth:`ServeRuntime.start`
the worker thread replays those graphs on its own current stream: a run
copies the stacked requests into the graph's static buffers, replays it
and reads the seed rows back with a synchronizing ``.cpu()``, all in
stream order on the calling thread.

The execute time the loop records (``exec_s``, the ``execute`` span, the
estimator's and the feedback store's observations) is the clock around
``runner(batch)``.  On the card it includes the device time because the
run ends in that synchronizing readback; it also includes the stacking
and the copies on the host.
"""

from __future__ import annotations

import threading
import traceback
from concurrent.futures import InvalidStateError
from typing import Callable, List, Optional, Sequence

from repro_torch.runtime.clock import Clock, RealClock
from repro_torch.runtime.metrics import MetricsRegistry, labeled
from repro_torch.runtime.queue import (
    BucketEstimator,
    Request,
    RequestQueue,
    UnknownServableError,
)
from repro_torch.runtime.scheduler import BatchScheduler, ClosedBatch

#: runner(batch) -> one output per batch request, in request order.
Runner = Callable[[ClosedBatch], Sequence]

_IDLE_WAIT_S = 0.05   # wait bound while the queue is empty


class RuntimeLoop:
    def __init__(
        self,
        scheduler: BatchScheduler,
        runner: Runner,
        *,
        clock: Optional[Clock] = None,
        metrics: Optional[MetricsRegistry] = None,
        name: str = "repro-torch-runtime",
        batch_info: Optional[Callable[[ClosedBatch], dict]] = None,
        feedback=None,
    ):
        self.scheduler = scheduler
        self.runner = runner
        self.clock = clock or scheduler.clock
        self.metrics = metrics or scheduler.metrics
        self.name = name
        # Optional observability hooks (both None when tracing/feedback
        # are off, keeping the hot path unchanged):
        # * batch_info(batch) -> {"bucket_key", "plan_key", "attrs",
        #   "layers"} describing the plans serving this batch — see
        #   repro_torch.obs.trace.engine_batch_info;
        # * feedback: a repro_torch.obs.feedback.PlanFeedback fed one measured
        #   (bucket_key, plan_key, exec seconds, padded batch) per batch.
        self.batch_info = batch_info
        self.feedback = feedback
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------

    def notify(self) -> None:
        """Wake the worker (new submission, cancellation, shutdown)."""
        with self._cond:
            self._cond.notify_all()

    def step(self, now: Optional[float] = None) -> int:
        """One poll-and-execute round on the calling thread."""
        executed = 0
        for batch in self.scheduler.poll(now):
            self.execute(batch)
            executed += 1
        return executed

    def drain(self) -> int:
        """Flush the queue and execute everything inline (sync path)."""
        executed = 0
        for batch in self.scheduler.poll():
            self.execute(batch)
            executed += 1
        for batch in self.scheduler.flush():
            self.execute(batch)
            executed += 1
        return executed

    @staticmethod
    def _fail_traces(requests: Sequence[Request], error: str,
                     at: float) -> None:
        for r in requests:
            if r.trace is not None:
                r.trace.finish(status="failed", at=at, error=error)

    def execute(self, batch: ClosedBatch) -> None:
        """Run one batch; on failure, fail only this batch's futures."""
        live = [r for r in batch.requests if not r.future.cancelled()]
        traced = any(r.trace is not None for r in live)
        info = None
        if (traced or self.feedback is not None) \
                and self.batch_info is not None:
            info = self.batch_info(batch)
        ledger_before = None
        if traced:
            from repro_torch.dist.collectives import LEDGER

            ledger_before = (dict(LEDGER.counts), dict(LEDGER.bytes))
        t0 = self.clock.now()
        try:
            outputs = self.runner(batch)
        except BaseException as e:  # noqa: BLE001 — must not kill the loop
            for r in live:
                if not r.future.done():
                    try:
                        r.future.set_exception(e)
                    except InvalidStateError:
                        continue     # caller cancelled between check and set
                if r.tenant is not None:
                    self.metrics.inc(labeled("failed", tenant=r.tenant,
                                             servable=r.graph_key))
            self.metrics.inc("failed", len(live))
            self._fail_traces(live, f"{type(e).__name__}: {e}",
                              self.clock.now())
            return
        if len(outputs) != len(batch.requests):
            # A buggy runner must not strand the unmatched tail futures.
            err = RuntimeError(
                f"runner returned {len(outputs)} outputs for "
                f"{len(batch.requests)} requests")
            for r in live:
                if not r.future.done():
                    try:
                        r.future.set_exception(err)
                    except InvalidStateError:
                        continue
            self.metrics.inc("failed", len(live))
            self._fail_traces(live, str(err), self.clock.now())
            return
        t1 = self.clock.now()
        padded = self.scheduler.padded_width(len(batch.requests),
                                             batch.bucket)
        if self.scheduler.estimator is not None:
            self.scheduler.estimator.observe(batch.bucket, padded, t1 - t0)
        if self.feedback is not None and info and info.get("plan_key"):
            # The executed plan's per-operand seconds fold into the
            # PlanFeedback EWMA the next warmup's choose_plan consults.
            self.feedback.record(info["bucket_key"], info["plan_key"],
                                 t1 - t0, batch=padded)
        ledger_delta = []
        if traced:
            from repro_torch.dist.collectives import LEDGER

            before_counts, before_bytes = ledger_before
            for kind in sorted(set(LEDGER.counts) | set(before_counts)):
                n = LEDGER.counts.get(kind, 0) - before_counts.get(kind, 0)
                nbytes = LEDGER.bytes.get(kind, 0.0) \
                    - before_bytes.get(kind, 0.0)
                if n > 0 or nbytes != 0.0:
                    ledger_delta.append((kind, nbytes, n))
        for r, out in zip(batch.requests, outputs):
            if r.future.cancelled() or r.future.done():
                continue
            # Timing fields land before set_result: a waiter wakes the
            # instant the result is set and may read them immediately.
            r.wait_s = batch.closed_at - r.arrival
            r.exec_s = t1 - t0
            try:
                r.future.set_result(out)
            except InvalidStateError:
                continue             # caller cancelled between check and set
            self.metrics.observe("wait_s", r.wait_s)
            self.metrics.observe("exec_s", r.exec_s)
            self.metrics.observe("e2e_s", r.prep_s + (t1 - r.arrival))
            verdict = None
            if r.deadline is not None:
                verdict = "slo_met" if t1 <= r.deadline else "slo_missed"
                self.metrics.inc(verdict)
                if r.tenant is not None:
                    self.metrics.inc(labeled(verdict, tenant=r.tenant))
            self.metrics.inc("completed")
            if r.tenant is not None:
                # Multi-tenant traffic carries per-tenant / per-servable
                # series beside the fleet-wide ones, same registry.
                self.metrics.inc(labeled("completed", tenant=r.tenant,
                                         servable=r.graph_key))
                self.metrics.observe(
                    labeled("e2e_s", tenant=r.tenant),
                    r.prep_s + (t1 - r.arrival))
                self.metrics.observe(
                    labeled("exec_s", servable=r.graph_key), r.exec_s)
            if r.trace is not None:
                self._trace_completion(r, batch, t0, t1, padded, info,
                                       ledger_delta, verdict)

    def _trace_completion(self, r: Request, batch: ClosedBatch,
                          t0: float, t1: float, padded: int,
                          info: Optional[dict], ledger_delta,
                          verdict: Optional[str]) -> None:
        """Stamp queue-wait / execute / per-layer spans and close the trace.

        The queue-wait span is written retroactively (arrival -> batch
        close, carrying the close reason); the execute span covers the
        runner call and owns the batch's ledger byte-delta events plus
        one ``execute_layer`` child per layer with the serving plan's
        attributes.  All timestamps are exact clock readings the loop
        already took, so traces are deterministic under ``VirtualClock``.
        """
        trace = r.trace
        queue_wait = trace.span(
            "queue_wait", start=r.arrival,
            close_reason=batch.reason,
            batch_size=len(batch.requests),
            padded_batch=padded)
        queue_wait.finish(at=batch.closed_at)
        info = info or {}
        execute = trace.span(
            "execute", start=t0,
            bucket_key=info.get("bucket_key"),
            plan_key=info.get("plan_key"),
            batch_size=len(batch.requests),
            padded_batch=padded,
            **info.get("attrs", {}))
        for kind, nbytes, n in ledger_delta:
            execute.event("ledger", at=t1, kind=kind, bytes=nbytes, n=n)
        for i, layer_attrs in enumerate(info.get("layers", ())):
            trace.span("execute_layer", parent=execute, start=t0,
                       layer=i, **layer_attrs).finish(at=t1)
        execute.finish(at=t1)
        if verdict is not None:
            trace.root.set(slo=verdict)
        trace.finish(status="ok", at=t1)

    # ------------------------------------------------------------------

    def start(self) -> "RuntimeLoop":
        if self._thread is not None:
            return self
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name=self.name, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                next_close = self.scheduler.next_close_time()
                now = self.clock.now()
                if next_close is None:
                    self._cond.wait(_IDLE_WAIT_S)
                elif next_close > now:
                    if getattr(self.clock, "manual", False):
                        # Manually-driven time advances by explicit steps,
                        # not by waiting; re-poll on every notification.
                        self._cond.wait(_IDLE_WAIT_S)
                    else:
                        targeted = next_close - now <= _IDLE_WAIT_S * 20
                        self._cond.wait(
                            min(next_close - now, _IDLE_WAIT_S * 20))
                        woke = self.clock.now()
                        if targeted and woke >= next_close:
                            # The wait aimed at this close trigger and
                            # landed past it: that overshoot is exactly
                            # the scheduling jitter the adaptive close
                            # margin must absorb next time.
                            observe = getattr(self.scheduler,
                                              "observe_wakeup", None)
                            if observe is not None:
                                observe(woke - next_close)
                if self._stop:
                    return
            try:
                self.step()
            except BaseException:  # noqa: BLE001
                # execute() already isolates runner failures per batch;
                # anything reaching here is a scheduler/bookkeeping bug —
                # surface it, but never let it kill the worker and strand
                # every queued future.
                traceback.print_exc()

    def shutdown(self, timeout: Optional[float] = 5.0) -> None:
        """Stop and join the worker; idempotent, never raises on re-entry."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        thread, self._thread = self._thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


class ServeRuntime:
    """Async deadline-aware serving on top of a warmed ``ServeEngine``.

    ``submit`` prepares the request on the calling thread (sampling +
    bucket padding — bounded work, and the bucket is what admission
    estimates against), then admits it into the bounded queue; the worker
    loop closes and executes batches.  ``deadline_s`` is relative to the
    runtime clock at submit time; pass ``deadline=None`` for best-effort.
    ``max_wait_s`` (default 50 ms) bounds a *best-effort* request's
    sojourn in a partially-filled bucket so deadline-less traffic always
    makes progress (deadline-carrying requests keep their own
    deadline-aware close trigger); pass ``None`` for pure
    deadline/full-trigger closing, where a best-effort request closes
    only when its bucket fills or on ``drain``.
    """

    def __init__(
        self,
        engine,
        *,
        capacity: Optional[int] = 256,
        clock: Optional[Clock] = None,
        estimator=None,
        metrics: Optional[MetricsRegistry] = None,
        max_wait_s: Optional[float] = 0.05,
        close_margin_s: Optional[float] = None,
        calibration: float = 1.0,
        graph_key: Optional[str] = None,
        tracer=None,
        feedback=None,
    ):
        self.engine = engine
        self.clock = clock or RealClock()
        self.metrics = metrics or MetricsRegistry()
        # repro_torch.obs hookups, both optional: a Tracer makes every
        # request yield one complete trace; a PlanFeedback store
        # accumulates measured per-(bucket, plan) execute latency.
        self.tracer = tracer
        self.feedback = feedback
        # the engine hashed its graph's content once, when it was built
        self.graph_key = graph_key or engine.graph_key
        self.estimator = estimator or BucketEstimator(
            engine.cfg,
            engine.batcher.ladder,
            calibration=calibration,
            device=engine.device_model,
        )
        self.queue = RequestQueue(
            capacity=capacity,
            clock=self.clock,
            estimator=self.estimator,
            metrics=self.metrics,
            key_check=lambda key: key == self.graph_key,
        )
        if close_margin_s is None:
            # Real clocks carry worker wake-up jitter; manually-driven
            # clocks are stepped exactly, so deterministic tests keep 0.
            close_margin_s = 0.0 if getattr(self.clock, "manual", False) \
                else 0.005
        self.scheduler = BatchScheduler(
            self.queue,
            max_batch=engine.batcher.max_batch,
            batch_sizes=engine.batcher.batch_ladder(),
            max_wait_s=max_wait_s,
            close_margin_s=close_margin_s,
        )
        self.loop = RuntimeLoop(
            self.scheduler, self._run_batch,
            batch_info=(self._batch_info
                        if (tracer is not None or feedback is not None)
                        else None),
            feedback=feedback,
        )

    # ------------------------------------------------------------------

    def _batch_info(self, batch: ClosedBatch) -> dict:
        from repro_torch.obs.trace import engine_batch_info

        return engine_batch_info(self.engine, batch.bucket)

    def _run_batch(self, batch: ClosedBatch) -> List:
        if self.tracer is not None:
            # Ledger the batch's modeled DRAM traffic host-side: a replay
            # (or, on the CPU, the executable's closure) makes none of
            # the per-dispatch records the eager path makes.  Gated on
            # tracing so untraced serving leaves the global LEDGER
            # exactly as before.
            self.engine.batcher.record_batch_dram(
                batch.bucket,
                self.scheduler.padded_width(len(batch.requests),
                                            batch.bucket),
                int(self.engine.features.shape[1]))
        return self.engine.batcher.run(
            self.engine.params, [r.padded for r in batch.requests]
        )

    def submit(
        self,
        seeds: Sequence[int],
        *,
        deadline_s: Optional[float] = None,
        deadline: Optional[float] = None,
        priority: int = 0,
        graph_key: Optional[str] = None,
    ) -> Request:
        """Admit one seed query; returns the request (``.future`` resolves
        to its seed logits).  Raises ``AdmissionError`` on rejection.

        ``graph_key`` defaults to this engine's graph; passing any other
        key is rejected at admission with ``UnknownServableError`` — a
        mismatched key used to enqueue anyway and silently answer from
        the wrong graph."""
        if deadline_s is not None and deadline is not None:
            raise ValueError("pass deadline_s (relative) or deadline "
                             "(absolute), not both")
        t0 = self.clock.now()
        key = graph_key if graph_key is not None else self.graph_key
        abs_deadline = (t0 + deadline_s if deadline_s is not None
                        else deadline)
        trace = None
        if self.tracer is not None:
            trace = self.tracer.trace(
                "request", graph_key=key, priority=priority,
                deadline=abs_deadline, n_seeds=len(seeds))
        padded = self.engine._prepare(seeds)
        t_prep = self.clock.now()
        if trace is not None:
            trace.span("prepare", start=t0,
                       bucket=str(padded.bucket)).finish(at=t_prep)
        req = Request(
            graph_key=key,
            seeds=tuple(int(s) for s in seeds),
            deadline=abs_deadline,
            priority=priority,
            trace=trace,
            bucket=padded.bucket,
            padded=padded,
            prep_s=t_prep - t0,
        )
        self.queue.submit(req)
        self.loop.notify()
        return req

    def cancel(self, request: Request) -> bool:
        ok = self.queue.cancel(request)
        if ok:
            self.loop.notify()
        return ok

    # ------------------------------------------------------------------

    def start(self) -> "ServeRuntime":
        self.loop.start()
        return self

    def drain(self) -> int:
        """Synchronous path: close + execute everything on this thread."""
        if self.loop.running:
            raise RuntimeError(
                "drain() is for the non-threaded mode; with the worker "
                "running, wait on the request futures instead")
        return self.loop.drain()

    def shutdown(self, timeout: Optional[float] = 5.0,
                 drain: bool = False) -> None:
        """Stop the runtime; ``drain=True`` makes the stop graceful.

        Both modes close the queue first, so every later ``submit`` is
        rejected with ``QueueClosedError`` instead of landing work that
        would never run.  With ``drain=True`` the already-admitted
        requests are then flushed through the scheduler and executed on
        the calling thread — batch membership is decided under the
        queue's lock inside ``poll``/``flush``, so a still-running worker
        and the drain never close the same request twice — and only then
        is the worker joined.  With ``drain=False`` the worker is stopped
        immediately and everything still queued is cancelled: a request
        the loop never closed must not leave its future pending forever —
        a caller blocked on ``future.result()`` with no timeout would
        hang past shutdown.  Cancelled requests raise
        ``concurrent.futures.CancelledError`` at the waiter and are
        counted under the ``cancelled`` metric.  Idempotent.
        """
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

    def __enter__(self) -> "ServeRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()
