"""Structured request tracing for the serving vertical.

One :class:`Trace` follows a request end to end: admission in
``runtime.queue``, queue wait + batch close in ``runtime.scheduler`` /
``runtime.loop``, batch execution, and per-layer execute spans stamped
with the :class:`~repro_torch.exec.plan.SpmmPlan` attributes (impl,
precision, fused, mesh width, block sizes) that actually served it.
Impl names are the port's (``exec.plan.IMPL_NAMES``: ``cuda`` where the
reference says ``pallas``).
``CollectiveLedger`` records become span events, so the modeled DRAM /
collective bytes of a batch are attributed to the request that paid
for them.

Design constraints, in order:

* **Clock-faithful.** Every timestamp comes from a
  :class:`~repro_torch.runtime.clock.Clock` — under ``VirtualClock`` a trace
  is bit-for-bit deterministic, so tests assert exact span edges.
* **Zero cost when off.** Nothing in the hot path allocates unless a
  tracer was handed to the runtime; instrumented call sites only do a
  ``getattr(request, "trace", None)`` check, and a :func:`phase` one C
  call and one thread-local read, its counts dearer to compute than a
  shape read only ``if`` the phase is open.
* **No upward imports.** This module depends only on
  ``runtime.clock`` and torch; the ledger hookup is lazy so ``dist``
  stays a leaf layer.

:func:`phase` marks where the GCN forward's work happens (``gcn.forward``
around one inference; ``gcn.permute``, ``gcn.layer``, ``gcn.combine``,
``gcn.aggregate``, ``gcn.fold``, ``gcn.activation``, ``gcn.unpermute``
inside it).  A phase is an ``obs`` child span when a span is current,
and a ``torch.profiler`` range, which the profiler's trace puts on the
device's clock, when a profiler runs; tracing is on exactly then.

Span ids and trace ids are deterministic counters (no randomness, no
wall-clock salt) — resumable tests and virtual-clock runs stay exact.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional

import torch

from repro_torch.runtime.clock import Clock, RealClock

__all__ = [
    "SpanEvent",
    "Span",
    "Trace",
    "Tracer",
    "current_span",
    "use_span",
    "plan_attributes",
    "engine_batch_info",
    "start_layer_span",
    "install_ledger_listener",
    "phase",
]


class SpanEvent:
    """A point-in-time annotation on a span (e.g. one ledger record)."""

    __slots__ = ("name", "at", "attributes")

    def __init__(self, name: str, at: float, attributes: Dict[str, object]):
        self.name = name
        self.at = at
        self.attributes = attributes

    def to_dict(self) -> dict:
        return {"name": self.name, "at": self.at,
                "attributes": dict(self.attributes)}


class Span:
    """One timed operation inside a trace.

    ``finish`` is idempotent: the first call pins ``end``, later calls
    are no-ops — so a span finished on the failure path can't be
    re-stamped by a late success path.
    """

    __slots__ = ("trace", "span_id", "parent_id", "name", "start", "end",
                 "attributes", "events")

    def __init__(self, trace: "Trace", span_id: int, parent_id: Optional[int],
                 name: str, start: float, attributes: Dict[str, object]):
        self.trace = trace
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.attributes = attributes
        self.events: List[SpanEvent] = []

    def set(self, **attrs: object) -> "Span":
        self.attributes.update(attrs)
        return self

    def event(self, name: str, at: Optional[float] = None,
              **attrs: object) -> SpanEvent:
        ev = SpanEvent(name, self.trace.clock.now() if at is None else at,
                       attrs)
        self.events.append(ev)
        return ev

    def finish(self, at: Optional[float] = None) -> "Span":
        if self.end is None:
            self.end = self.trace.clock.now() if at is None else at
        return self

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "attributes": dict(self.attributes),
            "events": [ev.to_dict() for ev in self.events],
        }


class Trace:
    """A tree of spans for one request; ``spans[0]`` is the root.

    ``finish`` is first-wins: a trace shed by the scheduler keeps its
    ``shed_expired`` status even if a racing success path also tries
    to close it. Finishing notifies the owning tracer exactly once, so
    ``Tracer.drain`` sees each trace one time.
    """

    def __init__(self, trace_id: str, name: str, clock: Clock,
                 tracer: Optional["Tracer"] = None,
                 attributes: Optional[Dict[str, object]] = None):
        self.trace_id = trace_id
        self.clock = clock
        self.tracer = tracer
        self.status: Optional[str] = None
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._root = self._new_span(name, parent_id=None, start=None,
                                    attributes=dict(attributes or {}))

    def _new_span(self, name: str, parent_id: Optional[int],
                  start: Optional[float],
                  attributes: Dict[str, object]) -> Span:
        with self._lock:
            span = Span(self, next(self._ids), parent_id, name,
                        self.clock.now() if start is None else start,
                        attributes)
            self.spans.append(span)
        return span

    @property
    def root(self) -> Span:
        return self._root

    def span(self, name: str, *, parent: Optional[Span] = None,
             start: Optional[float] = None, **attrs: object) -> Span:
        """Open a child span (of ``parent``, default the root)."""
        pid = (parent or self._root).span_id
        return self._new_span(name, parent_id=pid, start=start,
                              attributes=dict(attrs))

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    @property
    def done(self) -> bool:
        return self.status is not None

    def finish(self, status: str = "ok", at: Optional[float] = None,
               **attrs: object) -> "Trace":
        with self._lock:
            if self.status is not None:
                return self
            self.status = status
        if attrs:
            self._root.set(**attrs)
        self._root.set(status=status)
        self._root.finish(at=at)
        if self.tracer is not None:
            self.tracer._complete(self)
        return self

    def __enter__(self) -> "Trace":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish(status="ok" if exc_type is None
                    else f"error:{exc_type.__name__}")

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "name": self._root.name,
            "status": self.status,
            "spans": [s.to_dict() for s in self.spans],
        }


class Tracer:
    """Factory + bounded buffer of completed traces.

    Hand one to ``ServeRuntime`` (``tracer=``) and
    every request yields a complete trace; call :meth:`drain` to pull
    finished traces for export. The buffer is a deque capped at
    ``max_traces`` (oldest evicted first) so an un-drained tracer in a
    long-lived server never grows without bound.
    """

    def __init__(self, clock: Optional[Clock] = None,
                 max_traces: int = 4096, ledger_events: bool = True):
        self.clock: Clock = clock if clock is not None else RealClock()
        self.max_traces = int(max_traces)
        self._completed: deque = deque(maxlen=self.max_traces)
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self.started = 0
        self.completed = 0
        if ledger_events:
            install_ledger_listener()

    def trace(self, name: str, **attrs: object) -> Trace:
        with self._lock:
            tid = f"t{next(self._ids):06d}"
            self.started += 1
        return Trace(tid, name, self.clock, tracer=self, attributes=attrs)

    def _complete(self, trace: Trace) -> None:
        with self._lock:
            self._completed.append(trace)
            self.completed += 1

    def drain(self) -> List[Trace]:
        """Pop and return all completed traces (oldest first)."""
        with self._lock:
            out = list(self._completed)
            self._completed.clear()
        return out

    def __len__(self) -> int:
        return len(self._completed)


# --------------------------------------------------------------------------
# Thread-local active span: lets deep call sites (exec.dispatch, the
# ledger) attach children/events without threading a trace through
# every signature.

class _Local(threading.local):
    """Each thread's stack of current spans, there from the first read (a
    read of a missing thread-local attribute raises inside, ~1 us)."""

    def __init__(self):
        self.stack: list = []


_tls = _Local()
_profiler_enabled = torch._C._autograd._profiler_enabled


def _stack() -> list:
    return _tls.stack


def current_span() -> Optional[Span]:
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_span(span: Span):
    """Make ``span`` the thread's current span for the duration."""
    stack = _stack()
    stack.append(span)
    try:
        yield span
    finally:
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:  # pragma: no cover - unbalanced exit
            stack.remove(span)


def _capturing() -> bool:
    """Whether a CUDA graph capture is underway on the current stream:
    what is captured runs at each replay, not now, so no phase opens."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class Phase:
    """One open phase of the work, in up to two sinks at once.

    Under an active ``obs`` span it is a child :class:`Span` carrying the
    phase's counts as attributes, made current so that phases and ledger
    records inside it land on it; while ``torch.profiler`` runs it is a
    ``record_function`` range, which the profiler's trace holds as a
    ``user_annotation`` on the clock of the device's kernels.  The span
    is host time: it closes when the phase's launches are enqueued, and
    no synchronize is added for it.  ``finish`` (or leaving the ``with``)
    closes both.
    """

    __slots__ = ("span", "_range")

    def __init__(self, name: str, counts: Dict[str, object]):
        self.span: Optional[Span] = None
        self._range = None
        cur = current_span()
        if cur is not None:
            self.span = cur.trace.span(_SPAN_NAMES.get(name, name), parent=cur,
                                       **counts)
            _stack().append(self.span)
        if _profiler_enabled():
            self._range = torch.profiler.record_function(name)
            self._range.__enter__()

    def set(self, **counts: object) -> None:
        """Add counts known only once the phase has begun."""
        if self.span is not None:
            self.span.set(**counts)

    def finish(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self.span is not None:
            stack = _stack()
            if stack and stack[-1] is self.span:
                stack.pop()
            elif self.span in stack:  # pragma: no cover - unbalanced exit
                stack.remove(self.span)
            self.span.finish()

    def __enter__(self) -> "Phase":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish()


class _NoPhase:
    """The shared phase of untraced work: opens, counts and closes
    nothing, and is false, so that a caller computes the counts that
    cost work only ``if`` its phase is open."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def set(self, **counts: object) -> None:
        pass

    def __enter__(self) -> "_NoPhase":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NO_PHASE = _NoPhase()

#: The ``obs`` span name of a phase whose span the reference's trace tree
#: already names: the layer phase is its ``execute_layer`` span.
_SPAN_NAMES = {"gcn.layer": "execute_layer"}


def phase(name: str, **counts: object):
    """A context manager around one phase of the work (``gcn.fold``, ...).

    It opens a :class:`Phase` when a profiler runs or an ``obs`` span is
    current, and not inside a CUDA graph capture; else it returns the
    shared no-op phase, which is false, having made nothing (the call's
    keyword dict comes from CPython's free list).  ``counts`` are the
    phase's host-known sizes (rows, widths), kept as the span's
    attributes; counts that cost work to compute are added with
    ``set`` under ``if`` the phase.
    """
    if (_profiler_enabled() or _tls.stack) and not _capturing():
        return Phase(name, counts)
    return _NO_PHASE


def start_layer_span(plan) -> Optional[Phase]:
    """The ``gcn.layer`` phase of one layer, stamped with the resolved
    plan's attributes; ``None`` when :func:`phase` opens nothing.

    Under an active ``obs`` span its span is the reference's
    ``execute_layer`` child, and the ledger records fired inside the
    layer land on it or on the phases inside it as events; the caller
    ``finish``es it.  ``exec.dispatch.execute_layer`` opens the same
    phase with ``with``.
    """
    p = phase("gcn.layer")
    if not p:
        return None
    p.set(**plan_attributes(plan))
    return p


# --------------------------------------------------------------------------
# Plan / engine introspection helpers of the ServeRuntime instrumentation.


def plan_attributes(plan, **extra: object) -> Dict[str, object]:
    """The span attributes for one ``SpmmPlan`` (duck-typed)."""
    attrs: Dict[str, object] = {
        "impl": getattr(plan, "effective_impl", None)
        or getattr(plan, "impl", "?"),
        "precision": getattr(plan, "precision", "f32"),
        "fused": bool(getattr(plan, "fused", False)),
        "mesh_width": int(getattr(plan, "n_shards", 1) or 1),
        "block_rows": getattr(plan, "block_rows", None),
        "block_k": getattr(plan, "block_k", None),
        "block_f": getattr(plan, "block_f", None),
    }
    attrs.update(extra)
    return attrs


def engine_batch_info(engine, bucket) -> dict:
    """Describe how ``engine`` serves ``bucket``: keys + plan attrs.

    Returns the dict ``RuntimeLoop`` consumes: ``bucket_key`` /
    ``plan_key`` (the :mod:`repro_torch.obs.feedback` identities measured
    latency is filed under), ``attrs`` for the execute span, and one
    attribute dict per layer for ``execute_layer`` child spans. Plans
    are read from the batcher's caches, so this reflects the plans the
    rung's executable (its CUDA graph on the card) was built from.
    """
    import dataclasses as _dc

    from repro_torch.obs.feedback import bucket_key as _bucket_key
    from repro_torch.obs.feedback import plan_key_from_plan

    feature_dim = int(engine.features.shape[1])
    batcher = engine.batcher
    precision = batcher.precision_for_bucket(bucket)
    plan = batcher.plan_for_bucket(bucket, feature_dim)
    layer_plans = batcher.layer_plans_for_bucket(bucket, feature_dim)
    if precision != "f32":
        plan = _dc.replace(plan, precision=precision)
        layer_plans = [_dc.replace(p, precision=precision)
                       for p in layer_plans]
    return {
        "bucket_key": _bucket_key(bucket, feature_dim),
        "plan_key": plan_key_from_plan(plan),
        "attrs": plan_attributes(plan),
        "layers": [plan_attributes(p) for p in layer_plans],
    }


# --------------------------------------------------------------------------
# CollectiveLedger adoption: every LEDGER.record while a span is
# active becomes a span event, so modeled DRAM/collective bytes are
# attributed per request/layer.

_ledger_installed = False
_install_lock = threading.Lock()


def _on_ledger_record(kind: str, nbytes: float, n: int) -> None:
    span = current_span()
    if span is not None:
        span.event("ledger", kind=kind, bytes=float(nbytes), n=int(n))


def install_ledger_listener() -> bool:
    """Route ``LEDGER.record`` calls to the active span (idempotent)."""
    global _ledger_installed
    with _install_lock:
        if _ledger_installed:
            return False
        from repro_torch.dist.collectives import LEDGER

        LEDGER.listeners.append(_on_ledger_record)
        _ledger_installed = True
        return True
