"""Time sources for the serving runtime.

Every scheduling decision in ``repro_torch.runtime`` — admission feasibility,
batch-close times, deadline expiry, wait/exec/e2e latency accounting —
reads time through a :class:`Clock` so the whole runtime can run against
either source:

* :class:`RealClock` — ``time.perf_counter``, for production and the
  load benchmarks;
* :class:`VirtualClock` — a manually-stepped counter, so tests assert
  *exact* batch-close times, EDF ordering, and shed accounting with no
  sleeps and no wall-clock reads anywhere in the decision path.

Deadlines are **absolute** clock readings (seconds on the clock that
admitted the request), not durations: ``deadline = clock.now() + slo``.
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    #: True for clocks that advance only by explicit steps (no wall-time
    #: relationship).  The runtime uses this capability — never a concrete
    #: type check — to decide whether timed waits against the clock make
    #: sense and whether scheduling-jitter margins apply; any user clock
    #: that is manually driven should set it.
    manual: bool

    def now(self) -> float:
        """Current time in seconds; monotone non-decreasing."""
        ...


class RealClock:
    """Wall clock (``time.perf_counter``: monotonic, sub-microsecond)."""

    manual = False

    def now(self) -> float:
        return time.perf_counter()


class VirtualClock:
    """Manually-stepped clock for deterministic scheduler tests.

    ``advance``/``set_time`` only move forward — the scheduler relies on
    monotonicity.  Tests drive the runtime synchronously
    (``RuntimeLoop.step``) between steps; a worker *thread* paired with a
    manual clock re-polls on every submit notification and otherwise at
    the loop's idle cadence, since real-time waits cannot track virtual
    time.
    """

    manual = True

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance by a negative dt ({dt})")
        self._t += dt
        return self._t

    def set_time(self, t: float) -> float:
        if t < self._t:
            raise ValueError(
                f"virtual time may not go backwards ({t} < {self._t})")
        self._t = float(t)
        return self._t
