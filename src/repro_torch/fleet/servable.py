"""Servables: the unit a fleet loads, routes to, batches, and unloads.

The port of ``repro.fleet.servable``.  A :class:`Servable` is everything
the shared runtime needs to serve one model behind a key, with the model
kind abstracted away:

* ``prepare(payload)`` turns one request payload into a shape-bucketed
  prepared operand (the object carries ``.bucket``, the grouping key the
  queue and scheduler batch on);
* ``run_batch(prepared)`` executes one single-bucket batch through the
  servable's own warmed executables and returns one output per request;
* ``profile()`` exposes the servable's batching geometry
  (:class:`~repro_torch.runtime.scheduler.BatchProfile`) so the one shared
  close loop applies *this* servable's coalescing width and padded
  ladder to *this* servable's buckets;
* ``estimator`` prices a (bucket, padded batch) in seconds for admission
  feasibility and deadline-trigger placement;
* ``load()``/``unload()`` bound resident memory: the fleet manager
  hot-loads on first traffic and unloads on eviction.

:class:`GcnServable` serves the port's SpMM serving core: sampler +
micro-batcher + one CUDA graph per (bucket, batch) on the card, captured
by ``load()`` and dropped, with their graph memory pool, by ``unload()``.
:class:`LmServable` (a decoder LM from the arch registry) waits for the LM
models, ROADMAP A13; its payload types are plain data and ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.queue import BucketEstimator
from repro_torch.runtime.scheduler import BatchProfile


class Servable:
    """Interface contract (documented above); subclasses override all."""

    key: str

    def load(self) -> None:
        """Warm executables; idempotent.  Called by the manager on
        hot-load, never by the runtime mid-request."""
        raise NotImplementedError

    def unload(self) -> None:
        """Drop executables (resident memory back to near zero);
        ``load`` afterwards must restore service."""
        raise NotImplementedError

    @property
    def estimator(self):
        raise NotImplementedError

    def profile(self) -> BatchProfile:
        raise NotImplementedError

    def cost_units(self) -> float:
        """Relative residency weight against the manager's capacity
        budget (1.0 = one budget unit)."""
        return 1.0

    def prepare(self, payload):
        raise NotImplementedError

    def run_batch(self, prepared: List) -> List[np.ndarray]:
        raise NotImplementedError


class EwmaEstimator:
    """Generic (bucket, batch) cost estimator: a caller-supplied model
    function prices cold keys deterministically, and measured executions
    fold into a per-key EWMA — the same convergence contract as
    :class:`~repro_torch.runtime.queue.BucketEstimator` without assuming
    the GCN cost model."""

    def __init__(self, model_fn, *, ewma: float = 0.3):
        self.model_fn = model_fn
        self.ewma = float(ewma)
        self._measured: Dict[Tuple[object, int], float] = {}

    def estimate(self, bucket, batch: int = 1) -> float:
        key = (bucket, int(batch))
        if key in self._measured:
            return self._measured[key]
        return float(self.model_fn(bucket, int(batch)))

    def observe(self, bucket, batch: int, seconds: float) -> None:
        key = (bucket, int(batch))
        prev = self._measured.get(key)
        self._measured[key] = (
            float(seconds) if prev is None
            else (1 - self.ewma) * prev + self.ewma * float(seconds)
        )


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------


class GcnServable(Servable):
    """One :class:`~repro_torch.serve.engine.ServeEngine` behind a fleet
    key.

    Everything routes through the engine's machinery — sampler extraction
    in ``prepare`` (host work only: numpy and CPU tensors, so a submit
    never touches the card), the micro-batcher's coalesced executables in
    ``run_batch`` — so a fleet holding exactly one GcnServable computes
    the answers of ``ServeRuntime`` over the same engine (same padding,
    same executables, same batch membership).  ``load`` is the engine's
    warmup (one capture per rung and batch on the card), ``unload``
    drops every executable with its graph memory pool; ``compiles`` goes
    on counting across reloads.  The estimator prices buckets under the
    engine's device model (the H100 model unless the engine was given
    another)."""

    def __init__(
        self,
        engine,
        *,
        key: Optional[str] = None,
        calibration: float = 1.0,
        cost: Optional[float] = None,
    ):
        self.engine = engine
        self.key = key or engine.graph_key
        self._estimator = BucketEstimator(
            engine.cfg, engine.batcher.ladder, calibration=calibration,
            device=engine.device_model)
        self._cost = cost

    def load(self) -> None:
        self.engine.warmup()

    def unload(self) -> None:
        self.engine.batcher.clear_executables()

    @property
    def estimator(self) -> BucketEstimator:
        return self._estimator

    def profile(self) -> BatchProfile:
        return BatchProfile(
            self.engine.batcher.max_batch,
            tuple(self.engine.batcher.batch_ladder()),
        )

    def cost_units(self) -> float:
        if self._cost is not None:
            return self._cost
        # Graph residency dominates a GCN servable's footprint; scale by
        # node count so one huge graph spends more of the budget than
        # several small ones.
        return max(self.engine.graph.n_nodes / 65536.0, 1.0)

    def prepare(self, payload: Sequence[int]):
        return self.engine._prepare(payload)

    def run_batch(self, prepared: List) -> List[np.ndarray]:
        return self.engine.batcher.run(self.engine.params, prepared)


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, order=True)
class SeqBucket:
    """LM shape bucket: padded sequence length."""

    seq: int


@dataclasses.dataclass
class LmPrepared:
    """One token sequence padded to its sequence bucket."""

    bucket: SeqBucket
    tokens: np.ndarray        # (seq,) int32, zero padding
    n_tokens: int


class LmServable(Servable):
    """A decoder LM from the arch registry, served by sequence bucket: it
    needs the LM models and the arch registry, ROADMAP A13."""

    def __init__(self, arch: str, **kw):
        raise NotImplementedError(
            f"LmServable({arch!r}): the LM models and the arch registry are "
            f"ROADMAP item A13, not ported yet")
