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
:class:`LmServable` serves a decoder LM from the port's arch registry by
sequence bucket: one CUDA graph of ``models.lm.forward`` per (bucket,
batch) on the card, captured by ``load()`` and dropped, with its graph
memory pool, by ``unload()``; a closure on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.layers import bf16_full_reduction
from repro_torch.models.lm import forward, init_lm
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
    """A decoder LM from the arch registry, served by sequence bucket.

    Payloads are token-id sequences; the answer is the logits at the last
    *real* position (the next-token distribution).  Sequences pad to a
    small ladder of lengths and batches to a power-of-two ladder, so the
    executables are ``seq_buckets x batch ladder``, all warmed by
    ``load()``.  Padding is causal-safe: positions past ``n_tokens`` are
    zero tokens the causal mask keeps out of every real position's
    context, and the read-out row never moves.

    On the card an executable is a CUDA graph of ``forward`` over a static
    token buffer, captured (``thread_local``, one warm-up stream per
    servable, one graph pool for all its graphs) so a fleet can load it
    while its worker replays another servable's graphs; the forward reads
    nothing back to the host, so it captures whole.  ``compiles`` counts
    executables built, across reloads.  ``params`` takes a tree from
    :func:`repro_torch.models.convert.lm_params_from_numpy` (tests serve
    the reference's weights); without it the weights come from ``seed``
    through ``torch.Generator`` on the device.  Runs on the card unless
    ``device`` is given.
    """

    def __init__(
        self,
        arch: str,
        *,
        key: Optional[str] = None,
        seq_buckets: Sequence[int] = (16, 32, 64),
        max_batch: int = 8,
        seed: int = 0,
        full_size: bool = False,
        cost: Optional[float] = None,
        base_seconds: float = 2e-4,
        params: Optional[dict] = None,
        device=None,
    ):
        cfg = get_config(arch)
        if not full_size:
            cfg = reduced(cfg)
        if cfg.frontend_tokens:
            raise ValueError(
                f"arch {arch!r} needs frontend memory embeddings; "
                f"text-only servables cannot serve it")
        self.device = resolve_device(device)
        self.arch = arch
        self.key = key or f"lm_{cfg.name}"
        self.cfg = cfg
        self.seq_buckets = tuple(sorted(int(s) for s in seq_buckets))
        self.max_batch = int(max_batch)
        self.params = (params if params is not None else init_lm(
            cfg, torch.Generator(device=self.device).manual_seed(seed),
            self.device))
        self._cost = cost
        self.compiles = 0
        self.calls = 0
        self._executables: Dict[Tuple[SeqBucket, int], object] = {}
        self._pool = None
        self._side = None
        # Cold estimate: one forward is ~linear in tokens processed
        # (batch x seq) at smoke scale; real executions fold in through
        # the EWMA immediately.
        self._estimator = EwmaEstimator(
            lambda bucket, batch: base_seconds * batch * bucket.seq)

    # -- batching geometry ------------------------------------------------

    def batch_ladder(self) -> List[int]:
        sizes = [1]
        while sizes[-1] < self.max_batch:
            sizes.append(min(sizes[-1] * 2, self.max_batch))
        return sizes

    def pad_batch(self, n: int) -> int:
        for b in self.batch_ladder():
            if b >= n:
                return b
        raise ValueError(f"batch {n} exceeds max_batch {self.max_batch}")

    def profile(self) -> BatchProfile:
        return BatchProfile(self.max_batch, tuple(self.batch_ladder()))

    @property
    def estimator(self) -> EwmaEstimator:
        return self._estimator

    def cost_units(self) -> float:
        if self._cost is not None:
            return self._cost
        return 1.0

    # -- lifecycle --------------------------------------------------------

    def _executable(self, bucket: SeqBucket, batch: int):
        key = (bucket, batch)
        exe = self._executables.get(key)
        if exe is None:
            if self.device.type == "cuda":
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                if self._side is None:
                    self._side = torch.cuda.Stream(self.device)
                exe = _CapturedLm(self.params, self.cfg, (batch, bucket.seq),
                                  self.device, self._pool, self._side)
            else:
                exe = _EagerLm(self.params, self.cfg)
            self.compiles += 1
            self._executables[key] = exe
        return exe

    def load(self) -> None:
        for seq in self.seq_buckets:
            for b in self.batch_ladder():
                self._executable(SeqBucket(seq), b)

    def unload(self) -> None:
        """Drop every executable, with its graph, static buffers and the
        graph pool (the warm-up stream stays for the next captures)."""
        self._executables.clear()
        self._pool = None

    # -- serving ----------------------------------------------------------

    def prepare(self, payload: Sequence[int]) -> LmPrepared:
        tokens = np.asarray(list(payload), dtype=np.int32)
        if tokens.ndim != 1 or tokens.size == 0:
            raise ValueError("LM payload must be a non-empty 1-D token "
                             "sequence")
        if np.any(tokens < 0) or np.any(tokens >= self.cfg.vocab):
            raise ValueError(
                f"token ids must be in [0, {self.cfg.vocab})")
        for seq in self.seq_buckets:
            if seq >= tokens.size:
                break
        else:
            raise ValueError(
                f"sequence length {tokens.size} exceeds the top bucket "
                f"{self.seq_buckets[-1]}")
        padded = np.zeros((seq,), dtype=np.int32)
        padded[: tokens.size] = tokens
        return LmPrepared(
            bucket=SeqBucket(seq), tokens=padded, n_tokens=int(tokens.size))

    def run_batch(self, prepared: List[LmPrepared]) -> List[np.ndarray]:
        if not prepared:
            return []
        bucket = prepared[0].bucket
        if any(p.bucket != bucket for p in prepared):
            raise ValueError("run_batch() requires a single-bucket batch")
        batch = self.pad_batch(len(prepared))
        toks = np.zeros((batch, bucket.seq), dtype=np.int64)
        for i, p in enumerate(prepared):
            toks[i] = p.tokens
        rows = [p.n_tokens - 1 for p in prepared]
        out = self._executable(bucket, batch)(torch.from_numpy(toks), rows)
        self.calls += 1
        return list(out)


class _EagerLm:
    """One (bucket, batch) forward as a closure (CPU tensors)."""

    def __init__(self, params: dict, cfg):
        self.params, self.cfg = params, cfg

    def __call__(self, tokens: torch.Tensor, rows: List[int]) -> np.ndarray:
        with bf16_full_reduction():
            logits = forward(self.params, self.cfg, tokens)
        return logits[torch.arange(len(rows)), torch.as_tensor(rows)].numpy()


class _CapturedLm:
    """One (bucket, batch) forward as a CUDA graph over a static token
    buffer: run once on the servable's side stream (kernels load and
    cuBLAS sets up outside the capture), then captured into ``pool``.
    A replay copies the tokens in; only the read-out rows come back."""

    def __init__(self, params: dict, cfg, shape: Tuple[int, int],
                 device: torch.device, pool, side):
        self.tokens = torch.zeros(shape, dtype=torch.int64, device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with bf16_full_reduction():   # the GEMMs are chosen at capture
            with torch.cuda.stream(side):
                forward(params, cfg, self.tokens)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.out = forward(params, cfg, self.tokens)
        self.replays = 0

    def __call__(self, tokens: torch.Tensor, rows: List[int]) -> np.ndarray:
        self.tokens.copy_(tokens)
        self.graph.replay()
        self.replays += 1
        idx = torch.as_tensor(rows, device=self.out.device)
        first = torch.arange(len(rows), device=idx.device)
        return self.out[first, idx].cpu().numpy()
