"""Fault-tolerant training loop.

The port of ``repro.train.trainer``, over the port's checkpoints and
straggler monitor; the loop is the reference's, step for step.

Production behaviours, exercised by tests with injected failures:

* periodic async checkpointing (never blocks the step);
* automatic restart: on a step failure (device loss, preemption — simulated
  via an injectable ``failure_hook``) the loop restores the latest complete
  checkpoint and resumes, bounded by ``max_restarts``;
* straggler mitigation, two tiers:

  - per-*step* wall times feed an EWMA monitor; steps slower than
    ``straggler_factor`` x the EWMA are logged and counted;
  - with ``TrainerConfig.n_replicas > 1``, per-*replica* step times
    (reported by the step itself under the ``replica_step_times`` metrics
    key) feed a :class:`repro_torch.dist.straggler.StragglerMonitor`, and the monitor's
    ``alive()`` mask is handed to the step function as a third argument —
    the step averages gradients with
    ``repro_torch.dist.collectives.masked_psum_mean`` over that mask, so a
    dropped replica stops contributing to (and stops stalling) the
    surviving replicas' average instead of merely being counted;

* NaN/inf guard: non-finite loss aborts the step and restores, instead of
  poisoning the parameters.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.dist.straggler import StragglerMonitor
from repro_torch.train import checkpoint as ckpt

PyTree = Any
StepFn = Callable[..., Tuple[PyTree, Dict[str, Any]]]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    ckpt_shards: int = 1
    keep: int = 3
    max_restarts: int = 5
    straggler_factor: float = 3.0
    log_every: int = 10
    # Replica-level straggler dropping: with n_replicas > 1 the loop runs a
    # StragglerMonitor over the per-replica step times the step reports and
    # passes its alive() mask into step_fn (masked_psum_mean averaging).
    n_replicas: int = 1
    straggler_warn_factor: float = 2.0
    straggler_drop_factor: float = 4.0
    straggler_patience: int = 2


@dataclasses.dataclass
class TrainerReport:
    steps_done: int
    restarts: int
    stragglers: int
    losses: List[float]
    step_times: List[float]
    dropped_replicas: List[int] = dataclasses.field(default_factory=list)


class StepFailure(RuntimeError):
    pass


def run(
    cfg: TrainerConfig,
    state: PyTree,
    step_fn: StepFn,
    batch_iter,
    failure_hook: Optional[Callable[[int], None]] = None,
    log: Callable[[str], None] = print,
    straggler_monitor: Optional[StragglerMonitor] = None,
    metrics: Optional[Any] = None,
) -> Tuple[PyTree, TrainerReport]:
    """Run the loop; ``state`` is any tree holding params + opt state.

    ``step_fn(state, batch) -> (state, metrics)``; a step that updates
    the state in place must leave it as it was when it fails (raises
    :class:`StepFailure` or reports a non-finite loss), since the loop
    keeps the old state when no checkpoint exists yet.  ``failure_hook(step)`` may raise StepFailure to
    simulate a node loss at that step.

    With replica monitoring on (``cfg.n_replicas > 1`` or an explicit
    ``straggler_monitor``) the contract widens:
    ``step_fn(state, batch, alive) -> (state, metrics)`` receives the
    monitor's per-replica ``alive`` float mask (shape ``(n_replicas,)``)
    and is expected to average gradients with
    ``masked_psum_mean(grads, axis, alive[replica])``; reporting
    per-replica wall times under ``metrics["replica_step_times"]`` is
    what feeds the monitor's warn/drop verdicts.

    ``metrics`` (a :class:`repro_torch.runtime.metrics.MetricsRegistry`) is
    handed to the monitor the loop constructs, which then publishes
    per-replica ``straggler_step_ewma_s`` / ``straggler_alive`` gauges
    on every observation.  Ignored when ``straggler_monitor`` is passed
    explicitly — a pre-built monitor carries its own registry.
    """
    start_step = 0
    existing = ckpt.latest_step(cfg.ckpt_dir)
    if existing is not None:
        state, start_step = ckpt.restore(cfg.ckpt_dir, state)
        log(f"[trainer] resumed from step {start_step}")

    restarts = 0
    stragglers = 0
    losses: List[float] = []
    times: List[float] = []
    ewma: Optional[float] = None
    monitor = straggler_monitor
    if monitor is None and cfg.n_replicas > 1:
        monitor = StragglerMonitor(
            cfg.n_replicas,
            warn_factor=cfg.straggler_warn_factor,
            drop_factor=cfg.straggler_drop_factor,
            patience=cfg.straggler_patience,
            metrics=metrics,
        )
    dropped: List[int] = []

    step = start_step
    while step < cfg.total_steps:
        batch = next(batch_iter)
        t0 = time.perf_counter()
        try:
            if failure_hook is not None:
                failure_hook(step)
            if monitor is not None:
                new_state, metrics = step_fn(state, batch, monitor.alive())
            else:
                new_state, metrics = step_fn(state, batch)
            loss = float(metrics.get("loss", np.nan))
            if not np.isfinite(loss):
                raise StepFailure(f"non-finite loss at step {step}: {loss}")
            state = new_state
        except StepFailure as e:
            restarts += 1
            if restarts > cfg.max_restarts:
                raise RuntimeError(
                    f"exceeded max_restarts={cfg.max_restarts}"
                ) from e
            log(f"[trainer] step {step} failed ({e}); restoring + retrying")
            ckpt.wait_pending()
            existing = ckpt.latest_step(cfg.ckpt_dir)
            if existing is not None:
                state, step = ckpt.restore(cfg.ckpt_dir, state)
            else:
                step = start_step
            continue
        dt = time.perf_counter() - t0
        times.append(dt)
        losses.append(loss)

        # --- straggler monitor (EWMA of step time) ---------------------
        if ewma is None:
            ewma = dt
        else:
            if dt > cfg.straggler_factor * ewma and step > start_step + 3:
                stragglers += 1
                log(f"[trainer] straggler step {step}: {dt:.3f}s vs EWMA {ewma:.3f}s")
            ewma = 0.9 * ewma + 0.1 * dt

        # --- replica-level monitor (per-replica times -> alive mask) ---
        if monitor is not None and "replica_step_times" in metrics:
            for v in monitor.observe(
                np.asarray(metrics["replica_step_times"], np.float64)
            ):
                if v.action == "drop":
                    dropped.append(v.replica)
                    stragglers += 1
                    log(f"[trainer] replica {v.replica} dropped at step "
                        f"{step} ({v.ratio:.1f}x median); gradient "
                        f"averaging renormalizes over the survivors")
                else:
                    stragglers += 1
                    log(f"[trainer] replica {v.replica} straggling at step "
                        f"{step} ({v.ratio:.1f}x median)")

        step += 1
        if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
            ckpt.save_async(
                cfg.ckpt_dir, step, state, shards=cfg.ckpt_shards, keep=cfg.keep
            )
        if step % cfg.log_every == 0:
            log(f"[trainer] step {step}/{cfg.total_steps} loss={loss:.4f} ({dt*1e3:.0f} ms)")

    ckpt.wait_pending()
    return state, TrainerReport(
        steps_done=step - start_step,
        restarts=restarts,
        stragglers=stragglers,
        losses=losses,
        step_times=times,
        dropped_replicas=dropped,
    )
