"""The sharded SpMM's collectives and the DRAM/collective traffic ledger.

The port of ``repro.dist.collectives``' segment epilogues, SPMD: each rank
calls them with its own shard, and a ``torch.distributed`` process group
(an axis of the mesh, ``repro_torch.launch.mesh``) completes the rows.

* :func:`segment_psum` — the replicated epilogue: each shard folds its
  vertex-cut sub-row products into a full-height partial output
  (``core.spmm.segment_accumulate``), then ``all_reduce`` sums the
  partials, so every rank holds every output row;
* :func:`segment_reduce_scatter` — the row-sharded epilogue: the same fold
  into the padded height, then ``reduce_scatter`` leaves rank ``i`` rows
  ``[i * n/size, (i+1) * n/size)`` of the sum, at half the bytes;
* :func:`all_gather_rows` — the row-sharded dense prologue, and
  :func:`assemble`, which gathers a rank's shard of a sharded output into
  the global array (for tests and callers that need it).

A gloo group takes CUDA tensors for all three collectives (two ranks on
one card, where NCCL refuses); :func:`collective_path` names the way a
call runs, chosen by the group's backend, and :data:`COLLECTIVE_CALLS`
counts the calls per collective and way.

:class:`CollectiveLedger` records the modeled bytes of every dispatch,
host-side, with the reference's exact formulas, so the two packages'
ledgers can be compared entry for entry.  The reference's
``masked_psum_mean`` serves its trainer only (ROADMAP A14).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class CollectiveLedger:
    """Per-process tally of modeled DRAM and collective traffic.

    One entry per dispatched layer or SpMM; ``bytes`` holds the modeled
    byte count of each kind, ``counts`` how many records were made.
    """

    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: Observers called as ``listener(kind, nbytes, n)`` on every record.
    #: ``repro_torch.obs`` registers one to adopt ledger records as span
    #: events; listeners never affect the tallies and ``reset`` leaves
    #: them installed.
    listeners: List[Callable[[str, float, int], None]] = dataclasses.field(
        default_factory=list)
    _muted: threading.local = dataclasses.field(
        default_factory=threading.local, repr=False, compare=False)

    def record(self, kind: str, nbytes: float, n: int = 1) -> None:
        if getattr(self._muted, "depth", 0):
            return
        self.counts[kind] = self.counts.get(kind, 0) + n
        self.bytes[kind] = self.bytes.get(kind, 0.0) + float(nbytes)
        for listener in self.listeners:
            listener(kind, float(nbytes), n)

    @contextlib.contextmanager
    def muted(self):
        """Drop this thread's records inside the block.

        A serving executable on the CPU is a closure over the eager
        forward, whose dispatches record as they run; a CUDA graph replay
        on the card records nothing.  The batcher runs its CPU closures
        muted so that both devices ledger a served batch the same way:
        once, host-side, through ``MicroBatcher.record_batch_dram``.
        """
        self._muted.depth = getattr(self._muted, "depth", 0) + 1
        try:
            yield
        finally:
            self._muted.depth -= 1

    def record_fused_writeback(self, saved_bytes: float) -> None:
        """Ledger a fused layer's activation writeback: zero bytes, recorded.

        The explicit 0-byte ``activation_dram`` entry keeps the entry count
        comparable between fused and unfused runs; the eliminated bytes
        are tallied under ``fused_writeback_saved``.
        """
        self.record("activation_dram", 0.0)
        self.record("fused_writeback_saved", float(saved_bytes))

    def reset(self) -> None:
        self.counts.clear()
        self.bytes.clear()

    def snapshot(self) -> dict:
        return {"counts": dict(self.counts), "bytes": dict(self.bytes)}


#: The process-global ledger every dispatch records into.
LEDGER = CollectiveLedger()


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

#: Calls per ``"<collective>@<way>"`` (:func:`collective_path`), since the
#: last :func:`reset_collective_calls`.
COLLECTIVE_CALLS: Dict[str, int] = {}

# torch 2.13 names the tensor forms ``*_single``; earlier releases have
# only ``*_into_tensor`` / ``*_tensor`` (same arguments).
_ALL_GATHER = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_REDUCE_SCATTER = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


def reset_collective_calls() -> None:
    COLLECTIVE_CALLS.clear()


def collective_path(group, tensor: torch.Tensor) -> str:
    """How a collective over ``group`` runs on ``tensor``: ``"nccl"``,
    ``"gloo on CUDA"`` (a gloo group given card tensors) or ``"gloo"``
    (host tensors).  Decided by the group's backend."""
    if dist.get_backend(group) == "nccl":
        return "nccl"
    return "gloo on CUDA" if tensor.is_cuda else "gloo"


def _count(op: str, group, tensor: torch.Tensor) -> None:
    key = f"{op}@{collective_path(group, tensor)}"
    COLLECTIVE_CALLS[key] = COLLECTIVE_CALLS.get(key, 0) + 1


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    _count("all_reduce", group, t)
    dist.all_reduce(t, group=group)
    return t


def reduce_scatter_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` and keep this rank's contiguous slice of
    rows; ``t``'s height must divide by the group's size."""
    size = dist.get_world_size(group)
    if t.shape[0] % size:
        raise ValueError(f"reduce-scatter of {t.shape[0]} rows over "
                         f"{size} ranks: pad the height first")
    out = torch.empty((t.shape[0] // size,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _count("reduce_scatter", group, t)
    _REDUCE_SCATTER(out, t.contiguous(), group=group)
    return out


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked by rank along the rows (equal shapes)."""
    size = dist.get_world_size(group)
    out = torch.empty((t.shape[0] * size,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _count("all_gather", group, t)
    _ALL_GATHER(out, t.contiguous(), group=group)
    return out


def all_gather_columns(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``(rows, f)`` block side by side, by rank:
    ``(rows, size * f)``."""
    size = dist.get_world_size(group)
    rows, f = t.shape
    stacked = all_gather_rows(t, group).view(size, rows, f)
    return stacked.permute(1, 0, 2).reshape(rows, size * f)


def segment_psum(sub_rows: torch.Tensor, row_map: torch.Tensor,
                 n_out_rows: int, group) -> torch.Tensor:
    """Fold local sub-row partials into ``n_out_rows`` output rows, then sum
    the partials over ``group``: every rank ends with the full height."""
    from repro_torch.core.spmm import segment_accumulate  # deferred: no cycle

    return all_reduce(segment_accumulate(sub_rows, row_map, n_out_rows),
                      group)


def segment_reduce_scatter(sub_rows: torch.Tensor, row_map: torch.Tensor,
                           n_out_rows: int, group) -> torch.Tensor:
    """Row-sharded epilogue: the same fold into ``n_out_rows`` (padded to a
    multiple of the group's size by the caller, since the padded height is
    also the next layer's dense height), then reduce-scatter, so rank ``i``
    keeps rows ``[i * n_out_rows/size, (i+1) * n_out_rows/size)`` of the
    sum.  Followed by an all-gather it gives :func:`segment_psum`'s rows."""
    from repro_torch.core.spmm import segment_accumulate  # deferred: no cycle

    return reduce_scatter_rows(
        segment_accumulate(sub_rows, row_map, n_out_rows), group)


def assemble(x: torch.Tensor, plan,
             n_cols: Optional[int] = None) -> torch.Tensor:
    """The global array of which ``x`` is this rank's shard under ``plan``
    (an ``exec.plan.SpmmPlan`` or an ``exec.pipeline.GcnPipelinePlan``,
    whose last layer made ``x``): row shards gathered over the data axis
    (the padded height), feature shards side by side over the feature axis
    and cut to ``n_cols`` when given.  A replicated ``x`` comes back as it
    is.  Every rank of the mesh calls it."""
    if hasattr(plan, "layers"):
        plan = plan.layers[-1].spmm
    if plan.sharded and plan.out_layout == "row_sharded":
        x = all_gather_rows(x, plan.mesh.get_group(plan.data_axis))
    if plan.feature_sharded:
        x = all_gather_columns(x, plan.mesh.get_group(plan.feature_axis))
    return x if n_cols is None else x[:, :n_cols]
