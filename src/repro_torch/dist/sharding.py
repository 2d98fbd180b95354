"""Batch partition specs over a data mesh.

The port of ``repro.dist.sharding``'s ``batch_spec`` (with ``_axes_size``
and ``_dp_entry``), over the axis sizes of a mesh: an abstract mesh
(``dist.topology.abstract_mesh``) or the ``DeviceMesh`` a run is placed on
(``launch.mesh.make_data_mesh``).  A spec is a tuple of entries, one per
leading dimension, as the reference's ``PartitionSpec`` is: ``("data",)``
shards the batch over the data axis, ``(("pod", "data"),)`` over both,
``()`` replicates it.  ``ShardingPlan`` serves the LM models under a
mesh only and waits for ROADMAP A13b.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

from repro_torch.dist.topology import axis_sizes
from repro_torch.plan import cost


def _axes_size(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def _dp_entry(mesh, dp: Tuple[str, ...], dim: int, dtype_bytes: int = 4):
    """Cheapest dp-axis suffix that divides ``dim``, by estimated
    collective bytes (suffixes drop ``pod`` first; the cost model prefers
    the widest viable suffix and ties keep that order), or None when even
    the innermost axis does not fit."""
    viable = [
        dp[i:]
        for i in range(len(dp))
        if _axes_size(mesh, dp[i:]) > 1 and dim % _axes_size(mesh, dp[i:]) == 0
    ]
    if not viable:
        return None
    specs = [(c if len(c) > 1 else c[0],) for c in viable]
    chosen = viable[cost.rank_specs(axis_sizes(mesh), (dim,), specs,
                                    dtype_bytes)]
    return chosen if len(chosen) > 1 else chosen[0]


def batch_spec(mesh, global_batch: int) -> tuple:
    """Spec of a leading global-batch dim: sharded over the widest
    divisible suffix of the (pod, data) axes, else replicated (``()``)."""
    dp = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    entry = _dp_entry(mesh, dp, global_batch)
    return (entry,) if entry is not None else ()


def spec_axes(spec: tuple) -> Tuple[str, ...]:
    """The mesh axes a batch spec shards over (``()`` when replicated)."""
    if not spec:
        return ()
    entry = spec[0]
    return tuple(entry) if isinstance(entry, tuple) else (entry,)
