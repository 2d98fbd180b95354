"""Planning layer: one cost model behind every plan decision.

* ``cost``     — traffic/time terms over graph statistics and a device
                 model: the reference's Pallas arithmetic (``TPU_V5E``,
                 ``flexvector_device``) and the port's kernels on an H100
                 (``H100``, the default);
* ``autoplan`` — enumerate candidate :class:`~repro_torch.exec.SpmmPlan`s
                 (impl x block sizes x precision x fusion) and return the
                 argmin-cost plan.

``cost`` is imported eagerly; ``autoplan`` is loaded lazily because it
imports ``repro_torch.exec``, whose ``plan_for_config`` calls back into
it.
"""

from repro_torch.plan import cost
from repro_torch.plan.cost import (
    H100,
    TPU_V5E,
    CostBreakdown,
    CudaRates,
    DeviceModel,
    GraphStats,
    balanced_split_points,
    flexvector_device,
    grad_sync_bytes,
    graph_stats_from_ell,
    rank_specs,
    roofline_seconds,
    spmm_cost,
    synthetic_stats,
)

__all__ = [
    "CostBreakdown",
    "CudaRates",
    "DeviceModel",
    "GraphStats",
    "H100",
    "TPU_V5E",
    "autoplan",
    "balanced_split_points",
    "cost",
    "flexvector_device",
    "grad_sync_bytes",
    "graph_stats_from_ell",
    "rank_specs",
    "roofline_seconds",
    "spmm_cost",
    "synthetic_stats",
]


def __getattr__(name):
    if name == "autoplan":
        import repro_torch.plan.autoplan as _autoplan

        return _autoplan
    raise AttributeError(f"module 'repro_torch.plan' has no attribute {name!r}")
