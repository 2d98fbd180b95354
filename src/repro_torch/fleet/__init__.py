"""repro_torch.fleet — a multi-tenant servable fleet behind one runtime.

The port of ``repro.fleet``.  Many graphs served by one deadline-aware
queue / scheduler / worker loop: ``Servable`` abstracts the model kind
(:class:`GcnServable` over the port's serving engine; :class:`LmServable`
waits for the LM models, ROADMAP A13), :class:`FleetManager` owns routing
and hot load/unload under a residency budget, :class:`TenantTable`
enforces per-tenant quotas and SLO classes at admission, and
:class:`FleetRuntime` ties them to ``repro_torch.runtime`` with
per-servable batching geometry and weighted-fair batch ordering.
"""

from repro_torch.fleet.loadgen import TenantLoad, run_open_loop_mix
from repro_torch.fleet.manager import (
    FleetBucket,
    FleetEstimator,
    FleetManager,
    FleetRuntime,
    build_servable,
    fleet_from_config,
)
from repro_torch.fleet.servable import (
    EwmaEstimator,
    GcnServable,
    LmPrepared,
    LmServable,
    SeqBucket,
    Servable,
)
from repro_torch.fleet.tenancy import (
    InflightLimitError,
    MethodDeniedError,
    QuotaExceededError,
    TenantAdmissionError,
    TenantPolicy,
    TenantTable,
)

__all__ = [
    "Servable",
    "GcnServable",
    "LmServable",
    "LmPrepared",
    "SeqBucket",
    "EwmaEstimator",
    "FleetBucket",
    "FleetEstimator",
    "FleetManager",
    "FleetRuntime",
    "build_servable",
    "fleet_from_config",
    "TenantPolicy",
    "TenantTable",
    "TenantAdmissionError",
    "QuotaExceededError",
    "InflightLimitError",
    "MethodDeniedError",
    "TenantLoad",
    "run_open_loop_mix",
]
