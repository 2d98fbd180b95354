"""Mesh planning, the sharded SpMM's collectives, the traffic ledger, the
sharding policy (``policy``) and the straggler monitor (``straggler``).

Exports the reference's (``repro.dist``) names, each bound to the port's
own object.  They load on first access (a module ``__getattr__``), so
``import repro_torch.dist`` imports none of its modules: ``sharding``
imports ``plan.cost``, which imports the kernels and the simulator's
configuration.
"""

import importlib

_HOMES = {
    "LEDGER": "collectives",
    "CollectiveLedger": "collectives",
    "masked_psum_mean": "collectives",
    "segment_psum": "collectives",
    "segment_reduce_scatter": "collectives",
    "constrain": "policy",
    "sharding_policy": "policy",
    "ShardingPlan": "sharding",
    "batch_spec": "sharding",
    "StragglerMonitor": "straggler",
    "StragglerVerdict": "straggler",
    "abstract_mesh": "topology",
    "viable_mesh_shapes": "topology",
}

__all__ = list(_HOMES)


def __getattr__(name):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{home}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
