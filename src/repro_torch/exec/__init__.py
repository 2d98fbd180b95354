"""Execution-plan layer: one planned pipeline behind every SpMM entry point.

* ``plan``     — :class:`SpmmPlan`, the impl-name table and resolution;
* ``operands`` — :class:`SpmmOperands`, ELL tensors + host container;
* ``dispatch`` — :func:`execute` / :func:`execute_layer`;
* ``fused``    — :func:`execute_fused`, one launch per GCN layer;
* ``quant``    — the storage-precision policy (f32 / bf16 / int8).
"""

from repro_torch.exec.plan import IMPL_NAMES, SpmmPlan, plan_for_config
from repro_torch.exec.operands import SpmmOperands
from repro_torch.exec.dispatch import (
    execute,
    execute_layer,
    prepare_precision,
    sub_row_products,
)
from repro_torch.exec.fused import execute_fused

__all__ = [
    "IMPL_NAMES",
    "SpmmPlan",
    "plan_for_config",
    "SpmmOperands",
    "execute",
    "execute_layer",
    "prepare_precision",
    "sub_row_products",
    "execute_fused",
]
