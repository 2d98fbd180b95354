"""Execution-plan layer: one planned pipeline behind every SpMM entry point.

* ``plan``     — :class:`SpmmPlan`, the impl-name table and resolution
                 (a degradation warned once per process,
                 :func:`reset_degradation_warnings` clears the registry);
* ``operands`` — :class:`SpmmOperands`, ELL tensors + host container, and
                 the per-shard split (:func:`shard_operands`);
* ``dispatch`` — :func:`execute` / :func:`execute_layer`;
* ``fused``    — :func:`execute_fused`, one launch per GCN layer;
* ``sharded``  — :func:`execute_sharded`, the SpMM over a data mesh;
* ``pipeline`` — :func:`plan_pipeline` / :func:`pipeline_forward`: a whole
                 GCN stack planned per layer, with its activation layouts;
* ``quant``    — the storage-precision policy (f32 / bf16 / int8) and the
                 :class:`QuantizedELL` host artifact.

Layering: ``exec`` imports ``core``, ``kernels``, ``dist`` and
``plan.cost``; ``core`` reaches back only through imports deferred into
``spmm_ell`` / ``spmm_ell_arrays``, so the import graph stays acyclic.
"""

from repro_torch.exec.plan import (
    IMPL_NAMES,
    SpmmPlan,
    plan_for_config,
    reset_degradation_warnings,
)
from repro_torch.exec import quant
from repro_torch.exec.quant import QuantizedELL, quantize_ell
from repro_torch.exec.operands import ShardedOperands, SpmmOperands, shard_operands
from repro_torch.exec.dispatch import (
    execute,
    execute_layer,
    prepare_precision,
    sub_row_products,
)
from repro_torch.exec.fused import execute_fused
from repro_torch.exec.sharded import execute_sharded
from repro_torch.exec.pipeline import (
    GcnPipelinePlan,
    LayerPlan,
    chain_layouts,
    pipeline_forward,
    plan_pipeline,
    static_pipeline,
)

__all__ = [
    "IMPL_NAMES",
    "GcnPipelinePlan",
    "LayerPlan",
    "QuantizedELL",
    "chain_layouts",
    "static_pipeline",
    "ShardedOperands",
    "SpmmOperands",
    "SpmmPlan",
    "execute",
    "execute_fused",
    "execute_layer",
    "execute_sharded",
    "pipeline_forward",
    "plan_for_config",
    "plan_pipeline",
    "prepare_precision",
    "quant",
    "quantize_ell",
    "reset_degradation_warnings",
    "shard_operands",
    "sub_row_products",
]
