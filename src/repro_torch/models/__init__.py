"""The GCN model, the LM/SSM models (``layers``, ``ssm``, ``lm``) and the
parameter bridge from the reference (``convert``).

Exports the reference's (``repro.models``) names: the GCN's."""

from repro_torch.models.gcn import (
    GCNConfig,
    GCNGraph,
    gcn_accuracy,
    gcn_forward,
    gcn_loss,
    init_params,
)

__all__ = [
    "GCNConfig",
    "GCNGraph",
    "gcn_accuracy",
    "gcn_forward",
    "gcn_loss",
    "init_params",
]
