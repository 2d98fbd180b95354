"""The GCN model, the LM/SSM models (``layers``, ``ssm``, ``lm``) and the
parameter bridge from the reference (``convert``)."""
