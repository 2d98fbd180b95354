"""The GCN model and the parameter bridge from the reference."""
