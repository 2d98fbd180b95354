"""Deterministic synthetic data (token batches for LM training)."""
