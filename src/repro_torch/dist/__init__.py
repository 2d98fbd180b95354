"""Mesh planning, the sharded SpMM's collectives and the traffic ledger."""
