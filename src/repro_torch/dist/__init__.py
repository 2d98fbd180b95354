"""Mesh planning, the sharded SpMM's collectives, the traffic ledger and
the sharding policy (``policy``)."""
