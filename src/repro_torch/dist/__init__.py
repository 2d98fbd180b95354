"""Mesh planning, the sharded SpMM's collectives, the traffic ledger, the
sharding policy (``policy``) and the straggler monitor (``straggler``)."""
