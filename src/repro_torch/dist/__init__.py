"""Traffic ledger; the multi-GPU collectives are a queued slice."""
