"""The DRAM/collective traffic ledger (``repro.dist.collectives`` ledger part).

The executors record the modeled bytes of every dispatch here, host-side,
with the reference's exact formulas, so the two packages' ledgers can be
compared entry for entry.  The collectives themselves wait for the
multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class CollectiveLedger:
    """Per-process tally of modeled DRAM and collective traffic.

    One entry per dispatched layer or SpMM; ``bytes`` holds the modeled
    byte count of each kind, ``counts`` how many records were made.
    """

    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    def record(self, kind: str, nbytes: float, n: int = 1) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + n
        self.bytes[kind] = self.bytes.get(kind, 0.0) + float(nbytes)

    def record_fused_writeback(self, saved_bytes: float) -> None:
        """Ledger a fused layer's activation writeback: zero bytes, recorded.

        The explicit 0-byte ``activation_dram`` entry keeps the entry count
        comparable between fused and unfused runs; the eliminated bytes
        are tallied under ``fused_writeback_saved``.
        """
        self.record("activation_dram", 0.0)
        self.record("fused_writeback_saved", float(saved_bytes))

    def reset(self) -> None:
        self.counts.clear()
        self.bytes.clear()

    def snapshot(self) -> dict:
        return {"counts": dict(self.counts), "bytes": dict(self.bytes)}


#: The process-global ledger every dispatch records into.
LEDGER = CollectiveLedger()
