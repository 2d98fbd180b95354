"""Instruction-driven PPA simulator — the paper's evaluation vehicle.

The port's copy of ``repro.sim``: the tile statistics, Algorithm 2 and
the two simulators' group-bys run as ``torch`` ops on a device (the
card unless the caller passes ``device="cpu"``); the cycle, energy and
area arithmetic runs on the host in the reference's order, so every
result equals the reference's.  Its figures are the modeled cycles,
energy and area of the FlexVector and GROW-like ASIC designs.
"""

from repro_torch.sim.hw_config import HWConfig, GROWConfig, sram_pj_per_byte
from repro_torch.sim.blockstats import BlockStats, compute_block_stats, alg2_best_k
from repro_torch.sim.flexvector_sim import SimResult, simulate_flexvector
from repro_torch.sim.grow_sim import simulate_grow
from repro_torch.sim.area import flexvector_area, grow_area, AreaReport

__all__ = [
    "HWConfig",
    "GROWConfig",
    "sram_pj_per_byte",
    "BlockStats",
    "compute_block_stats",
    "alg2_best_k",
    "SimResult",
    "simulate_flexvector",
    "simulate_grow",
    "flexvector_area",
    "grow_area",
    "AreaReport",
]
