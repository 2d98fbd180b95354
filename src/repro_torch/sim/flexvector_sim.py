"""Instruction-driven cycle/energy simulator for FlexVector.

The port's copy of ``repro.sim.flexvector_sim``.  It executes the
coarse-grained ISA program (Section III-D) over the tile statistics,
with the paper's overlap semantics:

* **m-buffering (DRAM <-> buffer):** with m >= 2 the DRAM stream and the
  buffer->VRF compute pipeline overlap (Fig 8c); the pass latency is the
  max of the two, m = 1 serializes them.  Dense-row loads are
  burst-granular and grouped over m row panels.
* **double-VRF (buffer <-> VRF):** MV_Dyn of the next sub-row overlaps
  CMP of the current one (Fig 7c): per sub-row max(c_mv*miss, rnz)
  versus the single-VRF c_mv*miss + rnz.
* **flexible k (Algorithm 2):** the per-tile fixed region turns the k
  hottest columns' accesses into hits, at c_mv*k MV_Fixed cycles a tile.
* **vertex-cut:** bounds sub-row size by tau; without it, rows wider
  than the dynamic region run in ceil(RNZ/cap) refill chunks.

The group-bys and uniques run on the device of the :class:`BlockStats`;
each count is read back as a Python ``int`` and the cycle and energy
arithmetic runs on the host in the reference's order, so every field
equals the reference's.  The figures are the modeled cycles and energy
of the FlexVector design, not times of the device that computed them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from repro_torch.core.sparse_formats import CSRMatrix
from repro_torch.sim import hw_config as hc
from repro_torch.sim.area import flexvector_area
from repro_torch.sim.blockstats import (
    BlockStats,
    _ceil_div,
    alg2_best_k,
    compute_block_stats,
)
from repro_torch.sim.hw_config import HWConfig

DRAM_BURST_BYTES = 32  # HBM minimum access atom


@dataclasses.dataclass(frozen=True)
class SimResult:
    name: str
    cycles: float
    time_s: float
    dram_bytes: float
    dram_accesses: float          # burst-granular access count (Fig 12b)
    vrf_or_cache_misses: float    # dense-row miss count (Fig 12c)
    energy_pj: float
    energy_breakdown_pj: Dict[str, float]
    area_um2: float
    instr_count: int
    fine_instr_count: int
    n_passes: int
    compute_cycles: float = 0.0
    dram_cycles: float = 0.0
    stall_cycles: float = 0.0
    per_block_k: Optional[torch.Tensor] = None   # (n_blocks,) int32

    @property
    def energy_j(self) -> float:
        return self.energy_pj * 1e-12


def _total(t: torch.Tensor) -> int:
    """Exact integer sum of a tensor, read back to the host."""
    return int(t.to(torch.int64).sum())


def _per_pass_compute_cycles(
    stats: BlockStats, hw: HWConfig, k_b: torch.Tensor
) -> Dict[str, float]:
    """Per-pass VRF-level pipeline cycles + miss/MV statistics."""
    miss_br = stats.miss_per_block_row(k_b)
    rnz = stats.br_rnz.to(torch.int64)

    if hw.vertex_cut:
        k_splits = _ceil_div(rnz, hw.tau)
        sub_rnz = _ceil_div(rnz, k_splits)
        sub_miss = _ceil_div(miss_br, k_splits)      # balanced (Alg 1)
    else:
        cap = max(hw.dyn_half_depth
                  - (0 if hw.double_vrf else int(k_b.max())), 1)
        k_splits = _ceil_div(rnz, cap)
        sub_rnz = _ceil_div(rnz, k_splits)
        sub_miss = torch.clamp(miss_br, max=cap)     # worst chunk

    # one dispatch cycle per MV_Dyn instruction; sub-rows fully resident
    # in the fixed region skip the MV_Dyn entirely
    mv_issue = (sub_miss > 0).to(torch.int64) * k_splits

    if hw.double_vrf:
        row_cycles = (k_splits * torch.maximum(hw.c_mv * sub_miss, sub_rnz)
                      + mv_issue)
    else:
        row_cycles = hw.c_mv * miss_br + rnz + mv_issue

    comp = float(_total(row_cycles))
    comp += float(stats.n_blocks) * hw.c_setup + hw.c_mv * float(_total(k_b))
    return {
        "comp_pass": comp,
        "misses": float(_total(miss_br)),
        "subrows": float(_total(k_splits)),
    }


def _dram_traffic(
    stats: BlockStats, hw: HWConfig, n_passes: int
) -> Dict[str, float]:
    """Total DRAM traffic under burst-granular, m-grouped dense loads."""
    seg = hw.row_seg_bytes
    rows_per_burst = max(DRAM_BURST_BYTES // seg, 1)
    g = stats.nz_rb.to(torch.int64) // max(hw.m, 1)
    burst_key = g * (stats.n_cols + 1) + stats.nz_col // rows_per_burst
    bursts = float(len(torch.unique(burst_key)))
    load_rows = float(stats.unique_group_loads(hw.m))

    # segments wider than the HBM atom transfer seg bytes per row; narrow
    # segments share 32B atoms (coalesced across rows within a group)
    if seg >= DRAM_BURST_BYTES:
        load_bytes_pass = load_rows * seg
        bursts = load_rows * (seg // DRAM_BURST_BYTES)
    else:
        load_bytes_pass = bursts * DRAM_BURST_BYTES
    sparse_bytes = float(
        stats.nnz * (hw.csr_val_bytes + hw.csr_idx_bytes)
        + (stats.n_rows + 1) * hw.csr_ptr_bytes
    )
    # outputs stream on-chip into the next phase, so stores are excluded
    # from DRAM traffic for both designs
    store_bytes_pass = float(stats.n_rows * seg)
    return {
        "bytes": load_bytes_pass * n_passes + sparse_bytes,
        "bytes_pass": load_bytes_pass + sparse_bytes / n_passes,
        "accesses": bursts * n_passes + sparse_bytes / DRAM_BURST_BYTES,
        "load_rows": load_rows,
        "load_bytes_pass": load_bytes_pass,
        "sparse_bytes": sparse_bytes,
        "store_bytes_pass": store_bytes_pass,
    }


def simulate_flexvector(
    adj: CSRMatrix,
    feature_dim: int,
    hw: HWConfig = HWConfig(),
    stats: Optional[BlockStats] = None,
    name: str = "flexvector",
    device: Optional[Union[str, torch.device]] = None,
) -> SimResult:
    """Simulate one aggregation ``adj @ X`` (``feature_dim`` columns) on
    FlexVector.  Without ``stats`` the tiles are grouped on ``device``
    (the card unless the caller passes ``device="cpu"``)."""
    if stats is None:
        stats = compute_block_stats(adj, hw.tile, device=device)

    # --- fixed-region selection (Config / MV_Fixed) ---------------------
    if hw.flexible_k and hw.vertex_cut:
        k_b = alg2_best_k(
            stats, hw.tau, hw.vrf_depth, mode=hw.effective_mode(), pct=hw.pct
        )
    else:
        k_b = torch.clamp(stats.b_ncols, max=hw.static_k).to(torch.int32)

    comp = _per_pass_compute_cycles(stats, hw, k_b)
    n_passes = int(-(-feature_dim // hw.f_tile))
    dram = _dram_traffic(stats, hw, n_passes)

    comp_pass = comp["comp_pass"]
    dram_pass = dram["bytes_pass"] / hw.dram_bytes_per_cycle
    if hw.m >= 2:
        pass_cycles = max(comp_pass, dram_pass) + hw.dram_latency_cycles
    else:
        pass_cycles = comp_pass + dram_pass + hw.dram_latency_cycles
    cycles = pass_cycles * n_passes

    # --- instruction counts (Section VI-F) ------------------------------
    coarse = int(((5 + 1) * stats.n_blocks + 2 * comp["subrows"]) * n_passes)
    fine = int(
        ((5 + 1) * stats.n_blocks + comp["misses"] + stats.nnz) * n_passes
    )

    # --- energy ----------------------------------------------------------
    seg = hw.row_seg_bytes
    misses = comp["misses"]
    k_total = float(_total(k_b))
    out_rows = float(_total(stats.b_nrows))

    e_db = hc.sram_pj_per_byte(hw.dense_buffer_bytes)
    e_sb = hc.sram_pj_per_byte(hw.sparse_buffer_bytes)
    db_bytes_pass = (
        dram["load_bytes_pass"]                 # DRAM -> buffer writes
        + (misses + k_total) * seg              # MV reads buffer -> VRF
        + 3.0 * out_rows * seg                  # result wr + temp rd/wr
    )
    sb_bytes = 2.0 * dram["sparse_bytes"]       # stream write + decode read
    vrf_bytes_pass = (misses + k_total) * seg + float(stats.nnz) * seg
    mac_ops_pass = float(stats.nnz) * hw.f_tile
    area = flexvector_area(hw)

    breakdown = {
        "dram": dram["bytes"] * hc.PJ_PER_BYTE_DRAM,
        "dense_buffer": db_bytes_pass * n_passes * e_db,
        "sparse_buffer": sb_bytes * e_sb,
        "vrf": vrf_bytes_pass * n_passes * hc.VRF_PJ_PER_BYTE,
        "mac": mac_ops_pass * n_passes * hc.MAC_PJ_INT8,
    }
    time_s = cycles / hw.freq_hz
    leak_mw = hc.LEAK_MW_PER_MM2 * area.total_um2 * 1e-6
    breakdown["leakage"] = leak_mw * 1e-3 * time_s * 1e12  # W*s -> pJ
    energy = float(sum(breakdown.values()))

    return SimResult(
        name=name,
        cycles=float(cycles),
        time_s=time_s,
        dram_bytes=dram["bytes"],
        dram_accesses=dram["accesses"],
        vrf_or_cache_misses=misses * n_passes,
        energy_pj=energy,
        energy_breakdown_pj=breakdown,
        area_um2=area.total_um2,
        instr_count=coarse,
        fine_instr_count=fine,
        n_passes=n_passes,
        compute_cycles=comp_pass * n_passes,
        dram_cycles=dram_pass * n_passes,
        stall_cycles=0.0,
        per_block_k=k_b,
    )
