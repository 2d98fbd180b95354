"""Hardware configuration + PPA constants of the paper's FlexVector tile.

A copy of ``repro.sim.hw_config`` (pure dataclasses and constants): the
cost model (``repro_torch.plan.cost``) takes ``HWConfig``,
``PJ_PER_BYTE_DRAM`` and ``sram_pj_per_byte`` from it.

Defaults mirror the paper's Section VI-A3 setup: 28 nm @ 1 GHz, VLEN=128 bit
(16 x 8-bit lanes), VRF depth 6x2 (double-VRF, vertex-cut bound tau=6),
Dense Buffer 2 KB, Sparse Buffer 256 B, multi-buffer m=6, HBM 1.0 at
128 GB/s and 7 pJ/bit, 16x16 tiles.

Energy/area constants are CACTI-7-style fits anchored on the paper's own
published breakdown (Fig 9: 39.43 K um^2 total with component percentages)
so that the reproduced PPA tables land in the paper's regime; EXPERIMENTS.md
reports our numbers next to the paper's.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class HWConfig:
    """FlexVector hardware configuration."""

    # --- clocks and DRAM -------------------------------------------------
    freq_hz: float = 1e9
    dram_bw_bytes_per_s: float = 128e9        # HBM 1.0
    dram_pj_per_bit: float = 7.0
    dram_latency_cycles: int = 100            # first-word latency

    # --- vector engine ----------------------------------------------------
    vlen_bits: int = 128                      # VRF row width
    elem_bits: int = 8                        # int8 inference datapath
    vrf_depth: int = 12                       # total rows (6x2 when double)
    double_vrf: bool = True
    tau: int = 6                              # vertex-cut per-row RNZ bound
    vertex_cut: bool = True
    flexible_k: bool = True                   # Algorithm 2 per-tile k
    static_k: int = 0                         # used when flexible_k=False
    pct: float = 0.5                          # Algorithm 2 start fraction

    # --- on-chip buffers --------------------------------------------------
    dense_buffer_bytes: int = 2048
    sparse_buffer_bytes: int = 256
    m: int = 6                                # multi-buffer factor

    # --- tiling -----------------------------------------------------------
    tile: int = 16                            # tile_rows == tile_cols

    # --- microarchitectural costs ----------------------------------------
    c_setup: int = 2        # per-tile Config/LD_S issue/CAL_IDX drain/ST_D issue
    c_mv: int = 1           # cycles per dense row moved buffer->VRF
    csr_val_bytes: int = 1  # int8 value
    csr_idx_bytes: int = 2  # 16-bit tile-local column index
    csr_ptr_bytes: int = 4

    @property
    def lanes(self) -> int:
        return self.vlen_bits // self.elem_bits

    @property
    def f_tile(self) -> int:
        """Feature columns covered per pass (one VRF row per dense row)."""
        return self.vlen_bits // self.elem_bits

    @property
    def row_seg_bytes(self) -> int:
        """Bytes of one dense-row segment (f_tile elements)."""
        return self.f_tile * self.elem_bits // 8

    @property
    def dram_bytes_per_cycle(self) -> float:
        return self.dram_bw_bytes_per_s / self.freq_hz

    @property
    def vrf_bytes(self) -> int:
        return self.vrf_depth * self.vlen_bits // 8

    @property
    def dyn_half_depth(self) -> int:
        """Depth of one dynamic half in double-VRF mode."""
        return self.vrf_depth // 2 if self.double_vrf else self.vrf_depth

    def effective_mode(self) -> Literal["single", "double"]:
        return "double" if self.double_vrf else "single"


@dataclasses.dataclass(frozen=True)
class GROWConfig:
    """GROW-like cache-centric baseline (paper Section VI-A4)."""

    freq_hz: float = 1e9
    dram_bw_bytes_per_s: float = 128e9
    dram_pj_per_bit: float = 7.0
    dram_latency_cycles: int = 100

    vlen_bits: int = 128       # matched MAC throughput
    elem_bits: int = 8
    dense_buffer_bytes: int = 2048
    sparse_buffer_bytes: int = 256
    m: int = 6
    run_ahead: int = 16        # look-ahead depth [GROW]
    # fine-grained control interleaves a move and a MAC issue per nonzero
    # (dependent pair on an in-order pipeline -> 2 cycles per nonzero),
    # where FlexVector's decoupled coarse-grained CMP streams 1/cycle.
    c_issue: int = 2

    csr_val_bytes: int = 1
    csr_idx_bytes: int = 2
    csr_ptr_bytes: int = 4

    @property
    def f_tile(self) -> int:
        return self.vlen_bits // self.elem_bits

    @property
    def row_seg_bytes(self) -> int:
        return self.f_tile * self.elem_bits // 8

    @property
    def dram_bytes_per_cycle(self) -> float:
        return self.dram_bw_bytes_per_s / self.freq_hz

    @property
    def cache_rows(self) -> int:
        """Dense rows the HDN buffer can pin (full capacity preloaded)."""
        return max(self.dense_buffer_bytes // self.row_seg_bytes, 1)


# --- energy constants (CACTI-7-style fits, 28 nm) --------------------------


def sram_pj_per_byte(capacity_bytes: int) -> float:
    """Dynamic read/write energy per byte for an SRAM of given capacity.

    sqrt-capacity fit: small buffers (2 KB) cost ~0.3 pJ/B while large
    cache-class arrays (512 KB) cost ~4.6 pJ/B — reproducing the paper's
    Fig 12d crossover where GROW-like-dagger's 512 KB buffers flip the
    energy balance from DRAM-dominated to SRAM-dominated.
    """
    kb = capacity_bytes / 1024.0
    return 0.20 * kb ** 0.5 + 0.05


VRF_PJ_PER_BYTE = 0.04      # register-file access (flip-flop array)
MAC_PJ_INT8 = 0.05          # one 8-bit MAC
MAC_PJ_INT32 = 0.40
LEAK_MW_PER_MM2 = 12.0      # 28 nm leakage density
PJ_PER_BYTE_DRAM = 7.0 * 8  # 7 pJ/bit


# --- area constants (anchored on paper Fig 9) ------------------------------
# Component areas at the default config (um^2): total 39.43 K um^2 with
# Dense Buffer 28.0%, Sparse Buffer 16.1%, VRF 15.7%, MAC lanes 5.8%,
# control 16.3%, CSR decoder + DMA 18.0%.

AREA_TOTAL_DEFAULT = 39430.0
AREA_DB_FIXED = 3300.0      # periphery overhead of the Dense Buffer macro
AREA_DB_PER_BYTE = 3.87     # => 2 KB -> ~11.0 K um^2 (28.0%); 512 KB -> ~2.0 M
AREA_SB_FIXED = 5500.0
AREA_SB_PER_BYTE = 3.30     # => 256 B -> ~6.3 K um^2 (16.1%)
AREA_VRF_PER_BYTE = 32.2    # => 192 B -> ~6.2 K um^2 (15.7%)
AREA_MAC_PER_LANE = 143.0   # => 16 lanes -> ~2.3 K um^2 (5.8%)
AREA_CONTROL = 6430.0       # VEX control + VID (16.3%)
AREA_CSR_DMA = 7100.0       # CSR decoder + DMA (18.0%)
AREA_GROW_RUNAHEAD = 5800.0 # run-ahead queue + fine-grained scheduler
