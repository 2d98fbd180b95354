"""Area model (28 nm), anchored on the paper's Fig 9 breakdown (the port's copy
of ``repro.sim.area``: host arithmetic on the hardware configs)."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.sim import hw_config as hc
from repro_torch.sim.hw_config import GROWConfig, HWConfig


@dataclasses.dataclass(frozen=True)
class AreaReport:
    components_um2: Dict[str, float]

    @property
    def total_um2(self) -> float:
        return float(sum(self.components_um2.values()))

    def breakdown(self) -> Dict[str, float]:
        t = self.total_um2
        return {k: v / t for k, v in self.components_um2.items()}


def flexvector_area(hw: HWConfig) -> AreaReport:
    lanes = hw.lanes
    comps = {
        "dense_buffer": hc.AREA_DB_FIXED + hc.AREA_DB_PER_BYTE * hw.dense_buffer_bytes,
        "sparse_buffer": hc.AREA_SB_FIXED + hc.AREA_SB_PER_BYTE * hw.sparse_buffer_bytes,
        "vrf": hc.AREA_VRF_PER_BYTE * hw.vrf_bytes,
        "mac_lanes": hc.AREA_MAC_PER_LANE * lanes,
        # multi-buffer + flexible-VRF control adds modest logic on top of
        # the baseline controller (paper: +4.7% total vs GROW-like).
        "control": hc.AREA_CONTROL * (1.0 + 0.05 * max(hw.m - 1, 0) / 5.0),
        "csr_decoder_dma": hc.AREA_CSR_DMA,
    }
    return AreaReport(comps)


def grow_area(gw: GROWConfig) -> AreaReport:
    lanes = gw.vlen_bits // gw.elem_bits
    comps = {
        "dense_buffer": hc.AREA_DB_FIXED + hc.AREA_DB_PER_BYTE * gw.dense_buffer_bytes,
        "sparse_buffer": hc.AREA_SB_FIXED + hc.AREA_SB_PER_BYTE * gw.sparse_buffer_bytes,
        "mac_lanes": hc.AREA_MAC_PER_LANE * lanes,
        "control": hc.AREA_CONTROL,
        "runahead": hc.AREA_GROW_RUNAHEAD,
        "csr_decoder_dma": hc.AREA_CSR_DMA,
    }
    return AreaReport(comps)
