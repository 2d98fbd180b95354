"""GROW-like cache-centric baseline simulator (paper Section VI-A4).

The port's copy of ``repro.sim.grow_sim``.  It keeps GROW's three
mechanisms:

1. **cache-centric memory hierarchy** — the Dense Buffer holds
   *full-width* dense rows (one pass over the feature dimension) and
   preloads the top-N high-degree-node (HDN) rows, N = capacity / row
   bytes;
2. **run-ahead execution** — execution continues on buffer-resident rows
   (look-ahead 16), so miss latency overlaps the compute of hits;
3. **fine-grained ISA** — one (move, MAC) pair per nonzero x dense row.

The HDN residency (a stable descending sort of the column degrees) and
the panel-group uniques run on the device; the counts come back as
Python numbers and the rest is the reference's host arithmetic, so
every field equals the reference's.  The figures are modeled cycles and
energy of the GROW-like design.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.sparse_formats import CSRMatrix
from repro_torch.device import resolve_device
from repro_torch.sim import hw_config as hc
from repro_torch.sim.area import grow_area
from repro_torch.sim.blockstats import BlockStats
from repro_torch.sim.flexvector_sim import DRAM_BURST_BYTES, SimResult
from repro_torch.sim.hw_config import GROWConfig


def simulate_grow(
    adj: CSRMatrix,
    feature_dim: int,
    gw: GROWConfig = GROWConfig(),
    name: str = "grow-like",
    col_degree: Optional[Union[np.ndarray, torch.Tensor]] = None,
    stats: Optional[BlockStats] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> SimResult:
    """Simulate one aggregation on the GROW-like baseline.  The sorts run
    on ``device``, or on the device of ``stats`` when it is given and
    ``device`` is not; else on the card unless ``device="cpu"``."""
    if device is None and stats is not None:
        dev = stats.device
    else:
        dev = resolve_device(device)
    indices = torch.as_tensor(adj.indices, device=dev).to(torch.int64)
    if col_degree is None:
        col_degree = torch.bincount(indices, minlength=adj.cols)
    col_degree = torch.as_tensor(col_degree, device=dev).to(torch.int64)
    elem_bytes = gw.elem_bits // 8
    row_bytes = feature_dim * elem_bytes
    cpn = max(-(-feature_dim * gw.elem_bits // gw.vlen_bits), 1)

    # --- HDN residency ----------------------------------------------------
    cache_rows = min(gw.dense_buffer_bytes // max(row_bytes, 1), adj.cols)
    order = torch.sort(-col_degree, stable=True).indices
    hdn = torch.zeros(adj.cols, dtype=torch.bool, device=dev)
    hdn[order[:cache_rows]] = True
    hits = float(int(hdn[indices].sum()))
    misses = float(adj.nnz - hits)
    del indices, order, hdn
    # GROW's cache also captures short-range reuse beyond the HDN preload;
    # approximate the LRU stack with a sliding window of cache_rows rows
    # (panel-group uniques).
    if stats is not None and cache_rows >= stats.tile:
        lru_misses = float(
            stats.unique_group_loads(max(cache_rows // stats.tile, 1))
        )
        if lru_misses < misses:
            misses = lru_misses
            hits = float(adj.nnz) - misses

    # --- DRAM traffic (single pass, row granular) --------------------------
    sparse_bytes = float(
        adj.nnz * (gw.csr_val_bytes + gw.csr_idx_bytes)
        + (adj.rows + 1) * gw.csr_ptr_bytes
    )
    # outputs stream on-chip into the next phase, so stores are excluded
    # from DRAM traffic for both designs
    load_bytes = (cache_rows + misses) * row_bytes
    dram_bytes = load_bytes + sparse_bytes
    row_bursts = max(-(-row_bytes // DRAM_BURST_BYTES), 1)
    dram_accesses = (cache_rows + misses) * row_bursts

    # --- cycles -------------------------------------------------------------
    compute = float(adj.nnz) * cpn * gw.c_issue
    dram_cycles = dram_bytes / gw.dram_bytes_per_cycle
    # run-ahead: hit-row compute hides miss latency; floor at RA-deep
    # pipelining of outstanding fetches.
    miss_latency = misses * gw.dram_latency_cycles
    stall = max(miss_latency / gw.run_ahead, miss_latency - hits * cpn)
    if gw.m >= 2:
        cycles = max(compute, dram_cycles) + stall + gw.dram_latency_cycles
    else:
        cycles = compute + dram_cycles + stall + gw.dram_latency_cycles

    # --- instruction count (fine-grained: per nonzero) ----------------------
    fine = int(2 * adj.nnz + adj.rows)

    # --- energy ---------------------------------------------------------------
    e_db = hc.sram_pj_per_byte(gw.dense_buffer_bytes)
    e_sb = hc.sram_pj_per_byte(gw.sparse_buffer_bytes)
    # every nonzero streams its dense row through the cache read port
    db_bytes = load_bytes + float(adj.nnz) * row_bytes + 3.0 * adj.rows * row_bytes
    sb_bytes = 2.0 * sparse_bytes
    mac_ops = float(adj.nnz) * feature_dim
    area = grow_area(gw)

    breakdown = {
        "dram": dram_bytes * hc.PJ_PER_BYTE_DRAM,
        "dense_buffer": db_bytes * e_db,
        "sparse_buffer": sb_bytes * e_sb,
        "vrf": 0.0,
        "mac": mac_ops * hc.MAC_PJ_INT8,
    }
    time_s = cycles / gw.freq_hz
    leak_mw = hc.LEAK_MW_PER_MM2 * area.total_um2 * 1e-6
    breakdown["leakage"] = leak_mw * 1e-3 * time_s * 1e12
    energy = float(sum(breakdown.values()))

    return SimResult(
        name=name,
        cycles=float(cycles),
        time_s=time_s,
        dram_bytes=dram_bytes,
        dram_accesses=dram_accesses,
        vrf_or_cache_misses=misses,
        energy_pj=energy,
        energy_breakdown_pj=breakdown,
        area_um2=area.total_um2,
        instr_count=fine,
        fine_instr_count=fine,
        n_passes=1,
        compute_cycles=compute,
        dram_cycles=dram_cycles,
        stall_cycles=stall,
    )
