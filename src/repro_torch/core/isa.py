"""Coarse-grained ISA of FlexVector (paper Section III-D, Table II).

The port's copy of ``repro.core.isa`` (host numpy); for the same tiles
every program and instruction list equals the reference's.

Two artifacts are produced from a preprocessed tile stream:

* an explicit instruction list (``build_tile_program``) mirroring Fig 5 —
  used in tests and for instruction-count accounting (Fig 13a compares the
  coarse-grained count against the fine-grained expansion GROW uses);
* a vectorized :class:`TileProgram` (numpy arrays of per-sub-row RNZ and
  miss counts) that the instruction-driven simulator executes at scale —
  Reddit/Yelp have tens of millions of edges, so per-instruction Python
  objects are only materialized on demand.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.preprocessing import VertexCutTile
from repro_torch.core.topk_select import select_top_k, tile_miss_profile


class Op(enum.Enum):
    CONFIG = "Config"      # configure VRF fixed region boundary
    LD_S = "LD_S"          # DRAM -> Sparse Buffer
    LD_D = "LD_D"          # DRAM -> Dense Buffer
    CAL_IDX = "CAL_IDX"    # decode CSR, build one-hot row-index bitmap
    MV_FIXED = "MV_Fixed"  # Dense Buffer -> VRF fixed region
    MV_DYN = "MV_Dyn"      # Dense Buffer -> VRF dynamic region
    CMP = "CMP"            # sparse (sub-)row x dense sub-matrix -> output row
    ST_D = "ST_D"          # Dense Buffer -> DRAM


@dataclasses.dataclass(frozen=True)
class Instr:
    op: Op
    # Operand payload sizes; semantics depend on op (see expand_instructions).
    n: int = 0          # rows moved / nonzeros decoded / k
    partial: bool = False  # CMP accumulates into an existing partial row

    def __str__(self) -> str:
        flag = ",acc" if self.partial else ""
        return f"{self.op.value}({self.n}{flag})"


@dataclasses.dataclass(frozen=True)
class TileProgram:
    """Vectorized coarse-grained program for one tile."""

    k: int                     # fixed-region depth chosen by Algorithm 2
    n_sub_rows: int
    rnz: np.ndarray            # (n_sub_rows,) nonzeros per CMP
    miss: np.ndarray           # (n_sub_rows,) MV_Dyn rows per sub-row
    n_dense_rows: int          # unique dense rows the tile touches (LD_D)
    sparse_nnz: int            # nonzeros in the sparse tile (LD_S/CAL_IDX)
    out_rows: int              # rows written by ST_D
    partial: np.ndarray        # (n_sub_rows,) bool, CMP accumulate flag

    def coarse_instr_count(self) -> int:
        """Setup (Config, LD_S, LD_D, CAL_IDX, MV_Fixed) + per-row
        (MV_Dyn, CMP) + ST_D (Fig 5b)."""
        return 5 + 2 * self.n_sub_rows + 1

    def fine_instr_count(self) -> int:
        """Fine-grained expansion: one move + one MAC issue per nonzero
        (GROW-style control, Section VI-F red line)."""
        return 5 + int(self.rnz.sum()) * 2 + 1


def build_tile_program(
    vc: VertexCutTile,
    vrf_depth: int,
    mode: str = "double",
    k: Optional[int] = None,
    pct: float = 0.5,
) -> TileProgram:
    """Lower one vertex-cut tile to its coarse-grained program.

    If ``k`` is None, Algorithm 2 selects the fixed-region depth per tile
    (the paper's "+Flexible k" configuration); otherwise the given static k
    is used (the fixed-k bars of Fig 11).
    """
    if k is None:
        k = select_top_k(vc, vc.tau, vrf_depth, mode=mode, pct=pct)
    k = int(min(k, vrf_depth))
    miss, _hit = tile_miss_profile(vc, k)
    rnz = vc.rnz()
    # Sub-rows that share an output row with an earlier sub-row accumulate.
    seen = set()
    partial = np.zeros(len(vc.sub_row_map), dtype=bool)
    for i, r in enumerate(vc.sub_row_map.tolist()):
        partial[i] = r in seen
        seen.add(r)
    return TileProgram(
        k=k,
        n_sub_rows=len(vc.sub_rows_cols),
        rnz=rnz,
        miss=miss,
        n_dense_rows=len(vc.tile.col_ids),
        sparse_nnz=int(rnz.sum()),
        out_rows=len(seen),
        partial=partial,
    )


def expand_instructions(prog: TileProgram) -> List[Instr]:
    """Materialize the explicit coarse-grained instruction list (Fig 5b)."""
    instrs = [
        Instr(Op.CONFIG, prog.k),
        Instr(Op.LD_S, prog.sparse_nnz),
        Instr(Op.CAL_IDX, prog.sparse_nnz),
        Instr(Op.LD_D, prog.n_dense_rows),
        Instr(Op.MV_FIXED, prog.k),
    ]
    for i in range(prog.n_sub_rows):
        instrs.append(Instr(Op.MV_DYN, int(prog.miss[i])))
        instrs.append(Instr(Op.CMP, int(prog.rnz[i]), partial=bool(prog.partial[i])))
    instrs.append(Instr(Op.ST_D, prog.out_rows))
    return instrs


def build_programs(
    tiles: Sequence[VertexCutTile],
    vrf_depth: int,
    mode: str = "double",
    k: Optional[int] = None,
    pct: float = 0.5,
) -> List[TileProgram]:
    return [build_tile_program(t, vrf_depth, mode=mode, k=k, pct=pct) for t in tiles]
