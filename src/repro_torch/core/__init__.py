"""Host-side core: sparse formats, preprocessing, launch schedules, SpMM,
Algorithm 2 and the coarse-grained ISA.

Exports the reference's (``repro.core``) names, each bound to the port's
own object.  ``spmm`` reaches ``repro_torch.exec`` only through imports
deferred into its functions, so ``core`` -> ``exec`` stays acyclic.
"""

from repro_torch.core.sparse_formats import (
    CSRMatrix,
    TiledELL,
    PAD_COL,
    csr_to_ell,
    csr_rows_to_ell,
    ell_to_dense,
    random_power_law_csr,
)
from repro_torch.core.preprocessing import (
    PreprocessResult,
    Tile,
    VertexCutTile,
    edge_cut_permutation,
    apply_symmetric_permutation,
    partition_into_tiles,
    vertex_cut_tile,
    preprocess,
    hot_column_permutation,
)
from repro_torch.core.topk_select import (
    select_top_k,
    fixed_region_columns,
    tile_miss_profile,
)
from repro_torch.core.isa import (
    Op,
    Instr,
    TileProgram,
    build_tile_program,
    build_programs,
    expand_instructions,
)
from repro_torch.core.dataflow import (
    BufferPlan,
    KernelGrid,
    plan_buffer,
    plan_kernel_grid,
)
from repro_torch.core.spmm import (
    spmm_ell,
    segment_accumulate,
    spmm_dense_oracle,
)

__all__ = [
    "CSRMatrix",
    "TiledELL",
    "PAD_COL",
    "csr_to_ell",
    "csr_rows_to_ell",
    "ell_to_dense",
    "random_power_law_csr",
    "PreprocessResult",
    "Tile",
    "VertexCutTile",
    "edge_cut_permutation",
    "apply_symmetric_permutation",
    "partition_into_tiles",
    "vertex_cut_tile",
    "preprocess",
    "hot_column_permutation",
    "select_top_k",
    "fixed_region_columns",
    "tile_miss_profile",
    "Op",
    "Instr",
    "TileProgram",
    "build_tile_program",
    "build_programs",
    "expand_instructions",
    "BufferPlan",
    "KernelGrid",
    "plan_buffer",
    "plan_kernel_grid",
    "spmm_ell",
    "segment_accumulate",
    "spmm_dense_oracle",
]
