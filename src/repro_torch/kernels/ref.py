"""Plain PyTorch oracle for the FlexVector ELL products."""

from __future__ import annotations

import torch

PAD_COL = -1


def spmm_ell_ref(cols: torch.Tensor, vals: torch.Tensor,
                 dense: torch.Tensor) -> torch.Tensor:
    """Row-wise product oracle over the bounded-RNZ ELL table.

    out[i] = sum_t vals[i, t] * dense[cols[i, t]]  (PAD_COL slots masked)

    The sub-row output before the vertex-cut partial-sum fold
    (``repro_torch.core.spmm.segment_accumulate``).  Accumulates in f32,
    one ELL slot at a time, so the temporary is one ``(R, F)`` gather.
    """
    keep = cols != PAD_COL
    safe = torch.where(keep, cols, 0).long()
    w = torch.where(keep, vals, torch.zeros((), dtype=vals.dtype,
                                            device=vals.device)).float()
    out = torch.zeros(cols.shape[0], dense.shape[1], dtype=torch.float32,
                      device=dense.device)
    for t in range(cols.shape[1]):
        out += w[:, t, None] * dense[safe[:, t]].float()
    return out
