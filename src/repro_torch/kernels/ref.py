"""Plain PyTorch oracles for the FlexVector ELL products."""

from __future__ import annotations

import torch

PAD_COL = -1


def spmm_ell_ref(cols: torch.Tensor, vals: torch.Tensor,
                 dense: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Row-wise product oracle over the bounded-RNZ ELL table.

    out[i] = sum_t vals[i, t] * dense[cols[i, t]]  (PAD_COL slots masked)

    The sub-row output before the vertex-cut partial-sum fold
    (``repro_torch.core.spmm.segment_accumulate``).  ``out_dtype``
    defaults to int32 for an integer ``dense``, else f32.  Each gathered
    row and each weight is cast to ``out_dtype`` and their product taken
    there (so a bf16 ``out_dtype`` rounds every product to bf16); the
    products are summed in ``out_dtype``, or in f32 (int32) where it is a
    narrower float (integer) type, and the sum is cast to ``out_dtype``
    once, as the reference's ``.sum`` does.  One ELL slot at a time, so the
    temporary is one ``(R, F)`` gather.
    """
    if out_dtype is None:
        out_dtype = (torch.float32 if dense.dtype.is_floating_point
                     else torch.int32)
    acc_dtype = out_dtype
    if out_dtype.itemsize < 4:
        acc_dtype = (torch.float32 if out_dtype.is_floating_point
                     else torch.int32)
    keep = cols != PAD_COL
    safe = torch.where(keep, cols, 0).long()
    w = torch.where(keep, vals, torch.zeros((), dtype=vals.dtype,
                                            device=vals.device)).to(out_dtype)
    out = torch.zeros(cols.shape[0], dense.shape[1], dtype=acc_dtype,
                      device=dense.device)
    for t in range(cols.shape[1]):
        out += (w[:, t, None] * dense[safe[:, t]].to(out_dtype)).to(acc_dtype)
    return out.to(out_dtype)


def spmm_ell_quant_ref(cols: torch.Tensor, q_vals: torch.Tensor,
                       scales: torch.Tensor, dense: torch.Tensor,
                       block_rows: int) -> torch.Tensor:
    """Dequantize-then-multiply oracle for the int8 sub-row product path.

    Dequantizes the symmetric per-row-block int8 values exactly (f32
    multiply by the block scale; rows past the last scale take 1.0) and
    runs :func:`spmm_ell_ref` in f32.
    """
    return spmm_ell_ref(cols, dequantize_rows(q_vals, scales, block_rows),
                        dense, out_dtype=torch.float32)


def row_scales(scales, block_rows: int, n_rows: int) -> torch.Tensor:
    """Per-block scales as a per-row f32 vector of length ``n_rows`` (rows
    past the last scaled block take 1.0)."""
    expanded = torch.as_tensor(scales, dtype=torch.float32).repeat_interleave(
        block_rows)
    if expanded.shape[0] < n_rows:
        expanded = torch.cat(
            [expanded, expanded.new_ones(n_rows - expanded.shape[0])])
    return expanded[:n_rows]


def dequantize_rows(q_vals: torch.Tensor, scales, block_rows: int) -> torch.Tensor:
    """``(R, ...)`` int8 values times their row block's f32 scale, in f32."""
    r = q_vals.shape[0]
    rs = row_scales(scales, block_rows, r).to(q_vals.device)
    return q_vals.to(torch.float32) * rs.reshape((r,) + (1,) * (q_vals.dim() - 1))


def expand_block_ref(cols: torch.Tensor, vals: torch.Tensor, kb_base: int,
                     block_k: int, acc_dtype=torch.float32) -> torch.Tensor:
    """Oracle for the TPU kernels' one-hot block expansion: the (BR, tau)
    ELL slab as a dense (BR, block_k) block of k-tile ``kb_base``."""
    br, tau = cols.shape
    local = cols.long() - kb_base
    in_range = (local >= 0) & (local < block_k) & (cols != PAD_COL)
    out = torch.zeros(br, block_k, dtype=acc_dtype, device=cols.device)
    rows = torch.arange(br, device=cols.device)[:, None].expand(br, tau)
    zero = torch.zeros((), dtype=acc_dtype, device=cols.device)
    out.index_put_((rows.reshape(-1), torch.where(in_range, local, 0).reshape(-1)),
                   torch.where(in_range, vals.to(acc_dtype), zero).reshape(-1),
                   accumulate=True)
    return out
