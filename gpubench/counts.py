"""Operations and bytes of GCN inference, counted from its logical work.

Every count comes from the configuration's widths and the graph's
``nnz(A_hat)``, never from the program's layout (its ELL slots, padding,
sub-rows or block widths), so a change of layout cannot move a roofline.
A nonzero of ``A_hat`` is 8 bytes (a 4-byte column index and a 4-byte
value); activations and weights are f32.
"""

from __future__ import annotations

NNZ_BYTES = 8
F32 = 4


def combination_flops(n: int, f_in: int, f_out: int) -> float:
    return 2.0 * n * f_in * f_out


def aggregation_flops(nnz: int, f_out: int) -> float:
    return 2.0 * nnz * f_out


def model_flops(n: int, nnz: int, dims) -> float:
    """FLOPs of one inference: each layer's combination and aggregation
    (``dims`` holds each layer's ``(f_in, f_out)``)."""
    return sum(combination_flops(n, fi, fo) + aggregation_flops(nnz, fo)
               for fi, fo in dims)


def aggregation_bytes(n: int, nnz: int, f_out: int) -> float:
    """One aggregation: ``A_hat`` read once, the ``n x f_out`` operand read
    once and the ``n x f_out`` output written once."""
    return float(nnz * NNZ_BYTES + 2 * n * f_out * F32)


def fused_layer_bytes(n: int, nnz: int, f_in: int, f_out: int) -> float:
    """One fused layer: ``X`` read once, ``W``, ``A_hat`` read once and the
    ``n x f_out`` output written once (``X W`` never leaves the chip)."""
    return float(n * f_in * F32 + f_in * f_out * F32 + nnz * NNZ_BYTES
                 + n * f_out * F32)


def aggregation_least_seconds(n: int, nnz: int, dims, hbm_bytes_s: float) -> float:
    """The least time of the unfused aggregations of one inference."""
    return sum(aggregation_bytes(n, nnz, fo) for _, fo in dims) / hbm_bytes_s


def fused_least_seconds(n: int, nnz: int, dims, flops_s: float,
                        hbm_bytes_s: float) -> float:
    """The least time of the fused layers of one inference: per layer the
    larger of its FLOPs over the peak and its bytes over the bandwidth."""
    return sum(max((combination_flops(n, fi, fo) + aggregation_flops(nnz, fo))
                   / flops_s,
                   fused_layer_bytes(n, nnz, fi, fo) / hbm_bytes_s)
               for fi, fo in dims)
