"""Storage precision: int8/bf16 storage, f32 accumulation.

The port of ``repro.exec.quant``.  The policy, per precision:

``f32``
    The baseline.  Nothing is cast anywhere.

``bf16``
    ELL values, the dense operand and the layer weights are *stored*
    bfloat16; every kernel and the reference impl accumulate in f32.

``int8``
    ELL values and weights are stored as symmetric per-row-block int8
    (scale = max-abs over the block / 127, one scale per ``block_rows``
    rows; an all-zero block gets scale 1.0).  Activations stay bf16.
    Accumulation is f32 everywhere.

Quantization runs in torch f32 in the reference's order (``maxabs /
127``, then ``1 / scale``, then ``v * inv``, round half to even, clip to
+-127), so ``q`` and ``scales`` are bit-equal to the reference's on the
CPU and on the card.  Functions take tensors (or array-likes, taken as
CPU tensors) and return tensors on the input's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.flexvector_spmm import full_f32_matmul
# row_scales is part of the reference's quant API; it lives beside the
# kernels' plain versions, which dequantize with it too.
from repro_torch.kernels.ref import dequantize_rows, row_scales  # noqa: F401

PRECISIONS = ("f32", "bf16", "int8")

#: Per-row-block scale granularity for weights and host-side ELL artifacts.
QUANT_BLOCK_ROWS = 128

# int8 symmetric range: +-127 (the -128 code is unused).
_INT8_MAX = 127.0

_VALUE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
_ACTIVATION_BYTES = {"f32": 4, "bf16": 2, "int8": 2}
_STORAGE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                   "int8": torch.int8}


def validate_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision: {precision} (expected one of {PRECISIONS})"
        )
    return precision


def bytes_per_value(precision: str) -> int:
    """Stored bytes per ELL value / weight element."""
    return _VALUE_BYTES[validate_precision(precision)]


def activation_bytes(precision: str) -> int:
    """Stored bytes per dense-operand / activation element (int8 keeps
    activations in bf16, so its width is 2)."""
    return _ACTIVATION_BYTES[validate_precision(precision)]


def storage_dtype(precision: str) -> torch.dtype:
    """The dtype ELL values are stored in under ``precision``."""
    return _STORAGE_DTYPES[validate_precision(precision)]


def cast_dense(dense: torch.Tensor, precision: str) -> torch.Tensor:
    """Cast the dense operand to its storage dtype (bf16 for bf16/int8)."""
    if validate_precision(precision) == "f32":
        return dense
    return dense.to(torch.bfloat16)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a))


def quantize_values(vals, block_rows: int = QUANT_BLOCK_ROWS):
    """Symmetric per-row-block int8 quantization of a ``(rows, ...)`` array.

    Returns ``(q, scales)``: ``q`` int8 of the input's shape, ``scales``
    f32 of length ``ceil(rows / block_rows)`` (all-zero blocks get 1.0).
    """
    v = _tensor(vals).to(torch.float32)
    rows = v.shape[0]
    n_blocks = -(-rows // block_rows)
    pad = n_blocks * block_rows - rows
    v_p = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))]) if pad else v
    maxabs = v_p.reshape(n_blocks, -1).abs().amax(dim=1)
    # Tensor divisors: PyTorch turns division by a Python scalar into a
    # multiply by its reciprocal on CUDA, which can differ in the last bit.
    ones = torch.ones_like(maxabs)
    scales = torch.where(maxabs > 0, maxabs / torch.full_like(maxabs, _INT8_MAX),
                         ones)
    inv = (ones / scales).reshape((n_blocks,) + (1,) * (v.dim() - 1))
    inv_rows = inv.repeat_interleave(block_rows, dim=0)[:rows]
    q = torch.clamp(torch.round(v * inv_rows), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), scales


def dequantize_values(q, scales, block_rows: int = QUANT_BLOCK_ROWS):
    """Exact inverse of :func:`quantize_values` up to int8 rounding (f32)."""
    qa = _tensor(q)
    return dequantize_rows(qa, _tensor(scales), block_rows)


def align_scales(scales, scale_block_rows: int, block_rows: int):
    """Re-block per-row-block scales to a finer kernel granularity.

    Per-``block_rows``-block scales when ``block_rows`` divides
    ``scale_block_rows``, else ``None`` (one kernel block would need two
    scales; the caller dequantizes instead).
    """
    if scale_block_rows == block_rows:
        return scales
    if scale_block_rows % block_rows == 0:
        return _tensor(scales).repeat_interleave(scale_block_rows // block_rows)
    return None


# -- layer weights ----------------------------------------------------------


def quantize_params(params, precision: str, block_rows: int = QUANT_BLOCK_ROWS):
    """Quantize GCN params ``{layer: {"w", "b"}}`` for ``precision``.

    bf16 casts the weights; int8 stores each ``w`` as per-input-row-block
    int8 with a ``"w_scale"`` vector beside it.  Biases stay f32.  ``f32``
    returns ``params`` itself.
    """
    if validate_precision(precision) == "f32":
        return params
    out = {}
    for name, layer in params.items():
        if not (isinstance(layer, dict) and "w" in layer):
            out[name] = layer
            continue
        if precision == "bf16":
            out[name] = dict(layer, w=layer["w"].to(torch.bfloat16))
        else:
            q, scales = quantize_values(layer["w"], block_rows)
            out[name] = dict(layer, w=q, w_scale=scales)
    return out


def affine(x: torch.Tensor, layer: dict, precision: str,
           block_rows: int = QUANT_BLOCK_ROWS) -> torch.Tensor:
    """``x @ w + b`` under ``precision``: bf16 multiplies, f32 accumulate.

    ``layer`` holds an f32/bf16 ``w`` or an int8 ``w`` + ``w_scale`` from
    :func:`quantize_params`.  Under bf16/int8, ``x`` and ``w`` are rounded
    to bf16 and widened back, and the product runs in full f32 (no TF32):
    the reference's bf16 dot with an f32 result, rounded once.  The f32
    path keeps PyTorch's default (full f32).
    """
    w, b = layer["w"], layer["b"]
    if validate_precision(precision) == "f32":
        return torch.matmul(x, w) + b
    if "w_scale" in layer:
        w = dequantize_values(w, layer["w_scale"], block_rows)
    x32 = x.to(torch.bfloat16).to(torch.float32)
    w32 = w.to(torch.bfloat16).to(torch.float32)
    with full_f32_matmul():
        return torch.matmul(x32, w32) + b.to(torch.float32)


# -- host-side ELL artifacts ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantizedELL:
    """A quantized view of one ``TiledELL``'s value plane (CPU tensors).

    The structure (``cols``/``row_map``) is the source container's; only
    the values change representation.  :meth:`operands` turns it into
    dispatchable :class:`~repro_torch.exec.operands.SpmmOperands`.
    """

    precision: str
    cols: torch.Tensor
    vals: torch.Tensor                 # int8 or bfloat16 storage
    scales: Optional[torch.Tensor]     # (n_blocks,) f32 for int8, else None
    row_map: torch.Tensor
    n_out_rows: int
    block_rows: int                    # scale granularity (rows per block)

    @property
    def nbytes(self) -> int:
        n = sum(t.numel() * t.element_size()
                for t in (self.cols, self.vals, self.row_map))
        if self.scales is not None:
            n += self.scales.numel() * self.scales.element_size()
        return n

    def operands(self, ell=None, device="cpu"):
        from repro_torch.exec.operands import SpmmOperands  # no cycle

        def put(t):
            return None if t is None else t.to(device)

        return SpmmOperands(
            cols=put(self.cols), vals=put(self.vals), row_map=put(self.row_map),
            n_out_rows=self.n_out_rows, ell=ell, scales=put(self.scales),
            scale_block_rows=self.block_rows, precision=self.precision,
        )


def quantize_ell(ell, precision: str, block_rows: int = QUANT_BLOCK_ROWS):
    """Quantize a ``TiledELL``'s values into a :class:`QuantizedELL`."""
    if validate_precision(precision) == "f32":
        raise ValueError("f32 needs no quantized artifact — use the TiledELL")
    vals = torch.as_tensor(ell.vals, dtype=torch.float32)
    if precision == "bf16":
        q, scales = vals.to(torch.bfloat16), None
    else:
        q, scales = quantize_values(vals, block_rows)
    return QuantizedELL(
        precision=precision,
        cols=torch.as_tensor(ell.cols, dtype=torch.int32),
        vals=q,
        scales=scales,
        row_map=torch.as_tensor(ell.row_map, dtype=torch.int32),
        n_out_rows=ell.n_orig_rows,
        block_rows=block_rows,
    )


def logit_error(ref, test) -> float:
    """Relative max-abs error of ``test`` vs the f32 reference logits,
    normalized by the reference's max magnitude."""
    ref = _tensor(ref).detach().to("cpu", torch.float32)
    test = _tensor(test).detach().to("cpu", torch.float32)
    denom = max(float(ref.abs().max()), 1e-12)
    return float((test - ref).abs().max()) / denom
