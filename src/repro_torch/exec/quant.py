"""Storage precision: the f32 part of ``repro.exec.quant``.

The port runs ``f32`` only: asking for ``bf16`` or ``int8`` raises
:class:`NotImplementedError` (the int8/bf16 kernels are a queued slice).
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "bf16", "int8")   # the reference's
SUPPORTED_PRECISIONS = ("f32",)

_VALUE_BYTES = {"f32": 4}
_ACTIVATION_BYTES = {"f32": 4}


def validate_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision: {precision} (expected one of {PRECISIONS})"
        )
    if precision not in SUPPORTED_PRECISIONS:
        raise NotImplementedError(
            f"precision {precision!r} is not ported yet: repro_torch runs "
            f"f32 only (bf16/int8 storage is a queued slice)"
        )
    return precision


def bytes_per_value(precision: str) -> int:
    """Stored bytes per ELL value / weight element."""
    return _VALUE_BYTES[validate_precision(precision)]


def activation_bytes(precision: str) -> int:
    """Stored bytes per dense-operand / activation element."""
    return _ACTIVATION_BYTES[validate_precision(precision)]


def affine(x: torch.Tensor, layer: dict, precision: str) -> torch.Tensor:
    """``x @ w + b`` — the layer's combination, a plain f32 matmul.

    The matmul runs at full f32: PyTorch's default
    (``torch.backends.cuda.matmul.allow_tf32 = False``) is kept.
    """
    validate_precision(precision)
    return torch.matmul(x, layer["w"]) + layer["b"]
