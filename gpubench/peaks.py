"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 67 TFLOP/s in f32 outside the tensor cores, 495 in
TF32, 989 in bf16, 1,979 TOP/s in int8, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Optional

H100_SXM = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12,
            "hbm_bytes_s": 3.35e12}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks_of(name: Optional[str]) -> Optional[dict]:
    """The card's peaks, or None for a card not in the table."""
    return PEAKS.get(name) if name else None
