"""Plain two-layer GCN inference: the reference a cell's logits are held to.

``logits = A_hat relu(A_hat (X W0 + b0)) W1 + b1`` layer by layer, in
the original node order, from the normalized CSR, the features and the
weights the harness hands to both sides.  The combination is one dense
``matmul``; the aggregation runs in row blocks of ``A_hat``, each a CSR
slice times the dense operand.  Everything is f32 with TF32 off, unless
``tf32=True`` asks for the control: the same arithmetic with the dense
products' inputs in TF32 (the card's tensor-core path; on the CPU,
where that path does not exist, the inputs are rounded to TF32's 10-bit
mantissa by hand).

Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Iterator, Sequence, Tuple

import torch

#: Rows of ``A_hat`` aggregated at a time.
BLOCK_ROWS = 1 << 16


@contextlib.contextmanager
def matmul_precision(tf32: bool) -> Iterator[None]:
    """TF32 on or off for f32 products on the card, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to the nearest TF32 value (10 mantissa bits,
    ties to even), as f32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def combination(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                tf32: bool) -> torch.Tensor:
    """``x @ w + b`` in f32; under ``tf32`` the product's inputs are TF32."""
    if tf32 and x.device.type != "cuda":
        x, w = round_to_tf32(x), round_to_tf32(w)
    with matmul_precision(tf32 and x.device.type == "cuda"):
        return torch.matmul(x, w) + b


def aggregate(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
              dense: torch.Tensor, block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """``A_hat @ dense`` in f32, ``block_rows`` rows of ``A_hat`` at a time."""
    n = indptr.numel() - 1
    out = torch.empty(n, dense.shape[1], dtype=dense.dtype, device=dense.device)
    with warnings.catch_warnings():
        # PyTorch warns that its sparse CSR support is in beta.
        warnings.simplefilter("ignore", UserWarning)
        for r0 in range(0, n, block_rows):
            r1 = min(r0 + block_rows, n)
            lo, hi = int(indptr[r0]), int(indptr[r1])
            block = torch.sparse_csr_tensor(
                indptr[r0:r1 + 1] - lo, indices[lo:hi], data[lo:hi],
                size=(r1 - r0, dense.shape[0]))
            out[r0:r1] = torch.sparse.mm(block, dense)
    return out


def gcn_logits(csr: Sequence[torch.Tensor], features: torch.Tensor,
               layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               tf32: bool = False, block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """The logits of a GCN whose ``layers`` are ``(w, b)`` pairs: ReLU
    between layers, none after the last.  ``csr`` is ``(indptr, indices,
    data)`` of ``A_hat`` on the features' device (int64, int64, f32)."""
    indptr, indices, data = csr
    h = features
    for i, (w, b) in enumerate(layers):
        z = combination(h, w, b, tf32)
        h = aggregate(indptr, indices, data, z, block_rows)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h
