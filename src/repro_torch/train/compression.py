"""Gradient compression for data parallelism across replicas.

The port of ``repro.train.compression``: int8 quantized all-reduce with
error feedback.  Each replica quantizes its gradient to int8 with a
per-tensor scale, sums the int8 payload (4x fewer bytes on the wire than
f32), dequantizes, and carries the quantization residual into the next
step, which keeps the long-run gradient unbiased (Karimireddy et al.,
2019).

The reference sums over a named mesh axis with ``jax.lax.psum``; the port
is SPMD over a ``torch.distributed`` process group, each rank calling
with its own gradients, through ``repro_torch.dist.collectives``.
``group=None`` is one replica: the sums are the identity, as over the
reference's size-1 axis.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import psum
from repro_torch.train.tree import leaves, tree_map, unflatten

PyTree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(
    grads: PyTree,
    group=None,
    error: Optional[PyTree] = None,
) -> Tuple[PyTree, PyTree]:
    """Error-feedback int8 all-reduce over ``group``: (mean grads, new
    error).

    ``error`` is this replica's residual from the previous step (zeros on
    step 0).  The int8 payloads sum in int32 and the scales are averaged;
    the mean is rebuilt with the mean scale (exact when the scales agree).
    """
    if error is None:
        error = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)
    replicas = 1 if group is None else dist.get_world_size(group)
    means, errors = [], []
    for g, e in zip(leaves(grads), leaves(error)):
        n = torch.tensor(float(replicas), device=g.device)   # psum(1.0)
        g32 = g.float() + e
        q, scale = quantize_int8(g32)
        errors.append(g32 - dequantize_int8(q, scale))   # stays local
        total = psum(q.to(torch.int32), group)
        scale_sum = psum(scale, group)
        means.append((total.float() * (scale_sum / n) / n).to(g.dtype))
    return unflatten(grads, means), unflatten(grads, errors)


def compression_ratio(grads: PyTree) -> float:
    """Wire-bytes ratio of int8 + scale against an f32 all-reduce."""
    flat = leaves(grads)
    fp32 = sum(4 * leaf.numel() for leaf in flat)
    int8 = sum(1 * leaf.numel() + 4 for leaf in flat)
    return fp32 / int8
