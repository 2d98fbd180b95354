"""Mesh-shape planning.

The port of ``repro.dist.topology``'s ``viable_mesh_shapes``, which
enumerates (data, model) factorizations of a chip count: the requested
model-parallel width is an upper bound, not a demand, so an awkward card
count (a prime, fewer cards than the requested width) still gets a legal
shape.  :func:`cuda_device_count` counts the cards where the reference
reads ``jax.devices()``.  The device-free mesh (``abstract_mesh``) waits
for the multi-GPU slice.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def viable_mesh_shapes(n_chips: int,
                       model_parallel: int) -> List[Tuple[int, int]]:
    """All (data, model) shapes with data * model == n_chips and
    model <= model_parallel, widest model axis first."""
    if n_chips < 1:
        raise ValueError(f"n_chips must be >= 1, got {n_chips}")
    if model_parallel < 1:
        raise ValueError(
            f"model_parallel must be >= 1, got {model_parallel}")
    return [
        (n_chips // m, m)
        for m in range(min(model_parallel, n_chips), 0, -1)
        if n_chips % m == 0
    ]


def cuda_device_count() -> int:
    """CUDA cards visible to this process (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
