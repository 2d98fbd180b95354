"""Mesh-shape planning.

The port of ``repro.dist.topology``'s ``viable_mesh_shapes``, which
enumerates (data, model) factorizations of a chip count: the requested
model-parallel width is an upper bound, not a demand, so an awkward card
count (a prime, fewer cards than the requested width) still gets a legal
shape.  :func:`cuda_device_count` counts the cards where the reference
reads ``jax.devices()``.

:func:`abstract_mesh` is the device-free mesh the planners take: a
read-only mapping of axis name -> size, where the reference builds a
``jax.sharding.AbstractMesh``.  :func:`axis_sizes` reads the same mapping
off either form, or off the ``DeviceMesh`` a run is placed on
(``repro_torch.launch.mesh.make_data_mesh``).
"""

from __future__ import annotations

import types
from typing import Dict, List, Mapping, Sequence, Tuple

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


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> Mapping[str, int]:
    """Device-free mesh for planning: axis name -> size, read-only."""
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} sizes for {len(axis_names)} "
                         "axis names")
    return types.MappingProxyType(
        {str(n): int(s) for n, s in zip(axis_names, axis_sizes)})


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of an abstract mesh (a mapping) or of a
    ``torch.distributed.device_mesh.DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return {str(n): int(s) for n, s in mesh.items()}
    return {n: int(mesh.size(i)) for i, n in enumerate(mesh.mesh_dim_names)}
