"""Carry the reference's GCN parameters across as the port's tensors."""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(
    params: Mapping[str, Mapping[str, object]],
    device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """``{"layer_i": {"w", "b"}}`` of arrays (the reference's pytree, as
    numpy) -> the same dictionary of f32 tensors on ``device`` (``"cuda"``
    unless given)."""
    dev = resolve_device(device)
    return {
        name: {
            key: torch.as_tensor(np.array(value, dtype=np.float32), device=dev)
            for key, value in layer.items()
        }
        for name, layer in params.items()
    }
