"""Carry the reference's parameters (GCN and LM), LM caches and AdamW
states across as the port's tensors."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

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


def _leaf(value, dev: torch.device) -> torch.Tensor:
    """One numpy array at its own dtype; bf16 (``ml_dtypes.bfloat16``,
    which torch cannot read) goes across through its bits."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.as_tensor(np.array(arr, order="C"), device=dev)  # keeps 0-d


def _tree(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, dev) for v in tree]
    return _leaf(tree, dev)


def lm_params_from_numpy(
    tree: Any, device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """The reference's LM parameter pytree (``repro.models.lm.init_lm``,
    as numpy arrays) -> the port's tree of the same layout and dtypes on
    ``device`` (``"cuda"`` unless given): ``blocks`` and ``encoder``
    stacked over periods, ``head_blocks`` a list."""
    return _tree(tree, resolve_device(device))


def lm_cache_from_numpy(
    tree: Any, device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """The reference's LM decode cache (``repro.models.lm.init_cache``
    or a ``decode_step`` result, as numpy arrays) -> the port's cache of
    the same layout and dtypes on ``device`` (``"cuda"`` unless given)."""
    return _tree(tree, resolve_device(device))


def adamw_state_from_numpy(
    state: Any, device: Optional[Union[str, torch.device]] = None,
):
    """The reference's ``AdamWState`` (``repro.train.adamw_init`` or an
    ``adamw_update`` result, as numpy arrays: any ``(step, mu, nu)``) ->
    the port's ``AdamWState`` on ``device`` (``"cuda"`` unless given): the
    int32 step counter and the moment trees at their own dtypes."""
    from repro_torch.train.optimizer import AdamWState

    dev = resolve_device(device)
    step, mu, nu = state
    return AdamWState(step=_leaf(step, dev), mu=_tree(mu, dev),
                      nu=_tree(nu, dev))
