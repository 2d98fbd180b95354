"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless one is given.

    With no ``device`` and no CUDA card this raises instead of carrying on
    on the CPU; callers that want the plain PyTorch path pass
    ``device="cpu"`` explicitly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: repro_torch entry points run on the "
                "card by default; pass device='cpu' to run the plain PyTorch "
                "path"
            )
        return torch.device("cuda")
    return torch.device(device)
