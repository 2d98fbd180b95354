"""Step functions (prefill / serve) for the LM models.

The port of ``repro.launch.steps``.  Each ``build_*`` resolves its device
when it is called (the card unless ``device`` is given, raising without one)
and returns a step that takes the parameters on that device and token ids
as anything ``torch.as_tensor`` reads.  Training (``build_train_step``,
AdamW and the ``lm_loss`` gradient) is ROADMAP item A14; a step under a
mesh (tensor parallelism) is A13b.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm


def _single_card(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "an LM step under a mesh (tensor parallelism) is ROADMAP item "
            "A13b, not ported yet")


def _tokens(tokens, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=dev).long()


def build_prefill_step(cfg: ArchConfig, mesh=None, device=None) -> Callable:
    """``prefill_step(params, tokens, memory=None)`` -> the next-token
    logits (B, vocab) f32 at the last position; the (B, S, vocab) logits
    are never formed."""
    _single_card(mesh)
    dev = resolve_device(device)

    def prefill_step(params, tokens, memory=None):
        x = lm.forward_hidden(params, cfg, _tokens(tokens, dev), memory)
        return (x[:, -1, :] @ lm.head(params, cfg).to(x.dtype)).float()

    return prefill_step


def build_serve_step(cfg: ArchConfig, mesh=None, device=None) -> Callable:
    """``serve_step(params, cache, tokens, pos)`` -> (logits (B, vocab)
    f32, new cache): one cached decode step."""
    _single_card(mesh)
    dev = resolve_device(device)

    def serve_step(params, cache, tokens, pos):
        return lm.decode_step(params, cfg, cache, _tokens(tokens, dev), pos)

    return serve_step


def step_for(cfg: ArchConfig, kind: str, mesh=None, device=None) -> Callable:
    if kind == "train":
        raise NotImplementedError(
            "the train step (AdamW, the lm_loss gradient) is ROADMAP item "
            "A14, not ported yet")
    if kind == "prefill":
        return build_prefill_step(cfg, mesh=mesh, device=device)
    if kind == "decode":
        return build_serve_step(cfg, mesh=mesh, device=device)
    raise ValueError(kind)
