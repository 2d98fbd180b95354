"""Step functions (train / prefill / serve) for the LM models.

The port of ``repro.launch.steps``.  Each ``build_*`` resolves its device
when it is called (the card unless ``device`` is given, raising without one)
and returns a step that takes the parameters on that device and token ids
as anything ``torch.as_tensor`` reads.  Every step runs with bf16 matrix
products reducing in f32, as the reference's do
(``models.layers.bf16_full_reduction``).  A step under a mesh (tensor
parallelism) is ROADMAP item A13b.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.layers import bf16_full_reduction
from repro_torch.train.grad import value_and_grad
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def _single_card(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "an LM step under a mesh (tensor parallelism) is ROADMAP item "
            "A13b, not ported yet")


def _tokens(tokens, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=dev).long()


def build_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                     mesh=None, remat: bool = True,
                     device=None) -> Callable:
    """``train_step(params, opt_state, tokens, memory=None)`` -> (params,
    opt_state, {"loss", "grad_norm", "lr"}): the autograd gradient of
    ``lm_loss(remat=remat)``, then one AdamW step.

    The update is in place (``adamw_update(inplace=True)``): the returned
    params and moments are the given tensors, overwritten.  A step whose
    loss is not finite leaves them as they were (the trainer then
    restores a checkpoint, as the reference's discards the step).
    """
    _single_card(mesh)
    opt_cfg = opt_cfg or AdamWConfig()
    dev = resolve_device(device)
    grad_fn = value_and_grad(
        lambda p, tokens, memory: lm.lm_loss(p, cfg, tokens, memory,
                                             remat=remat))

    def train_step(params, opt_state, tokens, memory=None):
        with bf16_full_reduction():
            loss, grads = grad_fn(params, _tokens(tokens, dev), memory)
            if not torch.isfinite(loss):
                nan = torch.full_like(loss, float("nan"))
                return params, opt_state, {"loss": loss, "grad_norm": nan,
                                           "lr": nan}
            params, opt_state, metrics = adamw_update(
                opt_cfg, grads, opt_state, params, inplace=True)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def build_prefill_step(cfg: ArchConfig, mesh=None, device=None) -> Callable:
    """``prefill_step(params, tokens, memory=None)`` -> the next-token
    logits (B, vocab) f32 at the last position; the (B, S, vocab) logits
    are never formed."""
    _single_card(mesh)
    dev = resolve_device(device)

    def prefill_step(params, tokens, memory=None):
        with bf16_full_reduction():
            x = lm.forward_hidden(params, cfg, _tokens(tokens, dev), memory)
            return (x[:, -1, :] @ lm.head(params, cfg).to(x.dtype)).float()

    return prefill_step


def build_serve_step(cfg: ArchConfig, mesh=None, device=None) -> Callable:
    """``serve_step(params, cache, tokens, pos)`` -> (logits (B, vocab)
    f32, new cache): one cached decode step."""
    _single_card(mesh)
    dev = resolve_device(device)

    def serve_step(params, cache, tokens, pos):
        with bf16_full_reduction():
            return lm.decode_step(params, cfg, cache, _tokens(tokens, dev),
                                  pos)

    return serve_step


def step_for(cfg: ArchConfig, kind: str, mesh=None, device=None) -> Callable:
    if kind == "train":
        return build_train_step(cfg, mesh=mesh, device=device)
    if kind == "prefill":
        return build_prefill_step(cfg, mesh=mesh, device=device)
    if kind == "decode":
        return build_serve_step(cfg, mesh=mesh, device=device)
    raise ValueError(kind)
