"""Step functions (train / prefill / serve) for the LM models.

The port of ``repro.launch.steps``.  Each ``build_*`` resolves its device
when it is called (the card unless ``device`` is given, raising without one)
and returns a step that takes the parameters on that device and token ids
as anything ``torch.as_tensor`` reads.  Every step runs with bf16 matrix
products reducing in f32, as the reference's do
(``models.layers.bf16_full_reduction``).

Under ``mesh=`` (a ``DeviceMesh`` with axes ``data``/``model``, and
``pod``; ``launch.mesh.make_production_mesh``) a step runs SPMD on every
rank under ``sharding_policy(mesh)``, as the reference's do.  It takes
parameters, AdamW moments and caches placed by ``dist.sharding``
(``distribute_params`` / ``distribute_cache``), and token ids either as
a DTensor or as every rank's full copy, which it shards over the batch
by ``batch_spec``.  Ops run on DTensors, whose sharding propagation
plays the role of the reference's SPMD partitioner; plain tensors made
inside the model (positions, masks) are taken as replicated
(``implicit_replication``).  Logits come back as DTensors
(``.full_tensor()`` is every rank's whole copy), a decode step's cache
keeps the placements it came with, and the train step sums each
gradient into its parameter's placements (over ``data`` where the
parameter is replicated there) before AdamW, whose global-norm clip then
reduces across the shards.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist.policy import sharding_policy
from repro_torch.models import lm
from repro_torch.models.layers import bf16_full_reduction
from repro_torch.train.grad import value_and_grad
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.train.tree import leaves, unflatten


def _step_device(mesh, device) -> torch.device:
    if mesh is None:
        return resolve_device(device)
    from repro_torch.launch.mesh import mesh_device

    return mesh_device(mesh)


@contextlib.contextmanager
def _under(mesh):
    """The context a step body runs in: f32-reducing bf16 products, and
    under a mesh the sharding policy with plain tensors replicated."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(bf16_full_reduction())
        if mesh is not None:
            from torch.distributed.tensor.experimental import (
                implicit_replication)

            stack.enter_context(sharding_policy(mesh))
            stack.enter_context(implicit_replication())
        yield


def _batch_sharded(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (every rank's full copy, or a DTensor) as a DTensor sharded
    over its leading batch dim by ``batch_spec``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import batch_spec, distribute

    if isinstance(x, DTensor):
        return x
    return distribute(x, mesh, batch_spec(mesh, x.shape[0]))


def _tokens(tokens, dev: torch.device, mesh=None) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(tokens, DTensor):
        return tokens
    t = torch.as_tensor(tokens, device=dev).long()
    return t if mesh is None else _batch_sharded(t, mesh)


def _memory(memory, mesh):
    if memory is None or mesh is None:
        return memory
    return _batch_sharded(memory, mesh)


def _placed_like(new, like):
    """Each DTensor leaf of ``new`` redistributed to the placements of
    the same leaf of ``like`` (a cache keeps its layout step to step; a
    gradient is summed into its parameter's layout)."""
    from torch.distributed.tensor import DTensor

    out = []
    for n, o in zip(leaves(new), leaves(like)):
        if isinstance(o, DTensor):
            if not isinstance(n, DTensor):
                raise TypeError("a plain tensor where the tree holds a "
                                "DTensor")
            if tuple(n.placements) != tuple(o.placements):
                n = n.redistribute(o.device_mesh, o.placements)
        out.append(n)
    return unflatten(like, out)


def build_grad_step(cfg: ArchConfig, mesh=None, remat: bool = True,
                    device=None) -> Callable:
    """``grad_step(params, tokens, memory=None)`` -> (loss, grads): the
    train step's gradient of ``lm_loss(remat=remat)``, grads in
    ``params``' structure (under a mesh each laid out as its parameter,
    summed over the axes the parameter is replicated on)."""
    dev = _step_device(mesh, device)
    grad_fn = value_and_grad(
        lambda p, tokens, memory: lm.lm_loss(p, cfg, tokens, memory,
                                             remat=remat))

    def grad_step(params, tokens, memory=None):
        with _under(mesh):
            loss, grads = grad_fn(params, _tokens(tokens, dev, mesh),
                                  _memory(memory, mesh))
            if mesh is not None:
                grads = _placed_like(grads, params)
        return loss, grads

    return grad_step


def build_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                     mesh=None, remat: bool = True, device=None,
                     guard_finite: bool = True) -> Callable:
    """``train_step(params, opt_state, tokens, memory=None)`` -> (params,
    opt_state, {"loss", "grad_norm", "lr"}): :func:`build_grad_step`'s
    gradient, then one AdamW step.

    The update is in place (``adamw_update(inplace=True)``): the returned
    params and moments are the given tensors, overwritten.  A step whose
    loss is not finite leaves them as they were (the trainer then
    restores a checkpoint, as the reference's discards the step); that
    guard reads the loss on the host, which ``guard_finite=False`` skips
    (the dry run's tensors have no values to read).
    """
    opt_cfg = opt_cfg or AdamWConfig()
    grad_step = build_grad_step(cfg, mesh=mesh, remat=remat, device=device)

    def train_step(params, opt_state, tokens, memory=None):
        loss, grads = grad_step(params, tokens, memory)
        with _under(mesh):
            if guard_finite and not bool(torch.isfinite(loss)):
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
    dev = _step_device(mesh, device)

    def prefill_step(params, tokens, memory=None):
        with _under(mesh):
            x = lm.forward_hidden(params, cfg, _tokens(tokens, dev, mesh),
                                  _memory(memory, mesh))
            return (x[:, -1, :] @ lm.head(params, cfg).to(x.dtype)).float()

    return prefill_step


def build_serve_step(cfg: ArchConfig, mesh=None, device=None) -> Callable:
    """``serve_step(params, cache, tokens, pos)`` -> (logits (B, vocab)
    f32, new cache): one cached decode step."""
    dev = _step_device(mesh, device)

    def serve_step(params, cache, tokens, pos):
        with _under(mesh):
            logits, new = lm.decode_step(params, cfg, cache,
                                         _tokens(tokens, dev, mesh), pos)
            if mesh is not None:
                new = _placed_like(new, cache)
        return logits, new

    return serve_step


def step_for(cfg: ArchConfig, kind: str, mesh=None, device=None) -> Callable:
    if kind == "train":
        return build_train_step(cfg, mesh=mesh, device=device)
    if kind == "prefill":
        return build_prefill_step(cfg, mesh=mesh, device=device)
    if kind == "decode":
        return build_serve_step(cfg, mesh=mesh, device=device)
    raise ValueError(kind)
