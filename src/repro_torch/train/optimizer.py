"""AdamW and its learning-rate schedules over tensor trees.

The port of ``repro.train.optimizer``, with its arithmetic: the moments
and the update in f32, bias corrections ``1 - b ** step`` in f32 on the
step's device, and the new parameters cast back to their own dtype (bf16
for the LM).  A clipped gradient is ``f32(g) * scale``, as the reference's
bf16-times-f32 promotion makes it.

``adamw_update(..., inplace=True)`` writes the parameters and the moments
in place: the same values, without a second copy of the state (the
moments of a 1.9 B-parameter model are 15 GB).  A caller that keeps the
old state (``repro_torch.train.checkpoint.save_async`` does) must take its
copy before the next in-place update; ``save_async`` copies to the host
before it returns.  Moments in bf16 (``adamw_init(dtype=torch.bfloat16)``)
are replaced by f32 ones on the first update in either mode, as the
reference promotes them: the state returned holds f32 moments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.train.tree import leaves, tree_map, unflatten

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # cosine | linear | constant


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32, on the parameters' device
    mu: PyTree
    nu: PyTree


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Warmup then cosine / linear decay: an f32 scalar tensor on
    ``step``'s device (the CPU for a Python int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
                1 + torch.cos(math.pi * t))
        else:
            decay = 1.0 - (1.0 - cfg.min_lr_ratio) * t
    return cfg.lr * warm * decay


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in JAX's order) of their f32
    sums of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # one division, as JAX's (``max_norm / tensor`` multiplies by a
    # reciprocal in torch)
    return torch.clamp(norm.new_full((), max_norm)
                       / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: PyTree,
                        max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    """(every leaf as ``f32(g) * scale``, the global norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, tree), norm


def adamw_init(params: PyTree, dtype=torch.float32) -> AdamWState:
    """Zero moments of ``dtype`` beside each parameter (bf16 halves their
    memory); the step counter on the parameters' device."""
    first = leaves(params)
    device = first[0].device if first else None
    # ``zeros_like`` keeps a DTensor parameter's placements (the moments
    # of a sharded model are sharded as its parameters are)
    zeros = lambda p: torch.zeros_like(p, dtype=dtype,
                                       memory_format=torch.contiguous_format)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _decayed(m: torch.Tensor, b: float, inplace: bool) -> torch.Tensor:
    """``b * m`` in f32.  A narrower moment is scaled in its own dtype
    (JAX casts the weak-typed ``b`` to it) and then widened, as the
    reference's ``b * m + (1 - b) * g32`` promotes; an f32 moment is
    scaled in place when ``inplace``."""
    if m.dtype != torch.float32:
        return (m * torch.tensor(b, dtype=m.dtype)).float()
    return m.mul_(b) if inplace else m * b


def adamw_update(
    cfg: AdamWConfig,
    grads: PyTree,
    state: AdamWState,
    params: PyTree,
    *,
    inplace: bool = False,
) -> Tuple[PyTree, AdamWState, dict]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}).

    With ``inplace`` the given parameters and f32 moments are overwritten
    and returned; otherwise they are left as they were.  A moment of
    another dtype is never written: its f32 successor is a new tensor.
    """
    with torch.no_grad():
        if cfg.grad_clip_norm is not None:
            gnorm = global_norm(grads)
            scale = _clip_scale(gnorm, cfg.grad_clip_norm)
        else:
            gnorm, scale = global_norm(grads), None
        step = state.step + 1
        lr = lr_at(cfg, step)
        step32 = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(cfg.b1, step32)
        bc2 = 1.0 - torch.pow(cfg.b2, step32)
        if not inplace:
            params = tree_map(torch.clone, params)
        mus, nus = [], []
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.mu), leaves(state.nu)):
            g32 = g.to(torch.float32, copy=True)
            if scale is not None:
                g32.mul_(scale)
            m = _decayed(m, cfg.b1, inplace).add_(g32 * (1 - cfg.b1))
            v = _decayed(v, cfg.b2, inplace).add_(
                g32.square_().mul_(1 - cfg.b2))
            mus.append(m)
            nus.append(v)
            update = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
            p32 = p.float()                # ``p`` itself when it is f32
            update.add_(p32 * cfg.weight_decay).mul_(lr)
            if p32 is p:
                p.sub_(update)
            else:
                p.copy_(p32.sub_(update))
        state = AdamWState(step, unflatten(state.mu, mus),
                           unflatten(state.nu, nus))
    return params, state, {"grad_norm": gnorm, "lr": lr}
