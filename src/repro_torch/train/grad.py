"""``value_and_grad`` over a tree of parameter tensors, by autograd.

The port's counterpart of ``jax.value_and_grad`` for its steps: the
floating-point leaves of ``params`` are made to require grad for the one
call (their flags are restored after it), and ``torch.autograd.grad``
returns the gradients without touching any ``.grad``.  A leaf the value
does not depend on gets zeros, as in JAX.

:func:`hold_leaf` is the rule by which two gradients of one bf16 model
(the port's and ``jax.grad``'s, the card's and the CPU's) are held to
agree, leaf by leaf, given how far the reference's own gradient of that
leaf moves when its input moves by rounding (:func:`leaf_spread`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from repro_torch.train.tree import leaves, unflatten


def value_and_grad(fn: Callable) -> Callable[..., Tuple[torch.Tensor, Any]]:
    """``fn(params, *args, **kw) -> scalar`` as ``(value, grads)``, grads
    in ``params``' structure."""

    def wrapped(params, *args, **kw):
        flat = leaves(params)
        diff = [t for t in flat if t.is_floating_point()]
        flags = [t.requires_grad for t in diff]
        try:
            for t in diff:
                t.requires_grad_(True)
            with torch.enable_grad():
                value = fn(params, *args, **kw)
                grads = torch.autograd.grad(value, diff, allow_unused=True)
        finally:
            for t, flag in zip(diff, flags):
                t.requires_grad_(flag)
        by_id = {id(t): g if g is not None else torch.zeros_like(t)
                 for t, g in zip(diff, grads)}
        return value.detach(), unflatten(
            params, [by_id.get(id(t), torch.zeros_like(t)) for t in flat])

    return wrapped


# A leaf is held within REL_FLOOR of max|reference|, or within twice the
# reference's own move where that is larger, up to REL_CAP.  Where the
# reference moves more than that (the exponential gates of xlstm, the
# near-tied experts of an MoE router), its leaf is held by direction and
# size instead: the cosine distance within twice the reference's own (at
# least COS_FLOOR, at most COS_CAP) and the norm within a factor
# NORM_RATIO.  No bar passes a zero or a sign-flipped gradient: their
# relative errors are 1 and 2, their cosine distances 1 and 2.
REL_FLOOR = 2e-2
REL_CAP = 0.25
COS_FLOOR = 1e-3
COS_CAP = 0.5
NORM_RATIO = 1.5


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float64).flatten()


def rel_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|."""
    got, want = _f64(got), _f64(want)
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {got.shape} vs {want.shape}")
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-30))


def cos_distance(got: torch.Tensor, want: torch.Tensor) -> float:
    """1 - cos(got, want); 1 where one of them is zero and the other not."""
    got, want = _f64(got), _f64(want)
    den = float(got.norm() * want.norm())
    if den == 0.0:
        return 0.0 if float(got.norm() + want.norm()) == 0.0 else 1.0
    return 1.0 - float(got @ want) / den


def leaf_spread(want: torch.Tensor,
                draws: Sequence[torch.Tensor]) -> Tuple[float, float]:
    """The reference's own move of a leaf: the largest (relative error,
    cosine distance) of its perturbed ``draws`` from ``want``."""
    return (max((rel_error(d, want) for d in draws), default=0.0),
            max((cos_distance(d, want) for d in draws), default=0.0))


def hold_leaf(got: torch.Tensor, want: torch.Tensor,
              spread: Tuple[float, float]) -> Dict[str, Any]:
    """``got`` held against ``want`` given ``want``'s ``spread``:
    {"test": "rel" or "cos", "err", "bar", "norm_ratio", "ok"}."""
    rel_spread, cos_spread = spread
    rel_bar = max(REL_FLOOR, 2 * rel_spread)
    norm = float(_f64(want).norm())
    ratio = float(_f64(got).norm()) / norm if norm else float("inf")
    if rel_bar <= REL_CAP:
        err = rel_error(got, want)
        return {"test": "rel", "err": err, "bar": rel_bar,
                "norm_ratio": ratio, "ok": err <= rel_bar}
    err = cos_distance(got, want)
    bar = min(max(COS_FLOOR, 2 * cos_spread), COS_CAP)
    ok = err <= bar and 1 / NORM_RATIO <= ratio <= NORM_RATIO
    return {"test": "cos", "err": err, "bar": bar, "norm_ratio": ratio,
            "ok": ok}
