"""Tensor trees as the reference's JAX pytrees see them.

A tree is nested dicts, lists, tuples and ``NamedTuple``s (``AdamWState``)
of leaves; ``None`` holds no leaf.  Leaves are visited in JAX's order:
dict keys sorted, sequences and ``NamedTuple`` fields in order.  A leaf's
path string is the reference's ``"/".join(str(p) for p in path)`` over
``jax.tree_util`` keys: ``['params']/['layer_0']/['w']`` for dict keys,
``[0]`` for a list index and ``.mu`` for a ``NamedTuple`` field, so the
checkpoints of both packages name their leaves alike.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(key string, child) pairs of one node, in JAX's order."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{name}", v) for name, v in zip(tree._fields, tree)]
    return [(f"[{i}]", v) for i, v in enumerate(tree)]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """(path string, leaf) of every leaf, in JAX's order."""
    out: List[Tuple[str, Any]] = []

    def walk(t, path):
        if t is None:
            return
        if _is_node(t):
            for key, child in _children(t):
                walk(child, path + (key,))
        else:
            out.append(("/".join(path), t))

    walk(tree, ())
    return out


def leaves(tree) -> list:
    """The leaves of ``tree``, in JAX's order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure holding ``new_leaves`` (in :func:`leaves`'
    order) in place of its own."""
    it: Iterator = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-structured ``rest``."""
    flat = leaves(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"tree structures differ: {len(flat)} leaves "
                             f"vs {len(o)}")
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)])
