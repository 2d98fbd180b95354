"""Parameter, cache and batch sharding plans.

The port of ``repro.dist.sharding``.  ``ShardingPlan`` maps every
parameter leaf (addressed by its path, e.g. ``blocks/b0/mix/wq``) to a
partition spec using Megatron-style roles:

* column-parallel (output dim over ``model``): wq/wk/wv, MLA low-rank
  projections, FFN gate/up, lm_head;
* row-parallel (contracting dim over ``model``): wo, down;
* vocab-parallel embedding (tied heads transpose into column-parallel);
* MoE expert stacks shard the expert dim over ``model`` (expert
  parallelism) when it divides, falling back to the column/row rule;
* with ``fsdp=True`` the largest still-unsharded dim of each leaf is
  additionally sharded over ``data`` (ZeRO-3 style).

Leaves stacked over periods (paths under ``blocks/`` or ``encoder/``)
keep their leading period dim replicated.  Every rule is
divisibility-guarded, so the plan degrades to full replication on a
trivial mesh.  The roles give an ordered candidate list per leaf and the
winner is the cheapest by ``plan.cost.rank_specs`` at the element bytes
the reference uses, ties to the earlier candidate.

A spec is a tuple of entries, one per leading dimension, as the
reference's ``PartitionSpec`` is: an axis name, a tuple of axis names, or
None; ``()`` replicates.  Every function reads the axis sizes of a mesh
through ``dist.topology.axis_sizes``, so one plan serves an abstract mesh
(a mapping), the ``DeviceMesh`` a run is placed on and the dry run's mesh
over a fake process group.  :func:`placements` turns a spec into DTensor
placements; :func:`distribute_params` and :func:`distribute_cache` place
a tree of full tensors on a ``DeviceMesh`` as the plan says (each rank
keeps its own slice: every rank must hold the same full values).
:func:`fsdp_gathered` is the other half of FSDP: the models call it on
each period's leaves (and the embedding, norms and head) before their
products, so a weight sharded over ``data`` is gathered whole over that
axis first and every product runs on the layout it has without FSDP.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.dist.topology import axis_sizes
from repro_torch.plan import cost

# last path component -> tensor-parallel role
_COL = {"wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b",
        "gate", "up", "lm_head"}
_ROW = {"wo", "down"}
# collections stacked over periods: their leading dim is the period axis
_STACKED = {"blocks", "encoder"}


def _axes_size(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def _nbytes(dtype) -> int:
    return cost.TPU_V5E.bytes_per_element(dtype) if dtype is not None else 4


def leaf_paths(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) of every tensor leaf, in JAX's order, named as the
    reference's ``_path_name`` names them: dict keys as they are, list
    indices as ``[i]`` (``head_blocks/[0]/mix/wq``)."""
    out: List[Tuple[str, Any]] = []

    def walk(t, path):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (f"[{i}]",))
        else:
            out.append(("/".join(path), t))

    walk(tree, ())
    return out


def map_with_paths(fn, tree):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    def walk(t, path):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v, path + (f"[{i}]",))
                             for i, v in enumerate(t)))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path + (f"[{i}]",))
                           for i, v in enumerate(t))
        return fn("/".join(path), t)

    return walk(tree, ())


class ShardingPlan:
    """Sharding assignments for one mesh (axes ``data``/``model``, with an
    optional pure-DP ``pod`` axis)."""

    def __init__(self, mesh, fsdp: bool = False):
        self.mesh = mesh
        self.fsdp = fsdp
        self.sizes: Dict[str, int] = axis_sizes(mesh)
        self.model_axis: Optional[str] = (
            "model" if "model" in self.sizes else None)
        self.fsdp_axis: Optional[str] = (
            "data" if "data" in self.sizes else None)

    # -- parameters ---------------------------------------------------------

    def param_spec(self, name: str, shape: Sequence[int],
                   dtype=None) -> tuple:
        cands = self._param_candidates(name, shape)
        return cands[cost.rank_specs(self.sizes, shape, cands,
                                     _nbytes(dtype))]

    def _param_candidates(self, name: str,
                          shape: Sequence[int]) -> List[Tuple]:
        """Ordered candidate specs, most-preferred role first; the last is
        full replication, so the list is never empty."""
        parts = [p for p in name.split("/") if p]
        leaf = parts[-1] if parts else name
        ndim = len(shape)
        lo = 1 if parts and parts[0] in _STACKED else 0

        def fits(dim: int, size: int) -> bool:
            return size > 1 and dim % size == 0

        def base_with(idx: int) -> list:
            s: list = [None] * ndim
            s[idx] = model
            return s

        model = self.model_axis
        msize = self.sizes[model] if model else 0
        bases: List[list] = []
        if model and ndim - lo >= 2:
            if leaf == "embed":
                if fits(shape[0], msize):
                    bases.append(base_with(0))   # vocab-parallel
                if fits(shape[1], msize):
                    bases.append(base_with(1))
            elif leaf in _ROW:
                # MoE down is (E, W, D): the contracting dim is still -2
                if ndim - lo == 3 and fits(shape[lo], msize):
                    bases.append(base_with(lo))  # expert parallelism
                if fits(shape[ndim - 2], msize):
                    bases.append(base_with(ndim - 2))
            elif leaf in _COL:
                if ndim - lo == 3 and leaf != "lm_head" \
                        and fits(shape[lo], msize):
                    bases.append(base_with(lo))  # expert parallelism
                if fits(shape[ndim - 1], msize):
                    bases.append(base_with(ndim - 1))
        bases.append([None] * ndim)

        cands: List[Tuple] = []
        for base in bases:
            if self.fsdp and self.fsdp_axis:
                dsize = self.sizes[self.fsdp_axis]
                for i in sorted(range(lo, ndim), key=lambda i: -shape[i]):
                    if base[i] is None and fits(shape[i], dsize):
                        aug = list(base)
                        aug[i] = self.fsdp_axis
                        cands.append(tuple(aug))
                        break
            cands.append(tuple(base))
        return cands

    def shard_params(self, tree: Any) -> Any:
        """``tree`` with every leaf replaced by its spec."""
        return map_with_paths(
            lambda path, leaf: self.param_spec(
                path, tuple(leaf.shape), getattr(leaf, "dtype", None)),
            tree)

    # -- decode caches ------------------------------------------------------

    def cache_spec(self, name: str, shape: Sequence[int],
                   dp: Tuple[str, ...], dtype=None) -> tuple:
        parts = [p for p in name.split("/") if p]
        ndim = len(shape)
        lo = 1 if parts and parts[0] in _STACKED else 0
        spec: list = [None] * ndim
        dp = tuple(a for a in dp if a in self.sizes)
        if ndim > lo:
            spec[lo] = _dp_entry(self.mesh, dp, shape[lo], _nbytes(dtype))
        # (B, S, KV, hd) attention caches: kv heads over the model axis
        model = self.model_axis
        msize = self.sizes[model] if model else 0
        if model and msize > 1 and ndim - lo == 4 \
                and shape[lo + 2] % msize == 0:
            spec[lo + 2] = model
        return tuple(spec)

    def shard_cache(self, tree: Any, dp: Tuple[str, ...]) -> Any:
        return map_with_paths(
            lambda path, leaf: self.cache_spec(
                path, tuple(leaf.shape), dp, getattr(leaf, "dtype", None)),
            tree)


def _dp_entry(mesh, dp: Tuple[str, ...], dim: int, dtype_bytes: int = 4):
    """Cheapest dp-axis suffix that divides ``dim``, by estimated
    collective bytes (suffixes drop ``pod`` first; the cost model prefers
    the widest viable suffix and ties keep that order), or None when even
    the innermost axis does not fit."""
    viable = [
        dp[i:]
        for i in range(len(dp))
        if _axes_size(mesh, dp[i:]) > 1 and dim % _axes_size(mesh, dp[i:]) == 0
    ]
    if not viable:
        return None
    specs = [(c if len(c) > 1 else c[0],) for c in viable]
    chosen = viable[cost.rank_specs(axis_sizes(mesh), (dim,), specs,
                                    dtype_bytes)]
    return chosen if len(chosen) > 1 else chosen[0]


def batch_spec(mesh, global_batch: int) -> tuple:
    """Spec of a leading global-batch dim: sharded over the widest
    divisible suffix of the (pod, data) axes, else replicated (``()``)."""
    dp = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    entry = _dp_entry(mesh, dp, global_batch)
    return (entry,) if entry is not None else ()


def spec_axes(spec: tuple) -> Tuple[str, ...]:
    """The mesh axes a batch spec shards over (``()`` when replicated)."""
    if not spec:
        return ()
    entry = spec[0]
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


# -- placement on a DeviceMesh -------------------------------------------------


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` on each axis that shards tensor dim ``d``, else
    ``Replicate()``.  An entry naming several axes shards that dim over
    them major to minor, as a ``PartitionSpec`` does (DTensor lays a dim
    sharded on two mesh dims out in mesh-dim order, so the axes must come
    in the mesh's order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of {spec} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def distribute(t, mesh, spec: Sequence):
    """A full tensor (the same values on every rank) as a DTensor on
    ``mesh`` laid out by ``spec``: each rank keeps a copy of its slice (the
    full tensor can be freed), no traffic."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    place = placements(mesh, spec)
    if all(p.is_replicate() for p in place):
        return rep
    d = rep.redistribute(mesh, place)
    return DTensor.from_local(d.to_local().clone(), mesh, place,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def distribute_params(params, plan: ShardingPlan):
    """The parameter tree placed on ``plan.mesh`` (a ``DeviceMesh``) by
    ``plan.param_spec``."""
    return map_with_paths(
        lambda path, t: distribute(
            t, plan.mesh, plan.param_spec(path, tuple(t.shape), t.dtype)),
        params)


def fsdp_gathered(tree):
    """``tree`` (placed parameters) with every ``data`` placement of its
    leaves gathered to ``Replicate()`` and every other placement kept:
    ZeRO-3's gather of a weight before it is used.

    Without it DTensor plans each product on a weight FSDP split over
    ``data`` itself (partial products over ``data`` summed in bf16, or
    activations resharded around the split), which moves the answer and
    its gradients.  The gather is a ``DTensor.redistribute``, so its
    gradient comes back in the leaf's own layout: a partial sum over
    ``data`` reduce-scattered into the shard.  Called inside a rematerialized
    period, the gathered weights are dropped after the forward and gathered
    again in the backward.  The identity with no active mesh and on a tree
    with no leaf sharded over ``data`` (``fsdp=False``)."""
    from repro_torch.dist.policy import active_mesh

    mesh = active_mesh()
    if mesh is None or "data" not in axis_sizes(mesh):
        return tree
    from torch.distributed.tensor import DTensor, Replicate

    def gather(_, t):
        if not isinstance(t, DTensor) or "data" not in (
                t.device_mesh.mesh_dim_names or ()):
            return t
        i = t.device_mesh.mesh_dim_names.index("data")
        if not t.placements[i].is_shard():
            return t
        place = list(t.placements)
        place[i] = Replicate()
        return t.redistribute(t.device_mesh, place)

    return map_with_paths(gather, tree)


def distribute_cache(cache, plan: ShardingPlan, dp: Tuple[str, ...]):
    """The decode cache placed on ``plan.mesh`` by ``plan.cache_spec``."""
    return map_with_paths(
        lambda path, t: distribute(
            t, plan.mesh, plan.cache_spec(path, tuple(t.shape), dp, t.dtype)),
        cache)
