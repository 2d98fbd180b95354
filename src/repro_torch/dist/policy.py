"""Logical-axis sharding constraints.

The port of ``repro.dist.policy``.  Model code never names a concrete
mesh: it calls ``constrain(x, specs)`` with an ordered list of candidate
partition specs (most-sharded first).  A spec is a tuple of entries, one
per leading dimension, as in ``dist/sharding.py``: an axis name, a tuple
of axis names, or None.  :func:`spec_viable` and :func:`select_spec` read
the axis sizes of any mesh form ``dist.topology.axis_sizes`` takes.

With no active mesh (unit tests, single-card runs) ``constrain`` and
``constrain_ranked`` are the identity, as in the reference.  Under an
active ``DeviceMesh`` the reference's ``with_sharding_constraint``
becomes ``DTensor.redistribute`` to the placements of the chosen spec
(``dist.sharding.placements``); a plain tensor is every rank's full
copy, so laying it out is a local slice with no traffic.  An abstract
mesh (a mapping) has no ranks: the planners read it through
``select_spec`` / ``ranked_spec`` and never call ``constrain`` under it,
which raises there.

The active mesh is installed by ``sharding_policy(mesh)``.  State is
thread-local, as in the reference.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.dist.topology import axis_sizes

AxisEntry = Union[str, Tuple[str, ...], None]
Spec = Sequence[AxisEntry]

_state = threading.local()


def active_mesh():
    """The mesh installed by the innermost ``sharding_policy``, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def sharding_policy(mesh) -> Iterator[Optional[object]]:
    """Install ``mesh`` as the target of ``constrain`` calls underneath.

    ``mesh=None`` is valid and makes every ``constrain`` the identity.
    """
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def spec_viable(mesh, shape: Sequence[int], spec: Spec) -> bool:
    """True iff ``spec`` can legally shard an array of ``shape`` on
    ``mesh``: every named axis exists, none is used twice, every named
    dim divides."""
    if len(spec) > len(shape):
        return False
    sizes = axis_sizes(mesh)
    used = set()
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        names = axes if isinstance(axes, tuple) else (axes,)
        size = 1
        for n in names:
            if n not in sizes or n in used:
                return False
            used.add(n)
            size *= sizes[n]
        if dim % size:
            return False
    return True


def select_spec(mesh, shape: Sequence[int], specs: Sequence[Spec]):
    """First viable candidate spec (as a tuple), or None when nothing
    fits."""
    for spec in specs:
        if spec_viable(mesh, shape, spec):
            return tuple(spec)
    return None


def _as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: itself when it is one, else every
    rank's full copy (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _run_mesh(what: str):
    """The active mesh, None without one; raises under an abstract mesh."""
    mesh = active_mesh()
    if isinstance(mesh, Mapping):
        raise TypeError(
            f"{what} under an abstract mesh: only a run has ranks to place "
            "a tensor on; give sharding_policy a DeviceMesh")
    return mesh


def _apply(x, mesh, spec):
    """``x`` redistributed to ``spec`` on ``mesh`` (a ``DeviceMesh``)."""
    from repro_torch.dist.sharding import placements

    x = _as_dtensor(x, mesh)
    want = placements(mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def constrain_to(x, spec: Spec):
    """``x`` (a DTensor, or every rank's full copy) laid out by ``spec``
    on the active ``DeviceMesh``."""
    mesh = _run_mesh("constrain_to")
    if mesh is None:
        raise RuntimeError("constrain_to needs an active mesh")
    return _apply(x, mesh, tuple(spec))


def constrain(x, specs: Sequence[Spec]):
    """``x`` laid out by the first viable candidate spec on the active
    mesh (``DTensor.redistribute``; a plain tensor is every rank's full
    copy, so sharding it is a local slice); the identity with no active
    mesh, or when no candidate fits."""
    mesh = _run_mesh("constrain")
    if mesh is None:
        return x
    spec = select_spec(mesh, tuple(x.shape), specs)
    if spec is None:
        return x
    return _apply(x, mesh, spec)


def constrain_ranked(x, specs: Sequence[Spec]):
    """``x`` laid out by the viable candidate that
    ``plan.cost.rank_specs`` ranks cheapest (estimated per-device
    collective bytes to keep its replicas in sync; ties to the earlier
    candidate): the chooser for placements that decide a collective's
    shape, e.g. the MoE dispatch buffer's."""
    mesh = _run_mesh("constrain_ranked")
    if mesh is None:
        return x
    spec = ranked_spec(mesh, tuple(x.shape), specs, x.element_size())
    if spec is None:
        return x
    return _apply(x, mesh, spec)


def ranked_spec(mesh, shape: Sequence[int], specs: Sequence[Spec],
                dtype_bytes: int = 4):
    """The viable candidate ``plan.cost.rank_specs`` ranks first (as a
    tuple), or None when nothing fits."""
    viable = [tuple(s) for s in specs if spec_viable(mesh, shape, s)]
    if not viable:
        return None
    from repro_torch.plan.cost import rank_specs  # dist stays base-layer

    return viable[rank_specs(axis_sizes(mesh), shape, viable, dtype_bytes)]
