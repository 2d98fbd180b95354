"""Logical-axis sharding constraints.

The port of ``repro.dist.policy``.  Model code never names a concrete
mesh: it calls ``constrain(x, specs)`` with an ordered list of candidate
partition specs (most-sharded first).  A spec is a tuple of entries, one
per leading dimension, as in ``dist/sharding.py``: an axis name, a tuple
of axis names, or None.  :func:`spec_viable` and :func:`select_spec` read
the axis sizes of any mesh form ``dist.topology.axis_sizes`` takes.

With no active mesh (unit tests, single-card runs) ``constrain`` and
``constrain_ranked`` are the identity, as in the reference.  The LM under
a mesh (tensor parallelism over ``torch.distributed``) is ROADMAP item
A13b: under an active mesh both raise rather than silently leave the
tensor unsharded.

The active mesh is installed by ``sharding_policy(mesh)``.  State is
thread-local, as in the reference.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence, Tuple, Union

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


def _unported(what: str):
    return NotImplementedError(
        f"{what} under an active mesh: the LM under a mesh (tensor "
        f"parallelism) is ROADMAP item A13b, not ported yet")


def constrain(x, specs: Sequence[Spec]):
    """The identity with no active mesh; raises under one (A13b)."""
    if active_mesh() is None:
        return x
    raise _unported("constrain")


def constrain_ranked(x, specs: Sequence[Spec]):
    """The identity with no active mesh; raises under one (A13b)."""
    if active_mesh() is None:
        return x
    raise _unported("constrain_ranked")
