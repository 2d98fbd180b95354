"""Counts the torch ops a piece of the port runs, as the H100 cost model
counts launches (``repro_torch.plan.cost``): every ATen op except views,
bare allocations and the wrapping of Python scalars, none of which runs
anything on the card.  Imports only torch, so the card tests can use it.
"""

from torch.utils._python_dispatch import TorchDispatchMode

#: ATen ops that launch nothing on the card.
NO_LAUNCH = frozenset({"empty", "empty_strided", "scalar_tensor",
                       "_local_scalar_dense", "lift_fresh", "detach",
                       "alias"})


class CountOps(TorchDispatchMode):
    """``with CountOps() as ops: ...`` records each launching op's name in
    ``ops.names``; ops run while ``paused`` is above 0 are left out."""

    def __init__(self):
        super().__init__()
        self.names = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        if not self.paused and not func.is_view and name not in NO_LAUNCH:
            self.names.append(name)
        return func(*args, **(kwargs or {}))
