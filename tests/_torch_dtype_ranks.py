"""The rank function of ``tests/test_torch_dtypes.py``'s sharded case
(torch only; run through ``_torch_dist.run_ranks``)."""


def sharded_dtypes(rank, world, host, blocks):
    """On a ``world``-wide data mesh of gloo CPU ranks: the aggregation
    under ``out_dtype=torch.bfloat16`` at each impl, the fused layer under
    it, the int8 x int8 product, and the ``spmm_ell(mesh=)`` shorthand,
    each assembled to its global answer: ``{case: {"value", "dtype",
    "collective_dtype"}}``."""
    import numpy as np
    import torch

    from repro_torch.core import spmm_ell
    from repro_torch.core.sparse_formats import TiledELL
    from repro_torch.dist import collectives as coll
    from repro_torch.exec import SpmmOperands, SpmmPlan, execute_layer
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(world, device="cpu")
    ell, ell8 = TiledELL(**host["ell"]), TiledELL(**host["ell8"])
    dense = torch.as_tensor(host["dense"])
    dense8 = torch.as_tensor(host["dense8"])
    layer = {"w": torch.as_tensor(host["w"]), "b": torch.as_tensor(host["b"])}
    seen = []
    reduce = coll.dist.all_reduce

    def all_reduce(t, *args, **kw):
        seen.append(str(t.dtype).replace("torch.", ""))
        return reduce(t, *args, **kw)

    coll.dist.all_reduce = all_reduce
    out = {}

    def keep(name, y, plan):
        y = coll.assemble(y, plan)
        out[name] = {"value": y.float().numpy().astype(np.float64)
                     if y.dtype.is_floating_point else y.numpy(),
                     "dtype": str(y.dtype).replace("torch.", ""),
                     "collective_dtype": seen[-1] if seen else None}

    try:
        for impl in ("cuda", "cuda_sparse", "reference"):
            plan = SpmmPlan(impl=impl, mesh=mesh, out_dtype=torch.bfloat16,
                            **blocks)
            keep(f"spmm {impl}", spmm_ell(ell, dense, plan=plan,
                                          device="cpu"), plan)
        for impl in ("cuda", "cuda_sparse"):
            plan = SpmmPlan(impl=impl, mesh=mesh, fused=True,
                            out_dtype=torch.bfloat16, **blocks)
            keep(f"fused {impl}", execute_layer(
                plan, SpmmOperands.from_ell(ell, "cpu"),
                torch.as_tensor(host["x"]), layer), plan)
            plan = SpmmPlan(impl=impl, mesh=mesh, **blocks)
            keep(f"int8 {impl}", spmm_ell(ell8, dense8, plan=plan,
                                          device="cpu"), plan)
        plan = SpmmPlan(impl="cuda", mesh=mesh, **blocks)
        keep("spmm cuda f32", spmm_ell(ell, dense, plan=plan, device="cpu"),
             plan)
        keep("mesh shorthand", spmm_ell(ell, dense, impl="cuda", mesh=mesh,
                                        device="cpu", **blocks), plan)
    finally:
        coll.dist.all_reduce = reduce
    return out
