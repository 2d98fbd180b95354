"""The reference's side of the sharded cases, run in a subprocess.

    python -c "import _jax_sharded; _jax_sharded.main('out.pkl')"

with ``tests/`` and ``src/`` on the path.  It emulates four host devices
(``XLA_FLAGS`` is set before JAX loads), runs every case of
``_sharded_cases.reference_cases()`` through the reference's sharded
executors, and pickles ``{case: {"out": global output, "ledger": LEDGER
snapshot of that case}}`` (the reference's Pallas kernels in interpret
mode).  It also pickles the reference's pipeline plans: ``{("plan",
mesh, precision): [(impl, block_rows, block_k, block_f, fused,
in_layout, out_layout), ...]}`` for ``plan="auto"`` under ``TPU_V5E``.
"""

import os
import pickle

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import _sharded_cases as C  # noqa: E402


def _mesh(jax, np, name):
    d, f = C.MESHES[name]
    devs = np.array(jax.devices()[:d * f])
    if f == 1:
        return jax.sharding.Mesh(devs, ("data",))
    return jax.sharding.Mesh(devs.reshape(d, f), ("data", "feature"))


def main(path: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core import preprocess, random_power_law_csr
    from repro.dist.collectives import LEDGER
    from repro.exec import SpmmOperands, SpmmPlan, execute
    from repro.exec.dispatch import execute_layer
    from repro.exec.pipeline import plan_pipeline, static_pipeline
    from repro.models import gcn

    assert jax.device_count() == 4, jax.device_count()
    s, g = C.SPMM, C.GCN
    res = preprocess(random_power_law_csr(s["n"], s["n"], s["nnz"], seed=0),
                     tau=s["tau"], tile_rows=s["tile_rows"], edge_cut="rcm",
                     pad_rows_to=s["block"])
    dense, x, w, b = (jnp.asarray(a) for a in C.spmm_inputs())
    layer = {"w": w, "b": b}
    cfg = gcn.GCNConfig(in_dim=g["in_dim"], hidden_dim=g["hidden_dim"],
                        out_dim=g["out_dim"], tau=g["tau"],
                        block_rows=g["block"], block_k=g["block"],
                        block_f=g["block"])
    graph = gcn.GCNGraph.build(
        random_power_law_csr(g["n"], g["n"], g["nnz"], alpha=g["alpha"],
                             seed=0), cfg)
    params = gcn.init_params(cfg, jax.random.PRNGKey(0))
    feats = jnp.asarray(C.gcn_features())
    blocks = dict(block_rows=s["block"], block_k=s["block"],
                  block_f=s["block"])
    results = {}
    for case in C.reference_cases():
        LEDGER.reset()
        kind, mesh = case[0], _mesh(jax, np, case[1])
        if kind in ("spmm", "fused"):
            _, _, impl, prec, out_l, dense_l = case
            plan = SpmmPlan(
                impl=C.REF_IMPL[impl], mesh=mesh, precision=prec,
                out_layout=out_l, dense_layout=dense_l,
                feature_axis="feature" if C.MESHES[case[1]][1] > 1 else None,
                fused=kind == "fused", **blocks)
            ops = SpmmOperands.from_ell(res.ell)
            out = (execute(plan, ops, dense) if kind == "spmm"
                   else execute_layer(plan, ops, x, layer))
        elif kind == "gcn":
            _, _, impl, fused, prec, chain = case
            if chain == "pipelined":
                plan = static_pipeline(cfg, mesh, impl=C.REF_IMPL[impl],
                                       precision=prec, fused=fused)
            else:
                plan = SpmmPlan(impl=C.REF_IMPL[impl], mesh=mesh,
                                precision=prec, fused=fused,
                                block_rows=g["block"], block_k=g["block"],
                                block_f=g["block"])
            out_l = "row_sharded" if chain == "row_out" else "replicated"
            out = gcn.gcn_forward(params, graph, feats, cfg, plan=plan,
                                  out_layout=out_l, precision=prec)
        else:  # auto
            prec = case[2]
            pp = plan_pipeline(cfg, graph.pre.ell, mesh=mesh,
                               n_layers=len(params), precision=prec)
            results[("plan",) + case[1:]] = [
                (lp.spmm.impl, lp.spmm.block_rows, lp.spmm.block_k,
                 lp.spmm.block_f, lp.spmm.fused, lp.in_layout,
                 lp.out_layout) for lp in pp.layers]
            out = gcn.gcn_forward(params, graph, feats, cfg, plan="auto",
                                  mesh=mesh, precision=prec)
        results[case] = {"out": np.asarray(out, dtype=np.float32),
                         "ledger": LEDGER.snapshot()}
        print("ok", C.case_id(case), flush=True)
    with open(path, "wb") as fh:
        pickle.dump(results, fh)
