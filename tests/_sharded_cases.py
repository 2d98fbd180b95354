"""The sharded cases both packages run (numpy only).

``tests/test_torch_sharded.py`` runs every case in the port's ranks
(``_torch_dist.run_ranks``) and a subset in the reference, in one
subprocess with four emulated host devices (``_jax_sharded.py``).  A case
key is a tuple; its first entry names its kind:

* ``("spmm", mesh, impl, precision, out_layout, dense_layout)`` — one
  sharded SpMM, ``A @ dense``;
* ``("fused", mesh, impl, precision, out_layout, dense_layout)`` — one
  fused GCN layer, ``A (x W + b)``;
* ``("gcn", mesh, impl, fused, precision, chain)`` — a 2-layer
  ``gcn_forward`` on the mesh: ``chain`` is ``"replicated"`` (the static
  plan, an all-reduce per layer), ``"pipelined"`` (``static_pipeline``:
  reduce-scatter between the layers), ``"row_out"`` (the static plan
  with ``out_layout="row_sharded"``), ``"row_all"`` (a static plan taking
  and emitting row-sharded activations at every layer, so the features
  are sliced on entry; the port's runs only) or ``"feature"`` (a static
  plan that also splits the feature axis of ``d2f2``; the port's runs
  only);
* ``("auto", mesh, precision)`` — ``gcn_forward(plan="auto")`` on the
  mesh, planned with the Pallas model ``TPU_V5E``.

Impl names are the port's; ``REF_IMPL`` maps them to the reference's.
Meshes: ``d2`` and ``d4`` are 2 and 4 ranks on a ``data`` axis, ``d2f2``
is 2 x 2 with a ``feature`` axis.
"""

import numpy as np

REF_IMPL = {"reference": "reference", "cuda": "pallas",
            "cuda_sparse": "pallas_sparse"}
IMPLS = tuple(REF_IMPL)
PRECISIONS = ("f32", "bf16", "int8")
LAYOUTS = ("replicated", "row_sharded")
CHAINS = ("replicated", "pipelined", "row_out")
#: mesh name -> (data, feature) sizes
MESHES = {"d2": (2, 1), "d4": (4, 1), "d2f2": (2, 2)}

# The SpMM and the fused layer: tests/test_exec.py's problem (96 nodes,
# 700 nonzeros, tau 5, 16-row tiles), blocks of 16.
SPMM = dict(n=96, nnz=700, tau=5, tile_rows=16, block=16, f=24, f_in=12)
# The GCN: tests/test_torch_gcn.py's "fused_case" graph, hidden 32.
GCN = dict(n=96, nnz=700, alpha=2.1, in_dim=12, hidden_dim=32, out_dim=8,
           tau=6, block=16)
GCN_CONFIGS = (("reference", False), ("cuda", False), ("cuda_sparse", False),
               ("cuda", True), ("cuda_sparse", True))


def world(mesh: str) -> int:
    d, f = MESHES[mesh]
    return d * f


def spmm_inputs():
    """``(dense, x, w, b)`` of the SpMM and fused-layer cases, f32."""
    n, f, f_in = SPMM["n"], SPMM["f"], SPMM["f_in"]
    dense = np.random.default_rng(1).standard_normal((n, f)).astype(np.float32)
    x = np.random.default_rng(2).standard_normal((n, f_in)).astype(np.float32)
    w = (0.3 * np.random.default_rng(3).standard_normal((f_in, f))).astype(
        np.float32)
    b = (0.1 * np.random.default_rng(4).standard_normal(f)).astype(np.float32)
    return dense, x, w, b


def gcn_features():
    return np.random.default_rng(1).standard_normal(
        (GCN["n"], GCN["in_dim"])).astype(np.float32)


def port_cases(world_size: int):
    """Every case the port runs at ``world_size`` ranks."""
    meshes = [m for m in MESHES if world(m) == world_size]
    cases = []
    for mesh in meshes:
        for impl in IMPLS:
            for prec in PRECISIONS:
                for out in LAYOUTS:
                    for dense in LAYOUTS:
                        cases.append(("spmm", mesh, impl, prec, out, dense))
        if MESHES[mesh][1] > 1:
            # fused layers do not split the feature axis
            for impl in IMPLS:
                for prec in PRECISIONS:
                    cases.append(("gcn", mesh, impl, False, prec, "feature"))
            continue
        for impl in ("cuda", "cuda_sparse"):
            for prec in PRECISIONS:
                for out in LAYOUTS:
                    for dense in LAYOUTS:
                        cases.append(("fused", mesh, impl, prec, out, dense))
        for impl, fused in GCN_CONFIGS:
            for prec in PRECISIONS:
                for chain in CHAINS + ("row_all",):
                    cases.append(("gcn", mesh, impl, fused, prec, chain))
        if mesh == "d2":
            for prec in PRECISIONS:
                cases.append(("auto", mesh, prec))
    return cases


def reference_cases():
    """The cases the reference runs (each sharded run re-traces its
    ``shard_map``, ~1.7 s on the CPU): every layout and precision with the
    reference impl, and its kernels where the port's ledger or kernels
    need their own run."""
    cases = []
    for mesh in MESHES:
        for prec in PRECISIONS:
            for out in LAYOUTS:
                for dense in LAYOUTS:
                    cases.append(("spmm", mesh, "reference", prec, out, dense))
    for prec in PRECISIONS:
        for lay in LAYOUTS:
            cases.append(("spmm", "d2", "cuda_sparse", prec, lay, lay))
    cases += [("spmm", "d4", "cuda_sparse", "f32", "row_sharded",
               "row_sharded"),
              ("spmm", "d2", "cuda", "f32", "row_sharded", "row_sharded"),
              ("spmm", "d2", "cuda", "int8", "row_sharded", "row_sharded")]
    for prec in PRECISIONS:
        for lay in LAYOUTS:
            cases.append(("fused", "d2", "cuda", prec, lay, lay))
    cases += [("fused", "d2", "cuda_sparse", "int8", "row_sharded",
               "replicated"),
              ("fused", "d2", "cuda_sparse", "f32", "replicated",
               "row_sharded"),
              ("fused", "d4", "cuda", "f32", "row_sharded", "row_sharded"),
              ("fused", "d4", "cuda_sparse", "bf16", "replicated",
               "row_sharded")]
    for prec in PRECISIONS:
        for chain in CHAINS:
            cases.append(("gcn", "d2", "reference", False, prec, chain))
        for chain in ("pipelined", "row_out"):
            cases.append(("gcn", "d4", "reference", False, prec, chain))
        cases.append(("gcn", "d2", "cuda", True, prec, "pipelined"))
        cases.append(("auto", "d2", prec))
    cases += [("gcn", "d2", "cuda_sparse", False, "int8", "row_out"),
              ("gcn", "d2", "cuda_sparse", True, "f32", "replicated"),
              ("gcn", "d4", "cuda", True, "int8", "pipelined")]
    return cases


def reference_twin(case):
    """The reference-impl case whose output ``case`` is held against:
    the same mesh, precision and layouts (a fused layer's twin is none:
    the reference impl has no fused launch)."""
    kind = case[0]
    if kind == "spmm":
        return ("spmm", case[1], "reference") + case[3:]
    if kind == "gcn":
        return ("gcn", case[1], "reference", False) + case[4:]
    return None


def case_id(case) -> str:
    return "-".join(str(c) for c in case)
