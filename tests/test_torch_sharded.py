"""The port's sharded GCN inference against ``repro``'s, on gloo ranks.

Every case of ``_sharded_cases.port_cases`` runs in the port's ranks on
the CPU (one spawn per world size: 2 ranks, and 4 as ``data`` 4 and as 2 x
2 with a ``feature`` axis; ``_torch_dist.run_ranks``, which fails a test
when a rank fails or the spawn outlives its limit), where the kernel
wrappers run their plain versions.  Each rank returns its shard; the
shards are assembled (``dist.collectives.assemble``) into the global
output.  Held against:

* the reference's unsharded ``impl="reference"`` output, in-process: at
  f32 and bf16 within 1e-5 of the output scale (bf16 rounds the same
  values; only the order of the f32 sums differs); int8 re-quantizes the
  values per shard (the shard boundaries are not on scale blocks), so it
  is held within the reference's int8 logit budget (0.05) of the f32
  output;
* the reference's sharded output for the same case (its Pallas kernels in
  interpret mode) or, for the other impls, its ``impl="reference"`` run
  of the same mesh, precision and layouts, from one subprocess with four
  emulated host devices (``_jax_sharded.py``): within 1e-5 of the output
  scale at every precision (the same per-shard quantization);
* the reference's ``LEDGER`` entries, entry for entry, where it ran the
  same case (or, for ``reference``/``cuda`` unfused, whose entries equal
  it, its ``impl="reference"`` twin); each rank's ledger equals the
  others';
* the shard contract: each rank's shard shape, and the collectives each
  layout calls.

The H100 model's launches for one sharded layer are the torch ops the
rank runs (each collective counted as one launch, as NCCL runs it).
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

import _sharded_cases as C
from _torch_dist import run_ranks
from _torch_ops import WRAPPER_LAUNCHES
from repro.core import preprocess as j_preprocess
from repro.core import random_power_law_csr as j_power_law
from repro.exec import SpmmOperands as JOperands
from repro.exec import SpmmPlan as JPlan
from repro.exec import execute as j_execute
from repro.exec.dispatch import execute_layer as j_execute_layer
from repro.models import gcn as jgcn

RTOL = 1e-5
LOGIT_BUDGET = {"bf16": 0.02, "int8": 0.05}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_max_err(out, ref) -> float:
    out = np.asarray(out, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(out - ref))) / max(float(np.max(np.abs(ref))),
                                                  1e-30)


def _gcn_cfg():
    g = C.GCN
    return jgcn.GCNConfig(in_dim=g["in_dim"], hidden_dim=g["hidden_dim"],
                          out_dim=g["out_dim"], tau=g["tau"],
                          block_rows=g["block"], block_k=g["block"],
                          block_f=g["block"])


def _numpy_params():
    return {name: {k: np.asarray(v) for k, v in layer.items()}
            for name, layer in jgcn.init_params(
                _gcn_cfg(), jax.random.PRNGKey(0)).items()}


@pytest.fixture(scope="module")
def port():
    """``{world: [rank results]}`` of the port's ranks."""
    params = _numpy_params()
    return {w: run_ranks("_torch_dist", "port_rank", w, args=(params,))
            for w in (2, 4)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded results, from one subprocess."""
    path = tmp_path_factory.mktemp("jax_sharded") / "ref.pkl"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "tests"), os.path.join(ROOT, "src"),
         env.get("PYTHONPATH", "")])
    r = subprocess.run(
        [sys.executable, "-c",
         f"import _jax_sharded; _jax_sharded.main({str(path)!r})"],
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def unsharded():
    """The reference's unsharded ``impl="reference"`` outputs, per (kind,
    precision), and the GCN graph's inverse permutation."""
    s = C.SPMM
    res = j_preprocess(j_power_law(s["n"], s["n"], s["nnz"], seed=0),
                       tau=s["tau"], tile_rows=s["tile_rows"],
                       edge_cut="rcm", pad_rows_to=s["block"])
    dense, x, w, b = C.spmm_inputs()
    cfg = _gcn_cfg()
    g = C.GCN
    graph = jgcn.GCNGraph.build(
        j_power_law(g["n"], g["n"], g["nnz"], alpha=g["alpha"], seed=0), cfg)
    params = jgcn.init_params(cfg, jax.random.PRNGKey(0))
    blocks = dict(block_rows=s["block"], block_k=s["block"],
                  block_f=s["block"])
    out = {"inv": np.asarray(graph.inv)}
    for prec in C.PRECISIONS:
        plan = JPlan(impl="reference", precision=prec, **blocks)
        ops = JOperands.from_ell(res.ell)
        out["spmm", prec] = np.asarray(j_execute(plan, ops, dense))
        out["fused", prec] = np.asarray(
            j_execute_layer(plan, ops, x, {"w": w, "b": b}))
        out["gcn", prec] = np.asarray(jgcn.gcn_forward(
            params, graph, C.gcn_features(), cfg,
            plan=JPlan(impl="reference", precision=prec, block_rows=g["block"],
                       block_k=g["block"], block_f=g["block"]),
            precision=prec))
    return out


def _world(case) -> int:
    return C.world(case[1])


def _precision(case) -> str:
    return case[{"spmm": 3, "fused": 3, "gcn": 4, "auto": 2}[case[0]]]


def _original_order(case, out, unsharded):
    """A ``row_out`` forward's assembled rows are permuted and padded."""
    if case[0] == "gcn" and case[5] == "row_out":
        return out[:C.GCN["n"]][unsharded["inv"]]
    return out


PORT_CASES = C.port_cases(2) + C.port_cases(4)
REF_CASES = set(C.reference_cases())


def _sharded_reference(case):
    """The reference run a port case's output is held against."""
    if case in REF_CASES:
        return case
    twin = C.reference_twin(case)
    return twin if twin in REF_CASES else None


def _ledger_reference(case):
    """The reference run whose ledger equals the case's: the same case,
    or the ``impl="reference"`` twin of an unfused ``reference``/``cuda``
    case (the reserved block of ``cuda_sparse`` and the fused ledger
    differ from it)."""
    if case in REF_CASES:
        return case
    unfused = case[0] == "spmm" or (case[0] == "gcn" and not case[3])
    if unfused and case[2] in ("reference", "cuda"):
        twin = C.reference_twin(case)
        return twin if twin in REF_CASES else None
    return None


@pytest.mark.parametrize("case", PORT_CASES, ids=C.case_id)
def test_sharded_output_matches_unsharded_reference(case, port, unsharded):
    got = port[_world(case)][0][case]["out"]
    prec = _precision(case)
    kind = "gcn" if case[0] == "auto" else case[0]
    ref = unsharded[kind, prec]
    got = _original_order(case, got, unsharded)[:ref.shape[0]]
    assert got.shape == ref.shape and np.isfinite(got).all()
    if prec == "int8":
        assert rel_max_err(got, unsharded[kind, "f32"]) <= LOGIT_BUDGET[prec]
    else:
        assert rel_max_err(got, ref) <= RTOL


@pytest.mark.parametrize(
    "case", [c for c in PORT_CASES if _sharded_reference(c)], ids=C.case_id)
def test_sharded_output_matches_sharded_reference(case, port, reference):
    got = port[_world(case)][0][case]["out"]
    want = reference[_sharded_reference(case)]["out"]
    assert got.shape == want.shape
    assert rel_max_err(got, want) <= RTOL


@pytest.mark.parametrize(
    "case", [c for c in PORT_CASES if _ledger_reference(c)], ids=C.case_id)
def test_sharded_ledger_matches_reference(case, port, reference):
    ranks = port[_world(case)]
    want = reference[_ledger_reference(case)]["ledger"]
    for rank in ranks:
        assert rank[case]["ledger"] == want


@pytest.mark.parametrize("case", PORT_CASES, ids=C.case_id)
def test_each_rank_holds_its_shard(case, port):
    """The shard contract, and the collectives each layout calls."""
    ranks = port[_world(case)]
    d, f = C.MESHES[case[1]]
    shapes = {r[case]["shard_shape"] for r in ranks}
    calls = ranks[0][case]["calls"]
    assert all(r[case]["ledger"] == ranks[0][case]["ledger"] for r in ranks)
    assert all(r[case]["calls"] == calls for r in ranks)
    assert set(calls) <= {f"{op}@gloo" for op in
                          ("all_reduce", "reduce_scatter", "all_gather")}
    if case[0] in ("spmm", "fused"):
        _, _, impl, prec, out_l, dense_l = case
        n = C.SPMM["n"]
        rows = -(-n // d) if out_l == "row_sharded" else n
        cols = -(-C.SPMM["f"] // f)
        assert shapes == {(rows, cols)}
        assert calls.get("reduce_scatter@gloo", 0) == (out_l == "row_sharded")
        assert calls.get("all_reduce@gloo", 0) == (out_l == "replicated")
        assert calls.get("all_gather@gloo", 0) == (dense_l == "row_sharded")
    elif case[0] == "gcn":
        chain = case[5]
        n, out_dim = C.GCN["n"], C.GCN["out_dim"]
        rows = -(-n // d) if chain == "row_out" else n
        assert shapes == {(rows, -(-out_dim // f))}
        want = {"replicated": (2, 0, 0), "pipelined": (1, 1, 1),
                "row_out": (1, 1, 0), "row_all": (1, 1, 2),
                "feature": (2, 0, 1)}[chain]
        assert (calls.get("all_reduce@gloo", 0),
                calls.get("reduce_scatter@gloo", 0),
                calls.get("all_gather@gloo", 0)) == want


@pytest.mark.parametrize("precision", C.PRECISIONS)
def test_auto_plan_matches_reference(precision, port, reference):
    """``plan="auto"`` on a 2-rank mesh, planned with ``TPU_V5E``: the
    reference's per-layer plans and layouts (impl names mapped)."""
    key = ("plan", "d2", precision)
    got = [(C.REF_IMPL[p[0]],) + tuple(p[1:]) for p in port[2][0][key]]
    assert got == [tuple(p) for p in reference[key]]


@pytest.fixture(scope="module")
def launches():
    return run_ranks("_torch_dist", "sharded_launches", 2,
                     args=(WRAPPER_LAUNCHES,))


LAUNCH_CASES = [(impl, prec, fused, dense_l, out_l)
                for impl in C.IMPLS for prec in C.PRECISIONS
                for fused in (False, True) for dense_l in C.LAYOUTS
                for out_l in C.LAYOUTS]


@pytest.mark.parametrize("case", LAUNCH_CASES, ids=C.case_id)
def test_sharded_launches_are_the_ops_dispatch_runs(case, launches):
    """The H100 model's launches of one sharded layer (``cuda_spmm_work`` +
    ``cuda_combination_work``, or ``cuda_fused_work``, with ``n_shards=2``
    and the dense operand's gathered height, plus one per collective) are
    the torch ops each rank's ``execute_layer`` runs."""
    for rank in launches:
        names, want = rank[case]
        assert len(names) == want, names
