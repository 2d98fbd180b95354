"""Host core of the PyTorch port against the JAX reference.

Host artifacts must match exactly: the permutation, the ELL table, the
launch schedules, the synthetic datasets.  Also: the port imports
neither ``jax`` nor ``repro``, and its entry points refuse to fall back to
the CPU when no card is there.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro.core import preprocessing as jpre
from repro.core import sparse_formats as jsf
from repro.core.spmm import segment_accumulate as j_segment_accumulate
from repro.graphs import datasets as jds
from repro.kernels.flexvector_spmm import pad_operands as j_pad_operands
from repro.kernels.ref import spmm_ell_ref as j_spmm_ell_ref

from repro_torch.core import dataflow as tdf
from repro_torch.core import preprocessing as tpre
from repro_torch.core import sparse_formats as tsf
from repro_torch.core.spmm import segment_accumulate, spmm_ell
from repro_torch.exec import quant
from repro_torch.exec.operands import SpmmOperands
from repro_torch.exec.plan import (IMPL_NAMES, SpmmPlan, plan_for_config,
                                   reset_degradation_warnings)
from repro_torch.graphs import datasets as tds
from repro_torch.kernels.flexvector_spmm import pad_operands
from repro_torch.kernels.ref import spmm_ell_ref
from repro_torch.models import gcn as tgcn
from repro_torch.models.convert import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



@pytest.fixture(autouse=True)
def _fresh_degradation_registry():
    """The port warns once per process; each test starts unwarned."""
    reset_degradation_warnings()


# (n, nnz, tau, tile_rows, edge_cut, alpha, seed)
PREPROCESS_CASES = [
    (96, 700, 6, 16, "rcm", 2.1, 0),
    (200, 2500, 4, 16, "rcm", 2.6, 3),   # skewed: many vertex-cut splits
    (120, 900, 8, 8, "degree", 2.1, 5),
    (64, 300, 3, 16, "none", 2.1, 7),
]


def _pair(n, nnz, tau, tile_rows, edge_cut, alpha, seed, pad_rows_to=16):
    j_adj = jsf.random_power_law_csr(n, n, nnz, alpha=alpha, seed=seed)
    t_adj = tsf.random_power_law_csr(n, n, nnz, alpha=alpha, seed=seed)
    j = jpre.preprocess(j_adj, tau=tau, tile_rows=tile_rows, edge_cut=edge_cut,
                        pad_rows_to=pad_rows_to)
    t = tpre.preprocess(t_adj, tau=tau, tile_rows=tile_rows, edge_cut=edge_cut,
                        pad_rows_to=pad_rows_to)
    return j, t


@pytest.mark.parametrize("case", PREPROCESS_CASES)
def test_preprocess_matches_reference_exactly(case):
    j, t = _pair(*case)
    np.testing.assert_array_equal(t.perm, j.perm)
    np.testing.assert_array_equal(t.ell.cols, j.ell.cols)
    np.testing.assert_array_equal(t.ell.vals, j.ell.vals)
    np.testing.assert_array_equal(t.ell.row_map, j.ell.row_map)
    assert (t.ell.n_dense_rows, t.ell.n_orig_rows) == (
        j.ell.n_dense_rows, j.ell.n_orig_rows)
    assert len(t.tiles) == len(j.tiles)
    for tt, jt in zip(t.tiles, j.tiles):
        np.testing.assert_array_equal(tt.sub_row_map, jt.sub_row_map)


def test_random_power_law_csr_matches_reference():
    j = jsf.random_power_law_csr(150, 120, 1000, alpha=2.3, seed=11)
    t = tsf.random_power_law_csr(150, 120, 1000, alpha=2.3, seed=11)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.shape == j.shape


@pytest.mark.parametrize("blocks", [(16, 16), (32, 16), (8, 64), (16, 128)])
@pytest.mark.parametrize("hot_k_first", [True, False])
@pytest.mark.parametrize("skip_empty", [True, False])
def test_kernel_grid_matches_reference_exactly(blocks, hot_k_first, skip_empty):
    br, bk = blocks
    j, t = _pair(200, 2500, 4, 16, "rcm", 2.6, 3, pad_rows_to=br)
    np.testing.assert_array_equal(t.ell.block_occupancy(br, bk),
                                  j.ell.block_occupancy(br, bk))
    jg = jdf.plan_kernel_grid(j.ell, 40, br, bk, 16, skip_empty=skip_empty,
                              hot_k_first=hot_k_first)
    tg = tdf.plan_kernel_grid(t.ell, 40, br, bk, 16, skip_empty=skip_empty,
                              hot_k_first=hot_k_first)
    np.testing.assert_array_equal(tg.pairs, jg.pairs)
    assert tg.pairs.dtype == jg.pairs.dtype
    np.testing.assert_array_equal(tg.first_k, jg.first_k)
    assert (tg.n_row_blocks, tg.n_k_tiles, tg.n_f_tiles, tg.density) == (
        jg.n_row_blocks, jg.n_k_tiles, jg.n_f_tiles, jg.density)


def test_kernel_grid_keeps_empty_row_blocks_like_reference():
    # a trailing all-padding row block must still be visited once
    j, t = _pair(64, 300, 3, 16, "rcm", 2.1, 7, pad_rows_to=16)
    pad = lambda e, m: m.TiledELL(  # noqa: E731
        cols=np.concatenate([e.cols, np.full((32, e.tau), -1, np.int32)]),
        vals=np.concatenate([e.vals, np.zeros((32, e.tau), np.float32)]),
        row_map=np.concatenate([e.row_map, np.full(32, -1, np.int32)]),
        n_dense_rows=e.n_dense_rows, n_orig_rows=e.n_orig_rows)
    jg = jdf.plan_kernel_grid(pad(j.ell, jsf), 8, 16, 16, 8)
    tg = tdf.plan_kernel_grid(pad(t.ell, tsf), 8, 16, 16, 8)
    np.testing.assert_array_equal(tg.pairs, jg.pairs)
    np.testing.assert_array_equal(tg.first_k, jg.first_k)


@pytest.mark.parametrize("blocks", [(16, 16), (32, 32), (16, 128)])
@pytest.mark.parametrize("hot_k_first", [True, False])
def test_fused_k_schedule_matches_reference_exactly(blocks, hot_k_first):
    br, bk = blocks
    j, t = _pair(200, 2500, 4, 16, "rcm", 2.6, 3, pad_rows_to=br)
    js = jdf.plan_fused_k_schedule(j.ell, br, bk, hot_k_first=hot_k_first)
    ts = tdf.plan_fused_k_schedule(t.ell, br, bk, hot_k_first=hot_k_first)
    np.testing.assert_array_equal(ts, js)
    assert ts.dtype == js.dtype


def test_load_dataset_cora_matches_reference_exactly():
    j = jds.load_dataset("cora", seed=0)
    t = tds.load_dataset("cora", seed=0)
    assert t.spec == tds.DATASETS["cora"]
    assert (t.spec.nodes, t.spec.edges, t.spec.feature_dim, t.spec.classes) == (
        j.spec.nodes, j.spec.edges, j.spec.feature_dim, j.spec.classes)
    for attr in ("adj", "adj_norm"):
        for name in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(getattr(t, attr), name),
                                          getattr(getattr(j, attr), name))
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.labels, j.labels)


def test_dataset_table_matches_reference():
    assert {k: dataclass_tuple(v) for k, v in tds.DATASETS.items()} == {
        k: dataclass_tuple(v) for k, v in jds.DATASETS.items()}


def dataclass_tuple(spec):
    return (spec.name, spec.nodes, spec.edges, spec.feature_dim, spec.classes)


def test_segment_accumulate_matches_reference():
    rng = np.random.default_rng(0)
    sub = rng.standard_normal((40, 7)).astype(np.float32)
    row_map = rng.integers(-1, 12, 40).astype(np.int32)
    ref = np.asarray(j_segment_accumulate(sub, row_map, 12))
    out = segment_accumulate(torch.as_tensor(sub), torch.as_tensor(row_map), 12)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_spmm_ell_ref_matches_reference():
    j, t = _pair(96, 700, 6, 16, "rcm", 2.1, 0)
    dense = np.random.default_rng(2).standard_normal((96, 24)).astype(np.float32)
    ref = np.asarray(j_spmm_ell_ref(j.ell.cols, j.ell.vals, dense))
    out = spmm_ell_ref(torch.as_tensor(t.ell.cols), torch.as_tensor(t.ell.vals),
                       torch.as_tensor(dense))
    # same tau products, summed in another order: f32 rounding only
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["reference", "pallas", "pallas_sparse"])
def test_spmm_ell_entry_point_matches_dense_oracle(impl):
    _, t = _pair(96, 700, 6, 16, "rcm", 2.1, 0)
    dense = np.random.default_rng(4).standard_normal((96, 20)).astype(np.float32)
    out = spmm_ell(t.ell, dense, impl=IMPL_NAMES[impl], block_rows=16,
                   block_k=16, block_f=8, device="cpu")
    oracle = np.zeros((t.ell.n_orig_rows, t.ell.n_dense_rows))
    valid = t.ell.cols >= 0
    rows = np.broadcast_to(t.ell.row_map[:, None], t.ell.cols.shape)[valid]
    np.add.at(oracle, (rows, t.ell.cols[valid]), t.ell.vals[valid])
    np.testing.assert_allclose(out.numpy(), oracle @ dense, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(30, 5, 20, 9), (32, 5, 32, 16)])
def test_pad_operands_matches_reference(shape):
    r, tau, k, f = shape
    rng = np.random.default_rng(1)
    cols = rng.integers(-1, k, (r, tau)).astype(np.int32)
    vals = rng.standard_normal((r, tau)).astype(np.float32)
    dense = rng.standard_normal((k, f)).astype(np.float32)
    jc, jv, jd, jrf = j_pad_operands(cols, vals, dense, 16, 16, 8)
    tc, tv, td, trf = pad_operands(torch.as_tensor(cols), torch.as_tensor(vals),
                                   torch.as_tensor(dense), 16, 16, 8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert trf == jrf
    assert tc.dtype == torch.int32 and tc.is_contiguous()


def test_port_imports_neither_jax_nor_repro():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, 'repro_torch.')]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
        assert not bad, bad
        print(len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20   # every submodule was imported


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t = _pair(64, 300, 3, 16, "rcm", 2.1, 7)
    cfg = tgcn.GCNConfig(in_dim=4, hidden_dim=8, out_dim=2, block_rows=16,
                         block_k=16, block_f=16)
    graph = tgcn.GCNGraph(pre=t, n_nodes=64)
    params = tgcn.init_params(cfg, device="cpu")
    feats = np.zeros((64, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgcn.gcn_forward(params, graph, feats, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgcn.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spmm_ell(t.ell, np.zeros((64, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"layer_0": {"w": np.zeros((2, 2))}})
    # the LM entry points
    from repro_torch.configs import get_config, reduced
    from repro_torch.fleet import LmServable, fleet_from_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch.steps import step_for
    from repro_torch.models import lm as tlm
    from repro_torch.models.convert import lm_cache_from_numpy, lm_params_from_numpy

    lm_cfg = reduced(get_config("internlm2-1.8b"))
    for call in (
        lambda: LmServable("internlm2-1.8b"),
        lambda: lm_serve.main(["--reduced", "--tokens", "2"]),
        lambda: lm_params_from_numpy({"embed": np.zeros((2, 2), np.float32)}),
        lambda: lm_cache_from_numpy({"k": np.zeros((2, 2), np.float32)}),
        lambda: step_for(lm_cfg, "decode"),
        lambda: step_for(lm_cfg, "prefill"),
        lambda: tlm.init_lm(lm_cfg),
        lambda: tlm.init_cache(lm_cfg, 1, 4),
        lambda: fleet_from_config({"servables": [
            {"kind": "lm", "key": "lm", "arch": "internlm2-1.8b"}]}),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the same calls run when the CPU is asked for
    out = tgcn.gcn_forward(params, graph, feats, cfg, device="cpu")
    assert tuple(out.shape) == (64, 2)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_unported_precisions_raise_not_implemented(precision):
    """bf16 and int8 validate and plan like f32, with their byte widths;
    a precision the reference does not have raises ValueError."""
    assert quant.validate_precision(precision) == precision
    assert quant.validate_precision("f32") == "f32"
    assert SpmmPlan(impl="cuda", precision=precision).precision == precision
    assert quant.bytes_per_value(precision) == {"bf16": 2, "int8": 1}[precision]
    assert quant.activation_bytes(precision) == 2
    with pytest.raises(ValueError, match="unknown precision"):
        quant.validate_precision("fp8")
    with pytest.raises(ValueError, match="unknown precision"):
        SpmmPlan(impl="cuda", precision="fp8")


def test_impl_name_table_and_static_plan():
    assert IMPL_NAMES == {"reference": "reference", "pallas": "cuda",
                          "pallas_sparse": "cuda_sparse"}
    with pytest.raises(ValueError, match="unknown impl"):
        SpmmPlan(impl="pallas")
    cfg = tgcn.GCNConfig(in_dim=4, hidden_dim=8, out_dim=2,
                         spmm_impl="cuda_sparse", block_rows=32, block_k=16,
                         block_f=64)
    plan = plan_for_config(cfg)
    assert (plan.impl, plan.block_rows, plan.block_k, plan.block_f) == (
        "cuda_sparse", 32, 16, 64)
    assert not plan.resolved and not plan.fused


def test_sparse_plan_degrades_without_host_ell():
    _, t = _pair(96, 700, 6, 16, "rcm", 2.1, 0)
    ops = SpmmOperands.from_ell(t.ell, "cpu")
    bare = SpmmOperands(cols=ops.cols, vals=ops.vals, row_map=ops.row_map,
                        n_out_rows=ops.n_out_rows)
    plan = SpmmPlan(impl="cuda_sparse", block_rows=16, block_k=16, block_f=16)
    with pytest.warns(RuntimeWarning, match="degraded to cuda"):
        resolved = plan.resolve(schedulable=bare.schedulable)
    assert resolved.effective_impl == "cuda" and resolved.degraded
    assert resolved.resolve(schedulable=False) is resolved
    kept = plan.resolve(schedulable=True)
    assert kept.effective_impl == "cuda_sparse" and not kept.degraded


# -- graphs.partition ---------------------------------------------------------

# (n, nnz, alpha, seed)
PARTITION_CASES = [(96, 700, 2.1, 0), (200, 2500, 2.6, 3), (64, 40, 2.1, 7),
                   (150, 1200, 1.8, 11)]


@pytest.mark.parametrize("iters", [1, 5, 20])
@pytest.mark.parametrize("case", PARTITION_CASES)
def test_label_propagation_matches_reference(case, iters):
    from repro.graphs.partition import label_propagation_permutation as j_lp
    from repro_torch.graphs.partition import label_propagation_permutation as t_lp

    n, nnz, alpha, seed = case
    t = tsf.random_power_law_csr(n, n, nnz, alpha=alpha, seed=seed)
    j = jsf.random_power_law_csr(n, n, nnz, alpha=alpha, seed=seed)
    got, want = t_lp(t, iters=iters, device="cpu"), j_lp(j, iters=iters)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_label_propagation_of_isolated_nodes_matches_reference():
    """Rows with no nonzeros keep their own label; an empty graph is the
    identity ordered by degree."""
    import scipy.sparse as sp

    from repro.graphs.partition import label_propagation_permutation as j_lp
    from repro_torch.graphs.partition import label_propagation_permutation as t_lp

    d = np.zeros((12, 12), np.float32)
    d[0, [1, 2]] = d[1, [0, 2]] = d[2, [0, 1]] = d[5, 7] = d[7, 5] = 1.0
    for m in (sp.csr_matrix(d), sp.csr_matrix((9, 9), dtype=np.float32)):
        np.testing.assert_array_equal(
            t_lp(tsf.CSRMatrix.from_scipy(m), device="cpu"),
            j_lp(jsf.CSRMatrix.from_scipy(m)))


@pytest.mark.parametrize("tile", [4, 16, 64])
@pytest.mark.parametrize("case", PARTITION_CASES)
def test_cluster_greedy_bfs_matches_reference(case, tile):
    from repro.graphs.partition import cluster_greedy_bfs as j_bfs
    from repro_torch.graphs.partition import cluster_greedy_bfs as t_bfs

    n, nnz, alpha, seed = case
    t = tsf.random_power_law_csr(n, n, nnz, alpha=alpha, seed=seed)
    j = jsf.random_power_law_csr(n, n, nnz, alpha=alpha, seed=seed)
    got, want = t_bfs(t, tile), j_bfs(j, tile)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["rcm", "degree", "none", "lp", "bfs",
                                    "random"])
def test_edge_cut_quality_matches_reference(method):
    from repro.graphs import partition as jpart
    from repro_torch.graphs import partition as tpart

    t = tsf.random_power_law_csr(160, 160, 1500, alpha=2.3, seed=2)
    j = jsf.random_power_law_csr(160, 160, 1500, alpha=2.3, seed=2)
    perm = {"lp": lambda: jpart.label_propagation_permutation(j),
            "bfs": lambda: jpart.cluster_greedy_bfs(j, 16),
            "random": lambda: np.random.default_rng(0).permutation(160),
            }.get(method, lambda: jpre.edge_cut_permutation(j, method))()
    for tile in (8, 16):
        assert tpart.edge_cut_quality(t, perm, tile) == \
            jpart.edge_cut_quality(j, perm, tile)


def test_graphs_exports_the_reference_names():
    import repro.graphs as jg
    import repro_torch.graphs as tg

    assert tg.__all__ == jg.__all__
    for name in tg.__all__:
        obj = getattr(tg, name)
        if hasattr(obj, "__name__"):
            assert obj.__name__ == getattr(jg, name).__name__


# -- kernels.ops.flexvector_spmm ----------------------------------------------


def _spmm_case(seed=0, f=24):
    j = jpre.preprocess(jsf.random_power_law_csr(90, 90, 700, alpha=2.4,
                                                 seed=seed),
                        tau=6, tile_rows=16, pad_rows_to=16)
    rng = np.random.default_rng(seed + 1)
    return j.ell, rng.standard_normal((j.ell.n_dense_rows, f)).astype(np.float32)


@pytest.mark.parametrize("skip_empty", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_flexvector_spmm_matches_reference_wrapper(precision, skip_empty):
    """The port's wrapper (the kernels' plain versions on the CPU) against
    the reference wrapper (Pallas interpret) on the same ELL: within
    1e-5 of max|reference| (the kernels' bar, ``PERF.md`` §2), and no
    kernel launched on the CPU."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro_torch.kernels import flexvector_spmm as fv
    from repro_torch.kernels import ops as tops

    ell, dense = _spmm_case()
    kw = dict(block_rows=16, block_k=16, block_f=8, skip_empty=skip_empty,
              precision=precision)
    want = np.asarray(jops.flexvector_spmm(ell, jnp.asarray(dense),
                                           interpret=True, **kw), np.float64)
    fv.reset_launches()
    got = tops.flexvector_spmm(ell, dense, device="cpu", **kw)
    assert not any(fv.PRECISION_LAUNCHES.values())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy().astype(np.float64) - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    # a torch operand on the device, and an output dtype the kernels
    # store (each f32 sum rounded to bf16 once); one they do not store
    # raises, naming it
    out = tops.flexvector_spmm(ell, torch.as_tensor(dense), device="cpu",
                               out_dtype=torch.bfloat16, **kw)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, got.to(torch.bfloat16))
    with pytest.raises(ValueError, match="float64"):
        tops.flexvector_spmm(ell, torch.as_tensor(dense), device="cpu",
                             out_dtype=torch.float64, **kw)


def test_flexvector_spmm_refuses_the_cpu_without_being_asked(monkeypatch):
    from repro_torch.kernels import ops as tops

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ell, dense = _spmm_case()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.flexvector_spmm(ell, dense)


# -- examples/torch_*.py ------------------------------------------------------


def _example(name, *args, device="cpu"):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="",
               JAX_PLATFORMS="cpu")
    argv = [sys.executable, os.path.join(ROOT, "examples", name), *args]
    if device:
        argv += ["--device", device]
    return subprocess.run(argv, capture_output=True, text=True, env=env,
                          timeout=600, cwd=ROOT)


def test_torch_quickstart_runs_on_the_cpu_like_the_reference():
    """Cora with ``--device cpu``: its SpMM within the f32 bar of the scipy
    oracle, and its simulator lines the reference example's, character
    for character."""
    got = _example("torch_quickstart.py", "--impl", "cuda_sparse")
    assert got.returncode == 0, got.stderr
    want = _example("quickstart.py", device=None)
    assert want.returncode == 0, want.stderr
    lines, ref = got.stdout.splitlines(), want.stdout.splitlines()
    assert lines[0] == ref[0]                     # the dataset line
    assert lines[-3:] == ref[-3:]                 # FlexVector, GROW, speedup
    err = float(next(ln for ln in lines if "vs scipy" in ln).split()[-1])
    assert err <= 1e-5


def test_torch_serve_gcn_runs_on_the_cpu():
    got = _example("torch_serve_gcn.py", "--requests", "16", "--batch", "4")
    assert got.returncode == 0, got.stderr
    out = got.stdout
    for field in ("batch 0: 4 requests, receptive fields",
                  "16 requests in", "latency per request: p50=",
                  "FlexVector ASIC estimate:"):
        assert field in out, out
    # the estimate is the reference simulator's at the RCM permutation
    want = _example("serve_gcn.py", "--requests", "8", "--batch", "8",
                    device=None)
    assert want.returncode == 0, want.stderr
    assert out.splitlines()[-1] == want.stdout.splitlines()[-1]


def test_torch_train_gcn_runs_on_the_cpu_and_restarts(tmp_path):
    got = _example("torch_train_gcn.py", "--steps", "60", "--inject-failure",
                   "--fresh", "--ckpt-dir", str(tmp_path / "ckpt"))
    assert got.returncode == 0, got.stderr
    assert "done: steps=60 restarts=1" in got.stdout, got.stdout
    assert "final loss=" in got.stdout


@pytest.mark.parametrize("name, args", [
    ("torch_quickstart.py", ()),
    ("torch_serve_gcn.py", ("--requests", "4")),
    ("torch_train_gcn.py", ("--steps", "2")),
])
def test_torch_examples_refuse_the_cpu_without_being_asked(name, args):
    got = _example(name, *args, device=None)
    assert got.returncode != 0
    assert "CUDA is not available" in got.stderr
