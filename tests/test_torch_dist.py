"""The port's mesh, shard split and sharded planning against ``repro``'s.

In-process, on the CPU:

* ``dist.topology.abstract_mesh`` / ``launch.mesh.axis_size`` /
  ``dp_axes`` read the reference's axis sizes; ``make_data_mesh`` over a
  1-rank gloo group (``FileStore`` rendezvous) routes a forward through
  the single-device path;
* ``exec.operands.shard_operands`` gives the reference's host arrays
  exactly (``cols``, ``vals``, ``row_map``, ``rows_per_shard``, the shard
  ELLs) at ``split="nnz"`` and ``"uniform"``, with and without the
  reserved block, and each shard's int8 ``q``/``scales`` are the
  reference's shard-major quantization bit for bit, from f32, bf16 and
  int8 storage;
* under the reference's device models, ``plan_pipeline(mesh=)`` and
  ``choose_plan(mesh=)`` on 2- and 4-wide abstract meshes pick the
  reference's width, per-layer plans and layouts at its seconds (rel
  1e-12), and ``static_pipeline(mesh=)`` lays the reference's chain;
* the H100 model prices a shard's work and the collectives at NVLink's
  published rate;
* the spawn launcher fails a test whose rank fails or hangs, within its
  time limit.

The sharded forwards themselves are in ``tests/test_torch_sharded.py``.
"""

import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from repro.core import preprocess as j_preprocess
from repro.core import random_power_law_csr as j_power_law
from repro.dist.topology import abstract_mesh as j_abstract_mesh
from repro.exec import SpmmOperands as JOperands
from repro.exec import pipeline as jpipe
from repro.exec import quant as jq
from repro.exec.operands import shard_operands as j_shard_operands
from repro.launch import mesh as jmesh
from repro.models.gcn import GCNConfig as JConfig
from repro.plan import autoplan as jauto
from repro.plan import cost as jcost

from _torch_dist import run_ranks
from repro_torch.core.preprocessing import preprocess as t_preprocess
from repro_torch.core.sparse_formats import random_power_law_csr as t_power_law
from repro_torch.dist.topology import abstract_mesh, axis_sizes
from repro_torch.exec import SpmmOperands
from repro_torch.exec import pipeline as tpipe
from repro_torch.exec import quant as tq
from repro_torch.exec.operands import shard_operands
from repro_torch.exec.plan import IMPL_NAMES, SpmmPlan
from repro_torch.launch import mesh as tmesh
from repro_torch.models.gcn import GCNConfig as TConfig
from repro_torch.plan import autoplan as tauto
from repro_torch.plan import cost as tcost

TO_REF = {v: k for k, v in IMPL_NAMES.items()}
PRECISIONS = ("f32", "bf16", "int8")
DEVICES = {"tpu_v5e": (jcost.TPU_V5E, tcost.TPU_V5E),
           "flexvector": (jcost.flexvector_device(),
                          tcost.flexvector_device())}
REL = 1e-12


def _close(a, b) -> bool:
    return a == b or math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def _ells(n=96, nnz=700, alpha=2.1, tau=5, block=16):
    j = j_preprocess(j_power_law(n, n, nnz, alpha=alpha, seed=0), tau=tau,
                     tile_rows=16, edge_cut="rcm", pad_rows_to=block)
    t = t_preprocess(t_power_law(n, n, nnz, alpha=alpha, seed=0), tau=tau,
                     tile_rows=16, edge_cut="rcm", pad_rows_to=block)
    return j.ell, t.ell


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes,names", [
    ((2,), ("data",)), ((2, 2), ("data", "feature")),
    ((2, 4, 2), ("pod", "data", "model"))])
def test_abstract_mesh_axis_sizes_match_reference(sizes, names):
    j, t = j_abstract_mesh(sizes, names), abstract_mesh(sizes, names)
    assert axis_sizes(t) == dict(j.shape)
    assert tmesh.dp_axes(t) == jmesh.dp_axes(j)
    for name in names:
        assert tmesh.axis_size(t, name) == jmesh.axis_size(j, name)
    assert tmesh.axis_size(t, names) == jmesh.axis_size(j, names)
    plan = SpmmPlan(mesh=t, feature_axis="feature" if "feature" in names
                    else None)
    assert plan.n_shards == sizes[names.index("data")]
    assert plan.n_feature_shards == (2 if "feature" in names else 1)


def test_plan_validates_layouts_and_split():
    with pytest.raises(ValueError, match="out_layout"):
        SpmmPlan(out_layout="columns")
    with pytest.raises(ValueError, match="dense_layout"):
        SpmmPlan(dense_layout="columns")
    with pytest.raises(ValueError, match="shard_split"):
        SpmmPlan(shard_split="random")
    assert not SpmmPlan(mesh={"data": 1}).sharded
    assert SpmmPlan(mesh={"data": 4}).sharded


def test_make_data_mesh_needs_a_process_group(tmp_path):
    """Without a process group there is no mesh; over a 1-rank gloo group
    (``FileStore`` rendezvous) the mesh is 1 wide, a forward on it runs the
    single-device path, and a mesh wider than the group is refused."""
    import torch.distributed as dist

    from repro_torch.graphs.datasets import (DatasetSpec, gcn_normalize,
                                             synthesize_adjacency)
    from repro_torch.models import gcn

    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_data_mesh(2, device="cpu")
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="ranks"):
            tmesh.make_data_mesh(2, device="cpu")
        mesh = tmesh.make_data_mesh(1, device="cpu")
        assert axis_sizes(mesh) == {"data": 1}
        assert tmesh.mesh_device(mesh) == torch.device("cpu")
        spec = DatasetSpec("toy", nodes=80, edges=320, feature_dim=12,
                           classes=4)
        cfg = gcn.GCNConfig(in_dim=12, hidden_dim=8, out_dim=4,
                            spmm_impl="cuda", block_rows=16, block_k=16,
                            block_f=16)
        graph = gcn.GCNGraph.build(
            gcn_normalize(synthesize_adjacency(spec, seed=5)), cfg)
        params = gcn.init_params(cfg, device="cpu")
        feats = np.random.default_rng(5).standard_normal(
            (80, 12)).astype(np.float32)
        placed = gcn.gcn_forward(params, graph, feats, cfg, mesh=mesh)
        base = gcn.gcn_forward(params, graph, feats, cfg, device="cpu")
        assert torch.equal(placed, base)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the shard split: the reference's host arrays exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reserve", [False, True])
@pytest.mark.parametrize("split", ["nnz", "uniform"])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_shard_operands_match_reference(n_shards, split, reserve):
    jell, tell = _ells()
    want = j_shard_operands(JOperands.from_ell(jell), n_shards, 16,
                            reserve_empty_block=reserve, split=split)
    got = shard_operands(SpmmOperands.from_ell(tell, "cpu"), n_shards, 16,
                         reserve_empty_block=reserve, split=split)
    for name in ("cols", "vals", "row_map"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (got.rows_per_shard, got.n_shards, got.n_out_rows) == \
        (want.rows_per_shard, want.n_shards, want.n_out_rows)
    assert len(got.shard_ells) == len(want.shard_ells) == n_shards
    for t, j in zip(got.shard_ells, want.shard_ells):
        for name in ("cols", "vals", "row_map"):
            assert np.array_equal(getattr(t, name), getattr(j, name))
        assert (t.n_dense_rows, t.n_orig_rows) == (j.n_dense_rows,
                                                    j.n_orig_rows)


@pytest.mark.parametrize("stored", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_int8_values_match_reference(n_shards, stored):
    """Each shard's int8 ``q``/``scales`` (``SpmmOperands.shard`` then
    ``values_for("int8")``) are the reference's quantization of its
    shard-major layout, bit for bit; stored bf16/int8 values are taken to
    f32 first, as the reference does."""
    jell, tell = _ells()
    br = 16
    vals = np.asarray(jell.vals)
    scales = None
    if stored == "bf16":
        vals = np.asarray(torch.as_tensor(vals).to(torch.bfloat16).float())
    elif stored == "int8":
        q, scales = jq.quantize_values(vals, 32)
        vals = np.asarray(jq.dequantize_values(q, scales, 32))
    j_ops = JOperands(cols=jell.cols, vals=vals, row_map=jell.row_map,
                      n_out_rows=jell.n_orig_rows, ell=jell)
    sh = j_shard_operands(j_ops, n_shards, br, split="nnz")
    want_q, want_s = (np.asarray(a) for a in jq.quantize_values(sh.vals, br))

    base = SpmmOperands.from_ell(tell, "cpu")
    if stored == "bf16":
        base = dataclasses.replace(base, vals=base.vals.to(torch.bfloat16),
                                   precision="bf16", _memo={})
    elif stored == "int8":
        q, s = tq.quantize_values(base.vals, 32)
        base = dataclasses.replace(base, vals=q, scales=s,
                                   scale_block_rows=32, precision="int8",
                                   _memo={})
    qs, ss = [], []
    for d in range(n_shards):
        q, s = base.shard(n_shards, d, br).values_for("int8", br)
        qs.append(q.numpy())
        ss.append(s.numpy())
    assert np.array_equal(np.concatenate(qs), want_q)
    assert np.array_equal(np.concatenate(ss), want_s)


# ---------------------------------------------------------------------------
# sharded planning: the reference's choices under its device models
# ---------------------------------------------------------------------------

#: name -> (reference stats, port stats, config dims)
def _plan_graphs():
    jell, tell = _ells(320, 5000, 2.8, 6)
    big = dict(rows=2_000_000, n_out_rows=600_000, n_dense_rows=600_000,
               nnz=9_000_000, tau=6)
    return {
        "skewed": (jcost.graph_stats_from_ell(jell),
                   tcost.graph_stats_from_ell(tell)),
        "large": (jcost.synthetic_stats(**big), tcost.synthetic_stats(**big)),
    }


def _cfgs(impl, blocks=16):
    dims = dict(in_dim=64, hidden_dim=32, out_dim=8, n_layers=3,
                block_rows=blocks, block_k=blocks, block_f=blocks)
    return (JConfig(spmm_impl=TO_REF[impl], **dims),
            TConfig(spmm_impl=impl, **dims))


def _same_layers(got, want):
    assert len(got.layers) == len(want.layers)
    for t, j in zip(got.layers, want.layers):
        assert TO_REF[t.spmm.impl] == j.spmm.impl
        for field in ("block_rows", "block_k", "block_f", "precision",
                      "fused", "hot_k_first", "dense_layout", "out_layout",
                      "n_shards"):
            assert getattr(t.spmm, field) == getattr(j.spmm, field), field
        assert (t.f_in, t.f_out, t.in_layout, t.out_layout) == \
            (j.f_in, j.f_out, j.in_layout, j.out_layout)
        assert _close(t.seconds, j.seconds)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("out_layout", ["replicated", "row_sharded"])
@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("graph", ["skewed", "large"])
def test_sharded_plan_pipeline_matches_reference(graph, width, out_layout,
                                                 device):
    jdev, tdev = DEVICES[device]
    js, ts = _plan_graphs()[graph]
    jm, tm = (j_abstract_mesh((width,), ("data",)),
              abstract_mesh((width,), ("data",)))
    for impl in ("cuda", "cuda_sparse"):
        jcfg, tcfg = _cfgs(impl)
        for precision in PRECISIONS:
            want = jpipe.plan_pipeline(jcfg, js, mesh=jm,
                                       out_layout=out_layout,
                                       precision=precision, device=jdev)
            got = tpipe.plan_pipeline(tcfg, ts, mesh=tm,
                                      out_layout=out_layout,
                                      precision=precision, device=tdev)
            assert got.n_shards == want.n_shards
            assert (got.mesh is tm) == (want.mesh is jm)
            _same_layers(got, want)
            assert got.n_collective_rounds == want.n_collective_rounds
            assert _close(got.cost_seconds, want.cost_seconds)
            assert _close(got.static_cost_seconds, want.static_cost_seconds)


def test_sharded_plans_do_shard_the_large_graph():
    """The parity above is not all width 1: the large graph shards under
    ``TPU_V5E`` and chains reduce-scatters between its layers."""
    js, ts = _plan_graphs()["large"]
    _, tcfg = _cfgs("cuda")
    pp = tpipe.plan_pipeline(tcfg, ts, mesh={"data": 4},
                             device=tcost.TPU_V5E)
    assert pp.n_shards == 4
    assert pp.n_collective_rounds == 1
    assert [lp.out_layout for lp in pp.layers][:-1] == ["row_sharded"] * 2


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("width", [2, 4])
def test_sharded_choose_plan_matches_reference(width, device):
    jdev, tdev = DEVICES[device]
    jm, tm = (j_abstract_mesh((width,), ("data",)),
              abstract_mesh((width,), ("data",)))
    for graph, (js, ts) in _plan_graphs().items():
        for impl in ("reference", "cuda", "cuda_sparse"):
            jcfg, tcfg = _cfgs(impl)
            for f_in in (None, 64):
                want = jauto.choose_plan(js, 32, jcfg, mesh=jm, f_in=f_in,
                                         precisions=PRECISIONS, device=jdev)
                got = tauto.choose_plan(ts, 32, tcfg, mesh=tm, f_in=f_in,
                                        precisions=PRECISIONS, device=tdev)
                assert TO_REF[got.plan.impl] == want.plan.impl
                for field in ("block_rows", "block_k", "block_f",
                              "precision", "fused", "n_shards"):
                    assert getattr(got.plan, field) == \
                        getattr(want.plan, field), (graph, field)
                assert got.n_candidates == want.n_candidates
                assert _close(got.cost.seconds, want.cost.seconds)
                assert _close(got.static_cost.seconds,
                              want.static_cost.seconds)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("pipelined", [False, True])
def test_sharded_static_pipeline_matches_reference(pipelined, fused):
    jcfg, tcfg = _cfgs("cuda")
    jm, tm = j_abstract_mesh((2,), ("data",)), abstract_mesh((2,), ("data",))
    want = jpipe.static_pipeline(jcfg, jm, pipelined=pipelined, fused=fused)
    got = tpipe.static_pipeline(tcfg, tm, pipelined=pipelined, fused=fused)
    assert got.n_shards == want.n_shards == 2
    assert got.n_collective_rounds == want.n_collective_rounds
    for t, j in zip(got.layers, want.layers):
        assert (t.in_layout, t.out_layout, t.f_in, t.f_out) == \
            (j.in_layout, j.out_layout, j.f_in, j.f_out)
        assert (t.spmm.dense_layout, t.spmm.out_layout, t.spmm.fused) == \
            (j.spmm.dense_layout, j.spmm.out_layout, j.spmm.fused)
        assert t.spmm.mesh is tm


# ---------------------------------------------------------------------------
# the H100 model on a data mesh
# ---------------------------------------------------------------------------


def test_h100_prices_collectives_at_nvlink_rate():
    """A shard's work is the whole graph's times imbalance / n; the
    epilogue's per-device ring bytes (the reference's formulas) go over
    NVLink 4's published 450 GB/s after the kernels, one launch each."""
    _, ts = _plan_graphs()["large"]
    h = tcost.H100
    assert h.ici_bw == 450e9
    f = 64
    one = tcost.spmm_cost(ts, f, impl="cuda")
    for n, out_l, dense_l in ((2, "replicated", "replicated"),
                              (4, "row_sharded", "row_sharded")):
        c = tcost.spmm_cost(ts, f, impl="cuda", n_shards=n, out_layout=out_l,
                            dense_layout=dense_l, shard_imbalance=1.25)
        coll = (tcost.reduce_scatter_bytes(ts.n_out_rows, f, n)
                if out_l == "row_sharded"
                else tcost.psum_bytes(ts.n_out_rows, f, n))
        if dense_l == "row_sharded":
            coll += tcost.all_gather_bytes(ts.n_dense_rows, f, n, 4)
        assert c.collective_bytes == coll
        assert c.collective_s == coll / 450e9
        assert math.isclose(c.memory_s,
                            one.memory_s * 1.25 / n + c.collective_s,
                            rel_tol=1e-3)
        launches = one.host_s / h.cuda.launch_s
        assert math.isclose(c.host_s / h.cuda.launch_s,
                            launches + 1 + (dense_l == "row_sharded"),
                            rel_tol=1e-9)
    fused = tcost.fused_layer_cost(ts, 64, f, n_shards=2,
                                   dense_layout="row_sharded")
    assert fused.collective_bytes == (
        tcost.psum_bytes(ts.n_out_rows, f, 2)
        + tcost.all_gather_bytes(ts.n_dense_rows, 64, 2, 4))
    assert tcost.combination_seconds(1000, 64, 32, n_shards=2) == \
        tcost.combination_seconds(500, 64, 32)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_h100_sharded_pipeline_never_worse_than_static(precision):
    for graph, (_, ts) in _plan_graphs().items():
        _, tcfg = _cfgs("cuda")
        mesh = {"data": 2}
        pp = tpipe.plan_pipeline(tcfg, ts, mesh=mesh, precision=precision)
        assert pp.cost_seconds <= pp.static_cost_seconds
        assert pp == tpipe.plan_pipeline(tcfg, ts, mesh=mesh,
                                         precision=precision)
        assert math.isclose(tpipe.pipeline_seconds(ts, pp),
                            pp.cost_seconds, rel_tol=1e-12)


# ---------------------------------------------------------------------------
# the spawn launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hang", [False, True], ids=["fails", "hangs"])
def test_a_failing_rank_fails_within_the_limit(hang):
    limit = 30.0
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as err:
        run_ranks("_torch_dist", "failing_rank", 2, args=(hang,),
                  timeout=limit)
    assert time.monotonic() - t0 < limit + 20
    assert ("outlived" if hang else "fails on purpose") in str(err.value)
