"""The port's cost model and plan chooser against ``repro.plan``.

The same CSR is preprocessed by both packages (their ``TiledELL``s are
equal, ``tests/test_torch_core.py``), and every cost term and plan choice
is held against the reference's on the same inputs.

* Under the reference's device models (``TPU_V5E``, ``flexvector_device``)
  the port carries the reference's arithmetic over unchanged: every
  term (``spmm_cost``, ``fused_layer_cost``, ``combination_seconds``,
  ``bucket_forward_seconds``, the collective byte terms,
  ``balanced_split_points``, ``split_imbalance``, ``rank_specs``) equals
  the reference's to rel 1e-12, and ``choose_plan``'s choice and candidate
  count, ``choose_hot_k_first`` and ``choose_ladder_growth`` are the
  same, with impl names mapped by ``exec.plan.IMPL_NAMES``.
* The reference's invariants hold too (``tests/test_plan.py``):
  deterministic, never costed worse than static, monotone in nnz and in
  the feature dim — under the H100 model as well.
* Under the H100 model (the port's kernels): ``cuda_sparse`` is never
  priced below ``cuda``, knobs the kernels ignore leave the price alone,
  the plain version is never chosen over a kernel, and the fused kernel's
  viability does not depend on the graph's size.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from repro.core import preprocess as j_preprocess
from repro.core import random_power_law_csr as j_power_law
from repro.dist.topology import abstract_mesh
from repro.exec import plan_for_config as j_plan_for_config
from repro.models.gcn import GCNConfig as JConfig
from repro.plan import autoplan as jauto
from repro.plan import cost as jcost

from _torch_ops import WRAPPER_LAUNCHES
from repro_torch.core.preprocessing import preprocess as t_preprocess
from repro_torch.core.sparse_formats import random_power_law_csr as t_power_law
from repro_torch.exec.plan import IMPL_NAMES, SpmmPlan, plan_for_config
from repro_torch.kernels import flexvector_spmm as fv
from repro_torch.models.gcn import GCNConfig as TConfig
from repro_torch.plan import autoplan as tauto
from repro_torch.plan import cost as tcost

PRECISIONS = ("f32", "bf16", "int8")
PORT_IMPLS = ("reference", "cuda", "cuda_sparse")
TO_REF = {v: k for k, v in IMPL_NAMES.items()}
#: (reference model, the port's copy of it)
DEVICES = {"tpu_v5e": (jcost.TPU_V5E, tcost.TPU_V5E),
           "flexvector": (jcost.flexvector_device(), tcost.flexvector_device())}
REL = 1e-12

#: name -> (n, nnz, alpha, tau)
GRAPHS = {"small": (96, 700, 2.1, 5), "skewed": (320, 5000, 2.8, 6)}


@functools.lru_cache(maxsize=None)
def _ells(name):
    """``(reference TiledELL, port TiledELL)`` of one graph."""
    n, nnz, alpha, tau = GRAPHS[name]
    j = j_preprocess(j_power_law(n, n, nnz, alpha=alpha, seed=0), tau=tau,
                     tile_rows=16, edge_cut="rcm")
    t = t_preprocess(t_power_law(n, n, nnz, alpha=alpha, seed=0), tau=tau,
                     tile_rows=16, edge_cut="rcm")
    return j.ell, t.ell


def _stats(name):
    j, t = _ells(name)
    return jcost.graph_stats_from_ell(j), tcost.graph_stats_from_ell(t)


def _close(a, b) -> bool:
    return a == b or math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def assert_same_cost(got, want):
    """Every field of the reference's CostBreakdown, to rel 1e-12."""
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, str):
            assert g == w, field.name
        else:
            assert _close(g, w), (field.name, g, w)
    assert got.host_s == 0.0
    assert _close(got.seconds, want.seconds)


def _cfgs(impl="cuda", blocks=16, **kw):
    dims = dict(in_dim=12, hidden_dim=32, out_dim=5, block_rows=blocks,
                block_k=blocks, block_f=blocks, **kw)
    return (JConfig(spmm_impl=TO_REF[impl], **dims),
            TConfig(spmm_impl=impl, **dims))


def _same_plan(t_plan, j_plan):
    assert TO_REF[t_plan.impl] == j_plan.impl
    for field in ("block_rows", "block_k", "block_f", "precision", "fused",
                  "hot_k_first"):
        assert getattr(t_plan, field) == getattr(j_plan, field), field


# ---------------------------------------------------------------------------
# cost terms: exact under the reference's device models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_spmm_cost_matches_reference(impl, precision, device):
    jdev, tdev = DEVICES[device]
    for graph in GRAPHS:
        js, ts = _stats(graph)
        for f in (8, 41, 128):
            for blocks in ((16, 16, 16), (32, 128, 64), (128, 128, 128)):
                for shards, out_l, dense_l, imb in (
                        (1, "replicated", "replicated", 1.0),
                        (2, "row_sharded", "replicated", 1.3),
                        (4, "replicated", "row_sharded", 1.0)):
                    kw = dict(block_rows=blocks[0], block_k=blocks[1],
                              block_f=blocks[2], n_shards=shards,
                              out_layout=out_l, dense_layout=dense_l,
                              shard_imbalance=imb, precision=precision)
                    assert_same_cost(
                        tcost.spmm_cost(ts, f, impl=impl, device=tdev, **kw),
                        jcost.spmm_cost(js, f, impl=TO_REF[impl],
                                        device=jdev, **kw))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("impl", ("cuda", "cuda_sparse"))
def test_fused_layer_cost_matches_reference(impl, precision, device):
    jdev, tdev = DEVICES[device]
    for graph in GRAPHS:
        js, ts = _stats(graph)
        for f_in, f_out in ((12, 64), (64, 5), (500, 3)):
            for blocks in ((16, 16, 16), (64, 32, 128)):
                for shards, dense_l in ((1, "replicated"), (2, "row_sharded")):
                    kw = dict(block_rows=blocks[0], block_k=blocks[1],
                              block_f=blocks[2], n_shards=shards,
                              dense_layout=dense_l, precision=precision)
                    want = jcost.fused_layer_cost(
                        js, f_in, f_out, impl=TO_REF[impl], device=jdev, **kw)
                    assert_same_cost(
                        tcost.fused_layer_cost(ts, f_in, f_out, impl=impl,
                                               device=tdev, **kw), want)
                    assert _close(
                        tcost.fused_layer_seconds(ts, f_in, f_out, impl=impl,
                                                  device=tdev, **kw),
                        want.seconds)
                    vmem = dict(block_rows=blocks[0], block_k=blocks[1],
                                block_f=blocks[2], precision=precision,
                                n_shards=shards)
                    assert tcost.fused_viable(ts, f_in, device=tdev, **vmem) \
                        == jcost.fused_viable(js, f_in, device=jdev, **vmem)
                    assert tcost.fused_vmem_bytes(
                        ts.padded_rows, ts.tau, f_in, **vmem) == \
                        jcost.fused_vmem_bytes(js.padded_rows, js.tau, f_in,
                                               **vmem)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_combination_seconds_matches_reference(precision, device):
    jdev, tdev = DEVICES[device]
    for k, f_in, f_out in ((96, 12, 64), (19_717, 500, 64), (232_965, 64, 41)):
        for shards in (1, 2, 4):
            assert _close(
                tcost.combination_seconds(k, f_in, f_out, n_shards=shards,
                                          precision=precision, device=tdev),
                jcost.combination_seconds(k, f_in, f_out, n_shards=shards,
                                          precision=precision, device=jdev))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_bucket_forward_seconds_matches_reference(impl, precision, device):
    jdev, tdev = DEVICES[device]
    for rows, nodes, mean in ((256, 128, 2.5), (4_864, 256, 5.7),
                              (39_680, 19_840, 4.25)):
        kw = dict(f_dims=(64, 41), block_rows=128, block_k=64, block_f=128,
                  precision=precision)
        assert _close(
            tcost.bucket_forward_seconds(rows, nodes, mean, 6, impl=impl,
                                         device=tdev, **kw),
            jcost.bucket_forward_seconds(rows, nodes, mean, 6,
                                         impl=TO_REF[impl], device=jdev, **kw))


def test_collective_byte_terms_match_reference():
    for rows, f, n, b in ((100, 64, 1, 4), (101, 41, 2, 4), (96, 8, 4, 2),
                          (232_965, 64, 8, 4)):
        assert tcost.psum_bytes(rows, f, n, b) == jcost.psum_bytes(rows, f, n, b)
        assert tcost.reduce_scatter_bytes(rows, f, n, b) == \
            jcost.reduce_scatter_bytes(rows, f, n, b)
        assert tcost.all_gather_bytes(rows, f, n, b) == \
            jcost.all_gather_bytes(rows, f, n, b)
        for layout in ("replicated", "row_sharded"):
            assert tcost.activation_writeback_bytes(rows, f, n, layout, b) == \
                jcost.activation_writeback_bytes(rows, f, n, layout, b)


@pytest.mark.parametrize("device", DEVICES)
def test_roofline_seconds_matches_reference(device):
    jdev, tdev = DEVICES[device]
    for flops, byts, coll in ((1e9, 1e6, 0.0), (1e3, 1e9, 1e2),
                              (0.0, 0.0, 1e9)):
        assert tcost.roofline_seconds(flops, byts, coll, tdev) == \
            jcost.roofline_seconds(flops, byts, coll, jdev)


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4, 7])
def test_balanced_split_points_match_reference(n_parts):
    rng = np.random.default_rng(n_parts)
    _, ts = _stats("skewed")
    cases = [ts.row_nnz, np.zeros(10), rng.pareto(1.5, 200),
             np.r_[np.zeros(5), 1000.0, np.zeros(5)], np.ones(3)]
    for w in cases:
        got = tcost.balanced_split_points(w, n_parts)
        want = jcost.balanced_split_points(w, n_parts)
        np.testing.assert_array_equal(got, want)
        assert tcost.split_imbalance(w, got) == jcost.split_imbalance(w, want)


def test_rank_specs_matches_reference():
    for sizes in ((4,), (2, 2), (8, 1), (1, 4)):
        names = ("data", "model")[:len(sizes)]
        jmesh = abstract_mesh(sizes, names)
        tmesh = dict(zip(names, sizes))
        specs = [(None, None), ("data", None), (None, names[-1]),
                 (("data",) + names[1:], None)]
        for shape in ((64, 32), (7,), ()):
            specs_s = [s[:len(shape)] for s in specs]
            assert tcost.rank_specs(tmesh, shape, specs_s) == \
                jcost.rank_specs(jmesh, shape, specs_s)
            for spec in specs_s:
                assert tcost.spec_shard_factor(tmesh, spec) == \
                    jcost.spec_shard_factor(jmesh, spec)
                assert tcost.grad_sync_bytes(tmesh, shape, spec, 2) == \
                    jcost.grad_sync_bytes(jmesh, shape, spec, 2)
    with pytest.raises(ValueError, match="at least one"):
        tcost.rank_specs({"data": 2}, (4,), [])


def test_occupancy_counters_match_reference():
    for graph in GRAPHS:
        js, ts = _stats(graph)
        for br, bk in ((16, 16), (32, 128), (128, 64)):
            assert ts.occupied_pairs(br, bk) == js.occupied_pairs(br, bk)
            assert (br, bk) in ts._occ_cache
        for bk in (16, 64, 128):
            assert ts.occupied_k_tiles(bk) == js.occupied_k_tiles(bk)
    syn = dict(rows=512, n_out_rows=128, n_dense_rows=128, nnz=900, tau=6)
    t, j = tcost.synthetic_stats(**syn), jcost.synthetic_stats(**syn)
    assert t.occupied_pairs(16, 16) == j.occupied_pairs(16, 16)
    assert t.occupied_k_tiles(16) == j.occupied_k_tiles(16)


# ---------------------------------------------------------------------------
# plan choices: the same as the reference's under its device models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f_in", [None, 12])
@pytest.mark.parametrize("precisions", [("f32",), PRECISIONS])
@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("device", DEVICES)
def test_choose_plan_matches_reference(device, impl, precisions, f_in):
    jdev, tdev = DEVICES[device]
    jcfg, tcfg = _cfgs(impl)
    for graph in GRAPHS:
        jell, tell = _ells(graph)
        for feature_dim in (8, 32):
            for extra in ({}, {"accuracy_budget": 0.03,
                               "precision_errors": {"bf16": 0.01,
                                                    "int8": 0.04}}):
                kw = dict(precisions=precisions, f_in=f_in, **extra)
                want = jauto.choose_plan(jell, feature_dim, jcfg,
                                         device=jdev, **kw)
                got = tauto.choose_plan(tell, feature_dim, tcfg,
                                        device=tdev, **kw)
                _same_plan(got.plan, want.plan)
                _same_plan(got.static_plan, want.static_plan)
                assert got.n_candidates == want.n_candidates
                assert _close(got.cost.seconds, want.cost.seconds)
                assert _close(got.static_cost.seconds,
                              want.static_cost.seconds)


@pytest.mark.parametrize("device", DEVICES)
def test_choose_plan_unschedulable_cuda_sparse_matches_reference(device):
    """A ``cuda_sparse`` config over stats with no host operand (a serving
    rung): the block-skipping grid is excluded on both sides, and the
    static plan is still what the config asked for."""
    jdev, tdev = DEVICES[device]
    jcfg, tcfg = _cfgs("cuda_sparse")
    syn = dict(rows=1024, n_out_rows=256, n_dense_rows=256, nnz=4000, tau=6)
    for stats in ((jcost.synthetic_stats(**syn), tcost.synthetic_stats(**syn)),
                  _stats("small")):
        for schedulable in (None, False):
            want = jauto.choose_plan(stats[0], 32, jcfg, device=jdev,
                                     schedulable=schedulable)
            got = tauto.choose_plan(stats[1], 32, tcfg, device=tdev,
                                    schedulable=schedulable)
            _same_plan(got.plan, want.plan)
            assert got.n_candidates == want.n_candidates
            if schedulable is False or stats[1].ell is None:
                assert got.plan.impl != "cuda_sparse"
                assert got.static_plan.impl == "cuda_sparse"


def test_choose_hot_k_first_matches_reference():
    for graph in GRAPHS:
        jell, tell = _ells(graph)
        for f, blocks in ((32, 16), (8, 32), (64, 128)):
            kw = dict(block_rows=blocks, block_k=blocks, block_f=blocks)
            assert tauto.choose_hot_k_first(tell, f, **kw) == \
                jauto.choose_hot_k_first(jell, f, **kw)
    jcfg, tcfg = _cfgs("cuda_sparse")
    jell, tell = _ells("skewed")
    want = jauto.choose_plan(jell, 32, jcfg, impls=("pallas_sparse",))
    got = tauto.choose_plan(tell, 32, tcfg, impls=("cuda_sparse",),
                            device=tcost.TPU_V5E)
    _same_plan(got.plan, want.plan)


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("device", DEVICES)
def test_choose_ladder_growth_matches_reference(device, impl):
    jdev, tdev = DEVICES[device]
    jcfg, tcfg = _cfgs(impl, blocks=128)
    for graph in GRAPHS:
        js, ts = _stats(graph)
        for base, top in ((128, 128), (128, 384), (256, 19_840)):
            kw = dict(base_nodes=base, top_nodes=top)
            assert tauto.choose_ladder_growth(ts, tcfg, device=tdev, **kw) == \
                jauto.choose_ladder_growth(js, jcfg, device=jdev, **kw)


def test_plan_for_config_routes_through_autoplan_as_reference():
    """``plan_for_config(cfg, ell=...)`` is the cost model's pick (under
    the reference's model here, the reference's pick)."""
    for impl in PORT_IMPLS:
        jcfg, tcfg = _cfgs(impl)
        jell, tell = _ells("skewed")
        want = j_plan_for_config(jcfg, ell=jell, feature_dim=24)
        static = plan_for_config(tcfg)
        assert (static.impl, static.block_rows, static.fused) == (impl, 16, False)
        got = tauto.autoplan(tell, 24, tcfg, device=tcost.TPU_V5E)
        _same_plan(got, want)
        # with the default model the route is the same function's
        assert plan_for_config(tcfg, ell=tell, feature_dim=24) == \
            tauto.autoplan(tell, 24, tcfg)


# ---------------------------------------------------------------------------
# the reference's invariants, mirrored (tests/test_plan.py)
# ---------------------------------------------------------------------------

MODELS = {"tpu_v5e": tcost.TPU_V5E, "h100": tcost.H100}


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_cost_monotone_in_nnz(impl, model):
    """More nonzeros => at least as much traffic, compute and time."""
    sparse = t_preprocess(t_power_law(128, 128, 400, seed=0), tau=5)
    dense = t_preprocess(t_power_law(128, 128, 3000, seed=0), tau=5)
    lo, hi = (tcost.spmm_cost(tcost.graph_stats_from_ell(r.ell), 16,
                              impl=impl, block_rows=16, block_k=16,
                              block_f=16, device=MODELS[model])
              for r in (sparse, dense))
    assert hi.dram_bytes >= lo.dram_bytes
    assert hi.flops >= lo.flops
    assert hi.energy_pj >= lo.energy_pj
    assert hi.seconds >= lo.seconds
    if impl != "reference":
        lo, hi = (tcost.fused_layer_cost(tcost.graph_stats_from_ell(r.ell),
                                         12, 16, impl=impl, block_rows=16,
                                         block_k=16, block_f=16,
                                         device=MODELS[model])
                  for r in (sparse, dense))
        assert hi.seconds >= lo.seconds and hi.dram_bytes >= lo.dram_bytes


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_cost_monotone_in_feature_dim(impl, model):
    _, ts = _stats("small")
    costs = [tcost.spmm_cost(ts, f, impl=impl, block_rows=16, block_k=16,
                             block_f=16, device=MODELS[model])
             for f in (8, 32, 128, 512)]
    for key in ("dram_bytes", "seconds"):
        values = [getattr(c, key) for c in costs]
        assert values == sorted(values), key


@pytest.mark.parametrize("model", MODELS)
def test_autoplan_deterministic(model):
    """Same graph + device model => same plan, across fresh builds."""
    keys = []
    for _ in range(2):
        res = t_preprocess(t_power_law(96, 96, 700, seed=0), tau=5)
        for f_in in (None, 12):
            p = tauto.autoplan(res.ell, 24, None, f_in=f_in,
                               device=MODELS[model])
            keys.append((p.impl, p.block_rows, p.block_k, p.block_f, p.fused))
    assert keys[:2] == keys[2:]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_autoplan_never_costed_worse_than_static(impl, model):
    """The static default is always a candidate, so the argmin cannot lose
    to it, for any config impl, with or without fusion."""
    _, tcfg = _cfgs(impl, blocks=128)
    _, tell = _ells("skewed")
    for f_in in (None, 12):
        choice = tauto.choose_plan(tell, 32, tcfg, f_in=f_in,
                                   precisions=PRECISIONS,
                                   device=MODELS[model])
        assert choice.cost.seconds <= choice.static_cost.seconds
        assert choice.n_candidates > 1


def test_candidate_widths_are_divisors():
    assert tauto.candidate_widths(1) == (1,)
    assert tauto.candidate_widths(8) == (1, 2, 4, 8)
    assert tauto.candidate_widths(7) == (1, 7)


@pytest.mark.parametrize("kw,item", [({"n_devices": 4}, "A9"),
                                     ({"widths": (1, 2)}, "A9"),
                                     ({"mesh": {"data": 2}}, "A9"),
                                     ({"feedback": object()}, "A11")])
def test_choose_plan_one_card_only(kw, item):
    """Widths above 1 (item A9) are priced; without a process group or a
    mesh only width 1 can be placed, so the plan stays on one card; on a
    2-wide mesh a width-2 plan is placed on it.  ``feedback=`` (item A11)
    without a ``feedback_key`` leaves the modeled choice as it is."""
    _, tell = _ells("small")
    choice = tauto.choose_plan(tell, 16, _cfgs()[1], **kw)
    if item == "A11":
        assert choice == tauto.choose_plan(tell, 16, _cfgs()[1])
        assert choice.measured_used == 0

    if "mesh" in kw:
        assert choice.plan.n_shards in (1, 2)
        assert (choice.plan.mesh is kw["mesh"]) == (choice.plan.n_shards == 2)
        assert choice.static_plan.mesh is kw["mesh"]
    else:
        assert choice.plan.n_shards == 1 and choice.plan.mesh is None


# ---------------------------------------------------------------------------
# the H100 model: what the port's kernels move
# ---------------------------------------------------------------------------


def test_h100_is_the_default_model():
    _, ts = _stats("small")
    assert tcost.model_or_default(None) is tcost.H100
    assert tcost.H100.cuda is not None
    assert tcost.TPU_V5E.cuda is None
    assert tcost.spmm_cost(ts, 32, impl="cuda") == \
        tcost.spmm_cost(ts, 32, impl="cuda", device=tcost.H100)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_h100_cuda_sparse_never_cheaper_than_cuda(precision):
    syn = tcost.synthetic_stats(rows=4096, n_out_rows=1024,
                                n_dense_rows=1024, nnz=20_000, tau=6)
    for ts in (*(_stats(g)[1] for g in GRAPHS), syn):
        for f in (4, 41, 64, 128):
            for blocks in (16, 32, 64, 128):
                kw = dict(block_rows=blocks, block_k=blocks, block_f=blocks,
                          precision=precision)
                dense = tcost.spmm_cost(ts, f, impl="cuda", **kw)
                sparse = tcost.spmm_cost(ts, f, impl="cuda_sparse", **kw)
                assert sparse.seconds >= dense.seconds
                assert sparse.memory_s > dense.memory_s
                dense = tcost.fused_layer_cost(ts, 12, f, impl="cuda", **kw)
                sparse = tcost.fused_layer_cost(ts, 12, f, impl="cuda_sparse",
                                                **kw)
                assert sparse.seconds >= dense.seconds


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("impl", ("cuda", "cuda_sparse"))
def test_h100_ignored_knobs_leave_the_price_alone(impl, precision):
    """The aggregation kernels take the real width and no f-tile, so
    ``block_f`` never moves an unfused price, and ``block_k`` moves it
    only where the dispatch pads the dense operand's rows to it (one more
    launch); the chooser keeps the static block sizes where the model is
    indifferent."""
    for graph in GRAPHS:
        _, ts = _stats(graph)
        for f in (8, 41, 64):
            prices = {}
            for bk in (16, 32, 64, 128):
                for bf in (16, 32, 64, 128):
                    prices.setdefault(ts.n_dense_rows % bk == 0, set()).add(
                        tcost.spmm_cost(ts, f, impl=impl, block_rows=32,
                                        block_k=bk, block_f=bf,
                                        precision=precision).seconds)
            assert all(len(p) == 1 for p in prices.values())
    _, tcfg = _cfgs(impl, blocks=128)
    _, tell = _ells("skewed")
    plan = tauto.autoplan(tell, 41, tcfg, precisions=(precision,))
    assert (plan.block_k, plan.block_f) == (128, 128)


@pytest.mark.parametrize("f_in", [None, 12])
@pytest.mark.parametrize("impl", ("cuda", "cuda_sparse"))
def test_h100_never_chooses_the_plain_version_over_a_kernel(impl, f_in):
    """Under the H100 model ``reference`` is a candidate only when it is
    the config's own impl, whatever ``impls`` the caller offers."""
    _, tcfg = _cfgs(impl)
    syn = tcost.synthetic_stats(rows=128, n_out_rows=64, n_dense_rows=64,
                                nnz=50, tau=6)
    for ts in (*(_stats(g)[1] for g in GRAPHS), syn):
        for impls in (None, ("reference", "cuda")):
            choice = tauto.choose_plan(ts, 8, tcfg, impls=impls, f_in=f_in,
                                       precisions=PRECISIONS)
            assert choice.plan.impl != "reference"
    _, rcfg = _cfgs("reference")
    _, ts = _stats("small")
    n_with = tauto.choose_plan(ts, 8, rcfg).n_candidates
    n_tpu = tauto.choose_plan(ts, 8, rcfg, device=tcost.TPU_V5E).n_candidates
    assert n_with == n_tpu        # the static plain version stays a candidate


def test_h100_fused_viable_whatever_the_graph_size():
    """The port's fused kernel forms fixed 64-row tiles in shared memory:
    unlike the reference's VMEM-resident slab, its viability does not
    depend on the graph; only the sparse grid's k-tile bitmap grows."""
    huge = tcost.synthetic_stats(rows=4_205_568, n_out_rows=232_965,
                                 n_dense_rows=232_965, nnz=24_122_889, tau=6)
    for precision in PRECISIONS:
        for impl in ("cuda", "cuda_sparse"):
            assert tcost.fused_viable(huge, 602, precision=precision,
                                      impl=impl, block_k=16)
        assert not tcost.fused_viable(huge, 602, precision=precision,
                                      device=tcost.TPU_V5E)
    wide = tcost.synthetic_stats(rows=128, n_out_rows=64,
                                 n_dense_rows=2 ** 26, nnz=100, tau=6)
    assert tcost.fused_viable(wide, 64, impl="cuda", block_k=16)
    assert not tcost.fused_viable(wide, 64, impl="cuda_sparse", block_k=16)


def test_h100_counters_match_the_slot_lists():
    """The fused terms' runs and chunks are the kernel's: the runs of a
    row's slots in one 64-row column group (``column_slots`` orders a
    group's slots by flat index, so a chunk boundary is the only other
    cut) and the chunks ``column_slots`` cuts."""
    for graph in GRAPHS:
        _, tell = _ells(graph)
        ts = tcost.graph_stats_from_ell(tell)
        group, start, ids = fv.column_slots(tell.cols, tell.n_dense_rows)
        rows = ids // tell.tau
        chunk = np.repeat(np.arange(group.size), np.diff(start))
        grp = group[chunk]
        pairs = int(rows.size > 0) + int(
            ((rows[1:] != rows[:-1]) | (grp[1:] != grp[:-1])).sum())
        assert ts.scatter_runs() == pairs
        assert ts.column_chunks() == group.size
    syn = tcost.synthetic_stats(rows=512, n_out_rows=256, n_dense_rows=256,
                                nnz=2000, tau=6)
    assert syn.scatter_runs() == 2000
    assert syn.column_chunks() == fv.max_column_chunks(256, 2000)


def test_h100_fused_viability_counts_the_kernels_shared_memory():
    """The viability test uses the kernel's own tile: the ring of three
    (X, W) chunks in f32 (78,336 bytes) and in bf16 (41,472)."""
    assert fv.fused_smem_bytes(torch.float32) == 78_336
    assert fv.fused_smem_bytes(torch.bfloat16) == 41_472
    assert fv.fused_smem_bytes(torch.float32, 33) == 78_336 + 8


def test_h100_prices_the_reddit_fused_layer_above_the_unfused_one():
    """At Reddit's shape the fused layer's zero fill and scatter over the
    4.2 M-row sub-row output outweigh the saved ``X W`` round trip, as
    measured on the card (``PERF.md``: 16.14 vs 7.90 ms per f32 forward)."""
    reddit = tcost.synthetic_stats(rows=4_205_568, n_out_rows=232_965,
                                   n_dense_rows=232_965, nnz=24_122_889,
                                   tau=6)
    for precision in PRECISIONS:
        for f_in, f_out in ((602, 64), (64, 41)):
            unfused = (tcost.spmm_cost(reddit, f_out, impl="cuda",
                                       precision=precision).seconds
                       + tcost.combination_seconds(232_965, f_in, f_out,
                                                   precision=precision))
            fused = tcost.fused_layer_cost(reddit, f_in, f_out, impl="cuda",
                                           precision=precision).seconds
            assert fused > unfused


def _layer_case(nodes, f_in, f_out):
    """A 2-layer toy graph (6-slot ELL, 16-row blocks) as the port's
    operands on the CPU, layer-0 parameters and permuted features."""
    from repro_torch.graphs.datasets import (DatasetSpec, gcn_normalize,
                                             synthesize_adjacency)
    from repro_torch.models.gcn import GCNGraph, init_params

    spec = DatasetSpec("toy", nodes=nodes, edges=5 * nodes,
                       feature_dim=f_in, classes=f_out)
    cfg = TConfig(in_dim=f_in, hidden_dim=f_out, out_dim=f_out, tau=6,
                  spmm_impl="cuda", block_rows=16, block_k=16, block_f=16)
    graph = GCNGraph.build(gcn_normalize(synthesize_adjacency(spec, seed=1)),
                           cfg)
    operands, perm, _ = graph.on_device("cpu")
    x = torch.randn(nodes, f_in, generator=torch.Generator().manual_seed(0))
    layer = init_params(cfg, device="cpu")["layer_0"]
    return tcost.graph_stats_from_ell(graph.pre.ell), operands, x[perm], layer


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_h100_launches_are_the_ops_dispatch_runs(impl, precision, fused,
                                                 monkeypatch):
    """The H100 model's host launches per layer (``launches`` of
    ``cuda_spmm_work`` + ``cuda_combination_work``, or of
    ``cuda_fused_work``) are the torch ops ``execute_layer`` runs, counted
    op by op with each kernel wrapper taken as its CUDA branch's
    launches: at aligned and unaligned widths, with and without the row,
    K and f-tile padding the block sizes force.  Memoized operand builds
    (values, slot lists, schedules) are made by a first call."""
    from _torch_ops import CountOps

    from repro_torch.exec import quant
    from repro_torch.exec.dispatch import execute_layer

    counter = CountOps()

    def as_cuda_branch(name, fn):
        def run(*args, **kw):
            counter.paused += 1
            try:
                return fn(*args, **kw)
            finally:
                counter.paused -= 1
                counter.names += [name] * WRAPPER_LAUNCHES[
                    name.removesuffix("_scaled")]
        return run

    for name, fn in list(fv.KERNELS.items()):
        monkeypatch.setitem(fv.KERNELS, name, as_cuda_branch(name, fn))
    for nodes, f_in, f_out in ((300, 20, 16), (256, 24, 32), (250, 3, 5)):
        stats, operands, x, layer = _layer_case(nodes, f_in, f_out)
        for br, bk, bf in ((16, 16, 16), (32, 64, 8), (64, 16, 32)):
            plan = SpmmPlan(impl=impl, block_rows=br, block_k=bk, block_f=bf,
                            precision=precision, fused=fused)
            p = quant.quantize_params({"l": layer}, precision, br)["l"]
            execute_layer(plan, operands, x, p, w_block_rows=br)
            counter.names = []
            with counter:
                execute_layer(plan, operands, x, p, w_block_rows=br)
            blocks = dict(impl=impl, block_rows=br, block_k=bk,
                          precision=precision)
            if fused and impl != "reference":
                want = tcost.cuda_fused_work(stats, f_in, f_out, block_f=bf,
                                             **blocks)["launches"]
            else:
                want = (tcost.cuda_spmm_work(stats, f_out,
                                             **blocks)["launches"]
                        + tcost.cuda_combination_work(
                            stats.n_dense_rows, f_in, f_out,
                            precision)["launches"])
            assert len(counter.names) == want, (nodes, br, bk, bf,
                                                counter.names)
