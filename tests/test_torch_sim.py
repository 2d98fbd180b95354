"""The port's simulator against the JAX package's (``repro.sim``).

The same adjacency (made by both packages from one seed) goes through
both: the label-propagation edge-cut, ``compute_block_stats``, Algorithm
2 across tiles, and both simulators.  The bar is equality, not a
tolerance: every array equals the reference's, dtype included, and every
``SimResult`` field compares ``==`` (the floats come from the same
integer counts in the same order of operations).  On the CPU the port's
group-bys run as ``torch`` ops on CPU tensors; ``tests/test_torch_cuda.py``
holds the card against the CPU.  Also the reference's own claims
(``tests/test_sim.py``'s trends, the PubMed headline) as tests of the
port.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # seeded-sweep fallback, tests/_propcheck.py
    from tests._propcheck import given, settings, strategies as st

import repro.sim as jsim
from repro.core import random_power_law_csr as j_power_law
from repro.core.preprocessing import apply_symmetric_permutation as j_permute
from repro.graphs import load_dataset as j_load
from repro.graphs.partition import label_propagation_permutation as j_lp

import repro_torch.sim as tsim
from repro_torch.core.preprocessing import apply_symmetric_permutation as t_permute
from repro_torch.core.sparse_formats import random_power_law_csr as t_power_law
from repro_torch.graphs.datasets import load_dataset as t_load
from repro_torch.graphs.partition import label_propagation_permutation as t_lp

CPU = "cpu"
SMALL = ("cora", "citeseer", "pubmed")
# the ablation switches tests/test_sim.py uses, and the default
HW_CASES = {
    "default": {},
    "m1": dict(m=1),
    "single_vrf": dict(double_vrf=False),
    "static_k": dict(flexible_k=False),
    "no_vertex_cut": dict(vertex_cut=False),
    "no_vertex_cut_single": dict(vertex_cut=False, double_vrf=False,
                                 static_k=2, flexible_k=False),
    "deep_vrf": dict(vrf_depth=32, tau=6),
    "vlen_512": dict(vlen_bits=512, dense_buffer_bytes=8192),
}
STATS_ARRAYS = ("nz_block", "nz_col_rank", "nz_col", "nz_rb", "br_start",
                "br_block", "br_rnz", "b_start", "b_nnz_start", "b_nnz",
                "b_ncols", "b_nrows")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def assert_same_array(got, want, what=""):
    got = _np(got)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_same_stats(t, j):
    for name in ("tile", "n_rows", "n_cols", "nnz", "n_blocks"):
        assert getattr(t, name) == getattr(j, name), name
    for name in STATS_ARRAYS:
        assert_same_array(getattr(t, name), getattr(j, name), name)


def assert_same_result(t, j):
    for f in dataclasses.fields(j):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name == "per_block_k" and want is not None:
            assert_same_array(got, want, f.name)
        else:
            assert got == want, (f.name, got, want)
    assert t.energy_j == j.energy_j


def _pair_graph(n, nnz, seed, alpha=2.1):
    return (t_power_law(n, n, nnz, alpha=alpha, seed=seed),
            j_power_law(n, n, nnz, alpha=alpha, seed=seed))


@pytest.fixture(scope="module", params=SMALL)
def prepared(request):
    """(name, port (padj, stats), reference (padj, stats), feature dim),
    each package's own label propagation, permutation and statistics."""
    name = request.param
    t = t_load(name, seed=0, with_features=False)
    j = j_load(name, seed=0, with_features=False)
    tperm, jperm = t_lp(t.adj_norm, device=CPU), j_lp(j.adj_norm)
    np.testing.assert_array_equal(tperm, jperm)
    tp, jp = t_permute(t.adj_norm, tperm), j_permute(j.adj_norm, jperm)
    return (name, (tp, tsim.compute_block_stats(tp, 16, device=CPU)),
            (jp, jsim.compute_block_stats(jp, 16)), j.spec.feature_dim)


# -- BlockStats ---------------------------------------------------------------


def test_block_stats_match_reference_on_datasets(prepared):
    _, (_, ts), (_, js), _ = prepared
    assert_same_stats(ts, js)
    assert ts.device == torch.device("cpu")


@settings(max_examples=15, deadline=None)
@given(n=st.integers(16, 200), nnz=st.integers(1, 1500),
       tile=st.sampled_from([4, 8, 16, 32]), seed=st.integers(0, 1000))
def test_block_stats_match_reference_on_random_graphs(n, nnz, tile, seed):
    t, j = _pair_graph(n, nnz, seed)
    assert_same_stats(tsim.compute_block_stats(t, tile, device=CPU),
                      jsim.compute_block_stats(j, tile))


@pytest.mark.parametrize("shape", [(1, 1), (16, 16), (33, 20), (5, 40)])
def test_block_stats_of_an_empty_graph_match_reference(shape):
    import scipy.sparse as sp

    from repro.core import CSRMatrix as JCSR
    from repro_torch.core.sparse_formats import CSRMatrix as TCSR

    m = sp.csr_matrix(shape, dtype=np.float32)
    ts = tsim.compute_block_stats(TCSR.from_scipy(m), 16, device=CPU)
    js = jsim.compute_block_stats(JCSR.from_scipy(m), 16)
    assert_same_stats(ts, js)
    for mode in ("single", "double"):
        assert_same_array(tsim.alg2_best_k(ts, 6, 12, mode=mode),
                          jsim.alg2_best_k(js, 6, 12, mode=mode))


def test_block_stats_of_one_row_tiles_match_reference():
    """One nonzero row per tile: every second max is 0."""
    import scipy.sparse as sp

    from repro.core import CSRMatrix as JCSR
    from repro_torch.core.sparse_formats import CSRMatrix as TCSR

    rng = np.random.default_rng(4)
    d = np.zeros((64, 64), np.float32)
    for rb in range(4):
        d[rb * 16 + rng.integers(16), rng.choice(64, 9, replace=False)] = 1.0
    ts = tsim.compute_block_stats(TCSR.from_scipy(sp.csr_matrix(d)), 16,
                                  device=CPU)
    js = jsim.compute_block_stats(JCSR.from_scipy(sp.csr_matrix(d)), 16)
    assert_same_stats(ts, js)
    v = ts.br_rnz.to(torch.int64)
    m0, m1 = ts.top2_per_block(v)
    jm0, jm1 = js.top2_per_block(js.br_rnz.astype(np.int64))
    assert_same_array(m0, jm0)
    assert_same_array(m1, jm1)
    assert (m1 == 0).all()


@settings(max_examples=10, deadline=None)
@given(n=st.integers(16, 150), nnz=st.integers(5, 900),
       k=st.integers(0, 10), seed=st.integers(0, 500))
def test_block_stats_methods_match_reference(n, nnz, k, seed):
    """miss_per_block_row (scalar and per-tile k), br/b reductions,
    top2_per_block, br_block_rank and unique_group_loads."""
    t, j = _pair_graph(n, nnz, seed)
    ts = tsim.compute_block_stats(t, 16, device=CPU)
    js = jsim.compute_block_stats(j, 16)
    assert_same_array(ts.miss_per_block_row(k), js.miss_per_block_row(k))
    per_tile = np.random.default_rng(seed).integers(
        0, 8, js.n_blocks).astype(np.int32)
    assert_same_array(ts.miss_per_block_row(torch.as_tensor(per_tile)),
                      js.miss_per_block_row(per_tile))
    assert_same_array(ts.br_block_rank(), js.br_block_rank())
    rank = ts.nz_col_rank
    assert_same_array(ts.br_reduce(rank, "max"),
                      js.br_reduce(js.nz_col_rank, "max"))
    assert_same_array(ts.b_reduce(ts.br_rnz, "max"),
                      js.b_reduce(js.br_rnz, "max"))
    v = ts.miss_per_block_row(k)
    for got, want in zip(ts.top2_per_block(v),
                         js.top2_per_block(js.miss_per_block_row(k))):
        assert_same_array(got, want)
    np.testing.assert_array_equal(_np(ts.b_reduce(v, "sum")),
                                  np.add.reduceat(js.miss_per_block_row(k),
                                                  js.b_start))
    for g in (1, 2, 6, 16, 10_000):
        assert ts.unique_group_loads(g) == js.unique_group_loads(g)


# -- Algorithm 2 across tiles -------------------------------------------------


@pytest.mark.parametrize("mode", ["single", "double"])
@pytest.mark.parametrize("tau, depth, pct", [(6, 12, 0.5), (4, 8, 0.5),
                                             (6, 32, 0.25), (3, 6, 1.0)])
def test_alg2_best_k_matches_reference_on_datasets(prepared, mode, tau,
                                                   depth, pct):
    _, (_, ts), (_, js), _ = prepared
    assert_same_array(tsim.alg2_best_k(ts, tau, depth, mode=mode, pct=pct),
                      jsim.alg2_best_k(js, tau, depth, mode=mode, pct=pct))


@settings(max_examples=15, deadline=None)
@given(n=st.integers(16, 120), nnz=st.integers(10, 800),
       tau=st.integers(2, 8), depth=st.integers(2, 24),
       mode=st.sampled_from(["single", "double"]),
       pct=st.sampled_from([0.25, 0.5, 0.75, 1.0]), seed=st.integers(0, 500))
def test_alg2_best_k_matches_reference_on_random_graphs(n, nnz, tau, depth,
                                                        mode, pct, seed):
    t, j = _pair_graph(n, nnz, seed)
    assert_same_array(
        tsim.alg2_best_k(tsim.compute_block_stats(t, 16, device=CPU), tau,
                         depth, mode=mode, pct=pct),
        jsim.alg2_best_k(jsim.compute_block_stats(j, 16), tau, depth,
                         mode=mode, pct=pct))


# -- the simulators -----------------------------------------------------------


@pytest.mark.parametrize("case", sorted(HW_CASES))
def test_simulate_flexvector_matches_reference_on_datasets(prepared, case):
    _, (tp, ts), (jp, js), fdim = prepared
    hw = HW_CASES[case]
    assert_same_result(
        tsim.simulate_flexvector(tp, fdim, tsim.HWConfig(**hw), stats=ts),
        jsim.simulate_flexvector(jp, fdim, jsim.HWConfig(**hw), stats=js))


@settings(max_examples=12, deadline=None)
@given(n=st.integers(16, 200), nnz=st.integers(5, 2000),
       f=st.sampled_from([1, 16, 40, 500]),
       case=st.sampled_from(sorted(HW_CASES)), seed=st.integers(0, 1000))
def test_simulate_flexvector_matches_reference_on_random_graphs(n, nnz, f,
                                                                case, seed):
    t, j = _pair_graph(n, nnz, seed)
    hw = HW_CASES[case]
    # without stats: the port groups the tiles on the device it is given
    assert_same_result(
        tsim.simulate_flexvector(t, f, tsim.HWConfig(**hw), device=CPU),
        jsim.simulate_flexvector(j, f, jsim.HWConfig(**hw)))


GROW_CASES = {
    "m6": dict(m=6),
    "m1": dict(m=1),
    "big_buffer": dict(dense_buffer_bytes=512 * 1024, m=2273),
    "small_buffer": dict(dense_buffer_bytes=341, m=1),
}


@pytest.mark.parametrize("with_stats", [False, True], ids=["hdn", "lru"])
@pytest.mark.parametrize("case", sorted(GROW_CASES))
def test_simulate_grow_matches_reference_on_datasets(prepared, case,
                                                     with_stats):
    _, (tp, ts), (jp, js), fdim = prepared
    gw = GROW_CASES[case]
    assert_same_result(
        tsim.simulate_grow(tp, fdim, tsim.GROWConfig(**gw),
                           stats=ts if with_stats else None, device=CPU),
        jsim.simulate_grow(jp, fdim, jsim.GROWConfig(**gw),
                           stats=js if with_stats else None))


@settings(max_examples=10, deadline=None)
@given(n=st.integers(16, 200), nnz=st.integers(5, 2000),
       f=st.sampled_from([1, 16, 64, 602]),
       case=st.sampled_from(sorted(GROW_CASES)), seed=st.integers(0, 1000))
def test_simulate_grow_matches_reference_on_random_graphs(n, nnz, f, case,
                                                          seed):
    t, j = _pair_graph(n, nnz, seed)
    gw = GROW_CASES[case]
    deg = j.col_nnz()
    # the degree vector given as numpy (as the reference takes it)
    assert_same_result(
        tsim.simulate_grow(t, f, tsim.GROWConfig(**gw), col_degree=deg,
                           stats=tsim.compute_block_stats(t, 16, device=CPU)),
        jsim.simulate_grow(j, f, jsim.GROWConfig(**gw), col_degree=deg,
                           stats=jsim.compute_block_stats(j, 16)))


AREA_CASES = [dict(), dict(m=1), dict(m=12), dict(dense_buffer_bytes=512 * 1024),
              dict(vlen_bits=2048, dense_buffer_bytes=32768), dict(vrf_depth=32)]


@pytest.mark.parametrize("hw", AREA_CASES)
def test_area_reports_match_reference(hw):
    t, j = tsim.flexvector_area(tsim.HWConfig(**hw)), jsim.flexvector_area(
        jsim.HWConfig(**hw))
    assert t.components_um2 == j.components_um2
    assert t.total_um2 == j.total_um2 and t.breakdown() == j.breakdown()
    gw = {k: v for k, v in hw.items() if k != "vrf_depth"}
    t, j = tsim.grow_area(tsim.GROWConfig(**gw)), jsim.grow_area(
        jsim.GROWConfig(**gw))
    assert t.components_um2 == j.components_um2
    assert t.total_um2 == j.total_um2 and t.breakdown() == j.breakdown()


def test_sim_exports_the_reference_names():
    assert tsim.__all__ == jsim.__all__
    for name in tsim.__all__:
        assert getattr(tsim, name).__name__ == getattr(jsim, name).__name__


def test_simulator_refuses_the_cpu_without_being_asked(monkeypatch):
    """With no card and no ``device``, the port raises instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, _ = _pair_graph(32, 100, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.compute_block_stats(t, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.simulate_flexvector(t, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.simulate_grow(t, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_lp(t)


# -- the reference's own claims, as tests of the port -------------------------


@pytest.fixture(scope="module")
def cora():
    t = t_load("cora", seed=0, with_features=False)
    padj = t_permute(t.adj_norm, t_lp(t.adj_norm, device=CPU))
    return padj, tsim.compute_block_stats(padj, 16, device=CPU), \
        t.spec.feature_dim


def test_simulator_headline_claim():
    """tests/test_system.py's headline: at PubMed FlexVector beats the
    GROW-like baseline at equal buffer capacity (paper: 3.78x geomean,
    -40.5% energy)."""
    t = t_load("pubmed", seed=0, with_features=False)
    padj = t_permute(t.adj_norm, t_lp(t.adj_norm, device=CPU))
    stats = tsim.compute_block_stats(padj, 16, device=CPU)
    fdim = t.spec.feature_dim
    gl = tsim.simulate_grow(padj, fdim, tsim.GROWConfig(m=6), stats=stats)
    fv = tsim.simulate_flexvector(padj, fdim, tsim.HWConfig(), stats=stats)
    assert gl.cycles / fv.cycles > 2.0
    assert fv.energy_pj < 0.75 * gl.energy_pj


def test_area_breakdown_matches_fig9():
    area = tsim.flexvector_area(tsim.HWConfig())
    assert abs(area.total_um2 - 39430) / 39430 < 0.10
    b = area.breakdown()
    assert b["dense_buffer"] > b["vrf"] > b["mac_lanes"]
    onchip = b["dense_buffer"] + b["sparse_buffer"] + b["vrf"]
    assert 0.5 < onchip < 0.7  # paper: 59.9%


def test_area_scales_with_buffers():
    small = tsim.flexvector_area(tsim.HWConfig()).total_um2
    big = tsim.flexvector_area(
        tsim.HWConfig(dense_buffer_bytes=512 * 1024)).total_um2
    assert big > 40 * small


def test_flexvector_beats_grow_at_same_capacity(cora):
    padj, stats, f = cora
    gl = tsim.simulate_grow(padj, f, tsim.GROWConfig(m=6), device=CPU)
    fv = tsim.simulate_flexvector(padj, f, tsim.HWConfig(m=6), stats=stats)
    assert gl.cycles / fv.cycles > 1.5
    assert fv.energy_pj < gl.energy_pj
    assert fv.dram_bytes < gl.dram_bytes


def test_multibuffering_helps(cora):
    padj, stats, f = cora
    kw = dict(double_vrf=False, vrf_depth=16, vertex_cut=False,
              flexible_k=False)
    m1 = tsim.simulate_flexvector(padj, f, tsim.HWConfig(m=1, **kw),
                                  stats=stats)
    m6 = tsim.simulate_flexvector(padj, f, tsim.HWConfig(m=6, **kw),
                                  stats=stats)
    assert m6.cycles < m1.cycles


def test_double_vrf_helps(cora):
    padj, stats, f = cora
    single = tsim.simulate_flexvector(
        padj, f, tsim.HWConfig(double_vrf=False, flexible_k=False),
        stats=stats)
    double = tsim.simulate_flexvector(
        padj, f, tsim.HWConfig(double_vrf=True, flexible_k=False),
        stats=stats)
    assert double.cycles < single.cycles


def test_flexible_k_reduces_misses(cora):
    padj, stats, f = cora
    k0 = tsim.simulate_flexvector(
        padj, f, tsim.HWConfig(flexible_k=False, static_k=0), stats=stats)
    flex = tsim.simulate_flexvector(padj, f, tsim.HWConfig(flexible_k=True),
                                    stats=stats)
    assert k0.vrf_or_cache_misses / flex.vrf_or_cache_misses > 1.5


def test_grow_misses_decrease_with_buffer(cora):
    padj, _, f = cora
    prev = None
    for m in (1, 6, 64, 2273):
        cap = int(2048 * m / 6)
        r = tsim.simulate_grow(padj, f, tsim.GROWConfig(
            dense_buffer_bytes=cap, m=m), device=CPU)
        if prev is not None:
            assert r.vrf_or_cache_misses <= prev
        prev = r.vrf_or_cache_misses


def test_grow_large_buffer_wins_latency_loses_energy(cora):
    padj, stats, f = cora
    gl_big = tsim.simulate_grow(padj, f, tsim.GROWConfig(
        dense_buffer_bytes=512 * 1024, m=2273), stats=stats)
    gl_small = tsim.simulate_grow(padj, f, tsim.GROWConfig(m=6), stats=stats)
    assert gl_big.cycles < gl_small.cycles
    assert gl_big.vrf_or_cache_misses < 0.5 * gl_small.vrf_or_cache_misses

    def sram_share(r):
        e = r.energy_breakdown_pj
        return (e["dense_buffer"] + e["sparse_buffer"]) / r.energy_pj

    assert sram_share(gl_big) > 3 * sram_share(gl_small)


def test_coarse_isa_reduces_instructions(cora):
    padj, stats, f = cora
    fv = tsim.simulate_flexvector(padj, f, tsim.HWConfig(), stats=stats)
    assert fv.instr_count < fv.fine_instr_count


def test_vlen_sweep_trends():
    adj = t_power_law(512, 512, 8000, seed=0)
    stats = tsim.compute_block_stats(adj, 16, device=CPU)
    cycles, instrs, areas = [], [], []
    for vlen in (64, 128, 512, 2048):
        hw = tsim.HWConfig(vlen_bits=vlen,
                           dense_buffer_bytes=2048 * vlen // 128)
        r = tsim.simulate_flexvector(adj, 1024, hw, stats=stats)
        cycles.append(r.cycles)
        instrs.append(r.instr_count)
        areas.append(r.area_um2)
    assert cycles[0] > cycles[1] > cycles[2] >= cycles[3] * 0.98
    assert instrs[0] > instrs[-1]
    assert instrs[-1] < 0.1 * instrs[0]
    assert areas[-1] > areas[0]


def test_deeper_vrf_reduces_cycles():
    adj = t_power_law(256, 256, 6000, seed=1)
    stats = tsim.compute_block_stats(adj, 16, device=CPU)
    shallow = tsim.simulate_flexvector(
        adj, 256, tsim.HWConfig(vrf_depth=12, tau=6), stats=stats)
    deep = tsim.simulate_flexvector(
        adj, 256, tsim.HWConfig(vrf_depth=32, tau=6), stats=stats)
    assert deep.cycles <= shallow.cycles
    assert deep.vrf_or_cache_misses <= shallow.vrf_or_cache_misses


def test_grow_area_comparable():
    fv = tsim.flexvector_area(tsim.HWConfig())
    gl = tsim.grow_area(tsim.GROWConfig())
    assert abs(fv.total_um2 - gl.total_um2) / gl.total_um2 < 0.15


def test_unique_group_loads_monotone():
    adj = t_power_law(256, 256, 4000, seed=5)
    stats = tsim.compute_block_stats(adj, 16, device=CPU)
    loads = [stats.unique_group_loads(g) for g in (1, 2, 6, 16, 10_000)]
    assert all(a >= b for a, b in zip(loads, loads[1:]))
    assert loads[-1] == len(np.unique(adj.indices))
