"""The port's Algorithm 2 per tile and coarse-grained ISA against the JAX
package's (``repro.core.topk_select``, ``repro.core.isa``).

Both packages cut the same adjacency (made by each from one seed) into
vertex-cut tiles; per tile, every CNZ vector, miss profile, ``best_k``,
fixed region, program and instruction list must be equal — these are
host numpy integer computations, so the bar is equality.  Also the
reference's own Algorithm 2 claims (``tests/test_topk.py``) as tests of
the port.
"""

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # seeded-sweep fallback, tests/_propcheck.py
    from tests._propcheck import given, settings, strategies as st

import repro.core as jcore
from repro.core import isa as jisa
from repro.core import topk_select as jtk
from repro.graphs import load_dataset as j_load

import repro_torch.core as tcore
from repro_torch.core import isa as tisa
from repro_torch.core import topk_select as ttk
from repro_torch.graphs.datasets import load_dataset as t_load

PCTS = (0.25, 0.5, 0.75, 1.0)


def _tiles(core, adj, tau, tile_rows=16):
    return [core.vertex_cut_tile(t, tau)
            for t in core.partition_into_tiles(adj, tile_rows)]


def _pair_tiles(n, nnz, tau, seed, alpha=2.1):
    t = tcore.random_power_law_csr(n, n, nnz, alpha=alpha, seed=seed)
    j = jcore.random_power_law_csr(n, n, nnz, alpha=alpha, seed=seed)
    tt, jt = _tiles(tcore, t, tau), _tiles(jcore, j, tau)
    assert len(tt) == len(jt)
    return list(zip(tt, jt))


def assert_same_program(t, j):
    assert (t.k, t.n_sub_rows, t.n_dense_rows, t.sparse_nnz, t.out_rows) == (
        j.k, j.n_sub_rows, j.n_dense_rows, j.sparse_nnz, j.out_rows)
    for name in ("rnz", "miss", "partial"):
        got, want = getattr(t, name), getattr(j, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert t.coarse_instr_count() == j.coarse_instr_count()
    assert t.fine_instr_count() == j.fine_instr_count()
    ti, ji = tisa.expand_instructions(t), jisa.expand_instructions(j)
    assert [str(i) for i in ti] == [str(i) for i in ji]
    assert [(i.op.value, i.n, i.partial) for i in ti] == [
        (i.op.value, i.n, i.partial) for i in ji]


def assert_same_tile_analysis(tv, jv, tau, depth, mode, pct):
    np.testing.assert_array_equal(ttk.analyze_cnz(tv), jtk.analyze_cnz(jv))
    k = ttk.select_top_k(tv, tau, depth, mode=mode, pct=pct)
    assert k == jtk.select_top_k(jv, tau, depth, mode=mode, pct=pct)
    for kk in sorted({0, 1, k, k + 1, depth}):
        fixed = ttk.fixed_region_columns(tv, kk)
        np.testing.assert_array_equal(fixed,
                                      jtk.fixed_region_columns(jv, kk))
        assert fixed.dtype == jtk.fixed_region_columns(jv, kk).dtype
        np.testing.assert_array_equal(ttk.miss_counts(tv, fixed),
                                      jtk.miss_counts(jv, fixed))
        for got, want in zip(ttk.tile_miss_profile(tv, kk),
                             jtk.tile_miss_profile(jv, kk)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    return k


@settings(max_examples=12, deadline=None)
@given(n=st.integers(16, 120), nnz=st.integers(10, 700),
       tau=st.integers(2, 8), depth=st.integers(2, 32),
       mode=st.sampled_from(["single", "double"]),
       pct=st.sampled_from(PCTS), seed=st.integers(0, 1000))
def test_topk_select_matches_reference_on_random_tiles(n, nnz, tau, depth,
                                                       mode, pct, seed):
    for tv, jv in _pair_tiles(n, nnz, tau, seed):
        assert_same_tile_analysis(tv, jv, tau, depth, mode, pct)


@settings(max_examples=10, deadline=None)
@given(n=st.integers(16, 120), nnz=st.integers(10, 700),
       tau=st.integers(2, 8), depth=st.integers(2, 32),
       mode=st.sampled_from(["single", "double"]),
       static_k=st.sampled_from([None, 0, 2, 5]),
       pct=st.sampled_from(PCTS), seed=st.integers(0, 1000))
def test_isa_programs_match_reference_on_random_tiles(n, nnz, tau, depth,
                                                      mode, static_k, pct,
                                                      seed):
    pairs = _pair_tiles(n, nnz, tau, seed)
    tps = tisa.build_programs([t for t, _ in pairs], depth, mode=mode,
                              k=static_k, pct=pct)
    jps = jisa.build_programs([j for _, j in pairs], depth, mode=mode,
                              k=static_k, pct=pct)
    assert len(tps) == len(jps)
    for tp, jp in zip(tps, jps):
        assert_same_program(tp, jp)


@pytest.fixture(scope="module", params=("cora", "citeseer", "pubmed"))
def dataset_tiles(request):
    """The vertex-cut tiles of each package's own ``preprocess`` (RCM
    edge-cut, tau 6, 16-row tiles) of the dataset at seed 0."""
    name = request.param
    t = t_load(name, seed=0, with_features=False)
    j = j_load(name, seed=0, with_features=False)
    tt = tcore.preprocess(t.adj_norm, tau=6, tile_rows=16).tiles
    jt = jcore.preprocess(j.adj_norm, tau=6, tile_rows=16).tiles
    assert len(tt) == len(jt)
    return list(zip(tt, jt))


@pytest.mark.parametrize("mode", ["single", "double"])
@pytest.mark.parametrize("depth, pct", [(12, 0.5), (8, 0.25), (32, 1.0)])
def test_topk_select_matches_reference_on_datasets(dataset_tiles, mode,
                                                   depth, pct):
    ks = [ttk.select_top_k(tv, 6, depth, mode=mode, pct=pct)
          for tv, _ in dataset_tiles]
    assert ks == [jtk.select_top_k(jv, 6, depth, mode=mode, pct=pct)
                  for _, jv in dataset_tiles]
    for tv, jv in dataset_tiles[:: max(len(dataset_tiles) // 40, 1)]:
        assert_same_tile_analysis(tv, jv, 6, depth, mode, pct)


@pytest.mark.parametrize("mode", ["single", "double"])
@pytest.mark.parametrize("k", [None, 0, 3])
def test_isa_programs_match_reference_on_datasets(dataset_tiles, mode, k):
    tps = tisa.build_programs([t for t, _ in dataset_tiles], 12, mode=mode,
                              k=k)
    jps = jisa.build_programs([j for _, j in dataset_tiles], 12, mode=mode,
                              k=k)
    for tp, jp in zip(tps, jps):
        assert_same_program(tp, jp)


def test_isa_ops_and_instructions_match_reference():
    assert [(o.name, o.value) for o in tisa.Op] == [
        (o.name, o.value) for o in jisa.Op]
    for op in tisa.Op:
        for n, partial in ((0, False), (7, True)):
            assert str(tisa.Instr(op, n, partial)) == str(
                jisa.Instr(jisa.Op[op.name], n, partial))


def test_core_exports_the_reference_names():
    """The port's ``core`` exports the reference's names for the modules
    it has, under the same names."""
    assert set(tcore.__all__) <= set(jcore.__all__)
    for name in ("select_top_k", "fixed_region_columns", "tile_miss_profile",
                 "Op", "Instr", "TileProgram", "build_tile_program",
                 "build_programs", "expand_instructions", "preprocess",
                 "apply_symmetric_permutation", "spmm_ell"):
        assert name in tcore.__all__
    for name in tcore.__all__:
        obj = getattr(tcore, name)
        if hasattr(obj, "__name__"):
            assert obj.__name__ == getattr(jcore, name).__name__


def test_vertex_cut_tile_rnz_matches_reference():
    for tv, jv in _pair_tiles(80, 600, 4, seed=3):
        np.testing.assert_array_equal(tv.rnz(), jv.rnz())
        np.testing.assert_array_equal(tv.tile.rnz(), jv.tile.rnz())


# -- the reference's own Algorithm 2 claims, as tests of the port -------------


def _tiles_of(n, nnz, tau, seed):
    return _tiles(tcore, tcore.random_power_law_csr(n, n, nnz, seed=seed), tau)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(16, 100), nnz=st.integers(10, 500),
       tau=st.integers(2, 8), depth=st.integers(4, 32),
       mode=st.sampled_from(["single", "double"]), seed=st.integers(0, 1000))
def test_selected_k_is_feasible(n, nnz, tau, depth, mode, seed):
    for vc in _tiles_of(n, nnz, tau, seed):
        k = ttk.select_top_k(vc, tau, depth, mode=mode)
        assert 0 <= k <= depth
        if k == 0:
            continue
        miss, _ = ttk.tile_miss_profile(vc, k)
        srt = np.sort(miss)[::-1]
        m0 = int(srt[0]) if srt.size else 0
        m1 = int(srt[1]) if srt.size > 1 else 0
        assert k + m0 + (m1 if mode == "double" else 0) <= depth


def test_larger_k_never_increases_misses():
    for vc in _tiles_of(80, 600, 6, seed=3):
        prev = None
        for k in range(0, 8):
            miss, hit = ttk.tile_miss_profile(vc, k)
            total = int(miss.sum())
            if prev is not None:
                assert total <= prev
            prev = total
            assert np.all(miss + hit == vc.rnz())


def test_deeper_vrf_allows_larger_k():
    tiles = _tiles_of(100, 800, 6, seed=4)
    for mode in ("single", "double"):
        shallow = [ttk.select_top_k(vc, 6, 8, mode=mode) for vc in tiles]
        deep = [ttk.select_top_k(vc, 6, 32, mode=mode) for vc in tiles]
        assert sum(deep) >= sum(shallow)


def test_zero_reuse_tile_gets_k_zero():
    import scipy.sparse as sp

    adj = tcore.CSRMatrix.from_scipy(sp.eye(16, format="csr").astype(np.float32))
    vc = tcore.vertex_cut_tile(tcore.partition_into_tiles(adj, 16)[0], tau=4)
    k = ttk.select_top_k(vc, tau=4, vrf_depth=8, mode="double")
    miss, _ = ttk.tile_miss_profile(vc, k)
    assert int(miss.sum()) == 16 - k


def test_unknown_vrf_mode_raises():
    vc = _tiles_of(32, 200, 4, seed=1)[0]
    with pytest.raises(ValueError, match="unknown VRF mode"):
        ttk.select_top_k(vc, 4, 12, mode="triple")
