"""The reference's remaining host helpers, the array-level SpMM and the
warn-once degradation, held against the reference on the CPU.

Exact equality for the host arrays (``csr_to_ell``, ``ell_to_dense``,
``hot_column_permutation``, ``plan_buffer``, ``model_axis``);
``spmm_dense_oracle`` within 1e-12 relative; ``spmm_ell_arrays`` within
1e-4 x max|ref| at f32 and 2e-3 with int8 values, against
``repro.core.spmm.spmm_ell_arrays(impl="reference")``.
"""

import dataclasses
import itertools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro.core import preprocessing as jpre
from repro.core import sparse_formats as jsf
from repro.core import spmm as jspmm
from repro.exec import SpmmPlan as JPlan
from repro.exec import plan as jplan
from repro.exec import quant as jquant
from repro.launch import mesh as jmesh
from repro.roofline import analysis as jra

from repro_torch.core import dataflow as tdf
from repro_torch.core import preprocessing as tpre
from repro_torch.core import sparse_formats as tsf
from repro_torch.core import spmm as tspmm
from repro_torch.dist.topology import abstract_mesh
from repro_torch.exec import SpmmPlan as TPlan
from repro_torch.exec import plan as tplan
from repro_torch.launch import mesh as tmesh
from repro_torch.roofline import analysis as tra

F32_REL = 1e-4
INT8_REL = 2e-3


@pytest.fixture(autouse=True)
def _fresh_degradation_registries():
    jplan.reset_degradation_warnings()
    tplan.reset_degradation_warnings()


def _csr_pair(rows, cols, nnz, seed, alpha=2.1):
    return (jsf.random_power_law_csr(rows, cols, nnz, alpha=alpha, seed=seed),
            tsf.random_power_law_csr(rows, cols, nnz, alpha=alpha, seed=seed))


def _ell_equal(j, t):
    for field in ("cols", "vals", "row_map"):
        a, b = np.asarray(getattr(j, field)), getattr(t, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (j.n_dense_rows, j.n_orig_rows) == (t.n_dense_rows, t.n_orig_rows)


# ---------------------------------------------------------------------------
# csr_to_ell, ell_to_dense
# ---------------------------------------------------------------------------

# (rows, cols, nnz, seed, tau, pad_rows_to)
CSR_CASES = [
    (40, 40, 120, 0, None, 1),
    (40, 50, 120, 1, 64, 16),
    (33, 70, 200, 2, None, 8),
    (1, 5, 3, 3, None, 4),
]


@pytest.mark.parametrize("case", CSR_CASES)
def test_csr_to_ell_equals_the_reference(case):
    rows, cols, nnz, seed, tau, pad = case
    j_csr, t_csr = _csr_pair(rows, cols, nnz, seed)
    j = jsf.csr_to_ell(j_csr, tau=tau, pad_rows_to=pad)
    t = tsf.csr_to_ell(t_csr, tau=tau, pad_rows_to=pad)
    _ell_equal(j, t)
    assert t.padded_rows % pad == 0
    assert (t.row_map[rows:] == -1).all()
    assert (t.cols[rows:] == tsf.PAD_COL).all() and (t.vals[rows:] == 0).all()
    np.testing.assert_array_equal(jsf.ell_to_dense(j), tsf.ell_to_dense(t))


def test_csr_to_ell_refuses_a_long_row_as_the_reference_does():
    j_csr, t_csr = _csr_pair(30, 30, 200, 4)
    longest = int(t_csr.row_nnz().max())
    with pytest.raises(ValueError) as j_err:
        jsf.csr_to_ell(j_csr, tau=longest - 1)
    with pytest.raises(ValueError) as t_err:
        tsf.csr_to_ell(t_csr, tau=longest - 1)
    assert str(t_err.value) == str(j_err.value)
    assert str(t_err.value) == f"max RNZ {longest} exceeds tau {longest - 1}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ell_to_dense_of_a_vertex_cut_equals_the_reference(seed):
    j_adj, t_adj = _csr_pair(96, 96, 700, seed)
    j = jpre.preprocess(j_adj, tau=4, tile_rows=16)
    t = tpre.preprocess(t_adj, tau=4, tile_rows=16)
    dense = tsf.ell_to_dense(t.ell)
    assert dense.dtype == np.float64
    np.testing.assert_array_equal(jsf.ell_to_dense(j.ell), dense)
    # the split rows sum back to the permuted adjacency
    p = t.perm
    want = t_adj.to_scipy().toarray()[np.ix_(p, p)]
    np.testing.assert_allclose(dense, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# hot_column_permutation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_hot", [(0, 0), (0, 5), (1, 17), (2, 200)])
def test_hot_column_permutation_equals_the_reference(seed, n_hot):
    j_adj, t_adj = _csr_pair(120, 120, 900, seed, alpha=2.6)
    j = jpre.preprocess(j_adj, tau=6, tile_rows=16)
    t = tpre.preprocess(t_adj, tau=6, tile_rows=16)
    got = tpre.hot_column_permutation(t.ell, n_hot)
    want = jpre.hot_column_permutation(j.ell, n_hot)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(t.ell.n_dense_rows))


def test_hot_column_permutation_breaks_ties_by_column():
    """Equal counts keep their column order (a stable sort of -CNZ)."""
    cols = np.array([[3, 1, -1], [1, 3, 0], [2, -1, -1]], np.int32)
    ell = tsf.TiledELL(cols=cols, vals=np.ones(cols.shape, np.float32),
                       row_map=np.arange(3, dtype=np.int32), n_dense_rows=5,
                       n_orig_rows=3)
    j_ell = jsf.TiledELL(cols=cols, vals=np.ones(cols.shape, np.float32),
                         row_map=np.arange(3, dtype=np.int32), n_dense_rows=5,
                         n_orig_rows=3)
    for n_hot in range(6):
        got = tpre.hot_column_permutation(ell, n_hot)
        np.testing.assert_array_equal(
            got, jpre.hot_column_permutation(j_ell, n_hot))
    # CNZ = [1, 2, 1, 2, 0]: 1 and 3 tie at 2, then 0 and 2 at 1
    assert tpre.hot_column_permutation(ell, 3).tolist() == [1, 3, 0, 2, 4]


# ---------------------------------------------------------------------------
# plan_buffer
# ---------------------------------------------------------------------------

BUFFER_GRID = list(itertools.product(
    (1, 64, 500, 4096),            # feature_dim
    (1024, 64 * 1024, 2 ** 20),    # dense_buffer_bytes
    (16, 128),                     # tile_rows
    (0, 1, 2, 6),                  # m
    (1, 2, 4),                     # elem_bytes
    (0.25, 0.5),                   # rows_to_compute_frac
))


@pytest.mark.parametrize("feature_dim", (1, 64, 500, 4096))
def test_plan_buffer_equals_the_reference(feature_dim):
    cases = [c for c in BUFFER_GRID if c[0] == feature_dim]
    for f, nbytes, tile_rows, m, elem, frac in cases:
        want = jdf.plan_buffer(f, nbytes, tile_rows, m, elem_bytes=elem,
                               rows_to_compute_frac=frac)
        got = tdf.plan_buffer(f, nbytes, tile_rows, m, elem_bytes=elem,
                              rows_to_compute_frac=frac)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.overlapped == want.overlapped
    assert [fl.name for fl in dataclasses.fields(tdf.BufferPlan)] == [
        fl.name for fl in dataclasses.fields(jdf.BufferPlan)]
    assert tdf.plan_buffer(feature_dim, 2 ** 20, 16, 6) == tdf.BufferPlan(
        **dataclasses.asdict(jdf.plan_buffer(feature_dim, 2 ** 20, 16, 6)))


# ---------------------------------------------------------------------------
# model_axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,names", [
    ((1, 1), ("data", "model")),
    ((1, 1, 1), ("pod", "data", "model")),
])
def test_model_axis_equals_the_reference(shape, names):
    devs = np.asarray(jax.devices()[:1]).reshape(shape)
    want = jmesh.model_axis(jax.sharding.Mesh(devs, names))
    assert tmesh.model_axis(abstract_mesh(shape, names)) == want == "model"


# ---------------------------------------------------------------------------
# spmm_dense_oracle, spmm_ell_arrays
# ---------------------------------------------------------------------------

def _graph(seed, n=96, nnz=700, tau=6, f=24):
    j_adj, t_adj = _csr_pair(n, n, nnz, seed)
    j = jpre.preprocess(j_adj, tau=tau, tile_rows=16, pad_rows_to=16)
    t = tpre.preprocess(t_adj, tau=tau, tile_rows=16, pad_rows_to=16)
    dense = np.random.default_rng(seed).standard_normal((n, f)).astype(
        np.float32)
    return j.ell, t.ell, dense


@pytest.mark.parametrize("seed", [0, 1])
def test_spmm_dense_oracle_equals_the_reference(seed):
    j_ell, t_ell, dense = _graph(seed)
    want = jspmm.spmm_dense_oracle(j_ell, dense)
    got = tspmm.spmm_dense_oracle(t_ell, dense)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def _j_arrays(ell, dense, **kw):
    return np.asarray(jspmm.spmm_ell_arrays(
        jnp.asarray(ell.cols), jnp.asarray(ell.vals), jnp.asarray(ell.row_map),
        jnp.asarray(dense), ell.n_orig_rows, impl="reference", **kw))


def _hold(got, want, rel):
    got = got.detach().cpu().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("impl", ["reference", "cuda", "cuda_sparse"])
@pytest.mark.parametrize("seed", [0, 1])
def test_spmm_ell_arrays_f32_matches_the_reference(impl, seed):
    j_ell, t_ell, dense = _graph(seed)
    want = _j_arrays(j_ell, dense)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # cuda_sparse
        got = tspmm.spmm_ell_arrays(
            t_ell.cols, t_ell.vals, t_ell.row_map, dense, t_ell.n_orig_rows,
            impl=impl, block_rows=16, block_k=16, block_f=16, device="cpu")
    _hold(got, want, F32_REL)
    np.testing.assert_allclose(
        got.numpy(), tspmm.spmm_dense_oracle(t_ell, dense)[
            :t_ell.n_orig_rows], rtol=0,
        atol=F32_REL * np.abs(want).max())


@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_spmm_ell_arrays_int8_values_match_the_reference(impl, precision):
    """int8 values with their per-row-block scales, run as the plan's
    precision says, within 2e-3 x max|ref| of the reference's."""
    j_ell, t_ell, dense = _graph(3)
    q = jquant.quantize_ell(j_ell, "int8", 16)
    assert q.vals.dtype == np.int8
    want = np.asarray(jspmm.spmm_ell_arrays(
        jnp.asarray(q.cols), jnp.asarray(q.vals), jnp.asarray(q.row_map),
        jnp.asarray(dense), q.n_out_rows, impl="reference",
        plan=JPlan(impl="reference", block_rows=16, block_k=16, block_f=16,
                   precision=precision),
        scales=jnp.asarray(q.scales), scale_block_rows=16))
    got = tspmm.spmm_ell_arrays(
        q.cols, q.vals, q.row_map, dense, q.n_out_rows,
        plan=TPlan(impl=impl, block_rows=16, block_k=16, block_f=16,
                   precision=precision),
        scales=q.scales, scale_block_rows=16, device="cpu")
    _hold(got, want, INT8_REL)
    # and within the int8 budget of the f32 product
    _hold(got, _j_arrays(j_ell, dense), 2e-2)


def test_spmm_ell_arrays_defaults_the_scale_blocks_to_the_plan():
    j_ell, t_ell, dense = _graph(4)
    q = jquant.quantize_ell(j_ell, "int8", 32)
    want = np.asarray(jspmm.spmm_ell_arrays(
        jnp.asarray(q.cols), jnp.asarray(q.vals), jnp.asarray(q.row_map),
        jnp.asarray(dense), q.n_out_rows, block_rows=32,
        scales=jnp.asarray(q.scales)))
    got = tspmm.spmm_ell_arrays(q.cols, q.vals, q.row_map, dense,
                                q.n_out_rows, block_rows=32, scales=q.scales,
                                device="cpu")
    _hold(got, want, INT8_REL)


def test_spmm_ell_arrays_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t_ell, dense = _graph(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tspmm.spmm_ell_arrays(t_ell.cols, t_ell.vals, t_ell.row_map, dense,
                              t_ell.n_orig_rows)


# ---------------------------------------------------------------------------
# warn once
# ---------------------------------------------------------------------------

def _warnings_of(resolve) -> int:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        resolve()
    return sum(issubclass(w.category, RuntimeWarning)
               and "degraded" in str(w.message) for w in caught)


def test_a_degradation_warns_once_per_process_as_the_reference():
    """Two resolutions of an unschedulable sparse-grid plan warn once;
    after the registry is cleared, the next warns again; every resolved
    plan records the degradation."""
    plans = {"jax": JPlan(impl="pallas_sparse"),
             "torch": TPlan(impl="cuda_sparse")}
    resets = {"jax": jplan.reset_degradation_warnings,
              "torch": tplan.reset_degradation_warnings}
    counts = {}
    for key, plan in plans.items():
        seq, resolved = [], []

        def resolve():
            resolved.append(plan.resolve(schedulable=False))

        seq.append(_warnings_of(resolve))
        seq.append(_warnings_of(resolve))
        seq.append(_warnings_of(lambda: plan.resolve(schedulable=True)))
        resets[key]()
        seq.append(_warnings_of(resolve))
        counts[key] = seq
        assert all(r.degraded for r in resolved)
        assert len({r.degraded_reason for r in resolved}) == 1
    assert counts["torch"] == counts["jax"] == [1, 0, 0, 1]


def test_spmm_ell_arrays_warns_once_and_records_the_degradation():
    """Through the entry point, as the reference's ``spmm_ell_arrays``."""
    j_ell, t_ell, dense = _graph(5)
    j_counts = [_warnings_of(lambda: jspmm.spmm_ell_arrays(
        jnp.asarray(j_ell.cols), jnp.asarray(j_ell.vals),
        jnp.asarray(j_ell.row_map), jnp.asarray(dense), j_ell.n_orig_rows,
        impl="pallas_sparse", block_rows=16, block_k=16, block_f=16,
        interpret=True)) for _ in range(2)]
    t_counts = [_warnings_of(lambda: tspmm.spmm_ell_arrays(
        t_ell.cols, t_ell.vals, t_ell.row_map, dense, t_ell.n_orig_rows,
        impl="cuda_sparse", block_rows=16, block_k=16, block_f=16,
        device="cpu")) for _ in range(2)]
    assert t_counts == j_counts == [1, 0]


# ---------------------------------------------------------------------------
# collective_bytes
# ---------------------------------------------------------------------------

def test_collective_bytes_is_the_reference_record(tmp_path):
    """A counter filled by one all-reduce and one all-gather on a one-rank
    gloo group reads as the reference's record of the same two ops."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        counter = tra.CollectiveCounter()
        with counter:
            funcol.all_reduce(torch.ones(8, 4), "sum", group).wait()
            funcol.all_gather_tensor(torch.ones(3, 5, dtype=torch.bfloat16),
                                     0, group).wait()
    finally:
        dist.destroy_process_group()
    hlo = "\n".join([
        "%ar = f32[8,4]{1,0} all-reduce(f32[8,4]{1,0} %x), to_apply=%sum",
        "%ag = bf16[3,5]{1,0} all-gather(bf16[3,5]{1,0} %y), dimensions={0}",
        "%z = f32[8,4]{1,0} add(%ar, %ar)",
    ])
    want = jra.collective_bytes(hlo)
    got = tra.collective_bytes(counter)
    assert got == want
    assert list(got) == list(want)
    assert {k: type(v) for k, v in got.items()} == {
        k: type(v) for k, v in want.items()}
    assert got["all-reduce"] == 128.0 and got["all-gather"] == 30.0
    assert got["op_counts"] == {"all-gather": 1, "all-reduce": 1,
                                "reduce-scatter": 0, "all-to-all": 0,
                                "collective-permute": 0}
    # the counter's summary and a summary's re-read are the same record
    assert counter.summary() == got
    assert tra.collective_bytes(counter.summary()) == got
    assert tra.collective_bytes({"op_counts": {}}) == jra.collective_bytes("")
