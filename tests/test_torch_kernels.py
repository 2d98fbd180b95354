"""The four FlexVector kernels of the port against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX kernels run as the JAX tests run them here (Pallas
interpret mode, blocks of 16).  The same inputs, made with numpy from a
seed, go to both.  Tolerance: 1e-5 of max|reference| — both sides sum
the same f32 products (at most tau per output for the aggregation,
F_in-long dot products for the fused layer's ``x @ w``) in another order.
"""

import numpy as np
import pytest
import torch

from repro.core import preprocess as j_preprocess
from repro.core import random_power_law_csr as j_power_law
from repro.core.dataflow import plan_fused_k_schedule, plan_kernel_grid
from repro.kernels import flexvector_spmm as jfv

from repro_torch.kernels import flexvector_spmm as tfv

BR = BK = BF = 16
RTOL = 1e-5


def rel_max_err(out, ref) -> float:
    out = np.asarray(out, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(out - ref))) / max(float(np.max(np.abs(ref))), 1e-30)


def _ell(n=80, nnz=600, tau=6, seed=0):
    res = j_preprocess(j_power_law(n, n, nnz, alpha=2.4, seed=seed), tau=tau,
                       tile_rows=16, pad_rows_to=BR)
    return res.ell


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _operands(seed=0, f=32, f_in=20):
    ell = _ell(seed=seed)
    rng = np.random.default_rng(seed + 10)
    k = ell.n_dense_rows
    return dict(
        ell=ell,
        dense=rng.standard_normal((k, f)).astype(np.float32),
        x=rng.standard_normal((k, f_in)).astype(np.float32),
        w=rng.standard_normal((f_in, f)).astype(np.float32),
        b=rng.standard_normal((1, f)).astype(np.float32),
    )


def _grid(ell, drop_step=False):
    grid = plan_kernel_grid(ell, 32, BR, BK, BF)
    pairs, first = grid.pairs, grid.first_k.astype(np.int32)
    if drop_step:   # omit an occupied, non-first (row block, k-tile) pair
        s = int(np.flatnonzero(first == 0)[0])
        pairs, first = np.delete(pairs, s, axis=0), np.delete(first, s)
    return pairs[:, 0].copy(), pairs[:, 1].copy(), first


def _bitmaps(ell, steps):
    """The port's form of the schedule ``steps`` = (rb_ids, kb_ids, first)."""
    return _t(tfv.schedule_tile_bitmaps(
        *steps, -(-ell.cols.shape[0] // BR), -(-ell.n_dense_rows // BK)),
        torch.int32)


def _fused_schedule(ell, drop_and_pad=False):
    kb = plan_fused_k_schedule(ell, BR, BK)
    if drop_and_pad:  # omit the hottest tile, pad with -1 no-op steps
        kb = np.concatenate([kb[1:], [-1, -1, -1]]).astype(np.int32)
    return kb


KW = dict(block_rows=BR, block_k=BK, block_f=BF)


def test_dense_grid_plain_matches_pallas():
    o = _operands()
    e = o["ell"]
    ref = jfv.spmm_ell_dense_grid(e.cols, e.vals, o["dense"], **KW)
    out = tfv.spmm_ell_dense_grid(_t(e.cols, torch.int32), _t(e.vals),
                                  _t(o["dense"]), **KW)
    assert rel_max_err(out, ref) <= RTOL


@pytest.mark.parametrize("drop_step", [False, True], ids=["full", "omitted"])
def test_sparse_grid_plain_matches_pallas(drop_step):
    o = _operands(seed=1)
    e = o["ell"]
    rb, kb, first = _grid(e, drop_step)
    ref = np.asarray(jfv.spmm_ell_sparse_grid(
        e.cols, e.vals, o["dense"], rb, kb, first, **KW))
    args = (_t(e.cols, torch.int32), _t(e.vals), _t(o["dense"]),
            _bitmaps(e, (rb, kb, first)))
    out = tfv.spmm_ell_sparse_grid(*args, **KW)
    assert rel_max_err(out, ref) <= RTOL
    full = tfv.spmm_ell_dense_grid(*args[:3], **KW)
    # the full schedule visits every occupied pair: it equals the dense
    # grid; an omitted pair is observable in both outputs alike
    assert (rel_max_err(out, full) <= RTOL) != drop_step


@pytest.mark.parametrize("k_real_cut", [0, 7])
def test_fused_dense_grid_plain_matches_pallas(k_real_cut):
    o = _operands(seed=2)
    e = o["ell"]
    k_real = e.n_dense_rows - k_real_cut
    ref = jfv.spmm_ell_fused_dense_grid(e.cols, e.vals, o["x"], o["w"], o["b"],
                                        k_real=k_real, **KW)
    out = tfv.spmm_ell_fused_dense_grid(
        _t(e.cols, torch.int32), _t(e.vals), _t(o["x"]), _t(o["w"]),
        _t(o["b"]), k_real=k_real, **KW)
    assert rel_max_err(out, ref) <= RTOL


@pytest.mark.parametrize("drop_and_pad", [False, True],
                         ids=["full", "omitted_padded"])
def test_fused_sparse_grid_plain_matches_pallas(drop_and_pad):
    o = _operands(seed=3)
    e = o["ell"]
    kb = _fused_schedule(e, drop_and_pad)
    k_real = e.n_dense_rows - 5
    ref = jfv.spmm_ell_fused_sparse_grid(e.cols, e.vals, o["x"], o["w"],
                                         o["b"], kb, k_real=k_real, **KW)
    args = (_t(e.cols, torch.int32), _t(e.vals), _t(o["x"]), _t(o["w"]),
            _t(o["b"]))
    out = tfv.spmm_ell_fused_sparse_grid(*args, _t(kb, torch.int32),
                                         k_real=k_real, **KW)
    assert rel_max_err(out, ref) <= RTOL
    dense = tfv.spmm_ell_fused_dense_grid(*args, k_real=k_real, **KW)
    assert (rel_max_err(out, dense) <= RTOL) != drop_and_pad


def test_cpu_wrappers_run_plain_and_launch_nothing():
    o = _operands(seed=4)
    e = o["ell"]
    cols, vals = _t(e.cols, torch.int32), _t(e.vals)
    dense, x, w, b = (_t(o[k]) for k in ("dense", "x", "w", "b"))
    bitmaps = _bitmaps(e, _grid(e))
    kb_f = _t(_fused_schedule(e), torch.int32)
    before = dict(tfv.LAUNCHES)
    calls = {
        "spmm_ell_dense_grid": (cols, vals, dense),
        "spmm_ell_sparse_grid": (cols, vals, dense, bitmaps),
        "spmm_ell_fused_dense_grid": (cols, vals, x, w, b),
        "spmm_ell_fused_sparse_grid": (cols, vals, x, w, b, kb_f),
    }
    for name, args in calls.items():
        out = getattr(tfv, name)(*args, **KW)
        torch.testing.assert_close(out, tfv.PLAIN[name](*args, **KW),
                                   rtol=0, atol=0)
    assert tfv.LAUNCHES == before


def test_wrappers_check_their_contract():
    o = _operands(seed=5)
    e = o["ell"]
    cols, vals, dense = _t(e.cols, torch.int32), _t(e.vals), _t(o["dense"])
    with pytest.raises(ValueError, match="padded to block multiples"):
        tfv.spmm_ell_dense_grid(cols[:-1], vals[:-1], dense, **KW)
    with pytest.raises(ValueError, match="padded to block multiples"):
        tfv.spmm_ell_dense_grid(cols, vals, dense[:, :-3].contiguous(), **KW)
    with pytest.raises(TypeError, match="cols must be torch.int32"):
        tfv.spmm_ell_dense_grid(cols.long(), vals, dense, **KW)
    with pytest.raises(ValueError, match="contiguous"):
        tfv.spmm_ell_dense_grid(cols, vals, dense.t().contiguous().t(), **KW)
    with pytest.raises(ValueError, match="differ in length"):
        tfv.schedule_tile_bitmaps([0, 0], [0], [1], 1, 1)
    with pytest.raises(ValueError, match="tile_bitmaps must be"):
        tfv.spmm_ell_sparse_grid(cols, vals, dense,
                                 torch.zeros(1, 1, dtype=torch.int32), **KW)
    x, w = _t(o["x"]), _t(o["w"])
    with pytest.raises(ValueError, match="do not chain"):
        tfv.spmm_ell_fused_dense_grid(cols, vals, x, w, _t(o["b"][:, 1:]), **KW)
    with pytest.raises(ValueError, match="k_real"):
        tfv.spmm_ell_fused_dense_grid(cols, vals, x, w, _t(o["b"]),
                                      k_real=x.shape[0] + 1, **KW)


def test_schedule_runs_take_each_row_blocks_last_run():
    # steps: rb0 run [0, 2), rb1 run [2, 3), rb0 again [3, 5) -> rb0 keeps
    # its last run; rb2 is never visited -> nothing counted, zero output;
    # k-tile 33 lands in the second word, -1 and out-of-range ids drop out
    rb = [0, 0, 1, 0, 0, 0, 5]
    kb = [1, 2, 3, 31, 33, -1, 0]
    first = [1, 0, 1, 1, 0, 0, 0]
    bitmaps = tfv.schedule_tile_bitmaps(rb, kb, first, 3, 40)
    assert bitmaps.dtype == np.int32 and bitmaps.shape == (3, 2)
    words = bitmaps.view(np.uint32)
    assert words.tolist() == [[1 << 31, 1 << 1], [1 << 3, 0], [0, 0]]


def test_pad_operands_then_kernel_equals_unpadded_product():
    o = _operands(seed=6, f=24)
    e = o["ell"]
    cols, vals = _t(e.cols[:-5], torch.int32), _t(e.vals[:-5])
    dense = _t(o["dense"][:-3])
    cp, vp, dp, (r, f) = tfv.pad_operands(cols, vals, dense, BR, BK, BF)
    out = tfv.spmm_ell_dense_grid(cp, vp, dp, **KW)[:r, :f]
    torch.testing.assert_close(out, tfv.spmm_ell_dense_grid_plain(
        cols, vals, dense), rtol=0, atol=0)
