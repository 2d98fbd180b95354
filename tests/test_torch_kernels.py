"""The four FlexVector kernels of the port against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX kernels run as the JAX tests run them here (Pallas
interpret mode, blocks of 16).  The same inputs, made with numpy from a
seed, go to both.  Tolerance: 1e-5 of max|reference| — both sides sum
the same f32 products (at most tau per output for the aggregation,
F_in-long dot products for the fused layer's ``x @ w``) in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import preprocess as j_preprocess
from repro.core import random_power_law_csr as j_power_law
from repro.core.dataflow import plan_fused_k_schedule, plan_kernel_grid
from repro.exec import quant as jq
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


# -- storage precision: bf16 instantiations and the int8 ``_scaled`` variants --
#
# ``tests/test_quant.py``'s problem size (n=96, nnz=700, tau 5, blocks 16).
# Both sides get the same storage-dtype inputs: int8 values + f32 scales
# from the reference's quantizer, bf16 values / dense / x / w rounded once
# by JAX and carried across exactly.  Aggregation: 1e-5 of the output
# scale (the same f32 products, summed in another order).  Fused: 8e-3 —
# ``X W + b`` is summed in f32 in another order before its bf16 rounding
# (``cast_xw``), so an element near a rounding boundary can land one bf16
# ulp (2^-8 of itself) away.  Such flips are rare: at most
# QUANT_FLIP_SHARE of the elements may be off by more than RTOL of the
# scale, where a missing rounding moves most of them.
QUANT_FUSED_RTOL = 8e-3
QUANT_FLIP_SHARE = 1e-2


def flip_share(out, ref) -> float:
    """Share of elements off by more than RTOL of max|ref|."""
    out = np.asarray(out, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.mean(np.abs(out - ref) > RTOL * np.max(np.abs(ref))))


def _quant_operands(precision, seed=0, f=32, f_in=20):
    res = j_preprocess(j_power_law(96, 96, 700, seed=seed), tau=5,
                       tile_rows=16, edge_cut="rcm", pad_rows_to=BR)
    e = res.ell
    rng = np.random.default_rng(seed + 20)
    k = e.n_dense_rows

    def bf16(shape):
        return jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)

    if precision == "int8":
        vals, scales = jq.quantize_values(np.asarray(e.vals), BR)
        jvals, tvals = jnp.asarray(vals), _t(vals, torch.int8)
        jsc, tsc = dict(scales=jnp.asarray(scales)), dict(scales=_t(scales))
    else:
        jvals = jnp.asarray(e.vals, jnp.bfloat16)
        tvals = _t(np.asarray(jvals.astype(jnp.float32))).to(torch.bfloat16)
        jsc, tsc = {}, {}
    j = dict(cols=jnp.asarray(e.cols), vals=jvals, dense=bf16((k, f)),
             x=bf16((k, f_in)), w=bf16((f_in, f)),
             b=jnp.asarray(rng.standard_normal((1, f)), jnp.float32))
    t = {name: (_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
                if a.dtype == jnp.bfloat16 else _t(np.asarray(a)))
         for name, a in j.items() if name not in ("cols", "vals")}
    t.update(cols=_t(e.cols, torch.int32), vals=tvals)
    return e, j, jsc, t, tsc


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("kernel", ["dense_grid", "sparse_grid"])
def test_quant_aggregation_plain_matches_pallas(kernel, precision):
    e, j, jsc, t, tsc = _quant_operands(precision, seed=1)
    if kernel == "dense_grid":
        ref = jfv.spmm_ell_dense_grid(j["cols"], j["vals"], j["dense"], **KW,
                                      **jsc)
        out = tfv.spmm_ell_dense_grid(t["cols"], t["vals"], t["dense"], **KW,
                                      **tsc)
    else:
        rb, kb, first = _grid(e, drop_step=True)
        ref = jfv.spmm_ell_sparse_grid(j["cols"], j["vals"], j["dense"], rb,
                                       kb, first, **KW, **jsc)
        out = tfv.spmm_ell_sparse_grid(t["cols"], t["vals"], t["dense"],
                                       _bitmaps(e, (rb, kb, first)), **KW,
                                       **tsc)
    assert out.dtype == torch.float32
    assert rel_max_err(out, ref) <= RTOL


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("kernel", ["fused_dense_grid", "fused_sparse_grid"])
def test_quant_fused_plain_matches_pallas(kernel, precision):
    e, j, jsc, t, tsc = _quant_operands(precision, seed=2)
    k_real = e.n_dense_rows - 5
    jargs = [j[n] for n in ("cols", "vals", "x", "w", "b")]
    targs = [t[n] for n in ("cols", "vals", "x", "w", "b")]
    kw = dict(KW, k_real=k_real)
    if kernel == "fused_sparse_grid":
        kb = _fused_schedule(e, drop_and_pad=True)
        jargs.append(jnp.asarray(kb))
        targs.append(_t(kb, torch.int32))
    ref = getattr(jfv, f"spmm_ell_{kernel}")(*jargs, **kw, **jsc,
                                             cast_xw=jnp.bfloat16)
    out = getattr(tfv, f"spmm_ell_{kernel}")(*targs, **kw, **tsc,
                                             cast_xw=torch.bfloat16)
    assert rel_max_err(out, ref) <= QUANT_FUSED_RTOL
    assert flip_share(out, ref) <= QUANT_FLIP_SHARE
    # the share tells a missing cast_xw rounding apart
    unrounded = getattr(tfv, f"spmm_ell_{kernel}_plain")(*targs, **kw, **tsc)
    assert flip_share(unrounded, ref) > QUANT_FLIP_SHARE


def test_quant_wrappers_refuse_unsupported_types():
    _, _, _, t, tsc = _quant_operands("int8", seed=3)
    cols, q, dense = t["cols"], t["vals"], t["dense"]
    x, w, b = t["x"], t["w"], t["b"]
    with pytest.raises(TypeError, match="need scales"):
        tfv.spmm_ell_dense_grid(cols, q, dense, **KW)
    with pytest.raises(TypeError, match="dense must be torch.bfloat16"):
        tfv.spmm_ell_dense_grid(cols, q, dense.float(), **KW, **tsc)
    with pytest.raises(TypeError, match="scales= goes with int8"):
        tfv.spmm_ell_dense_grid(cols, q.to(torch.bfloat16), dense, **KW,
                                **tsc)
    with pytest.raises(TypeError, match="vals must be"):
        tfv.spmm_ell_dense_grid(cols, q.to(torch.float16), dense, **KW)
    with pytest.raises(TypeError, match="cast_xw"):
        tfv.spmm_ell_fused_dense_grid(cols, q, x, w, b, **KW, **tsc)
    with pytest.raises(TypeError, match="cast_xw"):
        tfv.spmm_ell_fused_dense_grid(cols, q.float(), x.float(), w.float(),
                                      b, **KW, cast_xw=torch.bfloat16)
    with pytest.raises(TypeError, match="b must be torch.float32"):
        tfv.spmm_ell_fused_dense_grid(cols, q, x, w, b.to(torch.bfloat16),
                                      **KW, **tsc, cast_xw=torch.bfloat16)
    # int8 launches with scales count under their own names, bf16 under
    # the kernel's; the aggregation kernels' other stores under keys of
    # their own
    assert set(tfv.KERNELS) == set(tfv.PLAIN) == set(tfv.LAUNCHES)
    aggregation = ("spmm_ell_dense_grid", "spmm_ell_sparse_grid")
    assert sorted(tfv.PRECISION_LAUNCHES) == sorted(
        [f"{n}@{p}" for n in tfv.LAUNCHES if not n.endswith("_scaled")
         for p in ("f32", "bf16")]
        + [f"{n}@int8" for n in tfv.LAUNCHES if n.endswith("_scaled")]
        + [f"{n}@{p}" for n in aggregation
           for p in ("f32->bf16", "bf16->bf16", "int8->int32")]
        + [f"{n}_scaled@int8->bf16" for n in aggregation])
    assert tfv.KERNELS["spmm_ell_dense_grid_scaled"] is tfv.spmm_ell_dense_grid


def test_column_slots_transpose_the_table():
    cols = np.array([[0, 70, -1], [65, 3, 127], [200, 64, 1]], np.int32)
    group, start, ids = tfv.column_slots(cols, 130)
    assert group.dtype == start.dtype == ids.dtype == np.int32
    # groups [0, 64), [64, 128), [128, 130); 200 >= K and -1 drop out;
    # the empty third group has no chunk
    assert group.tolist() == [0, 1]
    assert start.tolist() == [0, 3, 7]
    assert ids.tolist() == [0, 4, 8, 1, 3, 5, 7]


def test_column_slots_cut_hub_groups_into_chunks():
    """A hub column's group is cut into chunks of at most 4x the mean per
    non-empty group (and at least 256); every slot lands in one chunk of
    its own group, in flat order."""
    rng = np.random.default_rng(0)
    cols = rng.integers(0, 640, (3000, 6)).astype(np.int32)
    cols[:2000, :3] = 5                      # a hub column in group 0
    cols[rng.random(cols.shape) < 0.1] = -1
    group, start, ids = tfv.column_slots(cols, 640)
    sizes = np.diff(start)
    n_valid = int((cols >= 0).sum())
    mean = n_valid / 10
    # the hub group's chunks but its last are full
    assert sizes.max() == max(256, 32 * -(-int(4 * mean) // 32))
    assert (group == 0).sum() > 1 and (sizes > 0).all()
    assert sorted(ids.tolist()) == np.flatnonzero(cols.reshape(-1) >= 0).tolist()
    flat = cols.reshape(-1)
    for g, lo, hi in zip(group, start[:-1], start[1:]):
        chunk = ids[lo:hi]
        assert (flat[chunk] // 64 == g).all() and (np.diff(chunk) > 0).all()


@pytest.mark.parametrize("case", ["uniform", "hub", "sparse_with_hub"])
def test_max_column_chunks_bounds_column_slots(case):
    """``max_column_chunks`` (the serving batcher's per-rung chunk bound)
    is never below the chunks ``column_slots`` cuts, also where a hub
    group is cut into many chunks of the shortest length."""
    rng = np.random.default_rng(3)
    k = 6400 if case == "sparse_with_hub" else 640
    cols = rng.integers(0, k, (3000, 6)).astype(np.int32)
    if case == "hub":
        cols[:2000, :3] = 5
    elif case == "sparse_with_hub":
        # ~30 slots per group: the hub group is cut at MIN_CHUNK_SLOTS
        cols[:, 1:] = -1
        cols[:2000, 0] = 5
    group, _, _ = tfv.column_slots(cols, k)
    assert group.size <= tfv.max_column_chunks(k, cols.size)
    if case == "sparse_with_hub":
        hub = int((cols[:, 0] < tfv.XW_TILE_ROWS).sum())
        assert (group == 0).sum() == -(-hub // tfv.MIN_CHUNK_SLOTS) > 1


# -- the fused kernels' order of sums, emulated on the CPU ---------------------
#
# The CUDA fused kernels form X W + b per 64-row column group and add
# v * XW[c] into a zeroed output through the chunks of ``column_slots``.
# Walking the same chunks with ``index_add_`` from a materialized X W + b
# (rounded to bf16 under bf16/int8, as ``cast_xw`` does) must give the
# gather plain version: the same terms, each output row's tau of them
# summed in another order, so within RTOL of the scale at every precision.


def _scatter_case(case, seed=0):
    """``ragged``: the chip smoke test's ragged shapes (an empty row block,
    F_in and F not multiples of 4); ``hub``: two thirds of the rows share
    column 5 in three slots, so its group spans several chunks."""
    rng = np.random.default_rng(seed)
    r, tau, k, f, f_in = (64, 5, 48, 40, 37) if case == "ragged" else \
        (768, 5, 640, 40, 37)
    cols = rng.integers(0, k, (r, tau)).astype(np.int32)
    if case == "hub":
        cols[:2 * r // 3, :3] = 5
    cols[rng.random((r, tau)) < 0.3] = -1
    cols[2 * BR:3 * BR] = -1
    vals = rng.standard_normal((r, tau)).astype(np.float32)
    vals[cols < 0] = 0.0
    return dict(cols=cols, vals=vals, x=rng.standard_normal((k, f_in)),
                w=rng.standard_normal((f_in, f)),
                b=rng.standard_normal((1, f)), k_real=k - 5)


def _scatter_emulation(cols, vals, x, w, b, k_real, slots, cast_xw=None):
    """The fused kernel's order of sums with ``index_add_``: one chunk of
    slots at a time into a zeroed output, slots with a column >= k_real
    dropped."""
    with tfv.full_f32_matmul():
        xw = torch.matmul(x.float(), w.float()) + b
    xw[k_real:] = 0.0
    if cast_xw is not None:
        xw = xw.to(cast_xw).float()
    flat_cols = cols.reshape(-1).long()
    flat_vals = vals.reshape(-1).float()
    out = torch.zeros(cols.shape[0], w.shape[1])
    group, start, ids = (torch.as_tensor(a).long() for a in slots)
    for i in range(group.shape[0]):
        chunk = ids[start[i]:start[i + 1]]
        c = flat_cols[chunk]
        assert (c // tfv.XW_TILE_ROWS == group[i]).all()
        chunk, c = chunk[c < k_real], c[c < k_real]
        out.index_add_(0, chunk // cols.shape[1],
                       flat_vals[chunk, None] * xw[c])
    return out


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", ["ragged", "hub"])
def test_fused_scatter_order_matches_gather_plain(case, precision):
    c = _scatter_case(case)
    cols = _t(c["cols"], torch.int32)
    x, w, b = _t(c["x"]), _t(c["w"]), _t(c["b"])
    vals, kw = _t(c["vals"]), dict(KW, block_f=8, k_real=c["k_real"])
    slots = tfv.column_slots(c["cols"], x.shape[0])
    if case == "hub":
        assert (slots[0] == 0).sum() > 1        # the hub group is cut
    if precision != "f32":
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        kw["cast_xw"] = torch.bfloat16
        vals = vals.to(torch.bfloat16)
    if precision == "int8":
        q = _t(np.clip(np.rint(c["vals"] * 40), -127, 127), torch.int8)
        scales = _t(np.random.default_rng(1).uniform(
            0.01, 0.1, cols.shape[0] // BR))
        vals = q.float() * scales.repeat_interleave(BR)[:, None]
        kw["scales"] = scales
        ref = tfv.spmm_ell_fused_dense_grid(cols, q, x, w, b, **kw)
    else:
        ref = tfv.spmm_ell_fused_dense_grid(cols, vals, x, w, b, **kw)
    out = _scatter_emulation(cols, vals, x, w, b, c["k_real"], slots,
                             kw.get("cast_xw"))
    assert rel_max_err(out, ref) <= RTOL


def test_fused_operands_align_rows_to_16_bytes():
    """On the card the fused wrappers hand the kernel rows of ``x`` and
    ``w`` that start on 16-byte boundaries: zero columns of ``x`` with as
    many zero rows of ``w``, and ``w``'s rows at a stride ``ldw``; the
    dispatcher's padding (``pad_fused_operands`` with its K rows and F_out
    columns) is one copy of each, which the wrappers then take as it is."""
    rng = np.random.default_rng(0)
    for dtype, f_in_al, f_out, ldw_want in (
            (torch.float32, 40, 38, 40), (torch.bfloat16, 40, 38, 40),
            (torch.bfloat16, 40, 128, 128)):
        x = _t(rng.standard_normal((20, 37))).to(dtype)
        w = _t(rng.standard_normal((37, f_out))).to(dtype)
        xa, wa, ldw = tfv._fused_operands(x, w)
        assert xa.shape == (20, f_in_al) and wa.shape == (f_in_al, ldw)
        assert ldw == ldw_want
        assert xa.data_ptr() % 16 == 0 and wa.data_ptr() % 16 == 0
        assert not xa[:, 37:].any() and not wa[37:].any() \
            and not wa[:, f_out:].any()
        torch.testing.assert_close(
            (xa.double() @ wa.double())[:, :f_out], x.double() @ w.double())
        xp, wp = tfv.pad_fused_operands(x, w, k_rows=24, f_out=f_out + 2)
        assert xp.shape == (24, f_in_al) and wp.shape == (f_in_al, f_out + 2)
        assert not xp[20:].any() and not wp[:, f_out:].any()
        xq, wq = tfv.pad_fused_operands(xp, wp)
        assert xq is xp and wq is wp    # padded already: no new copy
    x = _t(rng.standard_normal((16, 602)))
    w = _t(rng.standard_normal((602, 32)))
    xa, wa, ldw = tfv._fused_operands(x, w)
    assert xa.shape == (16, 604) and wa.shape == (604, 32) and ldw == 32
    x = _t(rng.standard_normal((16, 40)))
    w = _t(rng.standard_normal((40, 32)))
    xa, wa, ldw = tfv._fused_operands(x, w)
    assert xa is x and wa is w and ldw == 32    # aligned: passed as they are


# -- the aggregation kernels' columns: real widths and L2 slabs ----------------


@pytest.mark.parametrize("k, f, dtype", [
    (233_088, 64, torch.float32), (233_088, 44, torch.float32),
    (233_088, 64, torch.bfloat16), (233_088, 48, torch.bfloat16),
    (300_000, 64, torch.float32), (300_000, 128, torch.bfloat16),
    (19_840, 64, torch.float32), (1, 4, torch.float32),
    (1, 136, torch.float32), (1, 8, torch.bfloat16),
    (4_000_000, 64, torch.float32),
])
def test_slab_width_covers_the_columns_within_the_budget(k, f, dtype):
    """Each slab is a whole number of 16-byte pieces and, unless one piece
    alone is over the budget, holds at most ``L2_SLAB_BYTES`` of the dense
    operand; the slabs cover ``f`` exactly, are as few as the budget
    allows and as even as the pieces allow."""
    size = torch.empty(0, dtype=dtype).element_size()
    per = 16 // size
    width = tfv.slab_width(k, f, dtype)
    n = -(-f // width)
    assert width > 0 and width % per == 0
    assert (n - 1) * width < f <= n * width            # covers f exactly
    assert k * width * size <= tfv.L2_SLAB_BYTES or width == per
    pieces = f // per
    if n > 1:                                          # the fewest slabs
        assert k * 16 * -(-pieces // (n - 1)) > tfv.L2_SLAB_BYTES
    assert width // per == -(-pieces // n)             # balanced
    if k * f * size > 50 * 2 ** 20:                    # more than the L2
        assert n >= 2


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("block_f", [4, 44, 48])
@pytest.mark.parametrize("kernel", ["dense_grid", "sparse_grid"])
def test_narrow_wrappers_match_plain_and_reference(kernel, block_f, precision):
    """B1/B2 at the narrow column extents the dispatcher now gives them:
    the wrapper equals its plain version and the JAX package's oracle
    (``repro.kernels.ref``; int8 dequantized by its quant oracle; B2 under
    the full schedule, which counts every slot)."""
    from repro.kernels import ref as jref

    e, j, jsc, t, tsc = _quant_operands(
        "int8" if precision == "int8" else "bf16", seed=4, f=block_f)
    dense = t["dense"]
    vals = t["vals"]
    if precision == "f32":
        dense, vals = dense.float(), vals.float()
    kw = dict(KW, block_f=block_f)
    args = (t["cols"], vals, dense)
    if kernel == "sparse_grid":
        args += (_bitmaps(e, _grid(e)),)
    name = f"spmm_ell_{kernel}" + ("_scaled" if precision == "int8" else "")
    out = tfv.KERNELS[name](*args, **kw, **tsc)
    assert out.shape == (e.cols.shape[0], block_f)
    torch.testing.assert_close(out, tfv.PLAIN[name](*args, **kw, **tsc),
                               rtol=0, atol=0)
    jdense = jnp.asarray(dense.float().numpy())
    if precision == "int8":
        ref = jref.spmm_ell_quant_ref(j["cols"], j["vals"], jsc["scales"],
                                      jdense, BR)
    else:
        ref = jref.spmm_ell_ref(j["cols"], jnp.asarray(vals.float().numpy()),
                                jdense)
    assert rel_max_err(out, ref) <= RTOL
