"""The port's dtype contract against the reference's, on the CPU.

The reference's kernels accumulate an integer dense operand in int32, take
a bf16 dense operand beside f32 values, and store ``out_dtype`` (its
"kernel accumulator override"); its f32 plans cast the values to the
dense operand's dtype.  The same numpy inputs go through both packages:
the reference's Pallas kernels in interpret mode, as its own tests run
them, and the port's kernels' plain PyTorch versions on CPU tensors.
The last cases hold the remaining parameters the port took from the
reference (``spmm_ell(mesh=)``, ``lm.forward(remat=)``,
``run_cell(donate=)``) and the refusals of what the port does not
compute.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import preprocess as j_preprocess
from repro.core import random_power_law_csr as j_random_csr
from repro.core import spmm_ell as j_spmm_ell
from repro.core.spmm import spmm_dense_oracle
from repro.exec import SpmmOperands as JOperands
from repro.exec import SpmmPlan as JPlan
from repro.exec import execute_layer as j_execute_layer
from repro.kernels import ops as j_ops
from repro.kernels.ref import spmm_ell_ref as j_spmm_ell_ref

from repro_torch.core import spmm_ell
from repro_torch.core.sparse_formats import TiledELL
from repro_torch.exec import SpmmOperands, SpmmPlan, execute_layer
from repro_torch.kernels import flexvector_spmm as fv
from repro_torch.kernels import ops
from repro_torch.kernels.ref import spmm_ell_ref

from _torch_dist import run_ranks

IMPLS = {"reference": "reference", "cuda": "pallas",
         "cuda_sparse": "pallas_sparse"}
BLOCKS = dict(block_rows=16, block_k=16, block_f=8)
# Both packages sum the same f32 products (bf16 values widened, or bf16
# products widened) in f32, in another order: a few f32 ulps of the
# output's scale.
F32_REL = 1e-5
# The reference's kernels add each k-tile's sums into their bf16 output
# block (``out_ref +=`` at bf16), rounding at every k-tile (2^-9 of the
# partial sum each); the port's kernels sum in f32 and round once.  Over
# this problem's three k-tiles and the bf16 vertex-cut fold both share,
# the two land at most one bf16 ulp of max|out| apart (2^-8, 3.9e-3); the
# bar is two (2^-7), well below test_kernel_bf16's 5e-2.
BF16_STORE_REL = 2 ** -7


def _problem(n, nnz, tau, fdim, seed):
    """The reference test's problem (tests/test_spmm_kernel.py::_problem):
    its preprocessed ELL and a dense operand."""
    adj = j_random_csr(n, n, nnz, seed=seed)
    res = j_preprocess(adj, tau=tau, tile_rows=16, edge_cut="rcm")
    dense = np.random.default_rng(seed + 1).standard_normal(
        (n, fdim)).astype(np.float32)
    return res.ell, dense


def _port_ell(ell, vals=None) -> TiledELL:
    return TiledELL(cols=np.asarray(ell.cols),
                    vals=np.asarray(ell.vals if vals is None else vals),
                    row_map=np.asarray(ell.row_map),
                    n_dense_rows=ell.n_dense_rows,
                    n_orig_rows=ell.n_orig_rows)


def _int8_problem():
    """``test_kernel_int8_exact``'s problem: int8 values (the ELL's times
    12, rounded) and an int8 dense operand in [-9, 9)."""
    ell, _ = _problem(64, 500, 4, 24, seed=1)
    q = np.clip(np.round(ell.vals * 12), -127, 127).astype(np.int8)
    dense8 = np.random.default_rng(2).integers(-9, 9, (64, 24)).astype(
        np.int8)
    return dataclasses.replace(ell, vals=q), dense8


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32), np.float64)


# -- spmm_ell_ref(out_dtype=) --------------------------------------------------


@pytest.mark.parametrize("dense_dtype, out_dtype", [
    ("float32", None), ("float32", "bfloat16"), ("bfloat16", None),
    ("bfloat16", "bfloat16"), ("int8", None), ("int8", "int32"),
    ("int8", "float32"),
])
def test_spmm_ell_ref_out_dtype_matches_the_reference(dense_dtype, out_dtype):
    """The oracle's default (int32 for an integer operand, else f32) and
    its override: the same dtype as the reference's, and its values (bf16
    products rounded to bf16 and summed in f32 in both)."""
    ell, dense = _problem(48, 300, 5, 16, seed=3)
    rng = np.random.default_rng(4)
    vals = np.asarray(ell.vals)
    if dense_dtype == "int8":
        vals = np.clip(np.round(vals * 12), -127, 127).astype(np.int8)
        dense = rng.integers(-9, 9, dense.shape).astype(np.int8)
    jd = jnp.asarray(dense, getattr(jnp, dense_dtype))
    jv = jnp.asarray(vals)
    want = j_spmm_ell_ref(jnp.asarray(ell.cols), jv, jd,
                          out_dtype=None if out_dtype is None
                          else getattr(jnp, out_dtype))
    td = torch.as_tensor(np.asarray(jd.astype(jnp.float32))).to(
        getattr(torch, dense_dtype))
    got = spmm_ell_ref(torch.as_tensor(np.asarray(ell.cols)),
                       torch.as_tensor(vals), td,
                       out_dtype=None if out_dtype is None
                       else getattr(torch, out_dtype))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    if not got.dtype.is_floating_point:
        assert np.array_equal(got.numpy(), np.asarray(want))
    elif got.dtype == torch.bfloat16:
        # one bf16 rounding of an f32 sum taken in another order
        assert _rel(_np(got), _np(want)) <= 2 ** -8
        assert (_np(got) != _np(want)).mean() <= 1e-2
    else:
        assert _rel(_np(got), _np(want)) <= F32_REL


# -- int8 x int8 -> int32 ------------------------------------------------------


@pytest.mark.parametrize("impl", list(IMPLS))
def test_kernel_int8_exact(impl):
    """``tests/test_spmm_kernel.py::test_kernel_int8_exact`` on the port:
    int8 values x an int8 operand give int32, equal to the reference's
    kernels' answer and to the f64 oracle, under every impl.

    The reference's own ``reference`` impl multiplies in int8 before its
    int32 sum, so a product past 127 wraps (its answer is off by multiples
    of 256 where one does); the port's takes each product in int32, so its
    ``reference`` impl is held to the reference's kernels instead."""
    ell8, dense8 = _int8_problem()
    want = j_spmm_ell(ell8, jnp.asarray(dense8), impl=IMPLS[impl],
                      interpret=True, **BLOCKS)
    assert want.dtype == jnp.int32
    if impl == "reference":
        wrapped = np.asarray(want)
        want = j_spmm_ell(ell8, jnp.asarray(dense8), impl="pallas",
                          interpret=True, **BLOCKS)
        off = wrapped - np.asarray(want)
        assert off.any() and not (off % 256).any()
    got = spmm_ell(_port_ell(ell8), torch.as_tensor(dense8), impl=impl,
                   device="cpu", **BLOCKS)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    oracle = spmm_dense_oracle(ell8, dense8.astype(np.float64))
    assert np.array_equal(got.numpy().astype(np.float64), oracle)


@pytest.mark.parametrize("kernel", ["dense_grid", "sparse_grid"])
def test_int8_exact_kernels_pad_to_whole_pieces(kernel):
    """The int32 instantiation's operand in 16-column pieces: an int8 row
    of 41 columns (the main path's output layer) is padded to 48 and the
    output cut back; int32 sums exact where f32 ones would round (past
    2^24)."""
    rng = np.random.default_rng(7)
    r, tau, k = 32, 6, 40
    cols = rng.integers(-1, k, (r, tau)).astype(np.int32)
    q = rng.integers(-127, 128, (r, tau)).astype(np.int8)
    q[cols < 0] = 0
    dense = rng.integers(-128, 128, (k, 41)).astype(np.int8)
    assert fv.aligned_width(41, torch.int8) == 48
    args = [torch.as_tensor(cols), torch.as_tensor(q),
            torch.as_tensor(dense)]
    kw = dict(block_rows=16, block_k=8, block_f=1)
    if kernel == "sparse_grid":
        args.append(torch.full((r // 16, 1), -1, dtype=torch.int32))
    got = getattr(fv, f"spmm_ell_{kernel}")(*args, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (r, 41)
    keep = cols >= 0
    want = (q.astype(np.int64)[..., None] * dense.astype(np.int64)[
        np.where(keep, cols, 0)] * keep[..., None]).sum(axis=1)
    assert np.array_equal(got.numpy(), want)
    # a sum past 2^24, where an f32 accumulator would round: 1,100 slots
    # of 127 x 127
    tau_big = 1100
    out = fv.spmm_ell_dense_grid(
        torch.zeros(16, tau_big, dtype=torch.int32),
        torch.full((16, tau_big), 127, dtype=torch.int8),
        torch.full((16, 16), 127, dtype=torch.int8),
        block_rows=16, block_k=16, block_f=16)
    assert out.dtype == torch.int32
    assert int(out[0, 0]) == tau_big * 127 * 127 > 2 ** 24


# -- bf16 dense operands --------------------------------------------------------


def test_kernel_bf16():
    """``tests/test_spmm_kernel.py::test_kernel_bf16`` on the port: f32
    ELL values beside a bf16 operand through ``flexvector_spmm``, against
    the reference's wrapper and its oracle."""
    ell, dense = _problem(48, 300, 5, 16, seed=3)
    want = j_ops.flexvector_spmm(ell, jnp.asarray(dense, jnp.bfloat16),
                                 interpret=True, **BLOCKS)
    bf = torch.as_tensor(dense).to(torch.bfloat16)
    got = ops.flexvector_spmm(_port_ell(ell), bf, device="cpu", **BLOCKS)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert _rel(_np(got), _np(want)) <= F32_REL
    ref = j_spmm_ell_ref(jnp.asarray(ell.cols),
                         jnp.asarray(ell.vals, jnp.bfloat16),
                         jnp.asarray(dense, jnp.bfloat16))
    np.testing.assert_allclose(_np(got)[:ref.shape[0]], _np(ref),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_spmm_ell_bf16_dense_keeps_the_references_dtype(impl):
    """A bf16 operand under the default f32 plan: the values are cast to
    bf16 (the reference's f32 branch), the kernels return f32 and the
    reference impl bf16 (its f32 sum rounded once), in both packages; both
    sum the same exact products of bf16 values in f32."""
    ell, dense = _problem(48, 300, 5, 16, seed=3)
    want = j_spmm_ell(ell, jnp.asarray(dense, jnp.bfloat16),
                      impl=IMPLS[impl], interpret=True, **BLOCKS)
    got = spmm_ell(_port_ell(ell), torch.as_tensor(dense).to(torch.bfloat16),
                   impl=impl, device="cpu", **BLOCKS)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert _rel(_np(got), _np(want)) <= F32_REL


# -- SpmmPlan(out_dtype=) --------------------------------------------------------


def _gcn_layer(seed=5):
    ell, _ = _problem(48, 300, 5, 16, seed=3)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ell.n_dense_rows, 12)).astype(np.float32)
    w = (rng.standard_normal((12, 20)) / 4).astype(np.float32)
    b = rng.standard_normal(20).astype(np.float32)
    return ell, x, w, b


@pytest.mark.parametrize("impl, fused", [
    ("reference", False), ("cuda", False), ("cuda_sparse", False),
    ("cuda", True), ("cuda_sparse", True)])
def test_out_dtype_bf16_layer_matches_the_reference(impl, fused):
    """One GCN layer under ``SpmmPlan(out_dtype=torch.bfloat16)``: the
    kernels store bf16 (the fused ones round their f32 output once) and
    the fold runs in bf16, as the reference's; the reference impl (never
    fused) does not read ``out_dtype`` in either package.  Within
    BF16_STORE_REL."""
    ell, x, w, b = _gcn_layer()
    jplan = JPlan(impl=IMPLS[impl], fused=fused, out_dtype=jnp.bfloat16,
                  interpret=True, **BLOCKS)
    want = j_execute_layer(jplan, JOperands.from_ell(ell), jnp.asarray(x),
                           {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    plan = SpmmPlan(impl=impl, fused=fused, out_dtype=torch.bfloat16,
                    **BLOCKS)
    got = execute_layer(plan, SpmmOperands.from_ell(_port_ell(ell), "cpu"),
                        torch.as_tensor(x),
                        {"w": torch.as_tensor(w), "b": torch.as_tensor(b)})
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    tol = F32_REL if impl == "reference" else BF16_STORE_REL
    assert _rel(_np(got), _np(want)) <= tol


def test_out_dtype_rounds_once_where_the_reference_rounds_per_k_tile():
    """The port's bf16 store is the f32 result rounded once: equal to the
    f32 plan's answer rounded to bf16, row by row, before the bf16 fold."""
    ell, dense = _problem(48, 300, 5, 16, seed=3)
    ops_ = SpmmOperands.from_ell(_port_ell(ell), "cpu")
    from repro_torch.exec.dispatch import sub_row_products

    d = torch.as_tensor(dense)
    for impl in ("cuda", "cuda_sparse"):
        f32 = SpmmPlan(impl=impl, **BLOCKS).resolve(schedulable=True)
        bf = dataclasses.replace(f32, out_dtype=torch.bfloat16)
        v = ops_.values_for("f32", 16)[0]
        assert torch.equal(sub_row_products(bf, ops_, v, d),
                           sub_row_products(f32, ops_, v, d).to(
                               torch.bfloat16))


def test_out_dtype_sharded_matches_the_reference():
    """Two gloo ranks on the CPU: the sharded aggregation (both grids),
    the fused layer and the reference impl under ``out_dtype=bf16``, and
    the int8 x int8 product, against the reference's single-device
    answers.  The fold and its all-reduce run in bf16 (int32): no
    collective is widened."""
    ell, x, w, b = _gcn_layer()
    _, dense = _problem(48, 300, 5, 16, seed=3)
    ell8, dense8 = _int8_problem()
    host = {"ell": dataclasses.asdict(_port_ell(ell)),
            "ell8": dataclasses.asdict(_port_ell(ell8)),
            "dense": dense, "dense8": dense8, "x": x, "w": w, "b": b}
    ranks = run_ranks("_torch_dtype_ranks", "sharded_dtypes", 2,
                      args=(host, BLOCKS))
    got = ranks[0]
    assert ranks[1].keys() == got.keys()
    operands = JOperands.from_ell(ell)
    for impl in ("cuda", "cuda_sparse", "reference"):
        want = j_spmm_ell(ell, jnp.asarray(dense), plan=JPlan(
            impl=IMPLS[impl], out_dtype=jnp.bfloat16, interpret=True,
            **BLOCKS))
        out = got[f"spmm {impl}"]
        assert out["dtype"] == str(want.dtype), impl
        tol = F32_REL if impl == "reference" else BF16_STORE_REL
        assert _rel(out["value"], _np(want)) <= tol, impl
        assert out["collective_dtype"] == out["dtype"]
    for impl in ("cuda", "cuda_sparse"):
        want = j_execute_layer(
            JPlan(impl=IMPLS[impl], fused=True, out_dtype=jnp.bfloat16,
                  interpret=True, **BLOCKS), operands, jnp.asarray(x),
            {"w": jnp.asarray(w), "b": jnp.asarray(b)})
        out = got[f"fused {impl}"]
        assert out["dtype"] == str(want.dtype) == "bfloat16"
        assert _rel(out["value"], _np(want)) <= BF16_STORE_REL
        want8 = j_spmm_ell(ell8, jnp.asarray(dense8), impl=IMPLS[impl],
                           interpret=True, **BLOCKS)
        out = got[f"int8 {impl}"]
        assert out["dtype"] == "int32" == str(want8.dtype)
        assert np.array_equal(out["value"], np.asarray(want8))
    # the mesh= shorthand runs the same sharded plan
    assert np.array_equal(got["mesh shorthand"]["value"],
                          got["spmm cuda f32"]["value"])


# -- the other parameters ----------------------------------------------------------


def test_spmm_ell_mesh_shorthand():
    """``spmm_ell(mesh=)`` puts the mesh on the plan it builds (a 1-wide
    data axis runs on one device), and raises beside ``plan=``, as the
    reference does."""
    from repro_torch.dist.topology import abstract_mesh

    ell, dense = _problem(48, 300, 5, 16, seed=3)
    tell, d = _port_ell(ell), torch.as_tensor(dense)
    mesh = abstract_mesh((1,), ("data",))
    got = spmm_ell(tell, d, impl="cuda", mesh=mesh, device="cpu", **BLOCKS)
    assert torch.equal(got, spmm_ell(tell, d, impl="cuda", device="cpu",
                                     **BLOCKS))
    with pytest.raises(ValueError, match="not both"):
        spmm_ell(tell, d, plan=SpmmPlan(), mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        j_spmm_ell(ell, jnp.asarray(dense), plan=JPlan(), mesh=object())


def test_lm_forward_remat_gives_the_same_logits():
    """``lm.forward(remat=True)`` is ``forward_hidden``'s remat: the same
    logits as ``remat=False``, and as the reference's under ``remat``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm

    cfg = reduced(get_config("qwen3-8b"))
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    with torch.no_grad():
        plain = lm.forward(params, cfg, tokens)
        remat = lm.forward(params, cfg, tokens, remat=True)
    assert remat.dtype == torch.float32
    assert torch.equal(plain, remat)


@pytest.mark.parametrize("donate", [True, False])
def test_run_cell_takes_donate(donate):
    """``run_cell(donate=)``: the record the reference's keys, donation
    read as the reference reads it (``alias_bytes``: the decode step
    updates nothing in place, so 0 either way) and nothing else moved by
    it."""
    import repro_torch.configs as C
    from repro_torch.launch import dryrun as D

    full = C.get_config
    C.get_config = lambda name: D._reduced_depth(full(name), 1)
    try:
        rec = D.run_cell("internlm2-1.8b", "decode_32k", False,
                         donate=donate, chips=8, model_parallel=2,
                         device="cpu")
    finally:
        C.get_config = full
    assert rec["memory_per_device"]["alias_bytes"] == 0
    assert rec["cost_analysis"]["flops_per_device"] > 0


def test_run_cell_donate_counts_in_place_bytes_as_aliased(monkeypatch):
    """Under ``donate`` a train step's in-place params and moments are its
    aliased bytes (the reference's donated buffers); without it, none.
    The step itself is stubbed: only the record's reading is tested."""
    from repro_torch.launch import dryrun as D

    seen = []

    def fake_step(cfg, shape, mesh, plan, donate=True):
        seen.append(donate)
        return {"lower_s": 0.0, "compile_s": 0.0, "flops": 1.0,
                "bytes": 1.0, "coll": {"total": 0.0, "op_counts": {}},
                "hlo_lines": 1,
                "memory": {"argument_bytes": 8, "output_bytes": 8,
                           "alias_bytes": 8 if donate else 0,
                           "peak_bytes_est": 16}}

    monkeypatch.setattr(D, "_run_step", fake_step)
    for donate in (True, False):
        rec = D.run_cell("internlm2-1.8b", "train_4k", False, donate=donate,
                         body_correction=False, chips=8, model_parallel=2,
                         device="cpu")
        assert rec["memory_per_device"]["alias_bytes"] == (8 if donate
                                                           else 0)
    assert seen == [True, False]


# -- refusals --------------------------------------------------------------------


def test_plan_refuses_an_unknown_out_dtype():
    with pytest.raises(ValueError, match="float64"):
        SpmmPlan(out_dtype=torch.float64)
    with pytest.raises(ValueError, match="float16"):
        SpmmPlan(out_dtype=torch.float16)


@pytest.mark.parametrize("case", ["int32_beside_f32", "bf16_beside_int8",
                                  "f32_beside_int8", "fused_int32",
                                  "int8_without_scales_beside_bf16"])
def test_kernels_refuse_what_they_do_not_compute(case):
    """Each out_dtype or operand pair the kernels do not compute raises,
    naming it: nothing is computed in another dtype and cast."""
    rng = np.random.default_rng(0)
    cols = torch.as_tensor(rng.integers(0, 16, (16, 3)).astype(np.int32))
    vals = torch.as_tensor(rng.standard_normal((16, 3)).astype(np.float32))
    q = vals.mul(10).round().to(torch.int8)
    dense = torch.as_tensor(rng.standard_normal((16, 8)).astype(np.float32))
    d8 = dense.mul(10).round().to(torch.int8)
    kw = dict(block_rows=16, block_k=16, block_f=8)
    if case == "int32_beside_f32":
        with pytest.raises(TypeError, match="int32"):
            fv.spmm_ell_dense_grid(cols, vals, dense, out_dtype=torch.int32,
                                   **kw)
    elif case == "bf16_beside_int8":
        with pytest.raises(TypeError, match="bfloat16"):
            fv.spmm_ell_dense_grid(cols, q, d8, out_dtype=torch.bfloat16,
                                   **kw)
    elif case == "f32_beside_int8":
        with pytest.raises(TypeError, match="float32"):
            fv.spmm_ell_sparse_grid(
                cols, q, d8, torch.ones(1, 1, dtype=torch.int32),
                out_dtype=torch.float32, **kw)
    elif case == "fused_int32":
        w = torch.ones(8, 8)
        b = torch.zeros(1, 8)
        with pytest.raises(TypeError, match="int32"):
            fv.spmm_ell_fused_dense_grid(cols, vals, dense, w, b,
                                         out_dtype=torch.int32, **kw)
    else:
        with pytest.raises(TypeError, match="need scales"):
            fv.spmm_ell_dense_grid(cols, q, dense.to(torch.bfloat16), **kw)
