"""Storage precision of the port against ``repro.exec.quant``.

The quantization helpers must be bit-equal to the reference's: int8
``q`` and ``scales`` (both compute in f32 in the same order and round
half to even), dequantized values, re-blocked scales, the quantized ELL
artifact, and what the dispatcher hands the kernels under every pair of
stored and planned precision.  Inputs are made with numpy from a seed and
given to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import preprocess as j_preprocess
from repro.core import random_power_law_csr as j_power_law
from repro.exec import SpmmPlan as JPlan
from repro.exec import execute as j_execute
from repro.exec import quant as jq
from repro.exec.dispatch import prepare_precision as j_prepare_precision
from repro.exec.operands import SpmmOperands as JOperands
from repro.kernels import ref as jref

from repro_torch.core.preprocessing import preprocess as t_preprocess
from repro_torch.core.sparse_formats import random_power_law_csr as t_power_law
from repro_torch.exec import quant as tq
from repro_torch.exec.dispatch import execute as t_execute
from repro_torch.exec.dispatch import prepare_precision as t_prepare_precision
from repro_torch.exec.operands import SpmmOperands as TOperands
from repro_torch.exec.plan import IMPL_NAMES
from repro_torch.exec.plan import SpmmPlan as TPlan
from repro_torch.kernels import ref as tref


def _np(a) -> np.ndarray:
    """Any jax / torch / numpy array as numpy (bf16 widened to f32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _bit_equal(out, ref) -> bool:
    out, ref = _np(out), _np(ref)
    return (out.dtype == ref.dtype and out.shape == ref.shape
            and out.tobytes() == ref.tobytes())


#: (shape, block_rows) — padded last blocks, one partial block, 1-D and 3-D
VALUE_CASES = [((96, 5), 32), ((100, 6), 16), ((7, 3), 128), ((50,), 8),
               ((40, 2, 3), 8)]


def _values(shape, seed):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(shape) * rng.uniform(0.01, 50.0)).astype(np.float32)
    v[: min(8, shape[0])] = 0.0                 # an all-zero block
    v.reshape(-1)[-1] = 1000.0                  # an outlier in the last block
    return v


@pytest.mark.parametrize("case", range(len(VALUE_CASES)))
def test_quantize_values_bit_equal(case):
    shape, br = VALUE_CASES[case]
    v = _values(shape, case)
    jq_, js = jq.quantize_values(v, br)
    tq_, ts = tq.quantize_values(torch.as_tensor(v), br)
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    assert _bit_equal(tq_, jq_) and _bit_equal(ts, js)
    assert _bit_equal(tq.dequantize_values(tq_, ts, br),
                      jq.dequantize_values(jq_, js, br))
    n = shape[0] + 5   # rows past the last scaled block take 1.0
    assert _bit_equal(tq.row_scales(ts, br, n), jq.row_scales(js, br, n))


@pytest.mark.parametrize("sbr,br", [(64, 64), (64, 16), (64, 48), (32, 64)])
def test_align_scales_matches_reference(sbr, br):
    scales = np.asarray([0.5, 2.0, 3.0], dtype=np.float32)
    ref = jq.align_scales(scales, sbr, br)
    out = tq.align_scales(torch.as_tensor(scales), sbr, br)
    assert (out is None) == (ref is None)
    if ref is not None:
        assert _bit_equal(out, ref)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {f"layer_{i}": {"w": rng.standard_normal(s).astype(np.float32),
                           "b": rng.standard_normal(s[1]).astype(np.float32)}
            for i, s in enumerate([(200, 64), (64, 7)])}


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_quantize_params_bit_equal(precision):
    params = _params()
    tparams = {n: {k: torch.as_tensor(v) for k, v in l.items()}
               for n, l in params.items()}
    ref = jq.quantize_params(params, precision, 64)
    out = tq.quantize_params(tparams, precision, 64)
    if precision == "f32":
        assert out is tparams
        return
    for name in params:
        assert set(out[name]) == set(ref[name])
        for key in ref[name]:
            assert _bit_equal(out[name][key], ref[name][key]), (name, key)


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_affine_matches_reference(precision):
    """bf16 multiplies, f32 sums: both sides take exact products of bf16
    values and sum 200 of them in f32 in another order, so they agree to
    a few f32 ulps of the output scale (1e-6)."""
    params = _params(1)
    x = np.random.default_rng(2).standard_normal((50, 200)).astype(np.float32)
    layer = params["layer_0"]
    jlayer = jq.quantize_params(params, precision, 32)["layer_0"]
    tlayer = tq.quantize_params(
        {"l": {k: torch.as_tensor(v) for k, v in layer.items()}},
        precision, 32)["l"]
    ref = _np(jq.affine(jnp.asarray(x), jlayer, precision, 32))
    out = tq.affine(torch.as_tensor(x), tlayer, precision, 32)
    assert out.dtype == torch.float32
    assert np.abs(_np(out) - ref).max() <= 1e-6 * np.abs(ref).max()


def _ells(n=96, nnz=700, tau=5, seed=0):
    kw = dict(tau=tau, tile_rows=16, edge_cut="rcm")
    return (j_preprocess(j_power_law(n, n, nnz, seed=seed), **kw).ell,
            t_preprocess(t_power_law(n, n, nnz, seed=seed), **kw).ell)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_quantize_ell_bit_equal(precision):
    jell, tell = _ells()
    ref = jq.quantize_ell(jell, precision, 16)
    out = tq.quantize_ell(tell, precision, 16)
    assert out.precision == ref.precision and out.block_rows == 16
    assert out.n_out_rows == ref.n_out_rows and out.nbytes == ref.nbytes
    for key in ("cols", "vals", "row_map"):
        assert _bit_equal(getattr(out, key), getattr(ref, key)), key
    assert (out.scales is None) == (ref.scales is None)
    if ref.scales is not None:
        assert _bit_equal(out.scales, ref.scales)
    with pytest.raises(ValueError, match="f32 needs no quantized artifact"):
        tq.quantize_ell(tell, "f32")


def _operands(stored, jell, tell, sbr=16):
    if stored == "f32":
        return JOperands.from_ell(jell), TOperands.from_ell(tell, "cpu")
    return (jq.quantize_ell(jell, stored, sbr).operands(jell),
            tq.quantize_ell(tell, stored, sbr).operands(tell, "cpu"))


@pytest.mark.parametrize("block_rows", [16, 8, 32])   # aligned, finer, straddling
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("stored", ["f32", "bf16", "int8"])
def test_prepare_precision_bit_equal(stored, precision, block_rows):
    """What the kernels get — values, scales, dense — under every pair of
    stored and planned precision, including int8 storage whose 16-row
    scale blocks straddle 32-row kernel blocks (dequantized, carried at
    bf16)."""
    jell, tell = _ells(seed=1)
    jops, tops = _operands(stored, jell, tell)
    dense = np.random.default_rng(3).standard_normal(
        (jell.n_dense_rows, 24)).astype(np.float32)
    kw = dict(block_rows=block_rows, block_k=16, block_f=16,
              precision=precision)
    jv, js, jd = j_prepare_precision(JPlan(impl="pallas", **kw), jops,
                                     jnp.asarray(dense))
    tv, ts, td = t_prepare_precision(TPlan(impl="cuda", **kw), tops,
                                     torch.as_tensor(dense))
    assert _bit_equal(tv, jv) and _bit_equal(td, jd)
    assert (ts is None) == (js is None)
    if js is not None:
        assert _bit_equal(ts, js)
    # built once per operand: a second call hands back the same tensors
    again = t_prepare_precision(TPlan(impl="cuda", **kw), tops,
                                torch.as_tensor(dense))
    assert again[0] is tv and again[1] is ts


@pytest.mark.parametrize("block_rows", [16, 32], ids=["aligned", "straddling"])
@pytest.mark.parametrize("impl", ["reference", "pallas", "pallas_sparse"])
def test_execute_int8_artifact_matches_reference(impl, block_rows):
    """An int8 artifact through ``execute`` under an int8 plan: 1e-5 of the
    output scale (the same f32 products, summed in another order)."""
    jell, tell = _ells(seed=2)
    jops, tops = _operands("int8", jell, tell)
    dense = np.random.default_rng(4).standard_normal(
        (jell.n_dense_rows, 24)).astype(np.float32)
    kw = dict(block_rows=block_rows, block_k=16, block_f=16, precision="int8")
    ref = _np(j_execute(JPlan(impl=impl, **kw), jops, jnp.asarray(dense)))
    out = _np(t_execute(TPlan(impl=IMPL_NAMES[impl], **kw), tops,
                        torch.as_tensor(dense)))
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_logit_error_bit_equal():
    rng = np.random.default_rng(5)
    ref = rng.standard_normal((30, 4)).astype(np.float32)
    test = ref + rng.standard_normal((30, 4)).astype(np.float32) * 1e-3
    assert tq.logit_error(torch.as_tensor(ref), torch.as_tensor(test)) == \
        jq.logit_error(ref, test)
    assert tq.logit_error(ref, ref) == 0.0


def test_storage_dtypes_and_byte_tables():
    assert tq.PRECISIONS == jq.PRECISIONS
    assert tq.QUANT_BLOCK_ROWS == jq.QUANT_BLOCK_ROWS
    for p in tq.PRECISIONS:
        assert tq.bytes_per_value(p) == jq.bytes_per_value(p)
        assert tq.activation_bytes(p) == jq.activation_bytes(p)
        assert str(tq.storage_dtype(p)).split(".")[-1].replace(
            "float32", "f32") == {"f32": "f32", "bf16": "bfloat16",
                                  "int8": "int8"}[p]
    d = torch.ones(3, 2)
    assert tq.cast_dense(d, "f32") is d
    assert tq.cast_dense(d, "int8").dtype == torch.bfloat16


def test_quant_oracles_match_reference():
    """``spmm_ell_quant_ref`` and ``expand_block_ref`` against the
    reference's oracles on the same inputs (f32 sums of tau terms: 1e-6;
    the expansion places each value exactly)."""
    jell, _ = _ells(seed=6)
    cols = np.asarray(jell.cols)
    q, scales = jq.quantize_values(np.asarray(jell.vals), 16)
    dense = np.random.default_rng(7).standard_normal(
        (jell.n_dense_rows, 12)).astype(np.float32)
    ref = _np(jref.spmm_ell_quant_ref(cols, q, scales[:-1], dense, 16))
    out = _np(tref.spmm_ell_quant_ref(torch.as_tensor(cols), torch.as_tensor(q),
                                      torch.as_tensor(scales[:-1]),
                                      torch.as_tensor(dense), 16))
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    vals = np.asarray(jell.vals)
    for kb_base in (0, 16, 48):
        ref = _np(jref.expand_block_ref(cols[:16], vals[:16], kb_base, 16))
        out = _np(tref.expand_block_ref(torch.as_tensor(cols[:16]),
                                        torch.as_tensor(vals[:16]), kb_base, 16))
        assert _bit_equal(out, ref)
