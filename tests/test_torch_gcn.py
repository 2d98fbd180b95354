"""Full-graph GCN inference of the port against ``repro.models.gcn``.

The same graph, features and parameters (the reference's ``init_params``,
carried across with ``params_from_numpy``) go through both packages, for
every impl (``reference | pallas | pallas_sparse`` and the port's
``reference | cuda | cuda_sparse``), unfused and fused.  The reference's
Pallas kernels run in interpret mode here, the port's plain versions on
the CPU.  Tolerance: max|port - reference| <= 1e-5 * max|reference| —
both sides sum the same f32 products in another order (the reference's
own fused and unfused f32 outputs differ by ~1e-7 of their scale).  The
DRAM ledger, a host-side byte model, must match exactly.

At bf16/int8 storage the same 1e-5 holds: the weights quantize bit-equal
(``tests/test_torch_quant.py``), and on these inputs no f32 sum taken in
another order lands on the other side of a bf16 rounding (one such flip
would show as ~1e-3).  Against the f32 reference both stay within the
reference's own logit budgets (``tests/test_quant.py``): bf16 <= 0.02,
int8 <= 0.05.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import random_power_law_csr as j_power_law
from repro.dist.collectives import LEDGER as J_LEDGER
from repro.exec import plan_for_config as j_plan_for_config
from repro.exec import quant as jq
from repro.models import gcn as jgcn

from repro_torch.core.sparse_formats import random_power_law_csr as t_power_law
from repro_torch.dist.collectives import LEDGER as T_LEDGER
from repro_torch.exec.plan import IMPL_NAMES
from repro_torch.models import gcn as tgcn
from repro_torch.models.convert import params_from_numpy

RTOL = 1e-5
IMPLS = ["reference", "pallas", "pallas_sparse"]
LOGIT_BUDGET = {"bf16": 0.02, "int8": 0.05}


def rel_max_err(out, ref) -> float:
    out = np.asarray(out, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(out - ref))) / max(float(np.max(np.abs(ref))), 1e-30)

#: name -> (n, nnz, alpha, in_dim, hidden, out_dim, blocks)
CASES = {
    # tests/test_fused.py::_case's graph
    "fused_case": (96, 700, 2.1, 12, 64, 8, 16),
    # a larger, more skewed power-law graph: hub rows split by the vertex-cut
    "skewed": (320, 5000, 2.8, 24, 32, 5, 32),
}


def _dims(case):
    n, nnz, alpha, d_in, hidden, d_out, blocks = CASES[case]
    return dict(in_dim=d_in, hidden_dim=hidden, out_dim=d_out, n_layers=2,
                tau=6, block_rows=blocks, block_k=blocks, block_f=blocks)


@functools.lru_cache(maxsize=None)
def _inputs(case):
    n, nnz, alpha = CASES[case][:3]
    feats = np.random.default_rng(1).standard_normal(
        (n, CASES[case][3])).astype(np.float32)
    cfg = jgcn.GCNConfig(**_dims(case))
    params = {name: {k: np.asarray(v) for k, v in layer.items()}
              for name, layer in jgcn.init_params(
                  cfg, jax.random.PRNGKey(0)).items()}
    return feats, params


@functools.lru_cache(maxsize=None)
def _graphs(case):
    n, nnz, alpha = CASES[case][:3]
    jcfg = jgcn.GCNConfig(**_dims(case))
    tcfg = tgcn.GCNConfig(**_dims(case))
    return (jgcn.GCNGraph.build(j_power_law(n, n, nnz, alpha=alpha, seed=0), jcfg),
            tgcn.GCNGraph.build(t_power_law(n, n, nnz, alpha=alpha, seed=0), tcfg))


@functools.lru_cache(maxsize=None)
def _reference(case, impl, fused, precision="f32"):
    feats, params = _inputs(case)
    jgraph, _ = _graphs(case)
    cfg = jgcn.GCNConfig(**_dims(case), spmm_impl=impl)
    plan = dataclasses.replace(j_plan_for_config(cfg), fused=fused)
    J_LEDGER.reset()
    out = np.asarray(jgcn.gcn_forward(params, jgraph, feats, cfg, plan=plan,
                                      precision=precision))
    return out, J_LEDGER.snapshot()


@functools.lru_cache(maxsize=None)
def _port(case, impl, fused, precision="f32"):
    feats, params = _inputs(case)
    _, tgraph = _graphs(case)
    cfg = tgcn.GCNConfig(**_dims(case), spmm_impl=IMPL_NAMES[impl])
    plan = dataclasses.replace(tgcn.plan_for_config(cfg), fused=fused)
    T_LEDGER.reset()
    out = tgcn.gcn_forward(params_from_numpy(params, "cpu"), tgraph, feats,
                           cfg, plan=plan, precision=precision, device="cpu")
    return out.numpy(), T_LEDGER.snapshot()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", list(CASES))
def test_gcn_forward_matches_reference(case, impl, fused):
    ref, _ = _reference(case, impl, fused)
    out, _ = _port(case, impl, fused)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert rel_max_err(out, ref) <= RTOL


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("impl", IMPLS)
def test_ledger_matches_reference_exactly(impl, fused):
    _, ref = _reference("fused_case", impl, fused)
    _, out = _port("fused_case", impl, fused)
    assert out == ref
    kinds = set(out["counts"])
    assert ("fused_dram" in kinds) == (fused and impl != "reference")


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", list(CASES))
def test_gcn_forward_quant_matches_reference(case, impl, fused, precision):
    ref, _ = _reference(case, impl, fused, precision)
    out, _ = _port(case, impl, fused, precision)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert rel_max_err(out, ref) <= RTOL
    f32, _ = _reference(case, "reference", False)
    assert 0.0 < jq.logit_error(f32, out) <= LOGIT_BUDGET[precision]


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("impl", IMPLS)
def test_ledger_matches_reference_exactly_quant(impl, fused, precision):
    """The int8 scale vector and the narrower value / activation widths
    enter the byte model exactly as in the reference."""
    _, ref = _reference("skewed", impl, fused, precision)
    _, out = _port("skewed", impl, fused, precision)
    assert out == ref
    _, f32 = _port("skewed", impl, fused)
    assert set(out["counts"]) == set(f32["counts"])
    assert sum(out["bytes"].values()) < sum(f32["bytes"].values())


def test_gcn_loss_and_accuracy_match_reference():
    feats, params = _inputs("fused_case")
    jgraph, tgraph = _graphs("fused_case")
    labels = np.random.default_rng(3).integers(0, 8, 96).astype(np.int32)
    mask = (np.arange(96) % 3 == 0).astype(np.float32)
    jcfg = jgcn.GCNConfig(**_dims("fused_case"))
    tcfg = tgcn.GCNConfig(**_dims("fused_case"))
    tparams = params_from_numpy(params, "cpu")
    for m in (None, mask):
        j_loss = float(jgcn.gcn_loss(params, jgraph, feats, labels, jcfg, mask=m))
        t_loss = float(tgcn.gcn_loss(tparams, tgraph, feats, labels, tcfg,
                                     mask=m, device="cpu"))
        assert abs(t_loss - j_loss) <= 1e-5 * max(abs(j_loss), 1.0)
        j_acc = float(jgcn.gcn_accuracy(params, jgraph, feats, labels, jcfg,
                                        mask=m))
        t_acc = float(tgcn.gcn_accuracy(tparams, tgraph, feats, labels, tcfg,
                                        mask=m, device="cpu"))
        assert t_acc == pytest.approx(j_acc, abs=1e-6)


def test_params_from_numpy_and_init_params():
    _, params = _inputs("fused_case")
    t = params_from_numpy(params, "cpu")
    assert set(t) == set(params) == {"layer_0", "layer_1"}
    for name, layer in params.items():
        for key, value in layer.items():
            assert t[name][key].dtype == torch.float32
            np.testing.assert_array_equal(t[name][key].numpy(), value)
    cfg = tgcn.GCNConfig(**_dims("fused_case"))
    a = tgcn.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = tgcn.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    for name in a:
        assert tuple(a[name]["w"].shape) == tuple(t[name]["w"].shape)
        assert torch.equal(a[name]["w"], b[name]["w"])
        assert not a[name]["b"].any()


def test_graph_places_operands_once_per_device():
    _, tgraph = _graphs("fused_case")
    first = tgraph.on_device("cpu")
    assert tgraph.on_device(torch.device("cpu")) is first
    ops, perm, inv = first
    assert torch.equal(perm[inv], torch.arange(tgraph.n_nodes))
    assert ops.schedulable and ops.n_out_rows == tgraph.n_nodes


def test_forward_rejects_auto_plan():
    """``plan="auto"`` on a 2-wide abstract mesh plans both widths; this
    host-bound graph stays at width 1 under the H100 model (a collective
    adds launches and saves little), so the forward equals the unplaced
    one.  A plan placed on an abstract mesh is rejected: it only plans;
    a forward runs on a ``DeviceMesh`` (``tests/test_torch_sharded.py``)."""
    from repro_torch.exec.pipeline import plan_pipeline

    feats, params = _inputs("fused_case")
    _, tgraph = _graphs("fused_case")
    cfg = tgcn.GCNConfig(**_dims("fused_case"))
    tparams = params_from_numpy(params, "cpu")
    mesh = {"data": 2}
    assert plan_pipeline(cfg, tgraph.pre.ell, mesh=mesh).n_shards == 1
    got = tgcn.gcn_forward(tparams, tgraph, feats, cfg, plan="auto",
                           device="cpu", mesh=mesh)
    want = tgcn.gcn_forward(tparams, tgraph, feats, cfg, plan="auto",
                            device="cpu")
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="abstract mesh"):
        tgcn.gcn_forward(tparams, tgraph, feats, cfg, device="cpu", mesh=mesh)


@pytest.mark.parametrize("impl", ["cuda", "cuda_sparse"])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_fused_args_pass_slot_lists_at_every_precision(precision, impl):
    """The dispatcher hands every fused launch the kernel's slot lists:
    ``column_slots`` of the table, covering each counted slot (column <
    k_real) exactly once, in its column's group; ``x`` arrives with rows
    of whole 16-byte pieces."""
    from repro_torch.exec import quant
    from repro_torch.exec.fused import fused_args
    from repro_torch.kernels import flexvector_spmm as tfv

    feats, params = _inputs("skewed")
    _, tgraph = _graphs("skewed")
    cfg = tgcn.GCNConfig(**_dims("skewed"))
    operands, perm, _ = tgraph.on_device("cpu")
    plan = dataclasses.replace(tgcn.plan_for_config(cfg), impl=impl,
                               precision=precision, fused=True).resolve(
                                   schedulable=operands.schedulable)
    qparams = quant.quantize_params(params_from_numpy(params, "cpu"),
                                    precision, cfg.block_rows)
    x = torch.as_tensor(feats)[perm]
    name, args, kw, real = fused_args(plan, operands, x, qparams["layer_0"],
                                      cfg.block_rows)
    assert name.endswith("_scaled") == (precision == "int8")
    assert ("sparse" in name) == (impl == "cuda_sparse")
    group, start, ids = (t.numpy() for t in kw["slots"])
    assert start[0] == 0 and start[-1] == ids.size == np.diff(start).sum()
    flat = operands.cols.numpy().reshape(-1)
    counted = np.flatnonzero((flat >= 0) & (flat < kw["k_real"]))
    assert np.array_equal(np.sort(ids), counted)      # each exactly once
    chunk_of = np.repeat(np.arange(group.size), np.diff(start))
    assert (flat[ids] // tfv.XW_TILE_ROWS == group[chunk_of]).all()
    x_k = args[2]
    assert x_k.shape[1] * x_k.element_size() % 16 == 0
    assert x_k.shape[1] == args[3].shape[0] >= x.shape[1]


@pytest.mark.parametrize("impl", ["cuda", "cuda_sparse"])
@pytest.mark.parametrize("precision, f, want", [
    ("f32", 64, 64), ("f32", 41, 44), ("f32", 3, 4),
    ("bf16", 41, 48), ("bf16", 3, 8), ("int8", 41, 48),
])
def test_aggregation_args_take_the_real_width(precision, f, want, impl):
    """The dispatcher hands B1/B2 the dense operand at its real width
    rounded up to 16 bytes of its storage type (f32 to 4 columns, bf16 and
    int8's bf16 operand to 8), not the plan's 128-column f-tile, with rows
    padded to ``block_rows`` and dense rows to ``block_k``; the wrapper
    cut back to ``(r, f)`` gives the reference impl's sub-row products."""
    from repro_torch.exec import dispatch
    from repro_torch.kernels import flexvector_spmm as tfv

    _, tgraph = _graphs("skewed")
    operands, _, _ = tgraph.on_device("cpu")
    blocks = CASES["skewed"][-1]
    plan = tgcn.SpmmPlan(impl=impl, block_rows=blocks, block_k=blocks,
                         block_f=128, precision=precision).resolve(
                             schedulable=operands.schedulable)
    dense = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (tgraph.n_nodes, f)), dtype=torch.float32)
    vals, scales, dense = dispatch.prepare_precision(plan, operands, dense)
    name, args, kw, (r, f_out) = dispatch.aggregation_args(
        plan, operands, vals, dense, scales)
    k_pad = -(-tgraph.n_nodes // blocks) * blocks
    assert kw["block_f"] == want and f_out == f
    assert tuple(args[2].shape) == (k_pad, want)
    assert args[0].shape[0] % blocks == 0 and r == operands.cols.shape[0]
    assert ("sparse" in name) == (impl == "cuda_sparse")
    out = tfv.KERNELS[name](*args, **kw)[:r, :f]
    ref = dispatch.sub_row_products(
        dataclasses.replace(plan, impl="reference", effective_impl=None)
        .resolve(schedulable=True), operands, vals, dense, scales)
    assert rel_max_err(out.numpy(), ref.numpy()) <= RTOL
