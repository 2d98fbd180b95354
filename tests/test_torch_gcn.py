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
from repro.models import gcn as jgcn

from repro_torch.core.sparse_formats import random_power_law_csr as t_power_law
from repro_torch.dist.collectives import LEDGER as T_LEDGER
from repro_torch.exec.plan import IMPL_NAMES
from repro_torch.models import gcn as tgcn
from repro_torch.models.convert import params_from_numpy

RTOL = 1e-5
IMPLS = ["reference", "pallas", "pallas_sparse"]


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
def _reference(case, impl, fused):
    feats, params = _inputs(case)
    jgraph, _ = _graphs(case)
    cfg = jgcn.GCNConfig(**_dims(case), spmm_impl=impl)
    plan = dataclasses.replace(j_plan_for_config(cfg), fused=fused)
    J_LEDGER.reset()
    out = np.asarray(jgcn.gcn_forward(params, jgraph, feats, cfg, plan=plan))
    return out, J_LEDGER.snapshot()


def _port(case, impl, fused):
    feats, params = _inputs(case)
    _, tgraph = _graphs(case)
    cfg = tgcn.GCNConfig(**_dims(case), spmm_impl=IMPL_NAMES[impl])
    plan = dataclasses.replace(tgcn.plan_for_config(cfg), fused=fused)
    T_LEDGER.reset()
    out = tgcn.gcn_forward(params_from_numpy(params, "cpu"), tgraph, feats,
                           cfg, plan=plan, device="cpu")
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
    feats, params = _inputs("fused_case")
    _, tgraph = _graphs("fused_case")
    cfg = tgcn.GCNConfig(**_dims("fused_case"))
    with pytest.raises(NotImplementedError, match="static SpmmPlan"):
        tgcn.gcn_forward(params_from_numpy(params, "cpu"), tgraph, feats, cfg,
                         plan="auto", device="cpu")
