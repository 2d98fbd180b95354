"""The port's pipeline planner, ``plan="auto"`` forwards and autoplanned
serving against ``repro.exec.pipeline`` and ``repro.serve``, on one card.

The same CSR is preprocessed by both packages and the reference's
parameters are carried across with ``models.convert.params_from_numpy``.

* Planning: under the reference's device models the port's
  ``plan_pipeline`` picks the reference's per-layer plans (impl mapped by
  ``exec.plan.IMPL_NAMES``, blocks, fusion) at the reference's seconds
  (rel 1e-12); the reference's width-1 invariants hold under the H100
  model too (never priced above static, deterministic).
* Forwards: ``gcn_forward(plan="auto")`` at f32, bf16 and int8 is within
  1e-5 of the output scale of the reference's ``plan="auto"`` forward
  when both plan with ``TPU_V5E`` (the reference's Pallas kernels in
  interpret mode, the port's plain versions on the CPU), and within 1e-5
  of the port's static forward under the H100 model.
* Serving: an ``autoplan=True, precision="auto"`` engine on the CPU
  picks the JAX engine's ladder, per-rung precisions and per-layer plans
  and gives its answers within 1e-5 under ``TPU_V5E``; under the H100
  model its answers equal the JAX engine's at the precisions it picked;
  no executable is built after warmup.
"""

import dataclasses
import functools
import math
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.exec import pipeline as jpipe
from repro.graphs.datasets import DatasetSpec, gcn_normalize, synthesize_adjacency
from repro.models import gcn as jgcn
from repro.plan import cost as jcost
from repro.serve import ServeEngine as JEngine

from repro_torch.core.sparse_formats import CSRMatrix as TCSR
from repro_torch.exec import pipeline as tpipe
from repro_torch.exec.plan import IMPL_NAMES, SpmmPlan
from repro_torch.launch import serve_gcn
from repro_torch.models import gcn as tgcn
from repro_torch.models.convert import params_from_numpy
from repro_torch.plan import cost as tcost
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve.batcher import Bucket

PRECISIONS = ("f32", "bf16", "int8")
PORT_IMPLS = ("reference", "cuda", "cuda_sparse")
TO_REF = {v: k for k, v in IMPL_NAMES.items()}
DEVICES = {"tpu_v5e": (jcost.TPU_V5E, tcost.TPU_V5E),
           "flexvector": (jcost.flexvector_device(), tcost.flexvector_device())}
RTOL = 1e-5

#: name -> (n, nnz, alpha, in_dim, hidden, out_dim, blocks), the graphs of
#: ``tests/test_torch_gcn.py``
CASES = {
    "fused_case": (96, 700, 2.1, 12, 64, 8, 16),
    "skewed": (320, 5000, 2.8, 24, 32, 5, 32),
}


def rel_max_err(out, ref) -> float:
    out = np.asarray(out, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(out - ref))) / max(float(np.max(np.abs(ref))), 1e-30)


def _dims(case, impl="cuda", **kw):
    n, nnz, alpha, d_in, hidden, d_out, blocks = CASES[case]
    dims = dict(in_dim=d_in, hidden_dim=hidden, out_dim=d_out, n_layers=2,
                tau=6, block_rows=blocks, block_k=blocks, block_f=blocks)
    dims.update(kw)
    return (jgcn.GCNConfig(spmm_impl=TO_REF[impl], **dims),
            tgcn.GCNConfig(spmm_impl=impl, **dims))


@functools.lru_cache(maxsize=None)
def _case(case):
    """``(reference graph, port graph, features, numpy params)``."""
    from repro.core import random_power_law_csr as j_power_law
    from repro_torch.core.sparse_formats import random_power_law_csr as t_power_law

    n, nnz, alpha = CASES[case][:3]
    jcfg, tcfg = _dims(case)
    feats = np.random.default_rng(1).standard_normal(
        (n, CASES[case][3])).astype(np.float32)
    params = {name: {k: np.asarray(v) for k, v in layer.items()}
              for name, layer in jgcn.init_params(
                  jcfg, jax.random.PRNGKey(0)).items()}
    jg = jgcn.GCNGraph.build(j_power_law(n, n, nnz, alpha=alpha, seed=0), jcfg)
    tg = tgcn.GCNGraph.build(t_power_law(n, n, nnz, alpha=alpha, seed=0), tcfg)
    return jg, tg, feats, params


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Keep registry persistence off the repo's .cache."""
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "cache"))


# The serving toy graph of tests/test_serve.py (400 nodes, 32 features, 5
# classes, hidden 8), built from seed 7 and given to both packages.
TOY = DatasetSpec("toy", nodes=400, edges=1_600, feature_dim=32, classes=5)
GEOMETRY = dict(max_seeds=4, max_batch=4, base_bucket_nodes=64)


@functools.lru_cache(maxsize=None)
def _toy():
    """``(reference CSR, port CSR, features)`` of the serving toy graph."""
    j_adj = gcn_normalize(synthesize_adjacency(TOY, seed=7))
    t_adj = TCSR(indptr=j_adj.indptr, indices=j_adj.indices,
                 data=j_adj.data, shape=j_adj.shape)
    feats = np.random.default_rng(7).standard_normal(
        (TOY.nodes, TOY.feature_dim)).astype(np.float32)
    return j_adj, t_adj, feats


def _toy_cfgs(impl="cuda"):
    dims = dict(in_dim=TOY.feature_dim, hidden_dim=8, out_dim=TOY.classes)
    return (jgcn.GCNConfig(spmm_impl=TO_REF[impl], **dims),
            tgcn.GCNConfig(spmm_impl=impl, **dims))


@functools.lru_cache(maxsize=None)
def _toy_params():
    jcfg, _ = _toy_cfgs()
    return {name: {k: np.asarray(v) for k, v in layer.items()}
            for name, layer in jgcn.init_params(
                jcfg, jax.random.PRNGKey(0)).items()}


@functools.lru_cache(maxsize=None)
def _toy_requests():
    rng = np.random.default_rng(2)
    return tuple(rng.choice(TOY.nodes, size=int(rng.integers(1, 5)),
                            replace=False) for _ in range(10))


def _close(a, b) -> bool:
    return a == b or math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


def _same_layers(got, want):
    assert len(got.layers) == len(want.layers)
    for t, j in zip(got.layers, want.layers):
        assert TO_REF[t.spmm.impl] == j.spmm.impl
        for field in ("block_rows", "block_k", "block_f", "precision",
                      "fused", "hot_k_first"):
            assert getattr(t.spmm, field) == getattr(j.spmm, field), field
        assert (t.f_in, t.f_out, t.in_layout, t.out_layout) == \
            (j.f_in, j.f_out, j.in_layout, j.out_layout)
        assert _close(t.seconds, j.seconds)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_plan_pipeline_matches_reference(case, impl, precision, device):
    jdev, tdev = DEVICES[device]
    jcfg, tcfg = _dims(case, impl)
    jg, tg = _case(case)[:2]
    want = jpipe.plan_pipeline(jcfg, jg.pre.ell, precision=precision,
                               device=jdev)
    got = tpipe.plan_pipeline(tcfg, tg.pre.ell, precision=precision,
                              device=tdev)
    _same_layers(got, want)
    assert got.n_shards == want.n_shards == 1
    assert _close(got.cost_seconds, want.cost_seconds)
    assert _close(got.static_cost_seconds, want.static_cost_seconds)
    assert got.n_candidates > 2 * len(got.layers)


@pytest.mark.parametrize("device", DEVICES)
def test_plan_pipeline_over_rung_stats_matches_reference(device):
    """A serving rung's synthetic stats (no host operand: ``cuda_sparse``
    is not schedulable there), as the batcher plans them."""
    jdev, tdev = DEVICES[device]
    for impl in PORT_IMPLS:
        jcfg, tcfg = _dims("skewed", impl)
        for rows, nodes, nnz in ((384, 128, 900), (1536, 512, 4000)):
            kw = dict(rows=rows, n_out_rows=nodes, n_dense_rows=nodes,
                      nnz=nnz, tau=6)
            want = jpipe.plan_pipeline(jcfg, jcost.synthetic_stats(**kw),
                                       device=jdev)
            got = tpipe.plan_pipeline(tcfg, tcost.synthetic_stats(**kw),
                                      device=tdev)
            _same_layers(got, want)
            assert _close(got.cost_seconds, want.cost_seconds)


def test_layer_dims_and_chain_layouts():
    _, tcfg = _dims("fused_case", n_layers=3)
    jcfg, _ = _dims("fused_case", n_layers=3)
    assert tpipe._layer_dims(tcfg) == jpipe._layer_dims(jcfg) == \
        ((12, 64), (64, 64), (64, 8))
    for n in (1, 2, 3):
        assert tpipe.chain_layouts(n) == jpipe.chain_layouts(n)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_static_pipeline_matches_reference(precision, fused):
    jcfg, tcfg = _dims("fused_case")
    want = jpipe.static_pipeline(jcfg, precision=precision, fused=fused)
    got = tpipe.static_pipeline(tcfg, precision=precision, fused=fused)
    for t, j in zip(got.layers, want.layers):
        assert TO_REF[t.spmm.impl] == j.spmm.impl
        assert (t.spmm.precision, t.spmm.fused, t.f_in, t.f_out) == \
            (j.spmm.precision, j.spmm.fused, j.f_in, j.f_out)
        assert (t.in_layout, t.out_layout) == ("replicated", "replicated")


@pytest.mark.parametrize("model", ["tpu_v5e", "h100"])
@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_plan_pipeline_never_worse_than_static(impl, model):
    device = {"tpu_v5e": tcost.TPU_V5E, "h100": tcost.H100}[model]
    for case in CASES:
        _, tcfg = _dims(case, impl)
        tg = _case(case)[1]
        for precision in PRECISIONS:
            pp = tpipe.plan_pipeline(tcfg, tg.pre.ell, precision=precision,
                                     device=device)
            assert pp.cost_seconds <= pp.static_cost_seconds
            assert len(pp.layers) == tcfg.n_layers
            assert all(lp.spmm.precision == precision for lp in pp.layers)
            assert sum(lp.seconds for lp in pp.layers) == \
                pytest.approx(pp.cost_seconds, rel=1e-12)


def test_plan_pipeline_deterministic():
    _, tcfg = _dims("skewed")
    for device in (tcost.TPU_V5E, tcost.H100):
        a, b = (tpipe.plan_pipeline(tcfg, _case("skewed")[1].pre.ell,
                                    device=device) for _ in range(2))
        assert a == b and a.describe() == b.describe()


def test_h100_layer_seconds_prices_the_fused_edge_with_its_kernel():
    """Under the H100 model a layer's price is the fused kernel's term or
    the combination + aggregation terms, plus the writeback."""
    _, tcfg = _dims("skewed")
    stats = tcost.graph_stats_from_ell(_case("skewed")[1].pre.ell)
    plan = SpmmPlan(impl="cuda", block_rows=32, block_k=32, block_f=32)
    wb = stats.n_out_rows * 32 * 4 / tcost.H100.hbm_bw
    unfused = (tcost.spmm_cost(stats, 32, impl="cuda", block_rows=32,
                               block_k=32, block_f=32).seconds
               + tcost.combination_seconds(stats.n_out_rows, 24, 32))
    fused = tcost.fused_layer_cost(stats, 24, 32, impl="cuda", block_rows=32,
                                   block_k=32, block_f=32).seconds
    assert tpipe.layer_seconds(stats, plan, 24, 32) == pytest.approx(
        unfused + wb, rel=1e-12)
    assert tpipe.layer_seconds(stats, dataclasses.replace(plan, fused=True),
                               24, 32) == pytest.approx(fused + wb, rel=1e-12)


@pytest.mark.parametrize("kw", [{"mesh": {"data": 2}},
                                {"out_layout": "row_sharded"}])
def test_plan_pipeline_one_card_only(kw):
    """A mesh bounds the widths to {1, its width} (item A9); without one
    and without a process group only width 1 can be placed, where the
    layouts coincide and a row-sharded output is replicated.  The static
    pipeline on a 2-wide mesh chains reduce-scatters between layers."""
    _, tcfg = _dims("fused_case")
    pp = tpipe.plan_pipeline(tcfg, _case("fused_case")[1].pre.ell, **kw)
    if "mesh" in kw:
        assert pp.n_shards in (1, 2)
        assert all((lp.spmm.mesh is kw["mesh"]) == (pp.n_shards == 2)
                   for lp in pp.layers)
    else:
        assert pp.n_shards == 1
        assert [lp.out_layout for lp in pp.layers] == ["replicated"] * 2
    static = tpipe.static_pipeline(tcfg, mesh={"data": 2})
    assert [(lp.in_layout, lp.out_layout) for lp in static.layers] == [
        ("replicated", "row_sharded"), ("row_sharded", "replicated")]
    assert static.n_shards == 2 and static.n_collective_rounds == 1


def test_pipeline_forward_refuses_row_sharded_boundaries():
    """A row-sharded boundary of a plan on no mesh runs replicated (the
    layouts coincide on one device); a plan placed on an abstract mesh
    only plans, and a layer count that does not match is refused."""
    _, tg, feats, params = _case("fused_case")
    _, tcfg = _dims("fused_case")
    pp = tpipe.static_pipeline(tcfg)
    sharded = dataclasses.replace(
        pp, layers=(dataclasses.replace(pp.layers[0],
                                        out_layout="row_sharded"),
                    pp.layers[1]))
    tparams = params_from_numpy(params, "cpu")
    got = tpipe.pipeline_forward(tparams, tg, feats, sharded, device="cpu")
    want = tpipe.pipeline_forward(tparams, tg, feats, pp, device="cpu")
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="abstract mesh"):
        tpipe.pipeline_forward(
            tparams, tg, feats, tpipe.static_pipeline(tcfg, mesh={"data": 2}),
            device="cpu")
    with pytest.raises(ValueError, match="layers"):
        tpipe.pipeline_forward(params_from_numpy(params, "cpu"), tg, feats,
                               tpipe.static_pipeline(tcfg, n_layers=3),
                               device="cpu")


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_auto_forward_matches_reference(case, impl, precision):
    """Both packages plan with TPU_V5E (the port's passed as
    ``device_model``), so both run the same per-layer plans: the port's
    answers are the reference's, to 1e-5 of the scale."""
    jg, tg, feats, params = _case(case)
    jcfg, tcfg = _dims(case, impl)
    want = np.asarray(jgcn.gcn_forward(params, jg, feats, jcfg, plan="auto",
                                       precision=precision))
    got = tgcn.gcn_forward(params_from_numpy(params, "cpu"), tg, feats, tcfg,
                           plan="auto", precision=precision, device="cpu",
                           device_model=tcost.TPU_V5E)
    assert got.shape == want.shape
    assert rel_max_err(got, want) <= RTOL


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", CASES)
def test_h100_auto_forward_matches_static(case, precision):
    """Under the H100 model (the default) the chosen plans give the static
    plan's answers, and a GcnPipelinePlan passed directly gives the
    ``"auto"`` forward's."""
    _, tg, feats, params = _case(case)
    _, tcfg = _dims(case)
    tparams = params_from_numpy(params, "cpu")
    static = tgcn.gcn_forward(tparams, tg, feats, tcfg, precision=precision,
                              device="cpu")
    auto = tgcn.gcn_forward(tparams, tg, feats, tcfg, plan="auto",
                            precision=precision, device="cpu")
    assert rel_max_err(auto, static) <= RTOL
    pplan = tpipe.plan_pipeline(tcfg, tg.pre.ell, precision=precision)
    again = tgcn.gcn_forward(tparams, tg, feats, tcfg, plan=pplan,
                             device="cpu")
    assert rel_max_err(again, auto) == 0.0


def test_forward_rejects_an_unknown_plan_string():
    _, tg, feats, params = _case("fused_case")
    _, tcfg = _dims("fused_case")
    with pytest.raises(ValueError, match="unknown plan"):
        tgcn.gcn_forward(params_from_numpy(params, "cpu"), tg, feats, tcfg,
                         plan="fastest", device="cpu")


# ---------------------------------------------------------------------------
# autoplanned serving
# ---------------------------------------------------------------------------


def _engines(impl="cuda", device_model=None, **kw):
    """The JAX engine and the port's over the serving toy graph, both with
    ``autoplan=True, precision="auto"`` (ladder growth "auto"); the port's
    plans on ``device_model`` (the H100 model when None)."""
    j_adj, t_adj, feats = _toy()
    jcfg, tcfg = _toy_cfgs(impl)
    opts = dict(fanout=4, autoplan=True, precision="auto",
                **dict(GEOMETRY, **kw))
    je = JEngine(j_adj, feats, jcfg, params=_toy_params(), **opts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # cuda_sparse
        te = TEngine(t_adj, feats, tcfg,
                     params=params_from_numpy(_toy_params(), "cpu"),
                     device="cpu", device_model=device_model, **opts)
    return je, te


def _serve(engine):
    reqs = _toy_requests()
    full = np.asarray(engine.full_forward())
    return full, [np.asarray(engine.query(s)) for s in reqs[:3]] + [
        np.asarray(o) for o in engine.query_batch(list(reqs))]


@pytest.mark.parametrize("impl", ["reference", "cuda", "cuda_sparse"])
def test_autoplanned_engine_matches_reference(impl):
    je, te = _engines(impl, device_model=tcost.TPU_V5E)
    j_built, t_built = je.warmup(), te.warmup()
    assert [(b.nodes, b.rows) for b in te.batcher.ladder.entries] == \
        [(b.nodes, b.rows) for b in je.batcher.ladder.entries]
    assert te.resolved_precision == je.resolved_precision
    assert set(te.precision_errors) == set(je.precision_errors)
    for p, err in je.precision_errors.items():
        assert te.precision_errors[p] == pytest.approx(err, rel=1e-3, abs=1e-9)
    for tb, jb in zip(te.batcher.ladder.entries, je.batcher.ladder.entries):
        assert te.batcher.precision_for_bucket(tb) == \
            je.batcher.precision_for_bucket(jb)
    t_full, t_out = _serve(te)
    j_full, j_out = _serve(je)
    assert rel_max_err(t_full, j_full) <= RTOL
    for got, want in zip(t_out, j_out):
        assert got.shape == want.shape
        assert rel_max_err(got, want) <= RTOL
    for (bucket, f), plans in je.batcher._layer_plans.items():
        mine = te.batcher.layer_plans_for_bucket(Bucket(bucket.nodes,
                                                        bucket.rows), f)
        assert [(TO_REF[p.impl], p.block_rows, p.block_k, p.block_f, p.fused)
                for p in mine] == \
            [(p.impl, p.block_rows, p.block_k, p.block_f, p.fused)
             for p in plans]
    assert te.compile_count == t_built > 0 and je.compile_count == j_built


def test_h100_autoplanned_engine_answers_at_its_precisions():
    """Under the H100 model the engine picks its own ladder, plans and
    precisions; each answer equals the JAX engine's at the precision the
    port picked for it, and nothing is built after warmup."""
    je, te = _engines()
    built = te.warmup()
    picks = {te.batcher.precision_for_bucket(b)
             for b in te.batcher.ladder.entries}
    assert len(picks) == 1
    j_adj, _, feats = _toy()
    jcfg, _ = _toy_cfgs("cuda")
    rung = JEngine(j_adj, feats, jcfg, params=_toy_params(), fanout=4,
                   precision=picks.pop(), **GEOMETRY)
    full = JEngine(j_adj, feats, jcfg, params=_toy_params(), fanout=4,
                   precision=te.resolved_precision, **GEOMETRY)
    t_full, t_out = _serve(te)
    assert rel_max_err(t_full, np.asarray(full.full_forward())) <= RTOL
    _, j_out = _serve(rung)
    for got, want in zip(t_out, j_out):
        assert rel_max_err(got, want) <= RTOL
    assert te.compile_count == built > 0
    for plans in te.batcher._layer_plans.values():
        assert all(p.impl != "reference" for p in plans)


def test_autoplanned_batcher_mixing_fused_and_unfused_layers(monkeypatch):
    """A rung whose layers mix fused and unfused plans, one of them at
    other block rows than the config's, builds slot lists for its fused
    layer and answers as the config's static plan does, at int8 too."""
    real = tpipe.plan_pipeline

    def mixed(cfg, graph, **kw):
        pp = real(cfg, graph, **kw)
        first = dataclasses.replace(pp.layers[0].spmm, impl="cuda",
                                    fused=True, block_rows=32)
        second = dataclasses.replace(pp.layers[1].spmm, impl="cuda",
                                     fused=False, block_rows=64)
        return dataclasses.replace(pp, layers=(
            dataclasses.replace(pp.layers[0], spmm=first),
            dataclasses.replace(pp.layers[1], spmm=second)))

    monkeypatch.setattr(tpipe, "plan_pipeline", mixed)
    j_adj, t_adj, feats = _toy()
    _, tcfg = _toy_cfgs("cuda")
    for precision in ("f32", "int8"):
        kw = dict(params=params_from_numpy(_toy_params(), "cpu"),
                  fanout=4, precision=precision, device="cpu",
                  **GEOMETRY)
        auto = TEngine(t_adj, feats, tcfg, autoplan=True, ladder_growth=4,
                       **kw)
        static = TEngine(t_adj, feats, tcfg, **kw)
        built = auto.warmup()
        static.warmup()
        reqs = _toy_requests()
        req = auto._prepare(reqs[0])
        plans = auto.batcher.layer_plans_for_bucket(req.bucket, 32)
        assert [(p.fused, p.block_rows) for p in plans] == [(True, 32),
                                                            (False, 64)]
        assert req.slots is not None
        got = [auto.query(s) for s in reqs[:3]] + auto.query_batch(list(reqs))
        want = [static.query(s) for s in reqs[:3]] + \
            static.query_batch(list(reqs))
        for g, w in zip(got, want):
            assert rel_max_err(g, w) <= RTOL
        assert auto.compile_count == built


def test_autoplanned_batcher_zero_builds_after_warmup():
    """The reference's ``test_autoplanned_batcher_zero_recompiles``: per
    rung, per-layer plans from the pipeline planner, fixed at warmup."""
    from repro_torch.graphs.datasets import (DatasetSpec, gcn_normalize,
                                             synthesize_adjacency)

    spec = DatasetSpec("toy", nodes=128, edges=600, feature_dim=12, classes=4)
    adj = gcn_normalize(synthesize_adjacency(spec, seed=7))
    feats = np.random.default_rng(7).standard_normal(
        (spec.nodes, spec.feature_dim)).astype(np.float32)
    cfg = tgcn.GCNConfig(in_dim=spec.feature_dim, hidden_dim=16,
                         out_dim=spec.classes, n_layers=2, tau=6,
                         spmm_impl="cuda", block_rows=16, block_k=16,
                         block_f=16)
    engine = TEngine(adj, feats, cfg, fanout=4, max_seeds=4, max_batch=4,
                     base_bucket_nodes=64, autoplan=True, device="cpu")
    built = engine.warmup()
    assert built > 0
    rng = np.random.default_rng(8)
    requests = [rng.choice(spec.nodes, size=int(rng.integers(1, 5)),
                           replace=False) for _ in range(32)]
    for seeds in requests[:8]:
        engine.query(seeds)
    engine.query_batch(requests[8:])
    assert engine.compile_count == built
    bucket = engine.batcher.ladder.entries[0]
    plans = engine.batcher.layer_plans_for_bucket(bucket, spec.feature_dim)
    assert len(plans) == cfg.n_layers
    assert all(p.effective_impl == "cuda" for p in plans)


def test_cli_autoplan_precision_auto(capsys, monkeypatch):
    from repro_torch.graphs import datasets as tdatasets

    monkeypatch.setitem(tdatasets.DATASETS, "toy", tdatasets.DatasetSpec(
        "toy", nodes=400, edges=1_600, feature_dim=32, classes=5))
    serve_gcn.main(["--dataset", "toy", "--reduced", "--requests", "12",
                    "--batch", "4", "--impl", "cuda", "--autoplan",
                    "--precision", "auto", "--ladder-growth", "auto"],
                   device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[warmup] ")
    assert lines[1].startswith("[precision] requested auto (budget 0.05)")
    assert "measured errors" in lines[1] and "full-graph" in lines[1]
    plans = [line for line in lines if line.startswith("[autoplan] bucket")]
    assert plans and all("L0:" in line and "L1:" in line for line in plans)
    assert lines[-1].startswith("[post-warmup compiles] 0 ")
