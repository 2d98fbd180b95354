"""The port's observability (``repro_torch.obs``) against ``repro.obs``.

Traces are compared as ``Trace.to_dict`` trees under the virtual clock,
after mapping the reference's impl names to the port's
(``exec.plan.IMPL_NAMES``): span names, nesting, timestamps, attributes
and ledger events must be equal.  The exporters render the same text for
the same registry operations; ``PlanFeedback`` keeps the same EWMAs and
files; ``choose_plan(feedback=)`` and ``MicroBatcher(feedback=)`` pick
the reference's plans under the reference's device model; an eager
forward under an active span opens the reference's ``execute_layer``
spans with its ledger events.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.fleet as JF
import repro.obs as JO
import repro.runtime as JR
import repro_torch.fleet as TF
import repro_torch.obs as TO
import repro_torch.runtime as TR
from repro.core import preprocess as j_preprocess
from repro.core import random_power_law_csr as j_random_csr
from repro.exec import SpmmOperands as JOperands
from repro.exec import SpmmPlan as JPlan
from repro.exec.dispatch import execute_layer as j_execute_layer
from repro.models.gcn import GCNConfig as JConfig
from repro.models.gcn import GCNGraph as JGraph
from repro.models.gcn import gcn_forward as j_gcn_forward
from repro.plan import autoplan as jauto
from repro.plan import cost as jcost
from repro.serve.batcher import Bucket as JBucket
from repro_torch.core.preprocessing import preprocess as t_preprocess
from repro_torch.core.sparse_formats import CSRMatrix as TCSR
from repro_torch.dist.collectives import LEDGER as T_LEDGER
from repro_torch.exec import SpmmOperands as TOperands
from repro_torch.exec import SpmmPlan as TPlan
from repro_torch.exec.dispatch import execute_layer as t_execute_layer
from repro_torch.exec.plan import IMPL_NAMES
from repro_torch.models.gcn import GCNConfig as TConfig
from repro_torch.models.gcn import GCNGraph as TGraph
from repro_torch.models.gcn import gcn_forward as t_gcn_forward
from repro_torch.plan import autoplan as tauto
from repro_torch.plan import cost as tcost
from repro_torch.serve.batcher import Bucket as TBucket

import _fleet_cases as fc
import _serve_parity as sp

SIDES = {"reference": (JO, JR, JBucket), "port": (TO, TR, TBucket)}


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "cache"))


def _port_names(value):
    """A trace dict with the reference's impl names mapped to the port's
    (the ``impl`` attribute and the impl field of a ``plan_key``)."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if k == "impl" and v in IMPL_NAMES:
                v = IMPL_NAMES[v]
            elif k == "plan_key" and isinstance(v, str):
                head, _, rest = v.partition("/")
                v = f"{IMPL_NAMES.get(head, head)}/{rest}"
            else:
                v = _port_names(v)
            out[k] = v
        return out
    if isinstance(value, list):
        return [_port_names(v) for v in value]
    return value


def _dicts(traces):
    return [t.to_dict() for t in traces]


# ---------------------------------------------------------------------------
# labels, trace primitives, queue/scheduler trace statuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("labels", [
    {}, {"tenant": "cold"}, {"tenant": "a,b", "servable": "x=y"},
    {"k": "br{ace}s"}, {"k": "back\\slash", "j": "plain"}])
def test_labeled_keys_match_reference(labels):
    key = TR.labeled("metric_name", **labels)
    assert key == JR.labeled("metric_name", **labels)
    assert TR.parse_labeled(key) == JR.parse_labeled(key) \
        == ("metric_name", labels)


def _primitives(O, R, B):
    clock = R.VirtualClock(start=5.0)
    tracer = O.Tracer(clock=clock, max_traces=3)
    trace = tracer.trace("request", graph_key="g")
    child = trace.span("prepare", start=5.0)
    clock.advance(1.0)
    child.finish()
    child.finish(at=99.0)
    child.event("ledger", kind="spmm_dram", bytes=1.0, n=1)
    trace.finish(status="ok", at=6.0)
    trace.finish(status="failed", at=7.0)
    for i in range(4):
        tracer.trace("request", i=i).finish()
    drained = tracer.drain()
    return [_dicts(drained), tracer.drain(), tracer.started,
            tracer.completed, child.duration]


def _queue_statuses(O, R, B):
    clock = R.VirtualClock()
    tracer = O.Tracer(clock=clock)
    queue = R.RequestQueue(capacity=2, clock=clock,
                           estimator=R.FixedEstimator(0.25))
    sched = R.BatchScheduler(queue, max_batch=4, max_wait_s=None)

    def req(deadline=None):
        return R.Request(graph_key="g", seeds=(0,), deadline=deadline,
                         bucket=B(64, 128), padded=object(),
                         trace=tracer.trace("request", graph_key="g"))

    shed, cancelled = req(deadline=1.0), req()
    queue.submit(shed)
    queue.submit(cancelled)
    try:
        queue.submit(req())
    except R.AdmissionError:
        pass
    queue.cancel(cancelled)
    clock.advance(2.0)
    sched.poll()
    return _dicts(tracer.drain())


@pytest.mark.parametrize("script", [_primitives, _queue_statuses],
                         ids=["primitives", "queue_statuses"])
def test_trace_scripts_match_reference(script):
    """Span trees, first-wins finishes, the bounded buffer and the
    admission / shed / cancel statuses, as the reference records them."""
    want = script(*SIDES["reference"])
    got = script(*SIDES["port"])
    assert got == want
    if script is _queue_statuses:
        assert [t["status"] for t in got] == [
            "rejected_queue_full", "cancelled", "shed_expired"]


# ---------------------------------------------------------------------------
# the served vertical: complete traces, feedback, the ledger
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,precision,fused", [
    ("reference", "f32", None), ("cuda", "int8", True)],
    ids=["reference-f32", "cuda-fused-int8"])
def test_runtime_traces_match_reference(impl, precision, fused):
    """The runtime scenario of ``tests/test_torch_runtime.py`` traced by
    both packages: the same trace trees (prepare, admission, queue wait,
    execute with the plan's keys and ledger events, one execute_layer per
    layer, shed statuses), span for span, after the impl-name mapping."""
    jeng = sp.reference_engine(impl, precision, fused)
    teng = sp.port_engine(impl, precision, fused)
    jtr, ttr = JO.Tracer(), TO.Tracer()
    sp.scenario(jeng, JR, tracer=jtr)
    got = sp.scenario(teng, TR, tracer=ttr)
    want = _port_names(_dicts(jtr.drain()))
    traces = ttr.drain()
    assert _dicts(traces) == want
    assert {t.status for t in traces} == {"ok", "shed_expired"}
    fdim = sp.SPEC.feature_dim
    for trace, req in zip(sorted(traces, key=lambda t: t.trace_id),
                          got["requests"]):
        if trace.status != "ok":
            continue
        [ex] = trace.find("execute")
        assert ex.attributes["bucket_key"] == TO.bucket_key(req.bucket, fdim)
        plan = dataclasses.replace(
            teng.batcher.plan_for_bucket(req.bucket, fdim),
            precision=precision)
        assert ex.attributes["plan_key"] == TO.plan_key_from_plan(plan)
        assert ex.attributes["impl"] == ("reference" if impl == "reference"
                                         else "cuda")
        layers = trace.find("execute_layer")
        assert len(layers) == teng.cfg.n_layers
        assert all(s.parent_id == ex.span_id for s in layers)
        kinds = {ev.attributes["kind"] for ev in ex.events}
        assert "spmm_dram" in kinds


def test_untraced_serving_leaves_ledger_untouched():
    """Without a tracer the runtime ledgers nothing: the CPU executables
    run with the ledger muted, as a replay records nothing on the card."""
    engine = sp.port_engine()
    before = (dict(T_LEDGER.counts), dict(T_LEDGER.bytes))
    rt = engine.runtime(capacity=16, clock=TR.VirtualClock(start=10.0))
    req = rt.submit([1, 2], deadline_s=1.0)
    sp.drive(rt)
    req.future.result(timeout=10)
    engine.query_batch([[3, 4], [5]])
    assert (dict(T_LEDGER.counts), dict(T_LEDGER.bytes)) == before
    rt.shutdown()


def test_serving_records_feedback_as_reference():
    """Serving with a store attached records one entry per executed
    (bucket, plan), under the reference's keys and counts."""
    jfb, tfb = JO.PlanFeedback(), TO.PlanFeedback()
    sp.scenario(sp.reference_engine(), JR, feedback=jfb)
    got = sp.scenario(sp.port_engine(), TR, feedback=tfb)
    assert tfb.entries() == jfb.entries()
    assert len(tfb) >= 1
    bkeys = {TO.bucket_key(r.bucket, sp.SPEC.feature_dim)
             for r in got["requests"]}
    assert set(tfb.entries()) <= bkeys
    total = sum(e["count"] for p in tfb.entries().values()
                for e in p.values())
    assert total == len(got["batches"])


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


def _registry_ops(R):
    reg = R.MetricsRegistry()
    reg.inc("completed", 5)
    reg.inc(R.labeled("completed", tenant="cold", servable="a b"), 2)
    reg.inc(R.labeled("completed", tenant='we"ird\\val'))
    reg.set_gauge("queue_depth", 3)
    for v in (0.010, 0.020, 0.030):
        reg.observe("e2e_s", v)
    reg.observe(R.labeled("exec_s", servable="x"), 0.5)
    return reg


def test_exports_render_as_reference(tmp_path):
    jreg, treg = _registry_ops(JR), _registry_ops(TR)
    text = TO.render_prometheus(treg)
    assert text == JO.render_prometheus(jreg)
    assert "repro_completed 5" in text
    assert 'repro_e2e_s_ms{quantile="0.5"} 20' in text
    assert TO.write_prometheus(str(tmp_path / "m.prom"), treg) == text
    snap = TO.write_metrics_json(str(tmp_path / "a" / "m.json"), treg)
    JO.write_metrics_json(str(tmp_path / "b" / "m.json"), jreg)
    with open(tmp_path / "a" / "m.json") as f, \
            open(tmp_path / "b" / "m.json") as g:
        assert f.read() == g.read()
    assert snap == treg.snapshot()
    jtr = JO.Tracer(clock=JR.VirtualClock())
    ttr = TO.Tracer(clock=TR.VirtualClock())
    for tracer in (jtr, ttr):
        for _ in range(3):
            tracer.trace("request").finish()
    jt, tt = jtr.drain(), ttr.drain()
    assert TO.render_traces_json(tt) == JO.render_traces_json(jt)
    assert TO.write_traces_json(str(tmp_path / "t.json"), tt) == 3
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == json.loads(JO.render_traces_json(jt))


# ---------------------------------------------------------------------------
# PlanFeedback
# ---------------------------------------------------------------------------


def _feedback_script(O, R, B, tmp_path, monkeypatch):
    out = []
    fb = O.PlanFeedback(ewma=0.5)
    k = O.plan_key("reference", 128, 128, 128)
    out.append(fb.measured("b", k))
    out.append(fb.record("b", k, seconds=0.8, batch=4))
    out.append(fb.record("b", k, seconds=0.4, batch=1))
    out += [len(fb), fb.has_bucket("b"), fb.has_bucket("x"), fb.entries()]
    path = str(tmp_path / "fb.json")
    fb.record("b2", "p", 0.125)
    out.append(fb.save(path) == path)
    with open(path) as f:
        out.append(f.read())
    back = O.PlanFeedback.load(path)
    out += [back.ewma, back.entries() == fb.entries()]
    out.append(len(O.PlanFeedback.load(str(tmp_path / "nope.json"))))
    corrupt = str(tmp_path / "bad.json")
    with open(corrupt, "w") as f:
        f.write('{"version": 1, "entries": [not json')
    out += [len(O.PlanFeedback.load(corrupt)),
            os.path.exists(corrupt + ".corrupt"), os.path.exists(corrupt)]
    monkeypatch.setenv("REPRO_BENCH_DIR", str(tmp_path / "bench"))
    from importlib import import_module

    feedback_mod = import_module(O.__name__ + ".feedback")
    out.append(feedback_mod.default_path()
               == str(tmp_path / "bench" / "PLAN_FEEDBACK.json"))
    fb.save()
    out.append(len(O.PlanFeedback.load()))
    clock = R.VirtualClock()
    tracer = O.Tracer(clock=clock)
    trace = tracer.trace("request")
    trace.span("execute", start=0.0, bucket_key="bk", plan_key="pk",
               padded_batch=2).finish(at=0.4)
    trace.span("execute", start=0.0)
    trace.span("prepare", start=0.0).finish(at=0.1)
    trace.finish()
    fresh = O.PlanFeedback()
    out += [fresh.ingest(tracer.drain()), fresh.measured("bk", "pk")]
    out.append(O.bucket_key(B(64, 128), 32))
    out.append(O.plan_key("reference", 64, 32, 16, 2, "int8", True))
    with pytest.raises(ValueError):
        O.PlanFeedback(ewma=0.0)
    return out


def test_plan_feedback_matches_reference(tmp_path, monkeypatch):
    """EWMA and batch normalisation, the saved file byte for byte, load of
    a missing and a corrupt file, the default path, trace ingestion and
    the key formats."""
    want = _feedback_script(*SIDES["reference"], tmp_path / "j", monkeypatch)
    got = _feedback_script(*SIDES["port"], tmp_path / "t", monkeypatch)
    assert got == want
    assert got[2] == pytest.approx(0.5 * 0.2 + 0.5 * 0.4)
    assert got[-3] == 0.2 and got[-2] == "b64x128/f32"


def _stats(mod):
    return mod.synthetic_stats(rows=512, n_out_rows=256, n_dense_rows=256,
                               nnz=2048, tau=8)


@pytest.mark.parametrize("impls", [("reference",), ("reference", "cuda")])
@pytest.mark.parametrize("entries", ["none", "steered", "static_fastest"])
def test_choose_plan_feedback_picks_reference_candidate(impls, entries):
    """Measurements that contradict the model steer the pick; one that
    says the static plan is fastest keeps it; without entries the model
    decides.  Under TPU_V5E the port picks the reference's candidate and
    counts the same measured candidates."""
    j_impls = tuple({v: k for k, v in IMPL_NAMES.items()}[i] for i in impls)
    base = jauto.choose_plan(_stats(jcost), 64, impls=j_impls,
                             block_candidates=(16, 64, 128), widths=(1,),
                             schedulable=False)
    jfb, tfb = JO.PlanFeedback(), TO.PlanFeedback()
    static = JO.plan_key("reference", 128, 128, 128)
    if entries == "steered":
        base_key = JO.plan_key_from_plan(base.plan)
        jfb.record("bkt", base_key, 1.0)
        tfb.record("bkt", _port_names({"plan_key": base_key})["plan_key"],
                   1.0)
        for fb in (jfb, tfb):
            fb.record("bkt", JO.plan_key("reference", 64, 64, 64), 1e-12)
    elif entries == "static_fastest":
        for fb in (jfb, tfb):
            fb.record("bkt", static, 1e-9)
    want = jauto.choose_plan(_stats(jcost), 64, impls=j_impls,
                             block_candidates=(16, 64, 128), widths=(1,),
                             schedulable=False, feedback=jfb,
                             feedback_key="bkt")
    got = tauto.choose_plan(_stats(tcost), 64, impls=impls,
                            block_candidates=(16, 64, 128), widths=(1,),
                            schedulable=False, feedback=tfb,
                            feedback_key="bkt", device=tcost.TPU_V5E)
    assert TO.plan_key_from_plan(got.plan) == _port_names(
        {"plan_key": JO.plan_key_from_plan(want.plan)})["plan_key"]
    assert got.measured_used == want.measured_used
    assert got.n_candidates == want.n_candidates
    if entries == "steered":
        assert TO.plan_key_from_plan(got.plan) == TO.plan_key(
            "reference", 64, 64, 64)
    if entries == "static_fastest":
        assert TO.plan_key_from_plan(got.plan) == static
    if entries == "none":
        assert got.measured_used == 0


def test_feedback_pins_rung_plans_as_reference():
    """An autoplanned engine built over a store with entries for a rung
    serves every layer of it with the feedback-informed plan, as the
    reference's engine does (under TPU_V5E); other rungs keep the
    pipeline planner's plans.  Warmup builds them and serving builds
    nothing more."""
    probe = sp.port_engine(warm=False)._prepare([1, 2]).bucket
    fdim = sp.SPEC.feature_dim
    fbs = (JO.PlanFeedback(), TO.PlanFeedback())
    for fb, O in zip(fbs, (JO, TO)):
        fb.record(O.bucket_key(probe, fdim),
                  O.plan_key("reference", 128, 128, 128), 1e-9)
    jeng = sp.reference_engine(autoplan=True, feedback=fbs[0], warm=False)
    teng = sp.port_engine(autoplan=True, feedback=fbs[1], warm=False,
                          device_model=tcost.TPU_V5E)
    assert [(b.nodes, b.rows) for b in teng.batcher.ladder.entries] == \
        [(b.nodes, b.rows) for b in jeng.batcher.ladder.entries]
    for jb, tb in zip(jeng.batcher.ladder.entries,
                      teng.batcher.ladder.entries):
        want = [JO.plan_key_from_plan(p) for p in
                [jeng.batcher.plan_for_bucket(jb, fdim)]
                + jeng.batcher.layer_plans_for_bucket(jb, fdim)]
        got = [TO.plan_key_from_plan(p) for p in
               [teng.batcher.plan_for_bucket(tb, fdim)]
               + teng.batcher.layer_plans_for_bucket(tb, fdim)]
        assert got == [_port_names({"plan_key": k})["plan_key"]
                       for k in want]
    pinned = teng.batcher.layer_plans_for_bucket(probe, fdim)
    assert [TO.plan_key_from_plan(p) for p in pinned] == \
        [TO.plan_key("reference", 128, 128, 128)] * teng.cfg.n_layers
    built = teng.warmup()
    assert teng.batcher.layer_plans_for_bucket(probe, fdim) == pinned
    teng.query_batch(sp.requests(8))
    assert teng.compile_count == built


# ---------------------------------------------------------------------------
# eager execute_layer spans, the ledger's listeners
# ---------------------------------------------------------------------------


def _layer_case():
    adj = j_random_csr(48, 48, 300, seed=3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((48, 8)).astype(np.float32)
    layer = {"w": rng.standard_normal((8, 8)).astype(np.float32),
             "b": np.zeros((8,), np.float32)}
    return adj, x, layer


@pytest.mark.parametrize("impl,precision,fused", [
    ("reference", "f32", False), ("cuda", "int8", False),
    ("cuda", "bf16", True)])
def test_eager_execute_layer_span_matches_reference(impl, precision, fused):
    """One ``execute_layer`` under an active span: one child span with the
    resolved plan's attributes and the layer's ledger records as events,
    as the reference opens it; no span outside an active one."""
    import jax.numpy as jnp

    adj, x, layer = _layer_case()
    kw = dict(block_rows=16, block_k=16, block_f=16, precision=precision,
              fused=fused)
    jres = j_preprocess(adj, tau=4, tile_rows=16)
    tres = t_preprocess(TCSR(indptr=adj.indptr, indices=adj.indices,
                             data=adj.data, shape=adj.shape),
                        tau=4, tile_rows=16)
    j_impl = {v: k for k, v in IMPL_NAMES.items()}[impl]
    jlayer = {k: jnp.asarray(v) for k, v in layer.items()}
    tlayer = {k: torch.as_tensor(v) for k, v in layer.items()}
    if precision == "int8":
        from repro.exec import quant as jquant
        from repro_torch.exec import quant as tquant

        jlayer = jquant.quantize_params({"l": jlayer}, "int8", 16)["l"]
        tlayer = tquant.quantize_params({"l": tlayer}, "int8", 16)["l"]
    out = {}
    for name, O, R, run in (
        ("reference", JO, JR, lambda: j_execute_layer(
            JPlan(impl=j_impl, interpret=True, **kw),
            JOperands.from_ell(jres.ell), jnp.asarray(x), jlayer,
            w_block_rows=16)),
        ("port", TO, TR, lambda: t_execute_layer(
            TPlan(impl=impl, **kw), TOperands.from_ell(tres.ell, "cpu"),
            torch.as_tensor(x), tlayer, w_block_rows=16)),
    ):
        tracer = O.Tracer(clock=R.VirtualClock())
        trace = tracer.trace("eager")
        with O.use_span(trace.root):
            first = np.asarray(run())
        second = np.asarray(run())
        out[name] = (trace.to_dict(), first, second)
    want, got = out["reference"], out["port"]
    assert got[0] == _port_names(want[0])
    [span] = [s for s in got[0]["spans"] if s["name"] == "execute_layer"]
    kinds = {e["attributes"]["kind"] for e in span["events"]}
    assert "spmm_dram" in kinds or "fused_writeback_saved" in kinds
    assert sp.rel_max_err(got[1], want[1]) <= 1e-5
    np.testing.assert_array_equal(got[1], got[2])


def test_eager_gcn_forward_spans_match_reference():
    """A two-layer eager forward under an active span: the reference's
    two ``execute_layer`` spans, attributes and ledger events."""
    import jax.numpy as jnp

    adj, _, _ = _layer_case()
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((48, 6)).astype(np.float32)
    params = {f"layer_{i}": {"w": rng.standard_normal(s).astype(np.float32),
                             "b": rng.standard_normal(s[1]).astype(
                                 np.float32)}
              for i, s in enumerate([(6, 8), (8, 3)])}
    dims = dict(in_dim=6, hidden_dim=8, out_dim=3, tau=4, tile_rows=16,
                block_rows=16, block_k=16, block_f=16)
    jcfg, tcfg = JConfig(**dims), TConfig(**dims)
    tadj = TCSR(indptr=adj.indptr, indices=adj.indices, data=adj.data,
                shape=adj.shape)
    jg, tg = JGraph.build(adj, jcfg), TGraph.build(tadj, tcfg)
    runs = {
        "reference": (JO, JR, lambda: j_gcn_forward(
            {n: {k: jnp.asarray(v) for k, v in l.items()}
             for n, l in params.items()}, jg, jnp.asarray(feats), jcfg)),
        "port": (TO, TR, lambda: t_gcn_forward(
            {n: {k: torch.as_tensor(v) for k, v in l.items()}
             for n, l in params.items()}, tg, feats, tcfg, device="cpu")),
    }
    out = {}
    for name, (O, R, run) in runs.items():
        tracer = O.Tracer(clock=R.VirtualClock())
        trace = tracer.trace("eager")
        with O.use_span(trace.root):
            logits = np.asarray(run())
        out[name] = (trace.to_dict(), logits)
    assert out["port"][0] == _port_names(out["reference"][0])
    layers = [s for s in out["port"][0]["spans"]
              if s["name"] == "execute_layer"]
    assert len(layers) == 2 and all(s["events"] for s in layers)
    assert sp.rel_max_err(out["port"][1], out["reference"][1]) <= 1e-5


def test_ledger_listeners_and_mute():
    """Listeners see every record and never change the tallies; ``reset``
    keeps them; a muted thread records nothing, other threads still do."""
    import threading

    from repro_torch.dist.collectives import CollectiveLedger

    ledger = CollectiveLedger()
    seen = []
    ledger.listeners.append(lambda *a: seen.append(a))
    ledger.record("spmm_dram", 10.0)
    ledger.record_fused_writeback(4.0)
    assert ledger.counts == {"spmm_dram": 1, "activation_dram": 1,
                             "fused_writeback_saved": 1}
    assert seen == [("spmm_dram", 10.0, 1), ("activation_dram", 0.0, 1),
                    ("fused_writeback_saved", 4.0, 1)]
    ledger.reset()
    assert ledger.listeners and not ledger.counts
    with ledger.muted():
        ledger.record("spmm_dram", 1.0)
        other = threading.Thread(target=ledger.record,
                                 args=("combination_dram", 2.0))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    ledger.record("spmm_dram", 3.0)
    assert ledger.counts == {"combination_dram": 1, "spmm_dram": 1}
    assert ledger.bytes == {"combination_dram": 2.0, "spmm_dram": 3.0}
    assert TO.install_ledger_listener() in (True, False)
    assert TO.install_ledger_listener() is False
    assert len([f for f in T_LEDGER.listeners
                if f.__module__ == "repro_torch.obs.trace"]) == 1


# ---------------------------------------------------------------------------
# fleet: traces, tenant attribution, per-method ACLs (tests/test_obs.py)
# ---------------------------------------------------------------------------

FLEETS = {"reference": (JO, JR, JF), "port": (TO, TR, TF)}


def _fleet_tenant_trace(O, R, F):
    tracer = O.Tracer(clock=R.VirtualClock())
    clock, sv, rt, _ = fc.fleet(
        F, R, fc.fake_servable(F, R)("gcn"), tracer=tracer,
        tenants=[F.TenantPolicy("hot", deadline_s=1.0)])
    tracer.clock = rt.clock
    req = rt.submit("gcn", [1, 2], tenant="hot")
    rt.drain()
    return [fc.outcome(req), _dicts(tracer.drain()), rt.metrics.snapshot()]


def _fleet_acl(O, R, F):
    tracer = O.Tracer(clock=R.VirtualClock())
    clock, sv, rt, _ = fc.fleet(
        F, R, fc.fake_servable(F, R)("gcn"), tracer=tracer,
        tenants=[F.TenantPolicy("locked", qps=10.0, burst=2.0,
                                allowed_methods=("other",))])
    tracer.clock = rt.clock
    out = [fc.verdict(rt.submit, "gcn", [1], tenant="locked")]
    return out + [_dicts(tracer.drain()), rt.tenants.state("locked"),
                  rt.metrics.snapshot()]


@pytest.mark.parametrize("script", [_fleet_tenant_trace, _fleet_acl],
                         ids=["tenant_and_servable", "acl_before_quota"])
def test_fleet_traces_match_reference(script):
    """The fleet cases of ``tests/test_obs.py``: the tenant and servable
    on the root span of a served request; an ACL denial that raises,
    counts ``rejected_acl`` (fleet-wide and per tenant and servable),
    finishes its trace with that status and burns no token — the same
    transcripts as the reference's."""
    want = script(*FLEETS["reference"])
    got = script(*FLEETS["port"])
    assert got == want
    if script is _fleet_tenant_trace:
        [trace] = got[1]
        root = trace["spans"][0]["attributes"]
        assert trace["status"] == "ok" and root["servable"] == "gcn"
        assert root["tenant"] == "hot" and root["priority"] == 0
        names = {s["name"] for s in trace["spans"]}
        assert {"admission", "execute"} <= names
    else:
        assert got[0] == "MethodDeniedError"
        assert got[1][0]["status"] == "rejected_acl"
        assert got[2] == {"tokens": 2.0, "inflight": 0}
        c = got[3]["counters"]
        assert c["rejected_acl"] == 1 and c["submitted"] == 1
        assert c[TR.labeled("rejected_acl", tenant="locked",
                            servable="gcn")] == 1


def _gcn_fleet_traces(engine, O, R, F):
    """A traced fleet over one GcnServable: three tenants' requests on a
    ``VirtualClock``, a fixed 10 ms estimate; the drained trace dicts."""
    clock = R.VirtualClock(start=50.0)
    tracer = O.Tracer(clock=clock)
    mgr = F.FleetManager(capacity_units=4.0, clock=clock)
    sv = mgr.register(engine.servable(key="toy"))
    sv._estimator = R.FixedEstimator(0.01)
    mgr.resolve("toy")
    rt = F.FleetRuntime(mgr, clock=clock, capacity=64, tracer=tracer)
    for i, seeds in enumerate(sp.requests(9, seed=2)):
        rt.submit("toy", seeds, tenant=("a", "b", None)[i % 3],
                  deadline_s=float(1 + i % 2))
        clock.advance(0.05)
    sp.drive(rt)
    rt.shutdown()
    return _dicts(tracer.drain())


@pytest.mark.parametrize("impl,precision,fused", [
    ("reference", "f32", None), ("cuda", "bf16", None)],
    ids=["reference-f32", "cuda-bf16"])
def test_gcn_fleet_traces_match_reference(impl, precision, fused):
    """A fleet's batches are traced through ``engine_batch_info`` with the
    servable on the execute span, and ledgered by ``record_batch_dram``:
    the same trace trees as the reference's, after the impl-name
    mapping."""
    jeng = sp.reference_engine(impl, precision, fused)
    teng = sp.port_engine(impl, precision, fused)
    want = _port_names(_gcn_fleet_traces(jeng, JO, JR, JF))
    got = _gcn_fleet_traces(teng, TO, TR, TF)
    assert got == want
    served = [t for t in got if t["status"] == "ok"]
    assert served
    for t in served:
        [ex] = [s for s in t["spans"] if s["name"] == "execute"]
        assert ex["attributes"]["servable"] == "toy"
        assert any(e["attributes"]["kind"] == "spmm_dram"
                   for e in ex["events"])
