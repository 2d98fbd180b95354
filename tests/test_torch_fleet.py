"""The port's fleet (``repro_torch.fleet``) against ``repro.fleet``.

Each pure case of ``tests/test_fleet.py`` (and a ``predictive_unload``
case) is a script in ``tests/_fleet_cases.py`` run through both packages
on a ``VirtualClock`` with the same ``FakeServable``; the transcripts —
batch membership and order, close reasons, per-tenant shed and reject
accounting, inflight release on completion, cancel and shed,
``loads``/``unloads`` and ``metrics.snapshot()`` — must be equal.  A port
``GcnServable`` over ``tests/_serve_parity.py``'s toy engine serves a
fleet scenario as the reference's does, within 1e-5 of the output scale
at f32, bf16 and int8, unfused and fused; a one-servable fleet is
bit-identical to the port's ``ServeRuntime``; ``fleet_from_config``
builds a GCN fleet and ``examples/fleet_smoke.json``'s GCN + LM fleet.
The reference's LM fleet cases run through the port in
``tests/test_torch_lm_serve.py``.
"""

import json

import numpy as np
import pytest
import torch

import repro.fleet as JF
import repro.runtime as JR
import repro_torch.fleet as TF
import repro_torch.runtime as TR
from repro_torch.graphs import datasets as tdatasets
from repro_torch.launch import serve_gcn

import _fleet_cases as fc
import _serve_parity as sp

SIDES = {"reference": (JF, JR), "port": (TF, TR)}


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "cache"))


# ---------------------------------------------------------------------------
# the pure cases of tests/test_fleet.py, one script each
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(fc.CASES))
def test_fleet_case_matches_reference(name):
    """One case: both packages give the same transcript, exactly."""
    want = fc.CASES[name](*SIDES["reference"])
    got = fc.CASES[name](*SIDES["port"])
    assert got == want


def test_port_cases_hold_the_reference_assertions():
    """The transcripts are equal; these are the reference's own claims on
    them, read from the port's."""
    P = SIDES["port"]
    first, again = fc.CASES["two_servables"](*P)
    assert first[0] == [(0.95, "b", 1), (0.99, "a", 1)] and again == first
    groups, a_ran, b_ran = fc.CASES["no_mixed_buckets"](*P)[:3]
    assert groups == 2 and a_ran == [1] and b_ran == [1]
    assert fc.CASES["per_servable_profile"](*P)[0] == [("a", 2, "full")]
    first, picks = fc.CASES["weighted_fair_pick"](*P)
    assert first.index("cold") <= 1
    head = [f for f, _ in picks[:12]]
    assert head.count("h") == 8 and head.count("c") == 4
    q = fc.CASES["quota"](*P)
    assert q[:5] == ["ok", "ok"] + ["QuotaExceededError"] * 3
    assert q[6:10] == ["ok", "QuotaExceededError", "ok", "ok"]
    c = q[-1]["counters"]
    assert c["rejected_quota"] == 4 and c["completed"] == 5
    assert c["submitted"] == 9
    cap = fc.CASES["inflight_cap"](*P)
    assert cap[0] == "InflightLimitError" and cap[1]["inflight"] == 2
    assert cap[3]["inflight"] == 0 and cap[4] == "ok"
    rel = fc.CASES["inflight_release"](*P)
    assert rel[0] is True and rel[1]["inflight"] == 0
    assert rel[3] == "DeadlineExceededError" and rel[4]["inflight"] == 0
    slo = fc.CASES["slo_class"](*P)
    assert slo[0][0] == 2 and slo[0][1] == pytest.approx(1.5)
    assert slo[1] == (0, pytest.approx(9.0))
    hot, cold, _, snap = fc.CASES["hot_vs_cold"](*P)
    assert hot.count("QuotaExceededError") == 8
    assert all(isinstance(o, list) for o in cold)
    assert snap["counters"]["rejected_queue_full"] == 0
    unknown = fc.CASES["unknown_servable"](*P)
    assert unknown[:3] == ["UnknownServableError", {"tokens": 1.0,
                                                    "inflight": 0},
                           "UnknownServableError"]
    lru = fc.CASES["lazy_load_lru"](*P)
    assert lru[:2] == [False, 0]
    assert lru[5] == ("c", 3, 1, [True, False, True])
    assert lru[6] == ("b", 4, 2, [False, True, True])
    weighted = fc.CASES["weighted_costs"](*P)
    assert weighted[0] == "ValueError" and weighted[1]["big"][1] == 1
    outs, loads = fc.CASES["serve_through_reload"](*P)[:2]
    assert outs == [[1.0], [2.0], [3.0]] and loads["a"][0] == 2
    lru_run, predictive = fc.CASES["predictive_unload"](*P)
    assert lru_run[1] == [False, True, True]       # LRU evicts a
    assert predictive[1] == [True, False, True]    # the rate evicts b


# ---------------------------------------------------------------------------
# GcnServable over the engines of both packages
# ---------------------------------------------------------------------------


def _fleet_scenario(engine, F, R, n=12):
    """Two tenants on one GcnServable on a ``VirtualClock`` at 100 s: the
    cold tenant's requests carry 1-3 s deadlines, the hot tenant's
    quota (2 req/s, burst 3) sheds some of its own; a fixed 10 ms
    estimate on both sides.  Returns the outputs (or exception names),
    the batches, the metrics snapshot and the manager's counts."""
    clock = R.VirtualClock(start=100.0)
    mgr = F.FleetManager(capacity_units=4.0, clock=clock)
    sv = mgr.register(engine.servable(key="toy"))
    sv._estimator = R.FixedEstimator(0.01)
    mgr.resolve("toy")
    rt = F.FleetRuntime(mgr, clock=clock, capacity=64, tenants=F.TenantTable(
        [F.TenantPolicy("cold", priority=1),
         F.TenantPolicy("hot", qps=2.0, burst=3)]))
    log = fc.log_batches(rt)
    reqs, verdicts = [], []
    for i, seeds in enumerate(sp.requests(n)):
        tenant = "hot" if i % 2 else "cold"
        try:
            reqs.append(rt.submit("toy", seeds, tenant=tenant,
                                  deadline_s=float(1 + i % 3)))
            verdicts.append("ok")
        except R.AdmissionError as e:
            verdicts.append(type(e).__name__)
        clock.advance(0.1)
    sp.drive(rt)
    outputs = []
    for r in reqs:
        exc = r.future.exception(timeout=10)
        outputs.append(type(exc).__name__ if exc is not None
                       else np.asarray(r.future.result(timeout=10)))
    rt.shutdown()
    return {"outputs": outputs, "verdicts": verdicts,
            "batches": [(b[0], (b[1].nodes, b[1].rows)) + tuple(b[2:])
                        for b in log],
            "metrics": rt.metrics.snapshot(),
            "counts": (mgr.loads, mgr.unloads)}


@pytest.mark.parametrize("precision", sp.PRECISIONS)
@pytest.mark.parametrize("impl,fused", sp.ENGINES,
                         ids=["reference", "cuda", "cuda-fused"])
def test_gcn_servable_matches_reference(impl, fused, precision):
    """The same tenants, requests and clock steps through each package's
    fleet over its toy engine: the same admissions, batches and metrics,
    answers within 1e-5 of the output scale, no executable built."""
    jeng = sp.reference_engine(impl, precision, fused)
    teng = sp.port_engine(impl, precision, fused)
    built = teng.compile_count
    want = _fleet_scenario(jeng, JF, JR)
    got = _fleet_scenario(teng, TF, TR)
    assert got["verdicts"] == want["verdicts"]
    assert "QuotaExceededError" in got["verdicts"]
    assert got["batches"] == want["batches"]
    assert got["metrics"] == want["metrics"]
    assert got["counts"] == want["counts"] == (1, 0)
    assert teng.compile_count == built    # warmed: load() built nothing
    assert len(got["outputs"]) == len(want["outputs"])
    for g, w in zip(got["outputs"], want["outputs"]):
        if isinstance(w, str):
            assert g == w
            continue
        assert g.shape == w.shape and sp.rel_max_err(g, w) <= sp.RTOL


def _drive(rt, clock):
    for _ in range(64):
        rt.loop.step()
        nxt = rt.scheduler.next_close_time()
        if nxt is None:
            break
        if nxt > clock.now():
            clock.set_time(nxt)
    rt.loop.drain()


def test_single_gcn_servable_bit_identical_to_serve_runtime():
    """Same submissions, same clock steps -> byte-identical outputs and
    batch counts from a one-servable fleet and the engine's runtime (the
    reference's acceptance test, on the port)."""
    engine = sp.port_engine()
    rng = np.random.default_rng(5)
    requests = [rng.choice(400, size=int(rng.integers(1, 5)), replace=False)
                for _ in range(13)]
    deadlines = [float(1 + (i % 3)) for i in range(len(requests))]

    clock_a = TR.VirtualClock(start=100.0)
    solo = TR.ServeRuntime(engine, capacity=64, clock=clock_a)
    solo_log = fc.log_batches(solo)
    solo_reqs = [solo.submit(s, deadline_s=d)
                 for s, d in zip(requests, deadlines)]
    _drive(solo, clock_a)

    clock_b = TR.VirtualClock(start=100.0)
    mgr = TF.FleetManager(capacity_units=4.0)
    mgr.register(engine.servable(key="toy"))
    mgr.resolve("toy")
    fleet = TF.FleetRuntime(mgr, clock=clock_b, capacity=64)
    fleet_log = fc.log_batches(fleet)
    fleet_reqs = [fleet.submit("toy", s, deadline_s=d)
                  for s, d in zip(requests, deadlines)]
    _drive(fleet, clock_b)

    for a, b in zip(solo_reqs, fleet_reqs):
        np.testing.assert_array_equal(a.future.result(timeout=0),
                                      b.future.result(timeout=0))
    assert [b[2:] for b in solo_log] == [b[2:] for b in fleet_log]
    for key in ("batches_full", "batches_deadline", "batches_flush",
                "completed"):
        assert solo.metrics.count(key) == fleet.metrics.count(key), key


def test_gcn_servable_reload_rebuilds_its_grid():
    """``unload`` drops every executable and ``load`` builds the grid
    again: ``compiles`` grows by the grid at each reload and nowhere
    else, and the answers after a reload are the answers before it."""
    engine = sp.port_engine(warm=False)
    sv = engine.servable(key="toy")
    sv.load()
    grid = engine.compile_count
    seeds = sp.requests(4)
    before = [engine.query(s) for s in seeds]
    assert engine.compile_count == grid and grid > 0
    for cycle in range(1, 3):
        sv.unload()
        assert not engine.batcher._executables
        sv.load()
        assert engine.compile_count == grid * (cycle + 1)
        for s, want in zip(seeds, before):
            np.testing.assert_array_equal(engine.query(s), want)
    assert engine.compile_count == 3 * grid
    assert sv.cost_units() == 1.0 and sv.profile().max_batch == 4


def test_threaded_fleet_reloads_while_submitting():
    """Real clock, worker thread, capacity for one of two servables:
    requests alternate between them, so the worker and the submitting
    thread both load and evict; every future resolves with its engine's
    answer, every build happens inside a load, and no batch mixes
    servables."""
    engines = {"a": sp.port_engine(warm=False),
               "b": sp.port_engine(warm=False, fanout=3)}
    mgr = TF.FleetManager(capacity_units=1.0)
    grids = {}
    for key, engine in engines.items():
        sv = mgr.register(engine.servable(key=key))
        load = sv.load

        def counted(load=load, engine=engine, key=key):
            before = engine.compile_count
            load()
            grids.setdefault(key, []).append(engine.compile_count - before)

        sv.load = counted
    seeds = sp.requests(12, seed=4)
    want = {k: [e.query(s) for s in seeds] for k, e in engines.items()}
    for e in engines.values():
        e.batcher.clear_executables()
    compiles0 = {k: e.compile_count for k, e in engines.items()}
    mixed = []
    with TF.FleetRuntime(mgr, capacity=64) as rt:
        execute = rt.loop.execute

        def checked(batch):
            mixed.extend(r.graph_key for r in batch.requests
                         if r.graph_key != batch.bucket.servable)
            return execute(batch)

        rt.loop.execute = checked
        reqs = [(k, i, rt.submit(k, s))
                for i, s in enumerate(seeds) for k in ("a", "b")]
        outs = [(k, i, r.future.result(timeout=120.0)) for k, i, r in reqs]
    assert not mixed
    for k, i, out in outs:
        np.testing.assert_allclose(out, want[k][i], rtol=1e-6, atol=1e-6)
    for k, e in engines.items():
        assert e.compile_count - compiles0[k] == sum(grids[k])
        assert len(set(grids[k])) == 1 and grids[k][0] > 0
    assert mgr.loads >= 2 and mgr.unloads >= 1
    assert rt.metrics.count("completed") == 24
    assert rt.metrics.count("failed") == 0


# ---------------------------------------------------------------------------
# config, LM, CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def toy_dataset(monkeypatch):
    monkeypatch.setitem(tdatasets.DATASETS, "toy", tdatasets.DatasetSpec(
        "toy", nodes=400, edges=1_600, feature_dim=32, classes=5))


def _config():
    return {
        "servables": [
            {"kind": "gcn", "key": "toy", "dataset": "toy", "hidden_dim": 8,
             "fanout": 4, "max_batch": 4, "max_seeds": 4,
             "base_bucket_nodes": 64, "cost": 1.0},
        ],
        "capacity_units": 2.0,
        "tenants": [
            {"name": "gold", "priority": 1, "deadline_s": 5.0},
            {"name": "free", "qps": 1.0, "burst": 1.0},
            {"name": "locked", "allowed_methods": ["other"]},
        ],
        "weights": {"toy": 2.0},
    }


def test_fleet_config_round_trip(toy_dataset):
    """The ``--fleet-config`` schema builds a runnable GCN fleet whose
    answers are its engine's."""
    clock = TR.VirtualClock()
    rt = TF.fleet_from_config(_config(), clock=clock, device="cpu")
    assert rt.manager.knows("toy") and not rt.manager.knows("lm")
    sv = rt.manager.servable("toy")
    assert isinstance(sv, TF.GcnServable) and sv.cost_units() == 1.0
    assert sv.engine.device.type == "cpu"
    assert rt.tenants.policy("locked").allowed_methods == ("other",)
    r = rt.submit("toy", [1, 2, 3], tenant="gold")
    assert r.priority == 1 and r.deadline == pytest.approx(5.0)
    rt.submit("toy", [4], tenant="free")
    with pytest.raises(TF.QuotaExceededError):
        rt.submit("toy", [5], tenant="free")
    with pytest.raises(TF.MethodDeniedError):
        rt.submit("toy", [5], tenant="locked")
    clock.advance(0.1)
    rt.drain()
    np.testing.assert_array_equal(r.future.result(timeout=0),
                                  sv.engine.query([1, 2, 3]))


def test_lm_servables_wait_for_a13():
    """The LM servables of ROADMAP A13 are served:
    ``examples/fleet_smoke.json`` builds its GCN and its LM servable and
    serves both: every load warms its grid, a request of each kind
    completes with its servable's answer, and no executable is built
    after the loads.  Unknown kinds raise; the LM payload types are plain
    data."""
    import os

    from repro_torch.models import lm as tlm

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "fleet_smoke.json")
    with open(path) as f:
        config = json.load(f)
    clock = TR.VirtualClock(start=10.0)
    rt = TF.fleet_from_config(config, clock=clock, device="cpu")
    assert sorted(rt.manager.keys()) == ["cora", "lm"]
    for key in rt.manager.keys():
        rt.manager.resolve(key)
    gcn, lm = rt.manager.servable("cora"), rt.manager.servable("lm")
    assert isinstance(gcn, TF.GcnServable) and isinstance(lm, TF.LmServable)
    assert lm.compiles == 3                      # seq 16 x batch (1, 2, 4)
    builds = (gcn.engine.compile_count, lm.compiles)
    rng = np.random.default_rng(2)
    payload = list(rng.integers(0, lm.cfg.vocab, size=12))
    r_lm = rt.submit("lm", payload, tenant="cold", deadline_s=2.0)
    r_gcn = rt.submit("cora", [1, 2, 3], tenant="cold", deadline_s=2.0)
    _drive(rt, clock)
    toks = torch.zeros((1, 16), dtype=torch.long)
    toks[0, :12] = torch.as_tensor(payload)
    want = tlm.forward(lm.params, lm.cfg, toks)[0, 11].numpy()
    np.testing.assert_allclose(r_lm.future.result(timeout=0), want,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(r_gcn.future.result(timeout=0),
                                  gcn.engine.query([1, 2, 3]))
    assert (gcn.engine.compile_count, lm.compiles) == builds
    assert rt.metrics.count("completed") == 2
    with pytest.raises(ValueError, match="unknown servable kind"):
        TF.build_servable({"kind": "ssm"})
    p = TF.LmPrepared(bucket=TF.SeqBucket(8),
                      tokens=np.zeros(8, np.int32), n_tokens=3)
    assert p.bucket < TF.SeqBucket(16) and p.n_tokens == 3


def test_cli_fleet_config_serves_the_toy_fleet(toy_dataset, tmp_path,
                                               capsys):
    """``--fleet-config`` loads every servable, drives each tenant's
    stream open loop and prints the fleet line and one line per load;
    the ``obs`` flags write their files."""
    config = _config()
    config["servables"].append(dict(config["servables"][0], key="toy2",
                                    fanout=3))
    config["capacity_units"] = 1.0          # one resident: reloads
    config["tenants"] = [{"name": "cold", "priority": 1},
                         {"name": "hot", "qps": 20.0, "burst": 4.0}]
    # a partial batch closes on its deadline trigger, ~2 s in
    config["loads"] = [
        {"tenant": "cold", "servable": "toy", "qps": 200, "requests": 6,
         "deadline_ms": 2000},
        {"tenant": "hot", "servable": "toy2", "qps": 400, "requests": 12,
         "deadline_ms": 2000}]
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(config))
    traces = tmp_path / "traces.json"
    metrics = tmp_path / "metrics.json"
    serve_gcn.main(["--fleet-config", str(path), "--trace-json",
                    str(traces), "--metrics-json", str(metrics)],
                   device="cpu")
    out = capsys.readouterr().out
    assert "[fleet] 2 servables loaded" in out
    assert "fleet: offered 18 over " in out
    assert "tenant cold -> toy: slo " in out
    assert "tenant hot -> toy2: slo " in out
    snap = json.loads(metrics.read_text())
    c = snap["counters"]
    assert c["submitted"] == 18 and c["completed"] > 0
    assert c["submitted"] == c["completed"] + c["rejected_quota"] \
        + c["rejected_infeasible"] + c["shed_expired"]
    assert c["rejected_quota"] > 0 and c["failed"] == 0
    assert len(json.loads(traces.read_text())["traces"]) == 18
