"""The port's async runtime (``repro_torch.runtime``) against ``repro.runtime``.

Each pure case of ``tests/test_runtime.py`` is a script of submits, clock
steps, polls, cancels and loop steps written once against a runtime
module; it runs through both packages on a ``VirtualClock`` and returns a
transcript — batch membership, close reasons and close times, verdicts,
shed and reject accounting, ``metrics.snapshot()`` with its histograms —
and the two transcripts must be equal.  ``BucketEstimator`` under the
reference's device model equals the reference's estimates.  The port's
``ServeRuntime`` over its CPU engine is held against the reference's over
the JAX engine on the same requests, deadlines and priorities: the same
batches and metrics, and outputs within 1e-5 of the output scale at f32,
bf16 and int8, unfused and fused.  Threaded mode, both shutdowns and the
mismatched-graph rejection run through the port; every ``result()`` has a
timeout, so no test can hang.
"""

import json
import threading

import numpy as np
import pytest

import repro.runtime as JR
import repro_torch.runtime as TR
from repro.models.gcn import GCNConfig as JConfig
from repro.plan import cost as jcost
from repro.serve.batcher import Bucket as JBucket
from repro.serve.batcher import BucketLadder as JLadder
from repro_torch.graphs import datasets as tdatasets
from repro_torch.launch import serve_gcn
from repro_torch.models.gcn import GCNConfig as TConfig
from repro_torch.plan import cost as tcost
from repro_torch.serve.batcher import Bucket as TBucket
from repro_torch.serve.batcher import BucketLadder as TLadder

import _serve_parity as sp

SIDES = {"reference": (JR, JBucket), "port": (TR, TBucket)}


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "cache"))


# ---------------------------------------------------------------------------
# the pure cases of tests/test_runtime.py, one script each
# ---------------------------------------------------------------------------


def _req(R, B, bucket=(64, 128), deadline=None, priority=0, seeds=(0,)):
    return R.Request(graph_key="g", seeds=tuple(seeds), deadline=deadline,
                     priority=priority, bucket=B(*bucket), padded=object())


def _rig(R, *, capacity=8, max_batch=4, est=0.25, max_wait=None):
    clock = R.VirtualClock()
    queue = R.RequestQueue(capacity=capacity, clock=clock,
                           estimator=R.FixedEstimator(est))
    sched = R.BatchScheduler(queue, max_batch=max_batch, max_wait_s=max_wait)
    return clock, queue, sched


def _batches(batches):
    return [((b.bucket.nodes, b.bucket.rows), [r.seq for r in b.requests],
             b.reason, b.closed_at) for b in batches]


def _verdict(fn, *args):
    """The name of what ``fn(*args)`` raised, or ``"ok"``."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 — the verdict is the record
        return type(e).__name__
    return "ok"


def _outcome(req):
    if req.future.cancelled():
        return "cancelled"
    if not req.future.done():
        return "pending"
    exc = req.future.exception(timeout=0)
    return type(exc).__name__ if exc is not None else req.future.result(0)


def case_virtual_clock(R, B):
    clock = R.VirtualClock(start=10.0)
    out = [clock.now(), clock.advance(2.5)]
    out.append(_verdict(clock.advance, -1.0))
    out.append(_verdict(clock.set_time, 5.0))
    out.append(clock.set_time(20.0))
    return out


def case_queue_full(R, B):
    clock, queue, _ = _rig(R, capacity=2)
    queue.submit(_req(R, B))
    queue.submit(_req(R, B))
    victim = _req(R, B)
    return [_verdict(queue.submit, victim), _outcome(victim), queue.depth,
            queue.metrics.snapshot()]


def case_infeasible_deadline(R, B):
    clock, queue, _ = _rig(R, est=1.0)
    victim = _req(R, B, deadline=clock.now() + 0.5)
    out = [_verdict(queue.submit, victim), queue.depth]
    out.append(_verdict(queue.submit, _req(R, B, deadline=clock.now() + 1.0)))
    return out + [queue.depth, queue.metrics.snapshot()]


def case_cancellation(R, B):
    clock, queue, sched = _rig(R)
    keep, drop = _req(R, B), _req(R, B)
    queue.submit(keep)
    queue.submit(drop)
    out = [queue.cancel(drop), drop.future.cancelled(), queue.depth,
           queue.cancel(drop)]
    return out + [_batches(sched.flush()), queue.metrics.snapshot()]


def case_full_bucket(R, B):
    clock, queue, sched = _rig(R, max_batch=2)
    queue.submit(_req(R, B))
    out = [_batches(sched.poll())]
    queue.submit(_req(R, B))
    return out + [_batches(sched.poll()), queue.depth,
                  queue.metrics.snapshot()]


def case_deadline_close_time(R, B):
    clock, queue, sched = _rig(R, est=0.25)
    queue.submit(_req(R, B, deadline=10.0))
    out = [sched.next_close_time()]
    clock.set_time(9.749999)
    out.append(_batches(sched.poll()))
    clock.set_time(9.75)
    return out + [_batches(sched.poll()), queue.metrics.snapshot()]


def case_padded_width_estimate(R, B):
    clock, queue, sched = _rig(R, max_batch=4, est=0.25)

    class PerBatchEst:
        def estimate(self, bucket, batch=1):
            return 0.1 * batch

        def observe(self, *a):
            pass

    sched.estimator = PerBatchEst()
    for d in (10.0, 12.0, 11.0):
        queue.submit(_req(R, B, deadline=d))
    return [sched.next_close_time(), sched.padded_width(3)]


def case_adaptive_margin(R, B):
    clock, queue, sched = _rig(R, est=0.25)
    out = [sched.effective_close_margin_s]
    queue.submit(_req(R, B, deadline=10.0))
    out.append(sched.next_close_time())
    for lateness in (0.010, 0.010, -1.0):
        sched.observe_wakeup(lateness)
        out += [sched.effective_close_margin_s, sched.next_close_time()]
    _, _, sched2 = _rig(R, est=0.25)
    sched2.close_margin_s = 0.005
    sched2.observe_wakeup(0.001)
    out.append(sched2.effective_close_margin_s)
    for _ in range(50):
        sched2.observe_wakeup(0.1)
    return out + [sched2.effective_close_margin_s]


def case_unknown_servable(R, B):
    clock = R.VirtualClock()
    queue = R.RequestQueue(capacity=8, clock=clock,
                           key_check=lambda k: k == "good")
    queue.submit(R.Request(graph_key="good", seeds=(0,), bucket=B(64, 128),
                           padded=object()))
    victim = R.Request(graph_key="evil", seeds=(0,), bucket=B(64, 128),
                       padded=object())
    return [_verdict(queue.submit, victim), _outcome(victim), queue.depth,
            queue.metrics.snapshot()]


def case_edf_ordering(R, B):
    clock, queue, sched = _rig(R, max_batch=8)
    for d in (5.0, None, 3.0, 4.0):
        queue.submit(_req(R, B, deadline=d))
    clock.set_time(2.74)
    out = [_batches(sched.poll())]
    clock.set_time(2.75)
    return out + [_batches(sched.poll())]


def case_priority_tiers(R, B):
    clock, queue, sched = _rig(R, max_batch=8)
    queue.submit(_req(R, B, deadline=2.0, priority=0))
    queue.submit(_req(R, B, deadline=9.0, priority=1))
    return _batches(sched.flush())


def case_oversized_group(R, B):
    clock, queue, sched = _rig(R, max_batch=2, capacity=8)
    reqs = [_req(R, B, deadline=float(10 - i)) for i in range(3)]
    for r in reqs[:2]:
        queue.submit(r)
    out = [_batches(sched.poll())]
    queue.submit(reqs[2])
    return out + [queue.depth, [r.deadline for r in reqs]]


def case_poll_at_deadline(R, B):
    clock, queue, sched = _rig(R, est=0.25)
    queue.submit(_req(R, B, deadline=1.0))
    clock.set_time(1.0)
    return [_batches(sched.poll()), queue.metrics.snapshot()]


def case_expired_shed(R, B):
    clock, queue, sched = _rig(R, est=0.25)
    victim = _req(R, B, deadline=1.0)
    queue.submit(victim)
    queue.submit(_req(R, B, deadline=50.0))
    clock.set_time(1.01)
    out = [_batches(sched.poll()), queue.depth, _outcome(victim)]
    return out + [queue.metrics.shed_rate, queue.metrics.snapshot()]


def case_max_wait(R, B):
    clock, queue, sched = _rig(R, max_wait=0.5)
    queue.submit(_req(R, B))
    out = [sched.next_close_time()]
    clock.set_time(0.5)
    return out + [_batches(sched.poll())]


def case_max_wait_vs_deadline(R, B):
    clock, queue, sched = _rig(R, max_wait=0.5, est=0.25)
    queue.submit(_req(R, B, deadline=10.0))
    out = [sched.next_close_time()]
    queue.submit(_req(R, B))
    return out + [sched.next_close_time()]


def case_flush_chunks(R, B):
    clock, queue, sched = _rig(R, max_batch=2, capacity=8)
    for bucket in ((64, 128), (256, 512), (64, 128), (64, 128)):
        queue.submit(_req(R, B, bucket=bucket))
    return [_batches(sched.flush()), queue.metrics.snapshot()]


def case_loop_futures(R, B):
    clock, queue, sched = _rig(R, max_batch=2)
    loop = R.RuntimeLoop(sched, lambda batch: [
        f"out-{r.seq}" for r in batch.requests])
    r1, r2 = _req(R, B, deadline=10.0), _req(R, B, deadline=10.0)
    queue.submit(r1)
    clock.advance(1.0)
    queue.submit(r2)
    out = [loop.step(), _outcome(r1), _outcome(r2), r1.wait_s, r2.wait_s,
           r1.exec_s]
    return out + [queue.metrics.snapshot()]


def case_failing_batch(R, B):
    clock, queue, sched = _rig(R, max_batch=2, capacity=8)

    def runner(batch):
        if batch.bucket.nodes == 64:
            raise RuntimeError("kernel exploded")
        return [r.seq for r in batch.requests]

    loop = R.RuntimeLoop(sched, runner)
    reqs = [_req(R, B, bucket=b) for b in ((64, 128),) * 2 + ((256, 512),) * 2]
    for r in reqs:
        queue.submit(r)
    out = [loop.step(), [_outcome(r) for r in reqs]]
    more = [_req(R, B, bucket=(256, 512)) for _ in range(2)]
    for r in more:
        queue.submit(r)
    return out + [loop.step(), [_outcome(r) for r in more],
                  queue.metrics.snapshot()]


def case_shutdown_idempotent(R, B):
    clock, queue, sched = _rig(R, max_batch=1)

    def runner(batch):
        raise ValueError("always broken")

    loop = R.RuntimeLoop(sched, runner)
    loop.start()
    out = [loop.running]
    r = _req(R, B)
    queue.submit(r)
    loop.notify()
    exc = r.future.exception(timeout=5.0)
    out.append((type(exc).__name__, str(exc)))
    loop.shutdown()
    out.append(loop.running)
    loop.shutdown()
    loop.shutdown(timeout=0.0)
    return out + [queue.metrics.snapshot()]


def case_bucket_estimator(R, B):
    """The estimator's arithmetic under the reference's device model (the
    port's default, H100, is held against TPU_V5E in the test below)."""
    cfg = (JConfig if R is JR else TConfig)(in_dim=32, hidden_dim=8,
                                            out_dim=5)
    ladder = (JLadder if R is JR else TLadder)(
        entries=(B(64, 128), B(256, 512)), mean_row_nnz=3.0)
    est = R.BucketEstimator(cfg, ladder, device=jcost.TPU_V5E if R is JR
                            else tcost.TPU_V5E)
    out = [est.estimate(B(64, 128), 1), est.estimate(B(256, 512), 4)]
    est.observe(B(64, 128), 1, 0.5)
    out.append(est.estimate(B(64, 128), 1))
    est.observe(B(64, 128), 1, 1.0)
    return out + [est.estimate(B(64, 128), 1), est.estimate(B(64, 128), 2)]


def case_metrics_snapshot(R, B):
    m = R.MetricsRegistry()
    m.inc("submitted", 4)
    m.inc("admitted", 3)
    m.inc("rejected_queue_full")
    m.observe("e2e_s", 0.010)
    m.observe("e2e_s", 0.030)
    m.inc("slo_met")
    return [m.snapshot(), m.shed_rate, m.slo_attainment]


def case_histogram_reservoir(R, B):
    from importlib import import_module

    metrics = import_module(R.__name__ + ".metrics")
    h = metrics.Histogram(max_samples=8)
    for i in range(200):
        h.observe(i * 1e-3)
    small = metrics.Histogram()
    for v in (0.001, 0.002, 0.003):
        small.observe(v)
    return [h.count, list(h._values), h.summary_ms(), small.summary_ms(),
            _verdict(metrics.Histogram, 0)]


def case_histogram_deterministic(R, B):
    from importlib import import_module

    metrics = import_module(R.__name__ + ".metrics")
    a = metrics.Histogram(max_samples=4)
    for i in range(100):
        a.observe(float(i))
    big = metrics.Histogram()
    for i in range(5000):
        big.observe((i * 7919 % 1000) * 1e-4)
    return [list(a._values), a.count, big.summary_ms(), list(big._values)]


CASES = {f.__name__[5:]: f for f in (
    case_virtual_clock, case_queue_full, case_infeasible_deadline,
    case_cancellation, case_full_bucket, case_deadline_close_time,
    case_padded_width_estimate, case_adaptive_margin, case_unknown_servable,
    case_edf_ordering, case_priority_tiers, case_oversized_group,
    case_poll_at_deadline, case_expired_shed, case_max_wait,
    case_max_wait_vs_deadline, case_flush_chunks, case_loop_futures,
    case_failing_batch, case_shutdown_idempotent, case_bucket_estimator,
    case_metrics_snapshot, case_histogram_reservoir,
    case_histogram_deterministic)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_runtime_case_matches_reference(name):
    """One case of ``tests/test_runtime.py``: both packages give the same
    transcript, exactly."""
    want = CASES[name](*SIDES["reference"])
    got = CASES[name](*SIDES["port"])
    assert got == want


def test_port_cases_hold_the_reference_assertions():
    """The transcripts are equal; these are the reference's own claims on
    them, read from the port's."""
    full = CASES["full_bucket"](*SIDES["port"])
    assert full[0] == [] and full[1][0][2] == "full" and full[2] == 0
    close = CASES["deadline_close_time"](*SIDES["port"])
    assert close[0] == pytest.approx(9.75) and close[1] == []
    assert close[2][0][2:] == ("deadline", 9.75)
    edf = CASES["edf_ordering"](*SIDES["port"])
    assert edf[0] == [] and edf[1][0][1] == [2, 3, 0, 1]
    shed = CASES["expired_shed"](*SIDES["port"])
    assert shed[:3] == [[], 1, "DeadlineExceededError"]
    assert shed[3] == pytest.approx(0.5)
    queue_full = CASES["queue_full"](*SIDES["port"])
    assert queue_full[:3] == ["QueueFullError", "QueueFullError", 2]
    est = CASES["bucket_estimator"](*SIDES["port"])
    assert est[1] > est[0] > 0 and est[2] == pytest.approx(0.5)
    assert 0.5 < est[3] < 1.0 and est[4] != est[3]


def test_metrics_write_json_round_trips(tmp_path):
    m = TR.MetricsRegistry()
    m.inc("submitted", 2)
    m.observe("wait_s", 0.25)
    snap = m.write_json(str(tmp_path / "sub" / "metrics.json"))
    with open(tmp_path / "sub" / "metrics.json") as f:
        assert json.load(f) == snap


@pytest.mark.parametrize("impl", ["reference", "cuda", "cuda_sparse"])
def test_bucket_estimator_equals_reference_under_tpu_model(impl):
    """On the toy ladder (``tests/test_obs.py``'s 400-node graph, base
    rung 64), every (rung, batch) estimate equals the reference's to rel
    1e-12 under ``device=TPU_V5E``; the port's default is the H100 model,
    and an engine's runtime estimates with the engine's model."""
    jeng = sp.reference_engine(impl, warm=False)
    teng = sp.port_engine(impl, warm=False)
    jest = JR.BucketEstimator(jeng.cfg, jeng.batcher.ladder)
    test = TR.BucketEstimator(teng.cfg, teng.batcher.ladder,
                              device=tcost.TPU_V5E)
    assert TR.BucketEstimator(teng.cfg, teng.batcher.ladder).device \
        is tcost.H100
    assert teng.runtime().estimator.device is tcost.H100
    for jb, tb in zip(jeng.batcher.ladder.entries,
                      teng.batcher.ladder.entries):
        assert (jb.nodes, jb.rows) == (tb.nodes, tb.rows)
        for batch in (1, 2, 4):
            want = jest.estimate(jb, batch)
            assert test.estimate(tb, batch) == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------------------------------
# ServeRuntime over the engines of both packages
# ---------------------------------------------------------------------------


def _compare(got, want):
    assert got["batches"] == want["batches"]
    assert got["metrics"] == want["metrics"]
    assert len(got["outputs"]) == len(want["outputs"])
    for g, w in zip(got["outputs"], want["outputs"]):
        if isinstance(w, str):
            assert g == w
            continue
        assert g.shape == w.shape
        assert sp.rel_max_err(g, w) <= sp.RTOL


@pytest.mark.parametrize("precision", sp.PRECISIONS)
@pytest.mark.parametrize("impl,fused", sp.ENGINES,
                         ids=["reference", "cuda", "cuda-fused"])
def test_serve_runtime_matches_reference(impl, fused, precision):
    """The same requests, deadlines and priorities on a VirtualClock: the
    same batches (members, reasons, close times), sheds and metrics, and
    answers within 1e-5 of the output scale; no executable is built."""
    jeng = sp.reference_engine(impl, precision, fused)
    teng = sp.port_engine(impl, precision, fused)
    built = teng.compile_count
    want = sp.scenario(jeng, JR)
    got = sp.scenario(teng, TR)
    _compare(got, want)
    assert teng.compile_count == built
    c = got["metrics"]["counters"]
    assert c["shed_expired"] > 0 and c["completed"] > 0
    assert c["batches_full"] + c["batches_deadline"] + c["batches_flush"] \
        == len(got["batches"])
    reasons = {b[2] for b in got["batches"]}
    assert {"full", "deadline"} <= reasons


def _threaded_seeds():
    return sp.requests(8, seed=3)


def test_threaded_runtime_answers_as_the_reference():
    """Real clock, worker thread: every future resolves (under a timeout)
    with the reference's answer for its seeds, the deadline-carrying
    requests on time; no executable is built after warmup."""
    jeng = sp.reference_engine()
    want = [np.asarray(jeng.query(s)) for s in _threaded_seeds()]
    teng = sp.port_engine()
    built = teng.compile_count
    with teng.runtime(capacity=32) as rt:
        assert rt.loop.running
        reqs = [rt.submit(s, deadline_s=5.0) for s in _threaded_seeds()[:6]]
        reqs += [rt.submit(s) for s in _threaded_seeds()[6:]]
        outs = [r.future.result(timeout=60.0) for r in reqs]
    assert not rt.loop.running
    for g, w in zip(outs, want):
        assert g.shape == w.shape and sp.rel_max_err(g, w) <= sp.RTOL
    m = rt.metrics
    assert m.count("completed") == 8 and m.count("failed") == 0
    assert m.count("slo_met") == 6 and m.slo_attainment == 1.0
    assert teng.compile_count == built
    rt.shutdown()


def test_threaded_submitters_and_worker_share_the_batcher():
    """Four submitting threads and the worker: every request completes
    once, with the answer of its seeds, and the batcher ran each batch
    once (a lost update in the shared counts would break the sums)."""
    import sys

    teng = sp.port_engine()
    seeds = sp.requests(32, seed=9)
    want = {i: teng.query(s) for i, s in enumerate(seeds)}
    calls0 = teng.batcher.calls
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with teng.runtime(capacity=64) as rt:
            got = {}

            def submit(part):
                for i in part:
                    got[i] = rt.submit(seeds[i])

            threads = [threading.Thread(target=submit,
                                        args=(range(k, 32, 4),))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
                assert not t.is_alive()
            outs = {i: r.future.result(timeout=60.0) for i, r in got.items()}
    finally:
        sys.setswitchinterval(switch)
    assert sorted(outs) == list(range(32))
    for i, out in outs.items():
        np.testing.assert_allclose(out, want[i], rtol=1e-6, atol=1e-6)
    m = rt.metrics.snapshot()["counters"]
    assert m["completed"] == 32 and m["failed"] == 0
    batches = m["batches_full"] + m["batches_deadline"] + m["batches_flush"]
    assert teng.batcher.calls - calls0 == batches


def _shutdown_script(engine, R, mode):
    """Hard shutdown of a never-started runtime, or graceful drain with
    and without the worker; returns the transcript."""
    from importlib import import_module

    queue_mod = import_module(R.__name__ + ".queue")
    if mode == "hard":
        rt = engine.runtime(capacity=8)
        req = rt.submit([1, 2], deadline_s=60.0)
        rt.shutdown()
        out = [req.future.cancelled(), rt.queue.depth]
        rt.shutdown()
        return out + [rt.metrics.count("cancelled"),
                      rt.metrics.count("completed")]
    if mode == "drain":
        rt = engine.runtime(capacity=None)
        reqs = [rt.submit([i, i + 1]) for i in range(5)]
        rt.shutdown(drain=True)
        outs = [np.asarray(r.future.result(timeout=0)) for r in reqs]
        out = [rt.queue.depth, rt.queue.closed,
               _verdict(rt.submit, [0]), rt.metrics.count("rejected_closed")]
        rt.shutdown(drain=True)
        assert issubclass(queue_mod.QueueClosedError, R.AdmissionError)
        return out + [rt.metrics.count("completed"),
                      rt.metrics.count("cancelled"), outs]
    rt = engine.runtime(capacity=32).start()
    reqs = [rt.submit([i]) for i in range(6)]
    rt.shutdown(drain=True, timeout=10.0)
    outs = [np.asarray(r.future.result(timeout=30)) for r in reqs]
    return [rt.loop.running, rt.metrics.count("completed"), outs]


@pytest.mark.parametrize("mode", ["hard", "drain", "drain_running"])
def test_shutdown_matches_reference(mode):
    """Hard shutdown cancels what is queued; a graceful one flushes it
    (with the worker running too, no request runs twice) and closes the
    door: the same counts as the reference, and its answers."""
    want = _shutdown_script(sp.reference_engine(), JR, mode)
    got = _shutdown_script(sp.port_engine(), TR, mode)
    w_outs = want.pop() if mode != "hard" else []
    g_outs = got.pop() if mode != "hard" else []
    assert got == want
    for g, w in zip(g_outs, w_outs):
        assert g.shape == w.shape and sp.rel_max_err(g, w) <= sp.RTOL
    if mode == "hard":
        assert got == [True, 0, 1, 0]


def _graph_key_script(engine, R):
    rt = engine.runtime(capacity=8, clock=R.VirtualClock())
    ok = rt.submit([0, 1])
    out = [_verdict(lambda: rt.submit([0, 1], graph_key="bogus"))]
    rt.submit([2], graph_key=rt.graph_key)
    rt.drain()
    outs = np.asarray(ok.future.result(timeout=0))
    return out + [rt.graph_key, rt.metrics.snapshot()], outs


def test_mismatched_graph_key_rejected_as_reference():
    want, w_out = _graph_key_script(sp.reference_engine(), JR)
    got, g_out = _graph_key_script(sp.port_engine(), TR)
    assert got == want
    assert got[0] == "UnknownServableError"
    assert sp.rel_max_err(g_out, w_out) <= sp.RTOL


def test_submit_rejects_both_deadline_forms():
    rt = sp.port_engine(warm=False).runtime(clock=TR.VirtualClock())
    with pytest.raises(ValueError, match="not both"):
        rt.submit([0], deadline_s=1.0, deadline=5.0)
    rt.shutdown()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def toy_dataset(monkeypatch):
    monkeypatch.setitem(tdatasets.DATASETS, "toy", tdatasets.DatasetSpec(
        "toy", nodes=400, edges=1_600, feature_dim=32, classes=5))


def test_cli_async_writes_four_files_that_parse(toy_dataset, tmp_path,
                                                capsys):
    """``--runtime-async`` with every observability flag writes the
    traces, the metrics (JSON and Prometheus text) and the feedback store;
    a second run loads the store it saved."""
    paths = {k: str(tmp_path / "out" / name) for k, name in (
        ("trace", "traces.json"), ("prom", "metrics.prom"),
        ("json", "metrics.json"), ("fb", "feedback.json"))}
    # batches of one close as they arrive, and no deadline can lapse on a
    # loaded host: every request completes
    argv = ["--dataset", "toy", "--reduced", "--requests", "12", "--batch",
            "1", "--deadline-ms", "60000", "--scenario", "batch",
            "--runtime-async", "--qps", "500",
            "--trace-json", paths["trace"], "--metrics-prom", paths["prom"],
            "--metrics-json", paths["json"], "--plan-feedback", paths["fb"]]
    serve_gcn.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "async: offered 12 @ 500 qps, completed 12" in out
    with open(paths["trace"]) as f:
        traces = json.load(f)["traces"]
    assert len(traces) == 12 and all(t["status"] == "ok" for t in traces)
    with open(paths["json"]) as f:
        snap = json.load(f)
    assert snap["counters"]["completed"] == 12
    with open(paths["prom"]) as f:
        prom = f.read()
    assert "repro_completed 12" in prom and "# TYPE repro_e2e_s_ms summary" \
        in prom
    with open(paths["fb"]) as f:
        store = json.load(f)
    assert store["version"] == 1 and store["entries"]
    serve_gcn.main(argv, device="cpu")
    assert (f"[obs] plan feedback loaded from {paths['fb']}: "
            f"{sum(len(p) for p in store['entries'].values())} measured") \
        in capsys.readouterr().out
