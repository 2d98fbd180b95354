"""The phase reader on the CPU: a synthetic profiler trace with the
program's ``gcn.*`` ranges, launches and their correlations, and idle
gaps; and ``devtrace.read`` unchanged by the ranges."""

import pytest

from gpubench import devtrace, phases


def x(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 7, "tid": tid}
    if args:
        e["args"] = args
    return e


def _bench_events():
    """The window and the harness's own spans, a host op and a sync."""
    return [
        x("user_annotation", "bench.window", 0, 200),
        x("user_annotation", "bench.enqueue", 0, 60),
        x("user_annotation", "bench.sync", 60, 140),
        x("cpu_op", "aten::index", 0, 4),
        x("cuda_runtime", "cudaDeviceSynchronize", 60, 140),
    ]


def _program_events():
    """One forward of two layers: its ranges, the launches inside them
    (correlations 1-6) and one outside (7), and their device operations;
    a memset with no correlation."""
    ranges = [("gcn.forward", 0, 50), ("gcn.permute", 1, 4),
              ("gcn.layer", 6, 24), ("gcn.aggregate", 7, 8),
              ("gcn.fold", 16, 9), ("gcn.layer", 31, 14),
              ("gcn.fold", 32, 8), ("gcn.unpermute", 46, 3)]
    launches = [(1, 2), (2, 10), (3, 20), (4, 35), (5, 47), (6, 28), (7, 55)]
    ops = [("gather", 1, 10, 10), ("ell_aggregate_kernel", 2, 20, 20),
           ("indexFuncLargeIndex", 3, 45, 15),
           ("indexFuncLargeIndex", 4, 60, 10), ("copy", 6, 70, 5),
           ("gather", 5, 80, 5), ("other", 7, 90, 5)]
    events = [x("user_annotation", n, a, d) for n, a, d in ranges]
    events += [x("cuda_runtime", "cudaLaunchKernel", t, 1, correlation=c)
               for c, t in launches]
    events += [x("kernel", n, a, d, tid=9, correlation=c)
               for n, c, a, d in ops]
    events.append(x("gpu_memset", "Memset", 100, 2, tid=9))
    return events


def _read(events, forwards):
    return phases.read(events, devtrace.read(events, forwards))


def test_phases_from_launch_correlations():
    t = _read(_bench_events() + _program_events(), forwards=1)
    p = t["phases"]
    assert sorted((n, layer) for n in p for layer in p[n]) == [
        ("gcn.aggregate", "0"), ("gcn.fold", "0"), ("gcn.fold", "1"),
        ("gcn.forward", "-"), ("gcn.layer", "0"), ("gcn.layer", "1"),
        ("gcn.permute", "-"), ("gcn.unpermute", "-")]
    device = {(n, layer): v["device_s"] for n in p for layer, v in p[n].items()}
    assert device == pytest.approx({
        ("gcn.permute", "-"): 10e-6, ("gcn.aggregate", "0"): 20e-6,
        ("gcn.fold", "0"): 15e-6, ("gcn.fold", "1"): 10e-6,
        ("gcn.layer", "0"): 5e-6, ("gcn.unpermute", "-"): 5e-6,
        ("gcn.forward", "-"): 0.0, ("gcn.layer", "1"): 0.0})
    assert p["gcn.fold"]["0"]["launches"] == 1
    assert p["gcn.forward"]["-"]["launches"] == 0
    # host self time: each range less the gcn ranges inside it
    assert p["gcn.forward"]["-"]["host_self_s"] == pytest.approx(5e-6)
    assert p["gcn.layer"]["0"]["host_self_s"] == pytest.approx(7e-6)
    assert p["gcn.layer"]["1"]["host_self_s"] == pytest.approx(6e-6)
    assert p["gcn.fold"]["1"]["host_self_s"] == pytest.approx(8e-6)
    # the idle seconds each phase's operations ended
    assert p["gcn.permute"]["-"]["idle_before_s"] == pytest.approx(10e-6)
    assert p["gcn.fold"]["0"]["idle_before_s"] == pytest.approx(5e-6)
    assert p["gcn.unpermute"]["-"]["idle_before_s"] == pytest.approx(5e-6)
    assert p["gcn.aggregate"]["0"]["idle_before_s"] == 0.0
    assert t["unattributed_s"] == pytest.approx(7e-6)
    assert t["unattributed_ops"] == {"other": pytest.approx(5e-6),
                                     "Memset": pytest.approx(2e-6)}
    assert t["busy_s"] == pytest.approx(72e-6)
    # each gap by the host span it began in (devtrace.read's labels) and
    # by the phase of the operation that ended it
    assert t["began_in"] == {
        "bench.enqueue:aten::index": (pytest.approx(10e-6), 1),
        "bench.enqueue": (pytest.approx(5e-6), 1),
        "bench.sync:cudaDeviceSynchronize": (pytest.approx(113e-6), 4),
    }
    assert t["ended_by"] == {
        "gcn.permute/-": (pytest.approx(10e-6), 1),
        "gcn.fold/0": (pytest.approx(5e-6), 1),
        "gcn.unpermute/-": (pytest.approx(5e-6), 1),
        "unattributed": (pytest.approx(10e-6), 2),
        "(window end)": (pytest.approx(98e-6), 1),
    }
    assert sum(s for s, _ in t["ended_by"].values()) == pytest.approx(
        sum(s for s, _ in t["began_in"].values()))
    assert phases.device_ms(t, "gcn.fold") == pytest.approx(25e-3)
    assert phases.device_ms(t, "gcn.permute", "gcn.unpermute") == (
        pytest.approx(15e-3))
    assert phases.device_ms(t, "gcn.combine") is None
    text = phases.table(t)
    assert text.splitlines()[1].split()[:3] == ["gcn.aggregate", "0", "0.0200"]
    assert "attributed 90.278% of busy" in text
    assert "idle ended by gcn.permute/- x1.00 0.0100 ms" in text


def test_layers_count_from_zero_in_each_forward():
    """Two forwards: each one's layers are 0 and 1, and the ranges of a
    second thread do not hold the first thread's launches."""
    events = _bench_events()
    for f0 in (0, 100):
        events += [x("user_annotation", "gcn.forward", f0, 40),
                   x("user_annotation", "gcn.layer", f0 + 5, 10),
                   x("user_annotation", "gcn.layer", f0 + 20, 10)]
    events.append(x("user_annotation", "gcn.fold", 0, 200, tid=2))
    for c, t in enumerate((8, 23, 108, 123)):
        events.append(x("cuda_runtime", "cudaLaunchKernel", t, 1,
                        correlation=c))
        events.append(x("kernel", "k", t + 2, 1, tid=9, correlation=c))
    t = _read(events, forwards=2)
    assert {layer: v["launches"] for layer, v in
            t["phases"]["gcn.layer"].items()} == {"0": 2, "1": 2}
    assert t["unattributed_s"] == 0.0
    assert t["phases"]["gcn.fold"]["-"]["launches"] == 0


def test_devtrace_reads_the_same_with_program_ranges():
    """``devtrace.read``'s numbers do not move when the program's ranges,
    launches and correlations are in the trace."""
    ops = [x("kernel", n, a, d, tid=9) for n, a, d in
           (("k_a", 10, 20), ("k_b", 25, 15))]
    plain = devtrace.read(_bench_events() + ops, forwards=2)
    ranged = devtrace.read(
        _bench_events() + ops + [
            x("user_annotation", "gcn.forward", 0, 50),
            x("user_annotation", "gcn.fold", 5, 20)], forwards=2)
    assert ranged == plain


def test_no_window_raises():
    trace = devtrace.read(_bench_events(), forwards=1)
    with pytest.raises(RuntimeError):
        phases.read(_program_events(), trace)
