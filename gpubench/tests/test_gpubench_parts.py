"""The benchmark's yardstick on the CPU: its graphs, reference, counts,
trace reader and metric readers."""

import math

import numpy as np
import pytest
import torch

from gpubench import counts, devtrace, graphgen
from gpubench.reference import gcn as reference


@pytest.mark.parametrize("nodes,edges,seed", [(2708, 5429, 0), (1500, 9000, 7)])
def test_generator_equals_the_programs(nodes, edges, seed):
    from repro_torch.graphs.datasets import (DatasetSpec, gcn_normalize,
                                             synthesize_adjacency)

    want = gcn_normalize(synthesize_adjacency(
        DatasetSpec("x", nodes, edges, 8), seed=seed))
    got = graphgen.gcn_normalize(graphgen.synthesize(nodes, edges, seed))
    for a, b in zip(got, (want.indptr, want.indices, want.data)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_graph_cache_is_read_back(tmp_path):
    graph = {"dataset": "t", "nodes": 400, "edges": 1600, "seed": 3,
             "alpha": 1.8, "intra_frac": 0.88}
    made, cached = graphgen.load_or_make(graph, str(tmp_path))
    again, cached2 = graphgen.load_or_make(graph, str(tmp_path))
    assert (cached, cached2) == (False, True)
    for a, b in zip(made, again):
        np.testing.assert_array_equal(a, b)
    assert [p.name for p in (tmp_path / "graphs").iterdir()] == [
        graphgen.graph_name(graph)]


def _tiny_inputs(n=300, widths=(12, 8, 3), seed=0):
    indptr, indices, data = graphgen.gcn_normalize(
        graphgen.synthesize(n, 4 * n, seed))
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, widths[0], generator=gen)
    layers = [(torch.randn(a, b, generator=gen), torch.randn(b, generator=gen))
              for a, b in zip(widths[:-1], widths[1:])]
    csr = (torch.as_tensor(indptr), torch.as_tensor(indices).long(),
           torch.as_tensor(data))
    return (indptr, indices, data), csr, x, layers


@pytest.mark.parametrize("block_rows", [1 << 16, 7])
def test_reference_matches_dense_f64(block_rows):
    (indptr, indices, data), csr, x, layers = _tiny_inputs()
    n = x.shape[0]
    a = np.zeros((n, n))
    for r in range(n):
        a[r, indices[indptr[r]:indptr[r + 1]]] = data[indptr[r]:indptr[r + 1]]
    h = x.double().numpy()
    for i, (w, b) in enumerate(layers):
        h = a @ (h @ w.double().numpy() + b.double().numpy())
        if i < len(layers) - 1:
            h = np.maximum(h, 0.0)
    got = reference.gcn_logits(csr, x, layers, block_rows=block_rows)
    assert got.dtype == torch.float32 and got.shape == (n, 3)
    assert np.abs(got.double().numpy() - h).max() <= 1e-5 * np.abs(h).max()


def test_round_to_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12,
                      3.14159, -2.5e-3], dtype=torch.float32)
    r = reference.round_to_tf32(x)
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    assert r[1] == 1.0                       # a tie rounds to the even 1.0
    assert r[2] == 1.0 + 4 * 2 ** -11        # ... and up to the even 1 + 2^-9
    assert ((r - x).abs() <= x.abs() * 2 ** -11).all()


def test_control_moves_the_logits_on_the_cpu():
    _, csr, x, layers = _tiny_inputs()
    want = reference.gcn_logits(csr, x, layers)
    got = reference.gcn_logits(csr, x, layers, tf32=True)
    rel = float((got - want).abs().max() / want.abs().max())
    assert 1e-5 < rel < 1e-2


def test_counts_by_hand():
    n, nnz, dims = 4, 10, [(3, 2), (2, 1)]
    # 2*4*3*2 + 2*10*2 + 2*4*2*1 + 2*10*1
    assert counts.model_flops(n, nnz, dims) == 124
    assert counts.aggregation_bytes(n, nnz, 2) == 10 * 8 + 2 * 4 * 2 * 4
    assert counts.fused_layer_bytes(n, nnz, 3, 2) == 4 * 3 * 4 + 3 * 2 * 4 + 80 + 4 * 2 * 4
    assert counts.aggregation_least_seconds(n, nnz, dims, 2.0) == (144 + 112) / 2.0
    # layer 0: max(88 / 10, 184 / 2); layer 1: max(36 / 10, 80 + 32 + 8 + 16 = 136 / 2)
    assert counts.fused_least_seconds(n, nnz, dims, 10.0, 2.0) == 92.0 + 68.0


def test_counts_at_reddit():
    dims = [(602, 64), (64, 41)]
    flops = counts.model_flops(232_965, 24_122_889, dims)
    assert math.isclose(flops, 24.24e9, rel_tol=1e-3)


def _events():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    return [
        x("user_annotation", "bench.window", 0, 100),
        x("user_annotation", "bench.enqueue", 0, 50),
        x("user_annotation", "bench.sync", 50, 50),
        x("cpu_op", "aten::mm", 0, 12),
        x("cuda_runtime", "cudaDeviceSynchronize", 50, 50),
        x("kernel", "k_a", 10, 20),
        x("kernel", "k_b", 25, 15),
        x("gpu_memset", "Memset", 60, 10),
        x("kernel", "outside", 150, 10),
        {"ph": "i", "name": "marker", "ts": 5},
    ]


def test_trace_reader():
    t = devtrace.read(_events(), forwards=2)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(40e-6)
    assert set(t["by_name"]) == {"k_a", "k_b", "Memset"}
    assert t["gaps"] == {
        "bench.enqueue:aten::mm": (pytest.approx(10e-6), 1),
        "bench.enqueue": (pytest.approx(20e-6), 1),
        "bench.sync:cudaDeviceSynchronize": (pytest.approx(30e-6), 1),
    }
    b = devtrace.breakdown(t)
    assert b["device_ops"][0][0] == "k_a"
    assert b["idle_gaps"][0][0] == "bench.sync:cudaDeviceSynchronize x1"


def test_metric_readers():
    from gpubench.bench import BENCH_DIR, load_module

    def metric(name):
        return load_module(f"{BENCH_DIR}/metrics/{name}.py").read

    ops = [("void ell_aggregate_kernel<float, 0>(int const*)", 0.0, 1000.0),
           ("ell_fused_xw_kernel", 0.0, 3000.0), ("other", 0.0, 5.0)]
    peaks = {"f32": 10.0, "hbm_bytes_s": 2.0}
    record = {
        "window": {"seconds": 2.0, "forwards": 4,
                   "latencies_s": [0.4] * 19 + [0.9], "enqueue_s": 0.2},
        "setup": {"setup_s": 12.0, "graph_load_s": 3.0},
        "memory": {"peak_bytes": 3 * 2 ** 30},
        "trace": {"window_s": 0.01, "busy_s": 0.008, "forwards": 2, "ops": ops},
        "counts": {"nodes": 4, "nnz": 10, "dims": [(3, 2), (2, 1)],
                   "precision": "f32"},
        "peaks": peaks,
    }
    assert metric("forward_ms")(record) == 500.0
    assert metric("forward_p95_ms")(record) == 400.0
    assert metric("peak_mem_gib")(record) == 3.0
    assert metric("setup_s")(record) == 12.0
    assert metric("graph_load_s")(record) == 3.0
    assert metric("enqueue_ms")(record) == 50.0
    assert metric("device_idle")(record) == pytest.approx(20.0)
    assert metric("forward_mfu")(record) == pytest.approx(124 / 0.005 / 10 * 100)
    assert metric("ell_spmm_roofline")(record) == pytest.approx(128 * 2 / 1e-3 * 100)
    assert metric("ell_fused_roofline")(record) == pytest.approx(160 * 2 / 3e-3 * 100)
    record["trace"] = None
    for name in ("device_idle", "forward_mfu", "ell_spmm_roofline",
                 "ell_fused_roofline"):
        assert metric(name)(record) is None
