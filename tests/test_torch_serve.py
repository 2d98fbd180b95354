"""GCN serving of the port (``repro_torch.serve``) against ``repro.serve``.

The toy graph of ``tests/test_serve.py`` (400 nodes, 1,600 edges, 32
features, 5 classes, hidden 8) is built from seed 7 with numpy and given
to both packages, with the reference's parameters carried across as
numpy.  Host artifacts must equal the reference's exactly: graph keys,
node sets, induced subgraphs, sampled ELL operands, the bucket ladder,
every padded request field (bf16 values as bits, int8 ``q`` and
``scales`` bit for bit), the batch ladder, the grouping of ``query_batch``
and the DRAM ledger.  Engine outputs (full graph, queries, batches) at
f32, bf16 and int8, unfused and fused, are held within 1e-5 of
max|reference| against the JAX engine (``spmm_impl="reference"``), the
bar ``tests/test_torch_gcn.py`` holds the full-graph forward to: both sum
the same f32 products in another order.  The port runs on the CPU, where
the kernel wrappers run their plain versions and an executable is a
closure built and counted under the CUDA graph's key.
"""

import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import textwrap
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.dist.collectives import LEDGER as J_LEDGER
from repro.graphs import sampling as jsampling
from repro.graphs.datasets import DatasetSpec, gcn_normalize, synthesize_adjacency
from repro.models.gcn import GCNConfig as JConfig
from repro.models.gcn import init_params as j_init_params
from repro.serve import ArtifactRegistry as JRegistry
from repro.serve import BucketLadder as JLadder
from repro.serve import MicroBatcher as JBatcher
from repro.serve import ServeEngine as JEngine
from repro.serve import SubgraphSampler as JSampler
from repro.serve import graph_key as j_graph_key
from repro.serve.cache import LruDict as JLruDict
from repro.serve.engine import latency_report as j_latency_report

from repro_torch.core.sparse_formats import CSRMatrix as TCSR
from repro_torch.dist.collectives import LEDGER as T_LEDGER
from repro_torch.exec.plan import IMPL_NAMES
from repro_torch.graphs import datasets as tdatasets
from repro_torch.graphs import sampling as tsampling
from repro_torch.kernels import flexvector_spmm as fv
from repro_torch.launch import serve_gcn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.gcn import GCNConfig as TConfig
from repro_torch.serve import ArtifactRegistry as TRegistry
from repro_torch.serve import BucketLadder as TLadder
from repro_torch.serve import MicroBatcher as TBatcher
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import SubgraphSampler as TSampler
from repro_torch.serve import graph_key as t_graph_key
from repro_torch.serve.cache import LruDict as TLruDict
from repro_torch.serve.engine import latency_report as t_latency_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = DatasetSpec("toy", nodes=400, edges=1_600, feature_dim=32, classes=5)
RTOL = 1e-5
PRECISIONS = ("f32", "bf16", "int8")
# engine geometry shared by both packages' engines in the parity tests
GEOMETRY = dict(max_seeds=4, max_batch=4, base_bucket_nodes=64)


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Keep registry persistence off the repo's .cache."""
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "cache"))


@functools.lru_cache(maxsize=None)
def _toy():
    """``(reference CSR, port CSR, features)`` of the toy graph."""
    j_adj = gcn_normalize(synthesize_adjacency(SPEC, seed=7))
    t_adj = TCSR(indptr=j_adj.indptr, indices=j_adj.indices,
                 data=j_adj.data, shape=j_adj.shape)
    feats = np.random.default_rng(7).standard_normal(
        (SPEC.nodes, SPEC.feature_dim)).astype(np.float32)
    return j_adj, t_adj, feats


def _dims(**kw):
    base = dict(in_dim=SPEC.feature_dim, hidden_dim=8, out_dim=SPEC.classes)
    base.update(kw)
    return base


def _cfgs(impl="reference", **kw):
    """The same config in both packages (port impl names)."""
    j_impl = {v: k for k, v in IMPL_NAMES.items()}[impl]
    return JConfig(**_dims(spmm_impl=j_impl, **kw)), TConfig(
        **_dims(spmm_impl=impl, **kw))


@functools.lru_cache(maxsize=None)
def _params():
    jcfg, _ = _cfgs()
    return {name: {k: np.asarray(v) for k, v in layer.items()}
            for name, layer in j_init_params(jcfg, jax.random.PRNGKey(0)).items()}


@functools.lru_cache(maxsize=None)
def _requests():
    rng = np.random.default_rng(2)
    return tuple(rng.choice(SPEC.nodes, size=int(rng.integers(1, 5)),
                            replace=False) for _ in range(10))


def _run_scenario(engine, batch_log):
    """Full graph, three single queries, then all requests as one batch;
    ``batch_log`` collects the request indices of each coalesced run."""
    reqs = _requests()
    index = {}
    prepare, run = engine._prepare, engine.batcher.run

    def logged_prepare(seeds):
        padded = prepare(seeds)
        index[id(padded)] = len(index)
        return padded

    def logged_run(params, padded):
        batch_log.append([index[id(p)] for p in padded])
        return run(params, padded)

    full = np.asarray(engine.full_forward())
    queries = [np.asarray(engine.query(s)) for s in reqs[:3]]
    index.clear()
    engine._prepare = logged_prepare
    engine.batcher.run = logged_run
    batch = [np.asarray(o) for o in engine.query_batch(list(reqs))]
    return full, queries, batch


@functools.lru_cache(maxsize=None)
def _reference_run(precision, fanout):
    j_adj, _, feats = _toy()
    jcfg, _ = _cfgs()
    engine = JEngine(j_adj, feats, jcfg, params=_params(), fanout=fanout,
                     precision=precision, **GEOMETRY)
    log = []
    return _run_scenario(engine, log) + (log,)


def _port_engine(impl="reference", precision="f32", fanout=None, fused=None,
                 **kw):
    _, t_adj, feats = _toy()
    _, tcfg = _cfgs(impl)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # cuda_sparse
        return TEngine(t_adj, feats, tcfg,
                       params=params_from_numpy(_params(), "cpu"),
                       fanout=fanout, precision=precision, fused=fused,
                       device="cpu", **dict(GEOMETRY, **kw))


def rel_max_err(out, ref) -> float:
    out = np.asarray(out, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(out - ref))) / max(float(np.max(np.abs(ref))), 1e-30)


# ---------------------------------------------------------------------------
# host artifacts: exact equality
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"tau": 4}, {"tile_rows": 8},
                                {"block_rows": 64}, {"edge_cut": "none"},
                                {"hidden_dim": 64, "impl": "cuda"}])
def test_graph_key_matches_reference(kw):
    j_adj, t_adj, _ = _toy()
    jcfg, tcfg = _cfgs(**kw)
    assert t_graph_key(t_adj, tcfg) == j_graph_key(j_adj, jcfg)


@pytest.mark.parametrize("fanout", [None, 1, 3, 8])
@pytest.mark.parametrize("seeds", [[3, 17], [0, 5, 9, 399], [42]])
def test_sample_k_hop_matches_reference(seeds, fanout):
    j_adj, t_adj, _ = _toy()
    want = jsampling.sample_k_hop(j_adj, seeds, 2, fanout=fanout,
                                  rng=np.random.default_rng(11))
    got = tsampling.sample_k_hop(t_adj, seeds, 2, fanout=fanout,
                                 rng=np.random.default_rng(11))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_induced_subgraph_matches_reference():
    j_adj, t_adj, _ = _toy()
    for nodes in (np.array([1, 4, 40, 200]), np.arange(0, 400, 3)):
        want = jsampling.induced_subgraph(j_adj, nodes)
        got = tsampling.induced_subgraph(t_adj, nodes)
        for field in ("indptr", "indices", "data"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got.shape == want.shape


@pytest.mark.parametrize("fanout", [None, 4])
def test_sampled_subgraphs_match_reference(fanout):
    j_adj, t_adj, _ = _toy()
    jcfg, tcfg = _cfgs()
    js = JSampler(j_adj, jcfg, fanout=fanout, seed=5)
    ts = TSampler(t_adj, tcfg, fanout=fanout, seed=5)
    for seeds in _requests():
        want, got = js.extract(seeds), ts.extract(seeds)
        np.testing.assert_array_equal(got.nodes, want.nodes)
        np.testing.assert_array_equal(ts.sample_nodes(seeds), want.nodes)
        np.testing.assert_array_equal(got.seed_local, want.seed_local)
        np.testing.assert_array_equal(got.graph.pre.perm, want.graph.pre.perm)
        np.testing.assert_array_equal(got.graph.inv, want.graph.inv)
        for field in ("cols", "vals", "row_map"):
            np.testing.assert_array_equal(getattr(got.graph.pre.ell, field),
                                          getattr(want.graph.pre.ell, field))
        assert got.n_ell_rows == want.n_ell_rows


def test_sampler_meets_tau_bound_and_rejects_empty_query():
    _, t_adj, _ = _toy()
    _, tcfg = _cfgs(tau=4)
    sampler = TSampler(t_adj, tcfg, fanout=None)
    ell = sampler.extract([11, 42, 99]).graph.pre.ell
    assert ell.tau == 4
    assert int((ell.cols != fv.PAD_COL).sum(axis=1).max()) <= 4
    with pytest.raises(ValueError, match="at least one seed"):
        sampler.extract([])


@pytest.mark.parametrize("growth", [4, 1.5])
def test_bucket_ladder_matches_reference(growth):
    j_adj, t_adj, _ = _toy()
    jcfg, tcfg = _cfgs()
    jg = JRegistry().get_or_build(j_adj, jcfg, persist=False)
    tg = TRegistry().get_or_build(t_adj, tcfg, persist=False)
    want = JLadder.for_graph(jg, jcfg, base_nodes=64, growth=growth)
    got = TLadder.for_graph(tg, tcfg, base_nodes=64, growth=growth)
    assert [(b.nodes, b.rows) for b in got.entries] == \
        [(b.nodes, b.rows) for b in want.entries]
    assert got.mean_row_nnz == want.mean_row_nnz
    top = got.entries[-1]
    assert got.bucket_for(tg.n_nodes, tg.pre.ell.padded_rows) == top
    with pytest.raises(ValueError, match="no bucket fits"):
        got.bucket_for(top.nodes + 1, 1)
    with pytest.raises(ValueError, match="growth"):
        TLadder.for_graph(tg, tcfg, base_nodes=64, growth=1.0)


def _bits(vals) -> np.ndarray:
    """Stored values as their bit patterns (bf16 as uint16)."""
    if isinstance(vals, torch.Tensor):
        assert vals.device.type == "cpu"
        if vals.dtype == torch.bfloat16:
            return vals.view(torch.int16).numpy().view(np.uint16)
        return vals.numpy()
    a = np.asarray(vals)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("precision", PRECISIONS)
def test_padded_requests_match_reference(precision):
    j_adj, t_adj, feats = _toy()
    jcfg, tcfg = _cfgs()
    jreg, treg = JRegistry(), TRegistry()
    jg = jreg.get_or_build(j_adj, jcfg, persist=False)
    tg = treg.get_or_build(t_adj, tcfg, persist=False)
    jb = JBatcher(jcfg, JLadder.for_graph(jg, jcfg, base_nodes=64),
                  max_seeds=4, precision=precision)
    tb = TBatcher(tcfg, TLadder.for_graph(tg, tcfg, base_nodes=64),
                  max_seeds=4, precision=precision, device="cpu")
    js = JSampler(j_adj, jcfg, fanout=4, registry=jreg)
    ts = TSampler(t_adj, tcfg, fanout=4, registry=treg)
    for seeds in _requests():
        jsub, tsub = js.extract(seeds), ts.extract(seeds)
        want = jb.prepare(jsub, feats[jsub.nodes])
        got = tb.prepare(tsub, feats[tsub.nodes])
        assert (got.bucket.nodes, got.bucket.rows) == \
            (want.bucket.nodes, want.bucket.rows)
        assert got.n_seeds == want.n_seeds
        for field in ("cols", "row_map", "feats", "seed_pos"):
            a, b = getattr(got, field), np.asarray(getattr(want, field))
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b)
        vg, vw = _bits(got.vals), _bits(want.vals)
        assert vg.dtype == vw.dtype and vg.shape == vw.shape
        assert vg.tobytes() == vw.tobytes()
        if precision == "int8":
            assert got.scales.dtype == want.scales.dtype == np.float32
            assert got.scales.tobytes() == want.scales.tobytes()
        else:
            assert got.scales is None and want.scales is None
        assert got.slots is None    # the unfused rung runs no fused kernel


@pytest.mark.parametrize("max_batch", [1, 3, 8, 16])
def test_batch_ladder_matches_reference(max_batch):
    j_adj, t_adj, _ = _toy()
    jcfg, tcfg = _cfgs()
    ladder = JLadder.for_graph(JRegistry().get_or_build(j_adj, jcfg), jcfg)
    jb = JBatcher(jcfg, ladder, max_batch=max_batch)
    tb = TBatcher(tcfg, TLadder.for_graph(
        TRegistry().get_or_build(t_adj, tcfg), tcfg), max_batch=max_batch,
        device="cpu")
    assert tb.batch_ladder() == jb.batch_ladder()
    for n in range(1, max_batch + 1):
        assert tb.pad_batch(n) == jb.pad_batch(n)
    with pytest.raises(ValueError, match="exceeds max_batch"):
        tb.pad_batch(max_batch + 1)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("impl,fused", [("reference", None), ("cuda", None),
                                        ("cuda", True), ("cuda_sparse", True)])
def test_record_batch_dram_matches_reference(impl, fused, precision):
    j_adj, t_adj, _ = _toy()
    jcfg, tcfg = _cfgs(impl)
    jg = JRegistry().get_or_build(j_adj, jcfg, persist=False)
    tg = TRegistry().get_or_build(t_adj, tcfg, persist=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jb = JBatcher(jcfg, JLadder.for_graph(jg, jcfg, base_nodes=64),
                      precision=precision, fused=fused)
        tb = TBatcher(tcfg, TLadder.for_graph(tg, tcfg, base_nodes=64),
                      precision=precision, fused=fused, device="cpu")
    J_LEDGER.reset()
    T_LEDGER.reset()
    for jbucket, tbucket in zip(jb.ladder.entries, tb.ladder.entries):
        for batch in (1, 4):
            jb.record_batch_dram(jbucket, batch, SPEC.feature_dim)
            tb.record_batch_dram(tbucket, batch, SPEC.feature_dim)
    assert T_LEDGER.counts == J_LEDGER.counts
    assert T_LEDGER.bytes == J_LEDGER.bytes
    J_LEDGER.reset()
    T_LEDGER.reset()


@pytest.mark.parametrize("fanout", [None, 4])
def test_query_batch_groups_as_reference_runtime(fanout):
    """The coalesced runs of ``query_batch`` take the same requests, in the
    same order, as the reference runtime's closed batches."""
    want = _reference_run("f32", fanout)[3]
    engine = _port_engine(fanout=fanout)
    got = []
    _run_scenario(engine, got)
    assert got == want
    assert len(want) > 2 and any(len(c) == GEOMETRY["max_batch"] for c in want)


@functools.lru_cache(maxsize=None)
def _mixed_requests():
    """13 requests of 1-4 seeds (the reference's facade test's draw),
    which land in more than one rung when uncapped."""
    rng = np.random.default_rng(5)
    return tuple(rng.choice(SPEC.nodes, size=int(rng.integers(1, 5)),
                            replace=False) for _ in range(13))


def _facade_run(engine):
    """``(outputs, chunks)`` of one ``query_batch`` over the mixed
    requests: each chunk the request indices of one coalesced run."""
    index, chunks = {}, []
    prepare, run = engine._prepare, engine.batcher.run

    def logged_prepare(seeds):
        padded = prepare(seeds)
        index[id(padded)] = len(index)
        return padded

    def logged_run(params, padded):
        chunks.append(([index[id(p)] for p in padded], padded[0].bucket))
        return run(params, padded)

    engine._prepare = logged_prepare
    engine.batcher.run = logged_run
    outputs = [np.asarray(o) for o in engine.query_batch(list(_mixed_requests()))]
    return outputs, chunks


@functools.lru_cache(maxsize=None)
def _reference_facade(precision):
    j_adj, _, feats = _toy()
    jcfg, _ = _cfgs()
    engine = JEngine(j_adj, feats, jcfg, params=_params(), fanout=None,
                     precision=precision, **GEOMETRY)
    outputs, chunks = _facade_run(engine)
    return outputs, [(c, (b.nodes, b.rows)) for c, b in chunks]


def test_query_batch_facade_chunks_match_reference():
    """The runtime facade closes the reference facade's batches over
    requests in more than one bucket: each bucket's group ``max_batch``
    at a time while it is full, then each bucket's rest.  The port runs
    them in that order (full closes, then the rests in first-seen bucket
    order); the reference's facade keeps a 50 ms sojourn bound, so the
    order in which it runs the rests depends on how long its preparation
    took, and only the membership is compared."""
    _, want = _reference_facade("f32")
    _, got = _facade_run(_port_engine())
    got = [(c, (b.nodes, b.rows)) for c, b in got]
    assert sorted(got) == sorted(want)
    assert len({b for _, b in want}) > 1
    assert any(len(c) == GEOMETRY["max_batch"] for c, _ in want)
    assert sorted(i for c, _ in want for i in c) == list(range(13))
    full = [x for x in got if len(x[0]) == GEOMETRY["max_batch"]]
    assert got[:len(full)] == full
    first_seen = {b: min(i for c, bb in got if bb == b for i in c)
                  for _, b in got}
    rests = [first_seen[b] for _, b in got[len(full):]]
    assert rests == sorted(rests)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_query_batch_facade_outputs_match_reference(precision):
    want, _ = _reference_facade(precision)
    got, _ = _facade_run(_port_engine(precision=precision))
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_max_err(g, w) <= RTOL


# ---------------------------------------------------------------------------
# engine outputs against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("impl,fused", [("reference", None), ("cuda", None),
                                        ("cuda", True), ("cuda_sparse", None),
                                        ("cuda_sparse", True)])
def test_engine_matches_reference(impl, fused, precision):
    for fanout in (None, 4):
        want_full, want_q, want_b, _ = _reference_run(precision, fanout)
        engine = _port_engine(impl, precision, fanout, fused)
        got_full, got_q, got_b = _run_scenario(engine, [])
        assert got_full.shape == want_full.shape == (SPEC.nodes, SPEC.classes)
        assert rel_max_err(got_full, want_full) <= RTOL
        for got, want in zip(got_q + got_b, want_q + want_b):
            assert got.shape == want.shape
            assert rel_max_err(got, want) <= RTOL


def test_uncapped_queries_equal_full_graph_rows():
    engine = _port_engine("cuda", fused=True)
    full = engine.full_forward()
    for seeds in _requests():
        np.testing.assert_allclose(engine.query(seeds), full[seeds],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl,precision,fused", [
    ("reference", "f32", None), ("cuda", "bf16", None), ("cuda", "int8", True),
    ("cuda_sparse", "f32", True)])
def test_zero_new_executables_after_warmup(impl, precision, fused):
    engine = _port_engine(impl, precision, fanout=4, fused=fused, max_batch=8)
    built = engine.warmup()
    assert built > 0 and engine.compile_count == built
    rng = np.random.default_rng(3)
    requests = [rng.choice(SPEC.nodes, size=int(rng.integers(1, 5)),
                           replace=False) for _ in range(64)]
    for seeds in requests[:16]:
        engine.query(seeds)
    engine.query_batch(requests[16:])
    assert engine.compile_count == built, (
        f"{engine.compile_count - built} executables built after warmup")
    assert engine.report("batch").n_requests == 48
    assert engine.report("query").n_requests == 16


def test_cuda_sparse_degrades_in_the_batcher_only():
    with pytest.warns(RuntimeWarning, match="degraded"):
        _, t_adj, feats = _toy()
        _, tcfg = _cfgs("cuda_sparse")
        engine = TEngine(t_adj, feats, tcfg, device="cpu", **GEOMETRY)
    assert engine.batcher.plan.degraded
    assert engine.batcher.plan.effective_impl == "cuda"


def test_fused_slot_lists_compose_to_the_coalesced_table():
    """Each request's slot lists, offset per slot and padded with empty
    chunks, describe the coalesced table: every chunk one 64-row column
    group's slots in flat order, together each counted slot once."""
    engine = _port_engine("cuda", "int8", fanout=4, fused=True)
    reqs = [engine._prepare(s) for s in _requests()]
    bucket = reqs[0].bucket
    same = [r for r in reqs if r.bucket == bucket][:3]
    batch = engine.batcher.pad_batch(len(same))
    specs = engine.batcher.input_specs(bucket, batch, SPEC.feature_dim)
    slots = engine.batcher._stack_slots(same, bucket, specs)
    group, start, ids = (slots[n].numpy() for n in
                         ("slot_group", "slot_start", "slot_ids"))
    assert group.shape == (batch * engine.batcher.chunk_bound(bucket),)
    n_real = sum(r.slots[0].size for r in same)
    assert n_real < group.size                       # empty chunks follow
    assert (np.diff(start) >= 0).all()
    assert (start[n_real:] == start[-1]).all()       # start == next start
    tau = engine.cfg.tau
    offs = np.arange(len(same))[:, None, None] * bucket.nodes
    cols = np.stack([r.cols for r in same])
    cols = np.where(cols < 0, -1, cols + offs).reshape(-1)
    seen = []
    for c in range(n_real):
        chunk = ids[start[c]:start[c + 1]]
        assert (np.diff(chunk) > 0).all()
        assert (cols[chunk] // fv.XW_TILE_ROWS == group[c]).all()
        seen.append(chunk)
    seen = np.sort(np.concatenate(seen))
    np.testing.assert_array_equal(seen, np.flatnonzero(cols >= 0))
    assert ids.size == batch * bucket.rows * tau


# ---------------------------------------------------------------------------
# registry, cache and pickling
# ---------------------------------------------------------------------------


def test_registry_memory_and_disk_hits(tmp_path):
    _, t_adj, _ = _toy()
    _, tcfg = _cfgs()
    reg = TRegistry(cache_dir=str(tmp_path))
    g1 = reg.get_or_build(t_adj, tcfg)
    assert (reg.stats.builds, reg.stats.mem_hits) == (1, 0)
    assert reg.get_or_build(t_adj, tcfg) is g1
    assert (reg.stats.builds, reg.stats.mem_hits) == (1, 1)
    reg2 = TRegistry(cache_dir=str(tmp_path))
    g3 = reg2.get_or_build(t_adj, tcfg)
    assert (reg2.stats.builds, reg2.stats.disk_hits) == (0, 1)
    np.testing.assert_array_equal(g3.pre.ell.cols, g1.pre.ell.cols)
    np.testing.assert_array_equal(g3.inv, g1.inv)
    assert os.path.exists(os.path.join(
        str(tmp_path), "repro_torch", t_graph_key(t_adj, tcfg) + ".pkl"))


def test_registry_eviction_drops_forward_steps(tmp_path):
    _, t_adj, feats = _toy()
    _, cfg_a = _cfgs(tau=3)
    _, cfg_b = _cfgs(tau=4)
    reg = TRegistry(cache_dir=str(tmp_path), mem_capacity=1)
    fwd_a = reg.forward_step(t_adj, cfg_a, device="cpu")
    params = params_from_numpy(_params(), "cpu")
    want = fwd_a(params, feats)
    assert len(reg._forwards) == 1
    reg.forward_step(t_adj, cfg_b, device="cpu")      # evicts graph A + step
    assert t_graph_key(t_adj, cfg_a) not in reg._graphs
    assert all(k[0] != t_graph_key(t_adj, cfg_a) for k in reg._forwards)
    torch.testing.assert_close(fwd_a(params, feats), want)  # held step serves
    fwd_a2 = reg.forward_step(t_adj, cfg_a, device="cpu")
    assert fwd_a2 is not fwd_a
    assert (reg.stats.disk_hits, reg.stats.builds) == (1, 2)
    torch.testing.assert_close(fwd_a2(params, feats), want)
    # a memory-only artifact has no disk fallback: eviction forces a build
    reg2 = TRegistry(cache_dir=str(tmp_path / "m"), mem_capacity=1)
    reg2.get_or_build(t_adj, cfg_a, persist=False)
    reg2.get_or_build(t_adj, cfg_b, persist=False)
    reg2.get_or_build(t_adj, cfg_a, persist=False)
    assert (reg2.stats.builds, reg2.stats.disk_hits) == (3, 0)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_registry_quantized_ell_is_cached(tmp_path, precision):
    _, t_adj, _ = _toy()
    _, tcfg = _cfgs()
    reg = TRegistry(cache_dir=str(tmp_path))
    art = reg.quantized_ell(t_adj, tcfg, precision)
    assert art.precision == precision and reg.stats.builds == 2
    assert reg.quantized_ell(t_adj, tcfg, precision) is art
    again = TRegistry(cache_dir=str(tmp_path)).quantized_ell(
        t_adj, tcfg, precision)
    assert again.vals.view(torch.uint8).equal(art.vals.view(torch.uint8))


def test_graph_stats_match_reference():
    from repro.plan import cost as jcost

    from repro_torch.plan import cost as tcost

    j_adj, t_adj, _ = _toy()
    jcfg, tcfg = _cfgs()
    jg = JRegistry().get_or_build(j_adj, jcfg, persist=False)
    tg = TRegistry().get_or_build(t_adj, tcfg, persist=False)
    want = jcost.graph_stats_from_ell(jg.pre.ell)
    got = tcost.graph_stats_from_ell(tg.pre.ell)
    for field in ("padded_rows", "n_sub_rows", "n_out_rows", "n_dense_rows",
                  "nnz", "tau", "rows_per_node", "mean_row_nnz"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.row_nnz, want.row_nnz)
    args = dict(rows=512, n_out_rows=128, n_dense_rows=128, nnz=10**6, tau=6)
    assert dataclasses.astuple(tcost.synthetic_stats(**args)) == \
        dataclasses.astuple(jcost.synthetic_stats(**args))


def test_disk_memo_builds_once(tmp_path):
    from repro_torch.serve import cache

    calls = []

    def build():
        calls.append(1)
        return {"x": np.arange(3)}

    obj, hit = cache.disk_memo("k", build, str(tmp_path))
    again, hit2 = cache.disk_memo("k", build, str(tmp_path))
    assert (hit, hit2, len(calls)) == (False, True, 1)
    np.testing.assert_array_equal(again["x"], obj["x"])
    assert cache.load_pickle("missing", str(tmp_path)) == (None, False)


def test_lru_dict_matches_reference():
    ops = [("put", "a", 1.0), ("put", "b", 1.0), ("put", "c", 1.0),
           ("get", "a", None), ("put", "d", 1.0), ("put", "big", 2.0),
           ("put", "huge", 99.0), ("pop", "huge", None), ("pop", "x", None)]
    logs = []
    for cls in (JLruDict, TLruDict):
        evicted = []
        d = cls(3.0, on_evict=lambda k, v: evicted.append(k))
        trace = []
        for op, key, w in ops:
            if op == "put":
                d.put(key, key.upper(), weight=w)
            trace.append((getattr(d, op)(key, "dflt") if op != "put" else None,
                          list(d.keys()), d.total_weight))
        logs.append((trace, evicted, d.evictions))
    assert logs[0] == logs[1]
    with pytest.raises(ValueError):
        TLruDict(0)


def test_latency_report_matches_reference():
    lats = [0.004, 0.001, 0.0025, 0.010, 0.0031]
    for wall in (None, 0.05):
        want = j_latency_report("batch", lats, 11, wall_s=wall)
        got = t_latency_report("batch", lats, 11, wall_s=wall)
        assert got.line() == want.line()
    assert t_latency_report("x", [], 0).n_requests == 0


def test_repeated_capped_query_is_cached_and_bit_identical():
    engine = _port_engine("cuda", fanout=3)
    out1 = engine.query([5, 77])
    builds, hits = engine.registry.stats.builds, engine.registry.stats.mem_hits
    out2 = engine.query([5, 77])
    assert engine.registry.stats.builds == builds
    assert engine.registry.stats.mem_hits == hits + 1
    np.testing.assert_array_equal(out1, out2)


def test_gcn_graph_pickles_without_device_tensors():
    _, t_adj, _ = _toy()
    _, tcfg = _cfgs()
    graph = TRegistry().get_or_build(t_adj, tcfg, persist=False)
    plain = pickle.dumps(graph)
    operands, perm, inv = graph.on_device("cpu")
    assert graph._placed
    blob = pickle.dumps(graph)
    assert len(blob) == len(plain)
    back = pickle.loads(blob)
    assert back._placed == {}
    operands2, perm2, inv2 = back.on_device("cpu")   # rebuilt on first use
    assert torch.equal(operands2.cols, operands.cols)
    assert torch.equal(operands2.vals, operands.vals)
    assert torch.equal(perm2, perm) and torch.equal(inv2, inv)


def test_port_registry_ignores_reference_artifacts(tmp_path):
    """Both packages name the graph alike; the port's registry, pointed at
    a directory where the JAX registry stored it, builds its own artifact
    under ``repro_torch/`` and never unpickles the reference's."""
    j_adj, _, _ = _toy()
    jcfg, _ = _cfgs()
    JRegistry(cache_dir=str(tmp_path)).get_or_build(j_adj, jcfg)
    assert os.path.exists(tmp_path / f"{j_graph_key(j_adj, jcfg)}.pkl")
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
        import numpy as np
        from repro_torch.graphs.datasets import (DatasetSpec, gcn_normalize,
                                                 synthesize_adjacency)
        from repro_torch.models.gcn import GCNConfig
        from repro_torch.serve import ArtifactRegistry
        spec = DatasetSpec("toy", nodes=400, edges=1600, feature_dim=32,
                           classes=5)
        adj = gcn_normalize(synthesize_adjacency(spec, seed=7))
        reg = ArtifactRegistry(cache_dir={str(tmp_path)!r})
        reg.get_or_build(adj, GCNConfig(in_dim=32, hidden_dim=8, out_dim=5))
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
        assert not bad, bad
        print(reg.stats.builds, reg.stats.disk_hits)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1", "0"]
    assert os.path.exists(
        tmp_path / "repro_torch" / f"{j_graph_key(j_adj, jcfg)}.pkl")


# ---------------------------------------------------------------------------
# what the slice leaves out, and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,item", [
    ({"mesh": object()}, "A9"), ({"feedback": object()}, "A11")])
def test_unported_engine_options_raise(kw, item):
    """``mesh=`` (A9b) still raises; ``feedback=`` (A11) is ported: the
    engine keeps the store and hands it to its batcher."""
    _, t_adj, feats = _toy()
    _, tcfg = _cfgs()
    if item == "A11":
        engine = TEngine(t_adj, feats, tcfg, device="cpu", **kw)
        assert engine.feedback is kw["feedback"]
        assert engine.batcher.feedback is kw["feedback"]
        return
    with pytest.raises(NotImplementedError, match=item):
        TEngine(t_adj, feats, tcfg, device="cpu", **kw)


@pytest.mark.parametrize("method,item", [("runtime", "A10"),
                                         ("servable", "A12")])
def test_unported_engine_methods_raise(method, item):
    """``servable()`` (A12) still raises; ``runtime()`` (A10) is ported
    and returns a runtime over this engine."""
    from repro_torch.runtime import ServeRuntime

    engine = _port_engine()
    if item == "A10":
        rt = engine.runtime(capacity=4)
        assert isinstance(rt, ServeRuntime) and rt.engine is engine
        assert rt.graph_key == engine.graph_key and rt.queue.capacity == 4
        rt.shutdown()
        return
    with pytest.raises(NotImplementedError, match=item):
        getattr(engine, method)()


def test_forward_step_auto_plan_raises():
    """``"auto"`` is the one plan string a forward step takes."""
    _, t_adj, _ = _toy()
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="unknown plan"):
        TRegistry().forward_step(t_adj, tcfg, plan="Auto", device="cpu")


@pytest.fixture
def toy_dataset(monkeypatch):
    monkeypatch.setitem(tdatasets.DATASETS, "toy", tdatasets.DatasetSpec(
        "toy", nodes=400, edges=1_600, feature_dim=32, classes=5))


@pytest.mark.parametrize("flags,item", [(["--runtime-async"], "A10"),
                                        (["--fleet-config", "f.json"], "A12"),
                                        (["--mesh", "2"], "A9b")])
def test_cli_unported_scenarios_raise(toy_dataset, capsys, flags, item):
    """``--fleet-config`` (A12) and ``--mesh`` (A9b) still raise;
    ``--runtime-async`` (A10) is ported and serves the batch open-loop."""
    if item == "A10":
        # batches of one close as they arrive, and no deadline can lapse
        serve_gcn.main(["--dataset", "toy", "--reduced", "--requests", "8",
                        "--batch", "1", "--scenario", "batch", "--qps",
                        "1000", "--deadline-ms", "60000", *flags],
                       device="cpu")
        out = capsys.readouterr().out
        assert "async: offered 8 @ 1000 qps, completed 8, shed 0" in out
        assert "[post-warmup compiles] 0 " in out
        return
    with pytest.raises(NotImplementedError, match=item):
        serve_gcn.main(["--dataset", "toy", "--reduced", *flags], device="cpu")


@pytest.mark.parametrize("impl,precision", [("cuda", "f32"),
                                            ("cuda_sparse", "int8")])
def test_cli_prints_its_lines(toy_dataset, capsys, impl, precision):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        serve_gcn.main(["--dataset", "toy", "--reduced", "--requests", "12",
                        "--batch", "4", "--impl", impl, "--precision",
                        precision], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[warmup] ") and "registry builds=1" in lines[0]
    if impl == "cuda_sparse":
        assert "impl cuda (degraded from cuda_sparse)" in lines[0]
    body = lines[1:]
    if precision != "f32":
        assert body[0].startswith(f"[precision] requested {precision}")
        body = body[1:]
    assert [line.split(":")[0] for line in body[:3]] == ["full", "query",
                                                          "batch"]
    assert body[1].startswith("query: 12 requests, p50 ")
    assert "tok-equiv/s" in body[2]
    assert body[3].startswith("[post-warmup compiles] 0 ")


def test_cli_runs_on_the_card_by_default(toy_dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_gcn.main(["--dataset", "toy", "--reduced"])
