"""The port's serving mesh against the reference's.

``dist.sharding.batch_spec`` over axis sizes equals ``repro``'s on the
cases of ``tests/test_dist.py`` and on a sweep of batches and meshes.
``ServeEngine(mesh=)`` runs in 2 and 4 spawned gloo ranks on the CPU
(``tests/_torch_dist.run_ranks``, with its time limit; the rank functions
are in ``tests/_serve_mesh_ranks.py``): rank 0 leads ``query``,
``query_batch`` and a traced runtime scenario, the other ranks follow.
Its answers equal the unmeshed port engine's and are within 1e-5 of the
reference engine's; a batch the ranks divide is split, one they do not is
replicated; the followers stop when rank 0 stops them, having followed
every forward; no rank builds an executable after warmup; and the
ledger, the traces and the metrics equal the unmeshed engine's (the mesh
stays off the plan: ``mesh_width`` 1).  The CLI's ``--mesh`` runs there
too.
"""

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import repro.dist.sharding as jsharding
import repro.dist.topology as jtopology
import repro_torch.dist.sharding as tsharding
import repro_torch.dist.topology as ttopology

import _serve_mesh_ranks as smr
import _serve_parity as sp
from _torch_dist import run_ranks

# ---------------------------------------------------------------------------
# batch_spec
# ---------------------------------------------------------------------------


def _as_tuple(spec) -> tuple:
    return tuple(spec)


@pytest.mark.parametrize("sizes,names,batch,want", [
    ((1, 1), ("data", "model"), 8, ()),
    ((1, 1), ("data", "model"), 7, ()),
    ((4, 2), ("data", "model"), 256, ("data",)),
    ((4, 2), ("data", "model"), 6, ()),
    ((2, 16, 16), ("pod", "data", "model"), 256, (("pod", "data"),)),
    ((2, 16, 16), ("pod", "data", "model"), 48, ("data",)),
    ((2, 16, 16), ("pod", "data", "model"), 7, ()),
])
def test_batch_spec_cases_of_test_dist(sizes, names, batch, want):
    """The cases of ``tests/test_dist.py``: the reference's spec on its
    abstract mesh and the port's on axis sizes are the same entries."""
    ref = jsharding.batch_spec(jtopology.abstract_mesh(sizes, names), batch)
    got = tsharding.batch_spec(ttopology.abstract_mesh(sizes, names), batch)
    assert got == _as_tuple(ref) == want
    assert isinstance(ref, P)


@pytest.mark.parametrize("sizes,names", [
    ((2,), ("data",)), ((4,), ("data",)), ((3, 2), ("data", "model")),
    ((2, 4), ("pod", "data")), ((4, 2, 2), ("pod", "data", "model")),
    ((1, 8), ("pod", "data"))])
def test_batch_spec_sweep_matches_reference(sizes, names):
    for batch in range(1, 65):
        ref = jsharding.batch_spec(jtopology.abstract_mesh(sizes, names),
                                   batch)
        got = tsharding.batch_spec(ttopology.abstract_mesh(sizes, names),
                                   batch)
        assert got == _as_tuple(ref), batch
        axes = tsharding.spec_axes(got)
        n = int(np.prod([dict(zip(names, sizes))[a] for a in axes]))
        assert batch % n == 0


def test_batch_spec_reads_a_device_mesh_shape():
    """A ``DeviceMesh`` and an abstract mesh of the same sizes give the
    same specs (``axis_sizes`` reads both); here through a stand-in with
    the ``DeviceMesh`` interface, since a real one needs a group."""

    class FakeDeviceMesh:
        mesh_dim_names = ("data",)

        def size(self, i):
            return 4

    for batch in (1, 2, 4, 6, 8, 12):
        assert tsharding.batch_spec(FakeDeviceMesh(), batch) \
            == tsharding.batch_spec(ttopology.abstract_mesh((4,), ("data",)),
                                    batch)


# ---------------------------------------------------------------------------
# ServeEngine(mesh=) over spawned gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "cache"))


def _reference_answers(requests):
    """The reference engines' answers to ``query_batch``, per engine."""
    out = {}
    for impl, precision, fused in smr.ENGINES:
        engine = sp.reference_engine(impl, precision, fused)
        out[(impl, precision, fused)] = [np.asarray(a) for a in
                                         engine.query_batch(requests)]
    return out


@pytest.fixture(scope="module")
def mesh_runs():
    """Every rank's records at world sizes 2 and 4 (one spawn each),
    and the reference engines' answers."""
    requests = [np.asarray(r) for r in sp.requests(16, seed=21)]
    runs = {world: run_ranks("_serve_mesh_ranks", "serve_mesh_rank", world,
                             (sp.params(), requests))
            for world in (2, 4)}
    return runs, _reference_answers(requests)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("engine", smr.ENGINES,
                         ids=["reference-f32", "cuda-bf16", "cuda-fused-int8"])
def test_serving_mesh_answers_as_unmeshed(mesh_runs, world, engine):
    """Rank 0's answers equal the unmeshed engine's, bit for bit, and
    the reference engine's within 1e-5 of the output scale; the traced
    runtime's ledger, traces (``mesh_width`` 1) and metrics equal the
    unmeshed engine's."""
    runs, reference = mesh_runs
    lead = runs[world][0][engine]
    meshed, plain = lead["meshed"], lead["plain"]
    np.testing.assert_array_equal(meshed["query"], plain["query"])
    for got, want in zip(meshed["batch"], plain["batch"]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(meshed["runtime"], plain["runtime"]):
        if isinstance(want, str):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)
    for got, want in zip(meshed["batch"], reference[engine]):
        assert got.shape == want.shape
        assert sp.rel_max_err(got, want) <= sp.RTOL
    assert meshed["widths"] == plain["widths"]
    assert meshed["ledger"] == plain["ledger"]
    assert meshed["ledger"]["counts"].get("spmm_dram", 0) > 0
    assert meshed["traces"] == plain["traces"]
    assert meshed["metrics"] == plain["metrics"]
    executes = [s for t in meshed["traces"] for s in t["spans"]
                if s["name"] == "execute"]
    assert executes and all(s["attributes"]["mesh_width"] == 1
                            for s in executes)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("engine", smr.ENGINES,
                         ids=["reference-f32", "cuda-bf16", "cuda-fused-int8"])
def test_serving_mesh_splits_replicates_and_follows(mesh_runs, world,
                                                    engine):
    """A batch whose padded width the ranks divide runs as one chunk per
    rank, any other is replicated on every rank; each follower followed
    every forward rank 0 ran and returned when stopped; no rank built an
    executable after warmup, and each built only its chunk shapes."""
    runs, _ = mesh_runs
    ranks = [r[engine] for r in runs[world]]
    lead = ranks[0]
    widths = lead["meshed"]["widths"]
    sharded = sum(1 for w in widths if w % world == 0)
    want = {"sharded": sharded, "replicated": len(widths) - sharded}
    assert sharded > 0 and want["replicated"] > 0
    for rk in ranks:
        assert rk["mesh_runs"] == want
        assert rk["compiles"] == rk["built"] == lead["built"]
    assert lead["calls"] == len(widths)
    for rk in ranks[1:]:
        assert rk["followed"] == rk["calls"] == len(widths)
    # one executable per distinct chunk width per warmed rung
    chunks = {w // world if w % world == 0 else w for w in (1, 2, 4)}
    assert lead["built"] * len((1, 2, 4)) == lead["plain_built"] \
        * len(chunks)


@pytest.mark.parametrize("failing", [0, 1], ids=["leader", "follower"])
def test_serving_mesh_forward_failing_midway_ends_every_rank(failing):
    """A rank that raises in a forward after the header and the scatter
    tears its process group down: every other rank's collective of that
    forward raises within seconds (not at the group's 300 s timeout),
    rank 0's ``stop_followers`` then sends nothing and returns, and every
    rank exits inside the spawn's limit."""
    requests = [np.asarray(r) for r in sp.requests(4, seed=21)]
    out = run_ranks("_serve_mesh_ranks", "failing_forward_rank", 2,
                    (sp.params(), requests, failing), timeout=120)
    first = out[failing]
    assert first["raised"] == (
        "RuntimeError", f"rank {failing} fails mid-forward on purpose")
    for r, rec in enumerate(out):
        assert rec["raised"] is not None, r
        assert not rec["group_up"], r
        assert rec["at"] - first["at"] < 30, r
    assert out[0]["stopped"]


def test_cli_mesh_runs_on_two_ranks():
    """``--mesh 2`` in two spawned ranks: rank 0 warms, serves every
    scenario and prints the report with no build after warmup; rank 1
    follows and prints nothing."""
    out = run_ranks("_serve_mesh_ranks", "serve_cli_rank", 2)
    lines = out[0].strip().splitlines()
    assert lines[0].startswith("[warmup] ") and "mesh data=2" in lines[0]
    assert [line.split(":")[0] for line in lines[1:4]] == [
        "full", "query", "batch"]
    assert lines[-1].startswith("[post-warmup compiles] 0 ")
    assert out[1] == ""
