"""LM serving on the port against the reference: the sharding policy
(``repro_torch.dist.policy``), the step functions (``launch/steps.py``),
the LM CLI (``launch/serve.py``), ``LmServable`` and the fleet's
``kind: "lm"``.

The policy cases are ``tests/test_dist.py``'s; under an active mesh the
port raises naming ROADMAP A13b instead of constraining.  The steps and
``LmServable`` get the reference's weights (carried across as numpy) and
give its prefill / decode logits and served answers within the logits'
bar of ``tests/test_torch_lm.py`` (1e-2 x max|reference| at
internlm2 / qwen3 / qwen2.5).  The reference's LM fleet cases
(``test_gcn_plus_lm_fleet_end_to_end``,
``test_lm_servable_validates_payloads``, and the LM ``fleet_from_config``
round trip) run through the port on the CPU, where an executable is a
closure.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.policy import select_spec as j_select_spec
from repro.dist.topology import abstract_mesh as j_abstract_mesh
from repro.launch.steps import build_prefill_step as j_prefill
from repro.launch.steps import build_serve_step as j_serve
from repro.models import lm as jlm

import repro_torch.fleet as TF
import repro_torch.runtime as TR
from repro_torch.dist import policy as tpolicy
from repro_torch.dist.topology import abstract_mesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.runtime.metrics import labeled

import _lm_parity as lp
import _serve_parity as sp

BAR = 1e-2      # the logits' bar at these archs (tests/test_torch_lm.py)


# ---------------------------------------------------------------------------
# dist.policy: the cases of tests/test_dist.py
# ---------------------------------------------------------------------------


def test_constrain_noop_without_policy():
    x = torch.ones((4, 4))
    assert tpolicy.constrain(x, [("data", "model")]) is x
    assert tpolicy.constrain_ranked(x, [("data", "model")]) is x


@pytest.mark.parametrize("shape,specs", [
    ((8, 6), [(("pod", "data"), None), ("data", None)]),
    ((6, 8), [("data", None), ("model", None)]),
    ((7, 7), [("data", None), ("model", None)]),
    ((8, 8), [(("data", "model"), None)]),
    ((4, 4, 4), [(None, "model", "data"), ("data",)]),
])
def test_select_spec_matches_reference(shape, specs):
    mesh_t = abstract_mesh((4, 2), ("data", "model"))
    mesh_j = j_abstract_mesh((4, 2), ("data", "model"))
    want = j_select_spec(mesh_j, shape, specs)
    got = tpolicy.select_spec(mesh_t, shape, specs)
    assert got == (None if want is None else tuple(want))


def test_select_spec_skips_missing_axes_and_indivisible_dims():
    mesh = abstract_mesh((4, 2), ("data", "model"))
    # first candidate names a "pod" axis this mesh lacks -> falls through
    spec = tpolicy.select_spec(mesh, (8, 6), [(("pod", "data"), None),
                                              ("data", None)])
    assert spec == ("data", None)
    # 6 % 4 != 0 kills the data candidate; 6 % 2 == 0 keeps model
    spec = tpolicy.select_spec(mesh, (6, 8), [("data", None), ("model", None)])
    assert spec == ("model", None)
    assert tpolicy.select_spec(mesh, (7, 7), [("data", None),
                                              ("model", None)]) is None
    # one mesh axis may not shard two dims of the same array
    assert not tpolicy.spec_viable(mesh, (4, 4), ("data", "data"))
    assert not tpolicy.spec_viable(mesh, (4,), ("data", None))


def test_sharding_policy_nests_and_restores():
    mesh = abstract_mesh((2,), ("data",))
    assert tpolicy.active_mesh() is None
    with tpolicy.sharding_policy(mesh):
        assert tpolicy.active_mesh() is mesh
        with tpolicy.sharding_policy(None):
            assert tpolicy.active_mesh() is None
        assert tpolicy.active_mesh() is mesh
    assert tpolicy.active_mesh() is None


def test_constrain_under_a_mesh_raises_naming_a13b():
    """The reference applies a sharding constraint here; the port has no
    tensor-parallel LM yet and says so rather than leaving the tensor
    unsharded.  A model run under the policy raises the same way."""
    mesh = abstract_mesh((1, 1), ("data", "model"))
    x = torch.ones((4, 4))
    _, tcfg = lp.cfgs("qwen3-8b")
    params = tlm.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    with tpolicy.sharding_policy(mesh):
        with pytest.raises(NotImplementedError, match="A13b"):
            tpolicy.constrain(x, [("data", "model")])
        with pytest.raises(NotImplementedError, match="A13b"):
            tpolicy.constrain_ranked(x, [("data", "model")])
        with pytest.raises(NotImplementedError, match="A13b"):
            tlm.forward(params, tcfg, torch.zeros((1, 4), dtype=torch.long))
    assert tlm.forward(params, tcfg, torch.zeros((1, 4), dtype=torch.long)
                       ).shape == (1, 4, tcfg.vocab)


# ---------------------------------------------------------------------------
# launch/steps.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2.5-14b"])
def test_prefill_and_serve_steps_match_reference(arch):
    """``step_for("prefill")`` gives the reference's last-position logits;
    ``step_for("decode")`` its cached steps (numpy token ids in)."""
    jcfg, tcfg = lp.cfgs(arch)
    params = jlm.init_lm(jcfg, jax.random.PRNGKey(4))
    tparams = lp.port_tree(params)
    tokens, _ = lp.inputs(jcfg, seq=12, seed=4)
    want = jax.jit(j_prefill(jcfg))(params, tokens)
    got = tsteps.step_for(tcfg, "prefill", device="cpu")(tparams, tokens)
    assert tuple(got.shape) == want.shape == (2, jcfg.vocab)
    assert lp.rel(got, want) <= BAR

    jstep = jax.jit(j_serve(jcfg))
    tstep = tsteps.step_for(tcfg, "decode", device="cpu")
    jcache = jlm.init_cache(jcfg, 2, 8)
    tcache = tlm.init_cache(tcfg, 2, 8, device="cpu")
    for t in range(4):
        want, jcache = jstep(params, jcache, tokens[:, t:t + 1], jnp.int32(t))
        got, tcache = tstep(tparams, tcache, tokens[:, t:t + 1], t)
        assert lp.rel(got, want) <= BAR


def test_steps_raise_for_train_and_mesh():
    _, tcfg = lp.cfgs("qwen3-8b")
    with pytest.raises(NotImplementedError, match="A14"):
        tsteps.step_for(tcfg, "train", device="cpu")
    mesh = abstract_mesh((2,), ("data",))
    for kind in ("prefill", "decode"):
        with pytest.raises(NotImplementedError, match="A13b"):
            tsteps.step_for(tcfg, kind, mesh=mesh, device="cpu")
    with pytest.raises(ValueError):
        tsteps.step_for(tcfg, "score", device="cpu")


# ---------------------------------------------------------------------------
# launch/serve.py
# ---------------------------------------------------------------------------


def test_lm_cli_decodes_on_the_cpu(capsys):
    """``main(argv, device="cpu")`` decodes greedily with the reference's
    flags and prints its line."""
    out = tserve.main(["--arch", "internlm2-1.8b", "--reduced", "--batch",
                       "2", "--tokens", "5", "--max-seq", "8"], device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("internlm2-1.8b-smoke: 5 tokens x batch 2; p50 ")
    assert " ms/tok, throughput " in line and line.endswith(" tok/s")
    assert len(out["lat_ms"]) == 4 and out["tok_s"] > 0
    assert out["p50_ms"] <= out["p99_ms"] and out["device"] == "cpu"


# ---------------------------------------------------------------------------
# LmServable and the fleet
# ---------------------------------------------------------------------------


def _reference_weights(arch="internlm2-1.8b", seed=0):
    """The reference servable's weights (``init_lm(PRNGKey(seed))``) as
    the reference tree and as the port's."""
    jcfg, _ = lp.cfgs(arch)
    params = jlm.init_lm(jcfg, jax.random.PRNGKey(seed))
    return jcfg, params, lp.port_tree(params)


def test_lm_servable_validates_payloads():
    lm = TF.LmServable("internlm2-1.8b", seq_buckets=(8,), max_batch=2,
                       device="cpu")
    with pytest.raises(ValueError):
        lm.prepare([])                          # empty
    with pytest.raises(ValueError):
        lm.prepare(list(range(9)))              # exceeds top bucket
    with pytest.raises(ValueError):
        lm.prepare([lm.cfg.vocab + 5])          # out-of-vocab token
    with pytest.raises(ValueError):
        lm.prepare([-1])
    p = lm.prepare([1, 2, 3])
    assert p.bucket.seq == 8 and p.n_tokens == 3
    assert p.tokens.tolist() == [1, 2, 3, 0, 0, 0, 0, 0]
    with pytest.raises(ValueError, match="frontend"):
        TF.LmServable("llama-3.2-vision-11b", device="cpu")


def test_lm_servable_batches_match_reference_forward():
    """Every bucket and padded batch: the answer is the port forward's row
    at the last real position (1e-6), and the reference forward's of the
    same weights within the logits' bar; reloads rebuild the grid."""
    jcfg, params, tparams = _reference_weights()
    lm = TF.LmServable("internlm2-1.8b", seq_buckets=(8, 16), max_batch=4,
                       params=tparams, device="cpu")
    lm.load()
    grid = lm.compiles
    assert grid == 2 * 3                         # (8, 16) x batches (1, 2, 4)
    rng = np.random.default_rng(6)
    payloads = [list(rng.integers(0, jcfg.vocab, size=int(n)))
                for n in (3, 8, 5, 11, 16, 1)]
    prepared = [lm.prepare(p) for p in payloads]
    fwd = jax.jit(lambda p, t: jlm.forward(p, jcfg, t))
    for seq in (8, 16):
        group = [p for p in prepared if p.bucket.seq == seq]
        outs = lm.run_batch(group)
        toks = np.stack([p.tokens for p in group])
        want = np.asarray(fwd(params, toks))
        port = tlm.forward(tparams, lm.cfg, lp.t_tokens(toks)).numpy()
        for i, (p, out) in enumerate(zip(group, outs)):
            assert out.shape == (jcfg.vocab,)
            np.testing.assert_allclose(out, port[i, p.n_tokens - 1],
                                       rtol=1e-6, atol=1e-6)
            assert lp.rel(out, want[i, p.n_tokens - 1]) <= BAR
    with pytest.raises(ValueError, match="single-bucket"):
        lm.run_batch([prepared[0], prepared[3]])
    assert lm.compiles == grid and lm.calls == 2
    lm.unload()
    assert not lm._executables
    lm.load()
    assert lm.compiles == 2 * grid
    assert lm.profile().max_batch == 4 and lm.batch_ladder() == [1, 2, 4]
    assert lm.estimator.estimate(TF.SeqBucket(8), 2) == pytest.approx(2e-4 * 16)


def _drive(rt, clock):
    for _ in range(64):
        rt.loop.step()
        nxt = rt.scheduler.next_close_time()
        if nxt is None:
            break
        if nxt > clock.now():
            clock.set_time(nxt)
    rt.loop.drain()


def test_gcn_plus_lm_fleet_end_to_end():
    """Both model kinds through one loop, zero builds after load() (the
    reference's case on the port; the LM serves the reference's weights,
    so its answers are also held against the reference's forward)."""
    jcfg, params, tparams = _reference_weights()
    engine = sp.port_engine()
    mgr = TF.FleetManager(capacity_units=4.0)
    mgr.register(engine.servable(key="gcn"))
    lm = mgr.register(TF.LmServable("internlm2-1.8b", key="lm",
                                    seq_buckets=(8,), max_batch=2,
                                    params=tparams, device="cpu"))
    mgr.resolve("gcn")
    mgr.resolve("lm")
    gcn_compiles = engine.compile_count
    lm_compiles = lm.compiles
    assert lm_compiles == 2                     # seq 8 x batch (1, 2)

    clock = TR.VirtualClock(start=10.0)
    rt = TF.FleetRuntime(mgr, clock=clock, capacity=64)
    rng = np.random.default_rng(3)
    gcn_reqs = [rt.submit("gcn", rng.choice(400, size=2, replace=False),
                          tenant="graphs", deadline_s=2.0)
                for _ in range(3)]
    lm_payloads = [list(rng.integers(0, lm.cfg.vocab, size=5))
                   for _ in range(3)]
    lm_reqs = [rt.submit("lm", p, tenant="words", deadline_s=2.0)
               for p in lm_payloads]
    _drive(rt, clock)

    for r in gcn_reqs:
        np.testing.assert_allclose(r.future.result(timeout=0),
                                   engine.query(list(r.seeds)),
                                   rtol=1e-4, atol=1e-4)
    for r, payload in zip(lm_reqs, lm_payloads):
        out = r.future.result(timeout=0)
        assert out.shape == (lm.cfg.vocab,)
        # oracle: unbatched forward at the last real position
        toks = np.zeros((1, 8), np.int64)
        toks[0, : len(payload)] = payload
        want = tlm.forward(lm.params, lm.cfg, torch.as_tensor(toks)).numpy()
        np.testing.assert_allclose(out, want[0, len(payload) - 1],
                                   rtol=1e-4, atol=1e-4)
        ref = np.asarray(jlm.forward(params, jcfg, toks.astype(np.int32)))
        assert lp.rel(out, ref[0, len(payload) - 1]) <= BAR
    assert engine.compile_count == gcn_compiles
    assert lm.compiles == lm_compiles
    m = rt.metrics
    assert m.count("completed") == 6
    assert m.count(labeled("completed", tenant="graphs",
                           servable="gcn")) == 3
    assert m.count(labeled("completed", tenant="words", servable="lm")) == 3
    assert m.histogram(labeled("exec_s", servable="lm")).count >= 1


def test_fleet_config_round_trip_with_an_lm():
    """The reference's ``--fleet-config`` case (an ``lm`` servable and
    two tenants) through the port."""
    config = {
        "servables": [
            {"kind": "lm", "key": "lm", "arch": "internlm2-1.8b",
             "seq_buckets": [8], "max_batch": 2},
        ],
        "capacity_units": 2.0,
        "tenants": [
            {"name": "gold", "priority": 1, "deadline_s": 5.0},
            {"name": "free", "qps": 1.0, "burst": 1.0},
        ],
        "weights": {"lm": 2.0},
    }
    clock = TR.VirtualClock()
    rt = TF.fleet_from_config(config, clock=clock, device="cpu")
    assert rt.manager.knows("lm") and not rt.manager.knows("gcn")
    sv = rt.manager.servable("lm")
    assert isinstance(sv, TF.LmServable) and sv.device.type == "cpu"
    r = rt.submit("lm", [1, 2, 3], tenant="gold")
    assert r.priority == 1 and r.deadline == pytest.approx(5.0)
    rt.submit("lm", [4], tenant="free")
    with pytest.raises(TF.QuotaExceededError):
        rt.submit("lm", [5], tenant="free")
    clock.advance(0.1)
    rt.drain()
    assert r.future.result(timeout=0).shape == (sv.cfg.vocab,)


def test_cli_serves_the_fleet_smoke_config(capsys):
    """``serve_gcn --fleet-config examples/fleet_smoke.json`` runs the
    whole file on the port (on the CPU): both servables load, every
    load's stream is offered, and the LM tenant's line prints."""
    import os

    from repro_torch.launch import serve_gcn

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "fleet_smoke.json")
    serve_gcn.main(["--fleet-config", path], device="cpu")
    out = capsys.readouterr().out
    assert "[fleet] 2 servables loaded" in out
    assert "fleet: offered 72 over " in out          # 16 + 8 + 48 requests
    assert "tenant cold -> lm: slo " in out
    assert "tenant hot -> cora: slo " in out
