"""The port's training substrate against the reference, case for case.

``repro_torch.train`` (AdamW, int8 compression, checkpoints, the
fault-tolerant trainer), ``dist.straggler``, ``dist.collectives``'
``masked_psum_mean`` and ``data.synthetic``, held against ``repro.train``
and friends on the same numpy inputs: the cases of
``tests/test_train_substrate.py``, each through both packages.  The
replica axis the reference emulates with ``jax.vmap(axis_name="dp")`` is,
in the port, four gloo ranks on the CPU (``tests/_torch_dist.run_ranks``
over ``tests/_torch_train_ranks.py``).  Checkpoints cross both ways: the
reference's files are the port's, bit for bit.  The LM CLI
(``repro_torch.launch.train``) prints the reference CLI's lines.

Tolerances: f32 results that take another order of operations (a sum over
leaves, over ranks, a libm ``cos``) within a few f32 ulp (rtol 1e-6);
elementwise f32 chains equal within 1 ulp; bf16 parameters equal bit for
bit but for rare last-bit flips (the f32 value they round can sit one
ulp away), at most FLIP_SHARE of them and never more than one bf16 ulp.
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data.synthetic import token_batch as j_token_batch
from repro.dist import StragglerMonitor as JMonitor
from repro.dist import masked_psum_mean as j_masked_psum_mean
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import StepFailure as JStepFailure
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import adamw_init as j_adamw_init
from repro.train import adamw_update as j_adamw_update
from repro.train import checkpoint as jckpt
from repro.train import clip_by_global_norm as j_clip
from repro.train import compressed_psum as j_compressed_psum
from repro.train import compression_ratio as j_compression_ratio
from repro.train import global_norm as j_global_norm
from repro.train import lr_at as j_lr_at
from repro.train import quantize_int8 as j_quantize_int8
from repro.train import run as j_run

import repro_torch.train as T
from repro_torch.data.synthetic import token_batch, token_batches
from repro_torch.dist.collectives import masked_psum_mean
from repro_torch.dist.straggler import StragglerMonitor
from repro_torch.models.convert import adamw_state_from_numpy
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.tree import flatten_with_paths
from repro_torch.train.tree import tree_map as t_tree_map

from _torch_dist import run_ranks

FLIP_SHARE = 1e-2
RTOL = 1e-6


def _np(x) -> np.ndarray:
    """A JAX array or a torch tensor as numpy (bf16 kept as bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _t(x) -> torch.Tensor:
    """A numpy / JAX array as a torch tensor holding the same bits."""
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tree_t(tree):
    return jax.tree.map(_t, tree)


def ulps(got, want, at=None) -> np.ndarray:
    """|got - want| in units of the f32 spacing at ``at`` (``want``'s
    magnitude unless given)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    at = np.abs(want) if at is None else np.asarray(at, np.float32)
    return np.abs(got - want) / np.spacing(at)


def bf16_flips(got, want):
    """(share of differing bf16 values, the largest difference in ulp)."""
    a = _np(got).view(np.int16).astype(np.int32)
    b = np.asarray(want).view(np.int16).astype(np.int32)
    diff = np.abs(a - b)
    return float((diff != 0).mean()), int(diff.max())


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_over_a_grid(schedule):
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1,
              schedule=schedule)
    jcfg, tcfg = JAdamWConfig(**kw), T.AdamWConfig(**kw)
    for s in range(0, 121, 3):
        want = float(j_lr_at(jcfg, jnp.int32(s)))
        got = T.lr_at(tcfg, s)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=RTOL, abs=1e-12), s
    # the reference test's shape of the schedule
    cfg = T.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_ratio=0.1)
    lrs = [float(T.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0) and lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(0.1, rel=1e-2)


def _mixed_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
        "e": (rng.standard_normal((7, 3)) * scale).astype(ml_dtypes.bfloat16),
        "blocks": [{"b": (rng.standard_normal(4) * scale).astype(np.float32)}],
    }


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_global_norm_and_clip_match(scale):
    tree = _mixed_tree(0, scale)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = _tree_t(tree)
    assert float(T.global_norm(ttree)) == pytest.approx(
        float(j_global_norm(jtree)), rel=RTOL)
    jclip, jn = j_clip(jtree, 1.0)
    tclip, tn = T.clip_by_global_norm(ttree, 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=RTOL)
    want = dict(flatten_with_paths(jclip))
    for key, leaf in flatten_with_paths(tclip):
        assert leaf.dtype == torch.float32      # bf16 * f32, as in JAX
        assert want[key].dtype == jnp.float32
        np.testing.assert_allclose(leaf.numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=0)


def test_grad_clip_reports_the_norm():
    cfg = T.AdamWConfig(grad_clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    opt = T.adamw_init(params)
    _, _, metrics = T.adamw_update(cfg, {"w": torch.full((4,), 100.0)}, opt,
                                   params)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_adamw_converges_quadratic():
    cfg = T.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                        total_steps=200, schedule="constant")
    params = {"w": torch.tensor([3.0, -2.0, 1.0]), "b": torch.tensor(0.5)}
    opt = T.adamw_init(params)
    loss_fn = lambda p: torch.sum(p["w"] ** 2) + p["b"] ** 2
    for _ in range(150):
        _, grads = T.value_and_grad(loss_fn)(params)
        params, opt, _ = T.adamw_update(cfg, grads, opt, params)
    assert float(loss_fn(params)) < 1e-3


def _adam_case(seed):
    """Params (bf16 and f32), grads, and a state three steps in."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 48), "e": (96, 32), "b": (48,)}
    dtypes = {"w": ml_dtypes.bfloat16, "e": ml_dtypes.bfloat16,
              "b": np.float32}
    params = {k: rng.standard_normal(s).astype(dtypes[k])
              for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * 0.3).astype(dtypes[k])
             for k, s in shapes.items()}
    mu = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: (rng.random(s) * 0.01).astype(np.float32)
          for k, s in shapes.items()}
    return params, grads, (np.int32(3), mu, nu)


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("inplace", [False, True])
def test_adamw_update_matches(clip, inplace):
    """One update from one state: each moment within 1 f32 ulp of the
    largest of its two terms (``b m`` and ``(1 - b) g``) and itself, f32
    params within
    2 ulp, bf16 params bit-equal but for at most FLIP_SHARE last-bit
    flips; the step and lr agree.  Unclipped, the moments are bit-equal.
    Clipped, the grad norm sums the squares in another order (within
    RTOL), and the moments follow the scale it gives: twice the norms'
    relative difference of the gradient term on top of the ulp."""
    params, grads, (step, mu, nu) = _adam_case(1)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=50, grad_clip_norm=clip)
    jstate = j_adamw_init(jax.tree.map(jnp.asarray, params))._replace(
        step=jnp.int32(step), mu=jax.tree.map(jnp.asarray, mu),
        nu=jax.tree.map(jnp.asarray, nu))
    jp, js, jm = j_adamw_update(JAdamWConfig(**kw),
                                jax.tree.map(jnp.asarray, grads), jstate,
                                jax.tree.map(jnp.asarray, params))
    tstate = adamw_state_from_numpy((step, mu, nu), device="cpu")
    tparams = _tree_t(params)
    before = {k: v.clone() for k, v in tparams.items()}
    tp, ts, tm = T.adamw_update(T.AdamWConfig(**kw), _tree_t(grads), tstate,
                                tparams, inplace=inplace)
    assert int(ts.step) == int(js.step) == 4
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=RTOL)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=RTOL)
    norm_rel = 0.0
    if clip is not None:    # the scales' relative difference, g and g^2
        norm_rel = abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1)
        assert norm_rel <= RTOL
    clip_scale = 1.0 if clip is None else min(1.0,
                                              clip / float(jm["grad_norm"]))
    for k in params:
        g = grads[k].astype(np.float32) * np.float32(clip_scale)
        for name, b, old, term in (("mu", 0.9, mu[k], g),
                                   ("nu", 0.95, nu[k], g * g)):
            got, want = getattr(ts, name)[k], getattr(js, name)[k]
            assert got.dtype == torch.float32
            at = np.maximum.reduce([np.abs(b * old), np.abs((1 - b) * term),
                                    np.abs(np.asarray(want))])
            bar = np.spacing(at) + 2 * norm_rel * np.abs((1 - b) * term)
            assert (np.abs(got.numpy() - np.asarray(want)) <= bar).all(), \
                (name, k)
            if clip is None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tp[k].dtype == tparams[k].dtype
        if params[k].dtype == ml_dtypes.bfloat16:
            share, worst = bf16_flips(tp[k], jp[k])
            assert share <= FLIP_SHARE and worst <= 1, (k, share, worst)
        else:
            at = np.maximum(np.abs(params[k]), np.abs(np.asarray(jp[k])))
            assert ulps(tp[k].numpy(), jp[k], at).max() <= 2, k
        # in place overwrites the given tensors; functional leaves them
        if inplace:
            assert tp[k] is tparams[k]
        else:
            assert tp[k] is not tparams[k]
            assert torch.equal(tparams[k], before[k])


@pytest.mark.parametrize("inplace", [False, True])
def test_adamw_update_widens_bf16_moments(inplace):
    """bf16 moments three steps in (as ``adamw_init(dtype=bfloat16)``
    makes them, then restored): one unclipped update gives the
    reference's f32 moments bit for bit in either mode (``b * m`` rounded
    in bf16, then promoted), bf16 params equal but for at most FLIP_SHARE
    last-bit flips; the given bf16 moments are left as they were."""
    params, grads, (step, mu, nu) = _adam_case(3)
    mu = {k: v.astype(ml_dtypes.bfloat16) for k, v in mu.items()}
    nu = {k: v.astype(ml_dtypes.bfloat16) for k, v in nu.items()}
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=50, grad_clip_norm=None)
    jstate = j_adamw_init(jax.tree.map(jnp.asarray, params),
                          dtype=jnp.bfloat16)._replace(
        step=jnp.int32(step), mu=jax.tree.map(jnp.asarray, mu),
        nu=jax.tree.map(jnp.asarray, nu))
    jp, js, _ = j_adamw_update(JAdamWConfig(**kw),
                               jax.tree.map(jnp.asarray, grads), jstate,
                               jax.tree.map(jnp.asarray, params))
    tstate = adamw_state_from_numpy((step, mu, nu), device="cpu")
    before = t_tree_map(torch.clone, tstate)
    tp, ts, _ = T.adamw_update(T.AdamWConfig(**kw), _tree_t(grads), tstate,
                               _tree_t(params), inplace=inplace)
    for k in params:
        for name in ("mu", "nu"):
            got, want = getattr(ts, name)[k], getattr(js, name)[k]
            assert got.dtype == torch.float32 and want.dtype == jnp.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert torch.equal(getattr(tstate, name)[k],
                               getattr(before, name)[k])
        if params[k].dtype == ml_dtypes.bfloat16:
            share, worst = bf16_flips(tp[k], jp[k])
            assert share <= FLIP_SHARE and worst <= 1, (k, share, worst)
        else:
            at = np.maximum(np.abs(params[k]), np.abs(np.asarray(jp[k])))
            assert ulps(tp[k].numpy(), jp[k], at).max() <= 2, k


def test_adamw_chain_stays_with_the_reference():
    """Five chained clipped updates of bf16 params from the same grads:
    the flips stay rare and one ulp, and the f32 moments within 1e-5 of
    their scale (each step's clip scale within RTOL)."""
    params, grads, _ = _adam_case(2)
    jcfg = JAdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    tcfg = T.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_adamw_init(jp)
    tp = _tree_t(params)
    ts = T.adamw_init(tp)
    jg = jax.tree.map(jnp.asarray, grads)
    tg = _tree_t(grads)
    for _ in range(5):
        jp, js, _ = j_adamw_update(jcfg, jg, js, jp)
        tp, ts, _ = T.adamw_update(tcfg, tg, ts, tp, inplace=True)
    for k in params:
        if params[k].dtype == ml_dtypes.bfloat16:
            share, worst = bf16_flips(tp[k], jp[k])
            assert share <= FLIP_SHARE and worst <= 1, (k, share, worst)
        want = np.asarray(js.mu[k])
        assert np.abs(ts.mu[k].numpy() - want).max() <= 1e-5 * np.abs(
            want).max()


def test_adamw_init_dtype():
    params = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    opt = T.adamw_init(params, dtype=torch.bfloat16)
    assert opt.mu["w"].dtype == torch.bfloat16
    assert opt.step.dtype == torch.int32 and int(opt.step) == 0


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_quantize_int8_is_the_references():
    rng = np.random.default_rng(0)
    for shape in [(1000,), (37, 19)]:
        x = rng.standard_normal(shape).astype(np.float32) * 3
        jq, js = j_quantize_int8(jnp.asarray(x))
        tq, ts = T.quantize_int8(torch.as_tensor(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == float(js)
        err = (T.dequantize_int8(tq, ts) - torch.as_tensor(x)).abs().max()
        assert float(err) <= float(ts) / 2 + 1e-6
    assert T.compression_ratio({"w": torch.zeros(128, 128)}) == \
        pytest.approx(j_compression_ratio({"w": jnp.zeros((128, 128))}))
    assert T.compression_ratio({"w": torch.zeros(128, 128)}) > 3.9


def _replica_grads(n, seed=1):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n, 64)).astype(np.float32),
            "b": (rng.standard_normal((n, 8)) * 10).astype(np.float32)}


def _j_psum_pair(grads):
    def f(g):
        avg, err = j_compressed_psum(g, "dp")
        avg2, err2 = j_compressed_psum(g, "dp", err)
        return avg, err, avg2, err2

    return jax.vmap(f, axis_name="dp")(jax.tree.map(jnp.asarray, grads))


def test_compressed_psum_one_replica():
    """``group=None`` is the reference's size-1 axis: every output equal,
    and error feedback keeps both steps within a quantization step."""
    grads = _replica_grads(1)
    want = _j_psum_pair(grads)
    mine = {k: torch.as_tensor(v[0]) for k, v in grads.items()}
    avg, err = T.compressed_psum(mine)
    avg2, err2 = T.compressed_psum(mine, None, err)
    for got, ref in zip((avg, err, avg2, err2), want):
        for k in grads:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k][0]))
    scale = float(np.abs(grads["w"]).max()) / 127
    assert float((avg["w"] - mine["w"]).abs().max()) <= scale
    assert float((avg2["w"] - mine["w"]).abs().max()) <= scale


def test_masked_psum_mean_one_replica():
    g = {"g": torch.tensor([2.0, 4.0])}
    np.testing.assert_array_equal(masked_psum_mean(g, None, 1.0)["g"].numpy(),
                                  [2.0, 4.0])
    # a dropped lone replica averages to zeros, not NaNs
    np.testing.assert_array_equal(masked_psum_mean(g, None, 0.0)["g"].numpy(),
                                  [0.0, 0.0])


def test_four_replicas_over_gloo_match_the_references_vmap():
    """compressed_psum (two steps of error feedback), masked_psum_mean and
    the trainer's straggler drop in four gloo ranks, against the
    reference's ``vmap(axis_name="dp")`` over four."""
    n = 4
    grads = _replica_grads(n)
    alive = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    poisoned = np.array([1.0, 1.0, 1.0, 1000.0], np.float32)
    ranks = run_ranks("_torch_train_ranks", "train_rank", n,
                      args=(grads, alive, poisoned), timeout=240)
    avg, err, avg2, err2 = _j_psum_pair(grads)
    masked = jax.vmap(lambda g, a: j_masked_psum_mean(g, "dp", a),
                      axis_name="dp")(jax.tree.map(jnp.asarray, grads),
                                      jnp.asarray(alive))
    for r, out in enumerate(ranks):
        for name, ref in (("avg", avg), ("err", err), ("avg2", avg2),
                          ("err2", err2), ("masked", masked)):
            for k in grads:
                want = np.asarray(ref[k][r])
                # the scale sum over 4 ranks in another order: a few ulp
                np.testing.assert_allclose(out[name][k], want, rtol=RTOL,
                                           atol=RTOL * np.abs(want).max(),
                                           err_msg=f"rank {r} {name} {k}")
    np.testing.assert_allclose(ranks[0]["masked"]["w"],
                               grads["w"][:3].mean(0), rtol=RTOL, atol=1e-7)

    # the reference's scenario, its average over the vmapped replicas
    def averaged(a):
        out = jax.vmap(lambda g, m: j_masked_psum_mean({"g": g}, "dp", m),
                       axis_name="dp")(jnp.asarray(poisoned), jnp.asarray(a))
        return float(out["g"][0])

    def j_step(state, _, alive_mask):
        times = np.ones(n)
        times[3] = 5.0
        return ({"w": state["w"] - 0.1 * averaged(alive_mask)},
                {"loss": 1.0, "replica_step_times": times})

    with tempfile.TemporaryDirectory() as tmp:
        jcfg = JTrainerConfig(total_steps=6, ckpt_dir=os.path.join(tmp, "c"),
                              ckpt_every=50, log_every=100, n_replicas=n,
                              straggler_drop_factor=4.0,
                              straggler_patience=2)
        jstate, jreport = j_run(jcfg, {"w": jnp.zeros(())}, j_step,
                                iter(lambda: None, 1), log=lambda *_: None)
    want_w = -0.1 * (2 * (3.0 + 1000.0) / 4 + 4 * 1.0)
    assert float(jstate["w"]) == pytest.approx(want_w)
    for out in ranks:
        assert out["calls"] == 6
        assert out["dropped"] == jreport.dropped_replicas == [3]
        assert out["w"] == pytest.approx(float(jstate["w"]), rel=RTOL)


# ---------------------------------------------------------------------------
# straggler monitor, synthetic data
# ---------------------------------------------------------------------------


def test_straggler_monitor_verdicts_match():
    from repro.runtime.metrics import MetricsRegistry as JRegistry

    from repro_torch.runtime.metrics import MetricsRegistry

    rng = np.random.default_rng(0)
    jm = JMonitor(5, warn_factor=2, drop_factor=4, patience=2,
                  metrics=JRegistry())
    tm = StragglerMonitor(5, warn_factor=2, drop_factor=4, patience=2,
                          metrics=MetricsRegistry())
    for step in range(40):
        times = 1.0 + rng.random(5) * 0.2
        if 5 <= step < 9:
            times[1] *= 2.5          # warn-level, recovers
        if step >= 12:
            times[4] *= 5.0          # sustained: dropped after patience
        if step in (20, 21):
            times[2] *= 4.5
        jv, tv = jm.observe(times), tm.observe(times)
        assert [(v.replica, v.action, v.ratio) for v in tv] == \
            [(v.replica, v.action, v.ratio) for v in jv], step
        np.testing.assert_array_equal(tm.alive(), jm.alive())
        np.testing.assert_array_equal(tm.step_ewma_s(), jm.step_ewma_s())
    assert tm.dropped().tolist() == jm.dropped().tolist() == \
        [False, False, True, False, True]
    assert tm.metrics.snapshot()["gauges"] == jm.metrics.snapshot()["gauges"]
    # the reference test's case
    mon = StragglerMonitor(n_replicas=4, warn_factor=2, drop_factor=4,
                           patience=2)
    mon.observe(np.array([1.0, 1.0, 1.0, 1.0]))
    v1 = mon.observe(np.array([1.0, 1.0, 1.0, 5.0]))
    assert v1 and v1[0].replica == 3 and v1[0].action == "warn"
    assert mon.observe(np.array([1.0, 1.0, 1.0, 6.0]))[0].action == "drop"
    with pytest.raises(ValueError):
        StragglerMonitor(2, warn_factor=3, drop_factor=2)


def test_token_batches_equal_the_references():
    gen = token_batches(512, 4, 32, seed=3)
    for step in range(5):
        got = next(gen)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_token_batch(512, 4, 32, 3, step)))
    np.testing.assert_array_equal(token_batch(92_544, 8, 128, 0, 7).numpy(),
                                  np.asarray(j_token_batch(92_544, 8, 128, 0,
                                                           7)))


# ---------------------------------------------------------------------------
# checkpoints: the same files in both packages
# ---------------------------------------------------------------------------


def _ckpt_tree():
    """bf16, f32 and int32 leaves, a list, and an AdamWState (numpy)."""
    rng = np.random.default_rng(4)
    params = {"layer_0": {"w": rng.standard_normal((5, 3)).astype(
                  ml_dtypes.bfloat16),
                          "b": rng.standard_normal(3).astype(np.float32)},
              "blocks": [{"ids": np.arange(7, dtype=np.int32)}]}
    f32 = lambda t: jax.tree.map(lambda a: a.astype(np.float32) * 0.5, t)
    opt = (np.int32(9), f32(params), f32(params))
    return params, opt


def _j_tree(params, opt):
    from repro.train import AdamWState as JState

    j = lambda t: jax.tree.map(jnp.asarray, t)
    return {"params": j(params), "opt": JState(jnp.asarray(opt[0]), j(opt[1]),
                                               j(opt[2]))}


def _t_tree(params, opt):
    from repro_torch.models.convert import lm_params_from_numpy

    return {"params": lm_params_from_numpy(params, device="cpu"),
            "opt": adamw_state_from_numpy(opt, device="cpu")}


def _assert_bits(got_tree, want_tree):
    want = dict(flatten_with_paths(want_tree))
    got = dict(flatten_with_paths(got_tree))
    assert sorted(got) == sorted(want)
    for k, leaf in got.items():
        g, w = _np(leaf), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def _shard_arrays(path):
    out = {}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    for s in range(meta["shards"]):
        with np.load(os.path.join(path, f"shard_{s}.npz")) as z:
            out[s] = {k: z[k] for k in z.files}
    return meta, out


def test_checkpoint_leaf_keys_are_the_references():
    params, opt = _ckpt_tree()
    jkeys = ["/".join(str(p) for p in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(_j_tree(params, opt))[0]]
    tkeys = [k for k, _ in flatten_with_paths(_t_tree(params, opt))]
    assert tkeys == jkeys
    assert "['opt']/.step" in tkeys and "['opt']/.mu/['layer_0']/['w']" in tkeys
    assert "['params']/['blocks']/[0]/['ids']" in tkeys


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_port_writes_the_references_files(tmp_path, shards):
    """Saved from the same tree, both packages' meta.json and shard
    arrays are equal: keys, shapes, dtype names, bf16 as ``|V2`` bits."""
    params, opt = _ckpt_tree()
    jckpt.save(str(tmp_path / "j"), 9, _j_tree(params, opt), shards=shards)
    tckpt.save(str(tmp_path / "t"), 9, _t_tree(params, opt), shards=shards)
    jmeta, jarr = _shard_arrays(str(tmp_path / "j" / "step_9"))
    tmeta, tarr = _shard_arrays(str(tmp_path / "t" / "step_9"))
    assert tmeta == jmeta
    assert jmeta["dtypes"]["['params']/['layer_0']/['w']"] == "bfloat16"
    for s in jarr:
        assert sorted(tarr[s]) == sorted(jarr[s])
        for k, want in jarr[s].items():
            got = tarr[s][k]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.tobytes() == want.tobytes(), k
    assert jarr[0]["['params']/['layer_0']/['w']"].dtype == np.dtype("V2")


@pytest.mark.parametrize("saved,restored", [(1, 3), (3, 1), (2, 2)])
def test_reference_checkpoint_restores_in_the_port(tmp_path, saved, restored):
    """The reference saves, the port restores bit-equal (bf16, f32, int32
    and the AdamWState), whatever the shard counts; the port's own save
    at another count restores the same bits."""
    params, opt = _ckpt_tree()
    jckpt.save(str(tmp_path), 9, _j_tree(params, opt), shards=saved)
    like = t_tree_map(torch.zeros_like, _t_tree(params, opt))
    got, step = tckpt.restore(str(tmp_path), like)
    assert step == 9 and isinstance(got["opt"], T.AdamWState)
    _assert_bits(got, _j_tree(params, opt))
    tckpt.save(str(tmp_path / "again"), 10, got, shards=restored)
    again, _ = tckpt.restore(str(tmp_path / "again"), like)
    _assert_bits(again, _j_tree(params, opt))


@pytest.mark.parametrize("saved", [1, 2, 4])
def test_port_checkpoint_restores_in_the_reference(tmp_path, saved):
    """The port saves, the reference restores bit-equal.  The reference's
    ``restore`` casts each stored array to the template's dtype, which
    numpy cannot do from ``|V2`` bits: it refuses a bf16 leaf, its own as
    the port's, so bf16 crosses as the bits above and the f32 / int32
    leaves and the AdamWState through the reference's ``restore``."""
    params, opt = _ckpt_tree()
    params["layer_0"]["w"] = params["layer_0"]["w"].astype(np.float32)
    opt = (opt[0], params, params)
    tckpt.save(str(tmp_path), 9, _t_tree(params, opt), shards=saved)
    like = jax.tree.map(jnp.zeros_like, _j_tree(params, opt))
    got, step = jckpt.restore(str(tmp_path), like)
    assert step == 9
    _assert_bits(got, _j_tree(params, opt))

    bf16 = {"w": np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16)}
    for save, root in ((jckpt.save, tmp_path / "jb"),
                       (tckpt.save, tmp_path / "tb")):
        save(str(root), 1, jax.tree.map(jnp.asarray, bf16)
             if save is jckpt.save else _tree_t(bf16))
        with pytest.raises(ValueError, match="cast"):
            jckpt.restore(str(root), jax.tree.map(jnp.asarray, bf16))
        got, _ = tckpt.restore(str(root), _tree_t(bf16))
        assert _np(got["w"]).tobytes() == bf16["w"].tobytes()


def test_checkpoint_atomicity_gc_and_checks(tmp_path):
    tree = {"x": torch.ones(4)}
    for s in (1, 2, 3, 4, 5):
        tckpt.save(str(tmp_path), s, tree, keep=2)
    assert [s for s, _ in tckpt.checkpoint_paths(str(tmp_path))] == [4, 5]
    os.makedirs(tmp_path / "step_99.tmp")
    assert tckpt.latest_step(str(tmp_path)) == 5
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(str(tmp_path), {"x": torch.ones(5)})
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore(str(tmp_path), {"y": torch.ones(4)})
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path), tree, step=3)
    restored, _ = tckpt.restore(str(tmp_path), {"x": torch.zeros(4,
                                                  dtype=torch.float64)})
    assert restored["x"].dtype == torch.float64     # cast to the template's


def test_save_async_snapshots_before_it_returns(tmp_path):
    """An in-place update right after ``save_async`` does not reach the
    checkpoint: the host copy is taken before it returns."""
    tree = {"w": torch.arange(8, dtype=torch.float32),
            "e": torch.arange(6, dtype=torch.float32).to(torch.bfloat16)}
    want = {k: v.clone() for k, v in tree.items()}
    t = tckpt.save_async(str(tmp_path), 7, tree)
    for v in tree.values():
        v.add_(100)
    t.join()
    tckpt.wait_pending()
    restored, step = tckpt.restore(str(tmp_path), tree)
    assert step == 7
    for k in tree:
        assert torch.equal(restored[k], want[k])


# ---------------------------------------------------------------------------
# the fault-tolerant trainer: each scenario through both packages
# ---------------------------------------------------------------------------


def _both(tmp_path, make_step, hook_at=None, **cfg):
    """Run one scenario through the reference's trainer and the port's;
    returns ((state, report), (state, report))."""
    out = []
    for pkg, (Cfg, run, Failure, zeros) in {
        "j": (JTrainerConfig, j_run, JStepFailure, jnp.zeros),
        "t": (T.TrainerConfig, T.run, T.StepFailure, torch.zeros),
    }.items():
        hook = None
        if hook_at is not None:
            fails = {"left": hook_at[1]}

            def hook(step, fails=fails, Failure=Failure):
                if step == hook_at[0] and fails["left"] > 0:
                    fails["left"] -= 1
                    raise Failure("injected")

        c = Cfg(ckpt_dir=str(tmp_path / pkg), **cfg)
        out.append(run(c, {"w": zeros(2)}, make_step(pkg),
                       iter(lambda: None, 1), failure_hook=hook,
                       log=lambda *_: None))
    return out


def test_trainer_restarts_after_failure(tmp_path):
    def make_step(pkg):
        def step_fn(state, _):
            return ({"w": state["w"] + 1},
                    {"loss": float(2.0 / (state["w"][0] + 1))})
        return step_fn

    (js, jr), (ts, tr) = _both(tmp_path, make_step, hook_at=(7, 2),
                               total_steps=12, ckpt_every=5, max_restarts=5,
                               log_every=100)
    assert tr.restarts == jr.restarts == 2
    assert float(ts["w"][0]) == float(js["w"][0]) == 12.0
    assert tr.losses == jr.losses and tr.steps_done == jr.steps_done


def test_trainer_resumes_from_its_checkpoints(tmp_path):
    """A second run over the same directory resumes where the first left
    its last checkpoint, in both packages."""
    def make_step(pkg):
        def step_fn(state, _):
            return {"w": state["w"] + 1}, {"loss": 1.0}
        return step_fn

    kw = dict(total_steps=8, ckpt_every=3, log_every=100)
    _both(tmp_path, make_step, **kw)
    (js, jr), (ts, tr) = _both(tmp_path, make_step, **dict(kw,
                                                           total_steps=10))
    assert tr.steps_done == jr.steps_done == 2
    assert float(ts["w"][0]) == float(js["w"][0]) == 10.0


def test_trainer_aborts_on_nan(tmp_path):
    for pkg, run, Cfg, zeros in (("j", j_run, JTrainerConfig, jnp.zeros),
                                 ("t", T.run, T.TrainerConfig, torch.zeros)):
        cfg = Cfg(total_steps=3, ckpt_dir=str(tmp_path / pkg),
                  max_restarts=1, log_every=100)
        with pytest.raises(RuntimeError, match="max_restarts"):
            run(cfg, {"w": zeros(1)}, lambda s, _: (s, {"loss": float("nan")}),
                iter(lambda: None, 1), log=lambda *_: None)


def test_trainer_restores_after_a_nan_step(tmp_path):
    """A non-finite loss restores the last checkpoint and retries."""
    def make_step(pkg):
        seen = {"nan": False}

        def step_fn(state, _):
            if float(state["w"][0]) == 4.0 and not seen["nan"]:
                seen["nan"] = True
                return state, {"loss": float("nan")}
            return {"w": state["w"] + 1}, {"loss": 1.0}
        return step_fn

    (js, jr), (ts, tr) = _both(tmp_path, make_step, total_steps=6,
                               ckpt_every=3, log_every=100)
    assert tr.restarts == jr.restarts == 1
    assert float(ts["w"][0]) == float(js["w"][0]) == 6.0
    assert tr.losses == jr.losses


def test_trainer_two_argument_step_without_replica_monitoring(tmp_path):
    (_, jr), (_, tr) = _both(
        tmp_path, lambda pkg: (lambda state, _: (state, {"loss": 0.5})),
        total_steps=2, log_every=100)
    assert tr.steps_done == jr.steps_done == 2
    assert tr.dropped_replicas == jr.dropped_replicas == []


# ---------------------------------------------------------------------------
# GCN training (examples/train_gcn.py's step, tests/test_system.py's run)
# ---------------------------------------------------------------------------

# Both packages sum the same f32 products in another order: the gradients
# agree within GCN_GRAD_REL of each leaf's max|reference grad|, the losses
# of 15 chained steps within GCN_LOSS_REL.
GCN_GRAD_REL = 1e-4
GCN_LOSS_REL = 1e-4
RESUME_REL = 1e-5


def _gcn_case(hidden=16):
    from repro.graphs import load_dataset as j_load_dataset
    from repro.models import gcn as jgcn

    from repro_torch.graphs.datasets import load_dataset as t_load_dataset
    from repro_torch.models import gcn as tgcn
    from repro_torch.models.convert import params_from_numpy

    jds, tds = j_load_dataset("cora"), t_load_dataset("cora")
    np.testing.assert_array_equal(tds.features, jds.features)
    np.testing.assert_array_equal(tds.labels, jds.labels)
    kw = dict(in_dim=jds.spec.feature_dim, hidden_dim=hidden,
              out_dim=jds.spec.classes)
    jcfg, tcfg = jgcn.GCNConfig(**kw), tgcn.GCNConfig(**kw)
    params = jgcn.init_params(jcfg, jax.random.PRNGKey(1))
    j = dict(cfg=jcfg, graph=jgcn.GCNGraph.build(jds.adj_norm, jcfg),
             feats=jnp.asarray(jds.features), labels=jnp.asarray(jds.labels),
             params=params)
    t = dict(cfg=tcfg, graph=tgcn.GCNGraph.build(tds.adj_norm, tcfg),
             feats=torch.as_tensor(tds.features), labels=tds.labels,
             params=params_from_numpy(jax.tree.map(np.asarray, params),
                                      device="cpu"))
    return j, t


def _t_gcn_loss(t):
    from repro_torch.models import gcn as tgcn

    return lambda p: tgcn.gcn_loss(p, t["graph"], t["feats"], t["labels"],
                                   t["cfg"], device="cpu")


def test_gcn_gradient_matches_jax():
    from repro.models import gcn as jgcn

    j, t = _gcn_case()
    jloss, jgrads = jax.value_and_grad(lambda p: jgcn.gcn_loss(
        p, j["graph"], j["feats"], j["labels"], j["cfg"]))(j["params"])
    tloss, tgrads = T.value_and_grad(_t_gcn_loss(t))(t["params"])
    assert float(tloss) == pytest.approx(float(jloss), rel=GCN_LOSS_REL)
    want = dict(flatten_with_paths(jgrads))
    for key, g in flatten_with_paths(tgrads):
        w = np.asarray(want[key])
        assert np.abs(g.numpy() - w).max() <= GCN_GRAD_REL * np.abs(w).max()
    # value_and_grad leaves the parameters' flags as it found them
    assert not any(p.requires_grad for _, p in flatten_with_paths(
        t["params"]))


def test_gcn_training_end_to_end_matches_the_reference():
    """tests/test_system.py's 15 AdamW steps, through both packages: the
    losses agree step for step and fall."""
    from repro.models import gcn as jgcn

    j, t = _gcn_case()
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=30)

    @jax.jit
    def j_step(params, opt):
        loss, grads = jax.value_and_grad(lambda p: jgcn.gcn_loss(
            p, j["graph"], j["feats"], j["labels"], j["cfg"]))(params)
        params, opt, _ = j_adamw_update(JAdamWConfig(**kw), grads, opt,
                                        params)
        return params, opt, loss

    jp, jo = j["params"], j_adamw_init(j["params"])
    tp, to = t["params"], T.adamw_init(t["params"])
    grad = T.value_and_grad(_t_gcn_loss(t))
    jl, tl = [], []
    for _ in range(15):
        jp, jo, loss = j_step(jp, jo)
        jl.append(float(loss))
        loss, grads = grad(tp)
        tp, to, _ = T.adamw_update(T.AdamWConfig(**kw), grads, to, tp)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=GCN_LOSS_REL)
    assert tl[-1] < tl[0] and np.isfinite(tl).all()


def test_gcn_trainer_resumes_after_an_injected_failure(tmp_path):
    """examples/train_gcn.py's loop through the port's trainer: a
    StepFailure at step 6 restores the step-4 checkpoint, and the run
    ends where an uninterrupted one does, within RESUME_REL: the CPU's
    scatter-add in the backward of the gathers is not bit-reproducible
    from run to run, and Adam carries such last-bit differences on."""
    _, t = _gcn_case()
    opt_cfg = T.AdamWConfig(lr=5e-3, total_steps=12, warmup_steps=4)
    grad = T.value_and_grad(_t_gcn_loss(t))

    def step_fn(state, _batch):
        loss, grads = grad(state["params"])
        params, opt, metrics = T.adamw_update(opt_cfg, grads, state["opt"],
                                              state["params"])
        return ({"params": params, "opt": opt},
                {"loss": float(loss), **{k: float(v)
                                         for k, v in metrics.items()}})

    finals = {}
    for name, fail_at in (("clean", None), ("failed", 6)):
        fired = {"done": False}

        def hook(step, fail_at=fail_at, fired=fired):
            if step == fail_at and not fired["done"]:
                fired["done"] = True
                raise T.StepFailure("injected node loss")

        state = {"params": t["params"], "opt": T.adamw_init(t["params"])}
        cfg = T.TrainerConfig(total_steps=12, ckpt_dir=str(tmp_path / name),
                              ckpt_every=4, log_every=100)
        finals[name] = T.run(cfg, state, step_fn, iter(lambda: None, 1),
                             failure_hook=hook, log=lambda *_: None)
    (clean, cr), (failed, fr) = finals["clean"], finals["failed"]
    assert fr.restarts == 1 and cr.restarts == 0
    assert len(fr.losses) == len(cr.losses) + 2     # steps 4, 5 again
    assert fr.losses[-1] == pytest.approx(cr.losses[-1], rel=RESUME_REL)
    assert cr.losses[-1] < cr.losses[0]
    for (k, a), (_, b) in zip(flatten_with_paths(clean["params"]),
                              flatten_with_paths(failed["params"])):
        assert float((a - b).abs().max()) <= RESUME_REL * float(
            a.abs().max()), k


@pytest.mark.parametrize("impl,fused", [("cuda", False),
                                        ("cuda_sparse", False),
                                        ("cuda", True)])
def test_kernel_impls_refuse_gradients(impl, fused):
    """The kernels have no backward, nor do the reference's Pallas kernels
    (``jax.value_and_grad`` through them fails): a layer through a kernel
    impl with gradients required raises on every device, where the CPU's
    plain versions would otherwise differentiate silently.  Without
    gradients they run as before."""
    import dataclasses

    from repro_torch.models import gcn as tgcn

    _, t = _gcn_case(hidden=8)
    cfg = dataclasses.replace(t["cfg"], spmm_impl=impl)
    plan = dataclasses.replace(tgcn.plan_for_config(cfg), fused=fused)
    loss = lambda p: tgcn.gcn_loss(p, t["graph"], t["feats"], t["labels"],
                                   cfg, plan=plan, device="cpu")
    with pytest.raises(RuntimeError, match="has no backward"):
        T.value_and_grad(loss)(t["params"])
    with torch.no_grad():
        assert np.isfinite(float(loss(t["params"])))
