"""The port's LM layers and SSM blocks against ``repro.models``.

Every function of ``repro_torch.models.layers`` and ``.ssm`` gets the
reference's weights (``init_*`` from ``jax.random``, carried across as
numpy) and the same bf16 inputs from a numpy seed, in each of its modes:
GQA attention full / sliding-window / qk-norm / QKV bias / bidirectional /
cross / query-blocked (S > 512) / cached decode (full and the SWA rolling
buffer past the window, cross from the cache), MLA full-sequence and
absorbed decode (with and without query compression), SwiGLU, MoE (with a
shared expert, and with a skewed router that overflows capacity), and the
Mamba, mLSTM and sLSTM blocks in full-sequence and single-step mode.
Outputs are held as a share of max|reference|, tighter than the logits'
``LOGIT_REL`` (2e-2) where tighter holds: most functions give the
reference's bits on this CPU (``EXACT``, 1e-3, below one bf16 rounding
flip at the maximum, 2^-8); where f32 transcendentals or sums differ in
the last bit and flip a bf16 rounding, the bar is stated with the worst
value measured beside it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MLAConfig as JMLA
from repro.models import layers as JL
from repro.models import ssm as JS

from repro_torch.configs import MLAConfig as TMLA
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

import _lm_parity as lp

EXACT = 1e-3    # measured 0.0 (bit-equal) wherever it is the bar


def _key(i: int):
    return jax.random.PRNGKey(100 + i)


def _positions(s: int, start: int = 0):
    return jnp.arange(start, start + s), torch.arange(start, start + s)


# ---------------------------------------------------------------------------
# norms, rope, init
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    jx, tx = lp.bf16_pair(rng, (2, 4, 16, 32))
    jw, tw = lp.bf16_pair(rng, (32,))
    assert lp.rel(TL.rms_norm(tx, tw), JL.rms_norm(jx, jw)) <= EXACT
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_allclose(
            TL.rope_freqs(32, theta).numpy(),
            np.asarray(JL.rope_freqs(32, theta)), rtol=1e-6)
        jp, tp = _positions(16, start=5)
        assert lp.rel(TL.apply_rope(tx, tp, theta),
                      JL.apply_rope(jx, jp, theta)) <= EXACT
    # per-batch positions (B, S) broadcast over heads
    pos = np.stack([np.arange(16), np.arange(3, 19)])
    assert lp.rel(TL.apply_rope(tx, torch.as_tensor(pos), 1e4),
                  JL.apply_rope(jx, jnp.asarray(pos), 1e4)) <= EXACT


def test_dense_init_draws_from_the_generator():
    """Shape, dtype and the reference's scale; the same seed gives the
    same weights, another seed other weights."""
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init(g, 256, 512)
    assert w.shape == (256, 512) and w.dtype == torch.bfloat16
    want = (2.0 / (256 + 512)) ** 0.5
    assert abs(float(w.float().std()) / want - 1.0) < 0.02
    again = TL.dense_init(torch.Generator().manual_seed(0), 256, 512)
    assert torch.equal(w, again)
    assert not torch.equal(w, TL.dense_init(torch.Generator().manual_seed(1),
                                            256, 512))
    f = TL.dense_init(g, 8, 4, dtype=torch.float32)
    assert f.dtype == torch.float32


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

# (arch, overrides of the reduced config, sequence, causal, cross)
ATTENTION_CASES = {
    "gqa_qknorm": ("qwen3-8b", {}, 16, True, False),
    "qkv_bias": ("qwen2.5-14b", {}, 16, True, False),
    "swa": ("h2o-danube-1.8b", {}, 16, True, False),
    "bidirectional": ("seamless-m4t-large-v2", {}, 16, False, False),
    "cross": ("llama-3.2-vision-11b", {}, 16, False, True),
    "blocked_causal": ("internlm2-1.8b", {}, 1024, True, False),
    "blocked_swa": ("mixtral-8x22b", {"swa_window": 100}, 1024, True, False),
    "blocked_encoder": ("seamless-m4t-large-v2", {}, 1024, False, False),
}


def _attention_params(arch, overrides, cross, key):
    jcfg, tcfg = lp.cfgs(arch)
    jcfg = dataclasses.replace(jcfg, **overrides)
    tcfg = dataclasses.replace(tcfg, **overrides)
    p = JL.init_attention(jcfg, key, cross=cross)
    if "bq" in p:      # the reference inits biases at zero: give them values
        rng = np.random.default_rng(3)
        for name in ("bq", "bk", "bv"):
            p[name] = jnp.asarray(rng.standard_normal(p[name].shape) * 0.1,
                                  jnp.bfloat16)
    return jcfg, tcfg, p, lp.port_tree(p)


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_attention_full_sequence_matches(case):
    arch, overrides, s, causal, cross = ATTENTION_CASES[case]
    jcfg, tcfg, jp, tp = _attention_params(arch, overrides, cross, _key(1))
    rng = np.random.default_rng(1)
    jx, tx = lp.bf16_pair(rng, (2, s, jcfg.d_model))
    jm = tm = None
    if cross:
        jm, tm = lp.bf16_pair(rng, (2, 12, jcfg.d_model))
    jpos, tpos = _positions(s)
    want, jc = JL.attention(jp, jx, jcfg, jpos, kv_source=jm, causal=causal,
                            cross=cross)
    got, tc = TL.attention(tp, tx, tcfg, tpos, kv_source=tm, causal=causal,
                           cross=cross)
    assert jc is None and tc is None
    # blocked cases: worst measured 1.21e-3 (blocked_encoder); others 0.0
    assert lp.rel(got, want) <= (5e-3 if s > TL.ATTN_Q_BLOCK else EXACT)


def test_blocked_path_equals_unblocked_port():
    """The query-blocked path (S > 512, S % 512 == 0) gives the answer of
    one unblocked ``_sdpa`` over the whole sequence."""
    jcfg, tcfg, _, tp = _attention_params("internlm2-1.8b", {}, False, _key(2))
    rng = np.random.default_rng(2)
    _, q = lp.bf16_pair(rng, (1, 1024, 4, 16))
    _, k = lp.bf16_pair(rng, (1, 1024, 2, 16))
    _, v = lp.bf16_pair(rng, (1, 1024, 2, 16))
    pos = torch.arange(1024)
    for window in (0, 300):
        blocked = TL._sdpa_blocked(q, k, v, pos, pos, True, window)
        whole = TL._sdpa(q, k, v, TL._causal_mask(pos, pos, window))
        assert lp.rel(blocked, whole) == 0.0


# (arch, overrides, decode steps)
DECODE_CASES = {
    "full": ("qwen3-8b", {}, 6),
    "qkv_bias": ("qwen2.5-14b", {}, 6),
    "swa_rolling": ("h2o-danube-1.8b", {}, 14),   # window 8: wraps twice
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_attention_cached_decode_matches(case):
    """Step by step from an empty cache: outputs and the written caches
    (the SWA case runs past its 8-slot rolling buffer)."""
    arch, overrides, steps = DECODE_CASES[case]
    jcfg, tcfg, jp, tp = _attention_params(arch, overrides, False, _key(3))
    jcache = JL.init_self_cache(jcfg, 2, 12)
    tcache = TL.init_self_cache(tcfg, 2, 12, device="cpu")
    assert lp.signature(tcache) == lp.signature(lp.to_numpy(jcache))
    if jcfg.swa_window:
        assert tcache["k"].shape[1] == min(12, jcfg.swa_window)
    rng = np.random.default_rng(4)
    worst = 0.0
    for t in range(steps):
        jx, tx = lp.bf16_pair(rng, (2, 1, jcfg.d_model))
        jpos, tpos = _positions(1, start=t)
        want, jcache = JL.attention(jp, jx, jcfg, jpos, cache=jcache,
                                    cache_pos=jnp.int32(t))
        got, tcache = TL.attention(tp, tx, tcfg, tpos, cache=tcache,
                                   cache_pos=t)
        worst = max(worst, lp.rel(got, want))
        for name in ("k", "v"):
            assert lp.rel(tcache[name], jcache[name]) <= EXACT
    assert worst <= EXACT


def test_cross_decode_reads_the_cache():
    """Cross-attention decode with the memory projected into the cache
    (no ``kv_source``) gives the same output as with it, on both sides."""
    jcfg, tcfg, jp, tp = _attention_params("llama-3.2-vision-11b", {}, True,
                                           _key(4))
    rng = np.random.default_rng(5)
    jm, tm = lp.bf16_pair(rng, (2, 12, jcfg.d_model))
    jx, tx = lp.bf16_pair(rng, (2, 1, jcfg.d_model))
    cache_j = {"k": JL._split_heads(jm @ jp["wk"], jcfg.n_kv_heads),
               "v": JL._split_heads(jm @ jp["wv"], jcfg.n_kv_heads)}
    cache_t = lp.port_cache(cache_j)
    jpos, tpos = _positions(1, start=3)
    want, jc = JL.attention(jp, jx, jcfg, jpos, cache=cache_j,
                            cache_pos=jnp.int32(3), causal=False, cross=True)
    got, tc = TL.attention(tp, tx, tcfg, tpos, cache=cache_t, cache_pos=3,
                           causal=False, cross=True)
    assert lp.rel(got, want) <= EXACT
    assert torch.equal(tc["k"], cache_t["k"])
    with_memory, _ = TL.attention(tp, tx, tcfg, tpos, kv_source=tm,
                                  cache=cache_t, cache_pos=3, causal=False,
                                  cross=True)
    assert lp.rel(with_memory, got) <= EXACT


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_cfgs(q_lora: bool):
    jcfg, tcfg = lp.cfgs("deepseek-v2-lite-16b")
    if q_lora:
        jcfg = dataclasses.replace(
            jcfg, mla=dataclasses.replace(jcfg.mla, q_lora_rank=32))
        tcfg = dataclasses.replace(
            tcfg, mla=TMLA(**dataclasses.asdict(jcfg.mla)))
    assert isinstance(jcfg.mla, JMLA)
    return jcfg, tcfg


@pytest.mark.parametrize("q_lora", [False, True], ids=["full_rank_q", "q_lora"])
def test_mla_matches(q_lora):
    """The full-sequence path, then six absorbed decode steps from an
    empty latent cache."""
    jcfg, tcfg = _mla_cfgs(q_lora)
    jp = JL.init_mla(jcfg, _key(5))
    tp = lp.port_tree(jp)
    assert ("wq_a" in tp) == q_lora
    rng = np.random.default_rng(6)
    jx, tx = lp.bf16_pair(rng, (2, 16, jcfg.d_model))
    jpos, tpos = _positions(16)
    want, _ = JL.mla_attention(jp, jx, jcfg, jpos)
    got, _ = TL.mla_attention(tp, tx, tcfg, tpos)
    assert lp.rel(got, want) <= EXACT

    jcache = JL.init_mla_cache(jcfg, 2, 10)
    tcache = TL.init_mla_cache(tcfg, 2, 10, device="cpu")
    assert lp.signature(tcache) == lp.signature(lp.to_numpy(jcache))
    for t in range(6):
        jx, tx = lp.bf16_pair(rng, (2, 1, jcfg.d_model))
        jpos, tpos = _positions(1, start=t)
        want, jcache = JL.mla_attention(jp, jx, jcfg, jpos, cache=jcache,
                                        cache_pos=jnp.int32(t))
        got, tcache = TL.mla_attention(tp, tx, tcfg, tpos, cache=tcache,
                                       cache_pos=t)
        assert lp.rel(got, want) <= EXACT
        for name in ("c", "kr"):
            assert lp.rel(tcache[name], jcache[name]) <= EXACT


# ---------------------------------------------------------------------------
# FFN: SwiGLU and MoE
# ---------------------------------------------------------------------------


def test_mlp_matches():
    jcfg, _ = lp.cfgs("qwen3-8b")
    jp = JL.init_mlp(jcfg, _key(6))
    rng = np.random.default_rng(7)
    jx, tx = lp.bf16_pair(rng, (2, 16, jcfg.d_model))
    assert lp.rel(TL.mlp(lp.port_tree(jp), tx), JL.mlp(jp, jx)) <= EXACT


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_moe_matches(arch):
    """Top-k routing, capacity slots and the gate-weighted combine (with a
    shared expert at DeepSeek)."""
    jcfg, tcfg = lp.cfgs(arch)
    jp = JL.init_moe(jcfg, _key(7))
    tp = lp.port_tree(jp)
    assert ("shared" in tp) == bool(jcfg.moe.n_shared)
    rng = np.random.default_rng(8)
    jx, tx = lp.bf16_pair(rng, (2, 16, jcfg.d_model))
    assert TL.moe_capacity(32, tcfg.moe) == int(
        max(-(-int(-(-32 * jcfg.moe.top_k // jcfg.moe.n_experts)
                   * jcfg.moe.capacity_factor) // 8) * 8, 8))
    got = TL.moe_layer(tp, tx, tcfg.moe)
    want = JL.moe_layer(jp, jx, jcfg.moe)
    assert lp.rel(got, want) <= EXACT


def test_moe_overflow_drops_as_the_reference():
    """A skewed router sends every token to expert 0 first: its 96
    routings overflow its capacity, and the overflow is dropped (zeroed)
    exactly as in the reference; the combine still adds each token's
    second expert."""
    jcfg, tcfg = lp.cfgs("mixtral-8x22b")
    jp = JL.init_moe(jcfg, _key(8))
    router = np.asarray(jp["router"]).copy()
    router[:, 0] = 1.0                       # the inputs below are all > 0
    jp["router"] = jnp.asarray(router)
    tp = lp.port_tree(jp)
    rng = np.random.default_rng(9)
    x = np.abs(rng.standard_normal((2, 48, jcfg.d_model))).astype(np.float32) + 1.0
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).bfloat16()
    n, cap = 96, TL.moe_capacity(96, tcfg.moe)
    assert cap < n                           # expert 0 overflows
    logits = tx.reshape(n, -1).float() @ tp["router"]
    assert bool((logits.argmax(-1) == 0).all())
    got = TL.moe_layer(tp, tx, tcfg.moe)
    want = JL.moe_layer(jp, jx, jcfg.moe)
    assert lp.rel(got, want) <= EXACT
    assert np.isfinite(lp.f32(got)).all()


# ---------------------------------------------------------------------------
# SSM blocks
# ---------------------------------------------------------------------------

SSM_ARCH = {"mamba": "jamba-1.5-large-398b", "mlstm": "xlstm-1.3b",
            "slstm": "xlstm-1.3b"}
# worst measured: mamba 1.4e-7, mLSTM 3.5e-4, sLSTM 4.6e-3 (its tanh and
# exp differ in the last f32 bit and feed back through h)
SSM_TOL = {"mamba": EXACT, "mlstm": 2e-3, "slstm": 1e-2}


@pytest.mark.parametrize("kind", sorted(SSM_ARCH))
def test_ssm_block_full_sequence_and_steps_match(kind):
    """The full-sequence mode and its final state, then four single steps
    threading the state, on both sides."""
    jcfg, tcfg = lp.cfgs(SSM_ARCH[kind])
    jp = getattr(JS, f"init_{kind}")(jcfg, _key(9))
    tp = lp.port_tree(jp)
    jblock, tblock = getattr(JS, f"{kind}_block"), getattr(TS, f"{kind}_block")
    rng = np.random.default_rng(10)
    jx, tx = lp.bf16_pair(rng, (2, 16, jcfg.d_model))
    want, jstate = jblock(jp, jx, jcfg)
    got, tstate = tblock(tp, tx, tcfg)
    assert lp.rel(got, want) <= SSM_TOL[kind]
    assert sorted(tstate) == sorted(jstate)
    for name in jstate:
        assert lp.rel(tstate[name], jstate[name]) <= SSM_TOL[kind]

    j0 = getattr(JS, f"init_{kind}_state")(jcfg, 2)
    t0 = getattr(TS, f"init_{kind}_state")(tcfg, 2, device="cpu")
    assert lp.signature(t0) == lp.signature(lp.to_numpy(j0))
    jstate, tstate = j0, t0
    for _ in range(4):
        jx, tx = lp.bf16_pair(rng, (2, 1, jcfg.d_model))
        want, jstate = jblock(jp, jx, jcfg, state=jstate)
        got, tstate = tblock(tp, tx, tcfg, state=tstate)
        assert lp.rel(got, want) <= SSM_TOL[kind]
        for name in jstate:
            assert lp.rel(tstate[name], jstate[name]) <= SSM_TOL[kind]


def test_silu_and_softplus_round_as_the_reference():
    """``silu`` equals ``jax.nn.silu`` bit for bit in bf16 (``F.silu``
    rounds once and does not); ``softplus`` is within an f32 ulp."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4096) * 4).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).bfloat16()
    np.testing.assert_array_equal(lp.f32(TL.silu(tx)), lp.f32(jax.nn.silu(jx)))
    assert lp.rel(torch.nn.functional.silu(tx), jax.nn.silu(jx)) > 0
    np.testing.assert_allclose(TL.softplus(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=3e-7, atol=1e-7)
