"""The port's LM models (``repro_torch.models.lm``, ``repro_torch.configs``)
against ``repro.models.lm`` and ``repro.configs``.

For each of the ten reduced archs the reference's ``init_lm`` weights
(carried across as numpy) and ``tests/test_models_smoke.py``'s inputs go
through both packages: ``forward`` logits, ``lm_loss`` and 8
``decode_step``s from an empty cache (cross caches filled as the
reference's ``_prefill_cross`` fills them), each block given the
reference's own input (teacher forcing), and the configs, parameter trees
and caches, which must be equal.  The port's decode is held against its
own forward for the three archs the reference checks.

The logits' bar is 2e-2 x max|reference| (``LOGIT_BAR``), tighter where
tighter holds.  Two archs do not hold it, and the reference shows why:
moving one bf16 ulp in 1% of its embedding entries moves its own logits
by 12% at xlstm and 2.8% at jamba (``test_reference_spread_bounds_the_bar``
measures it).  Each block of theirs gives the reference's output within
one bf16 rounding flip given the reference's input (the other archs'
blocks give its bits); the blocks amplify last-bit
differences of f32 transcendentals (exp, tanh) through eight layers.
Their bars sit at the reference's own spread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models import lm as jlm

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_archs as t_list_archs
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import lm as tlm

import _lm_parity as lp

ARCHS = j_list_archs()
DECODE_STEPS = 8

# max|port - reference| / max|reference| of the logits (and of the decode
# cache); worst measured forward / decode in the comment
LOGIT_BAR = {
    "deepseek-v2-lite-16b": 2e-2,     # 0.0139 / 0.0164
    "mixtral-8x22b": 1e-2,            # 0.0041 / 0.0047
    "internlm2-1.8b": 1e-2,           # 0.0073 / 0.0051
    "qwen3-8b": 1e-2,                 # 0.0083 / 0.0062
    "qwen2.5-14b": 1e-2,              # 0.0073 / 0.0051
    "h2o-danube-1.8b": 1e-2,          # 0.0070 / 0.0066
    "llama-3.2-vision-11b": 2e-2,     # 0.0115 / 0.0118
    "seamless-m4t-large-v2": 2e-2,    # 0.0113 / 0.0136
    "jamba-1.5-large-398b": 4e-2,     # 0.0283 / 0.0357; reference spread 0.028
    "xlstm-1.3b": 1e-1,               # 0.0791 / 0.0885; reference spread 0.120
}
LOSS_REL = 1e-3                       # worst measured: 1.6e-4
# teacher-forced blocks: 0.0 (bit-equal) but at xlstm, 3.95e-3 there (one
# bf16 rounding flip at the maximum is 2^-8)
BLOCK_REL = 5e-3


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """One arch through both packages: weights, inputs and every output
    the tests below compare."""
    arch = request.param
    jcfg, tcfg = lp.cfgs(arch)
    params = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    tparams = lp.port_tree(params)
    tokens, memory = lp.inputs(jcfg)
    jmem, tmem = lp.j_memory(memory), lp.t_memory(memory)

    ref_fwd = jax.jit(lambda p, t, m: (jlm.forward(p, jcfg, t, m),
                                       jlm.lm_loss(p, jcfg, t, m)))
    logits, loss = ref_fwd(params, tokens, jmem)
    ttok = lp.t_tokens(tokens)
    out = {
        "arch": arch, "jcfg": jcfg, "tcfg": tcfg, "params": params,
        "tparams": tparams, "tokens": tokens, "memory": memory,
        "logits": (logits, tlm.forward(tparams, tcfg, ttok, tmem)),
        "loss": (float(loss), float(tlm.lm_loss(tparams, tcfg, ttok, tmem))),
    }

    jcache = jlm.init_cache(jcfg, 2, 32)
    tcache = tlm.init_cache(tcfg, 2, 32, device="cpu")
    out["cache_sigs"] = (lp.signature(lp.to_numpy(jcache)),
                         lp.signature(tcache))
    if memory is not None:
        jcache = lp.prefill_cross(params, jcfg, jcache, jmem)
        tcache = tlm.fill_cross_cache(tparams, tcfg, tcache, tmem)
        out["cross"] = (lp.to_numpy(jcache), tcache)
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, jcfg, c, t, pos))
    steps = []
    for t in range(DECODE_STEPS):
        jl, jcache = step(params, jcache, tokens[:, t:t + 1], jnp.int32(t))
        tl, tcache = tlm.decode_step(tparams, tcfg, tcache,
                                     ttok[:, t:t + 1], t)
        steps.append((jl, tl))
    out["decode"] = steps
    out["final_cache"] = (lp.to_numpy(jcache), tcache)
    return out


def test_forward_logits_match(run):
    want, got = run["logits"]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert bool(torch.isfinite(got).all())
    assert lp.rel(got, want) <= LOGIT_BAR[run["arch"]]


def test_lm_loss_matches(run):
    want, got = run["loss"]
    assert np.isfinite(got)
    assert abs(got - want) / abs(want) <= LOSS_REL


def test_decode_steps_match(run):
    """8 cached steps from an empty cache; logits every step and the
    cache after the last within the arch's bar."""
    bar = LOGIT_BAR[run["arch"]]
    for t, (want, got) in enumerate(run["decode"]):
        assert tuple(got.shape) == want.shape == (2, run["jcfg"].vocab)
        assert lp.rel(got, want) <= bar, t
    jcache, tcache = run["final_cache"]
    assert lp.signature(tcache) == lp.signature(jcache)
    for (path, want), (_, got) in zip(lp.leaves(jcache), lp.leaves(tcache)):
        if np.abs(lp.f32(want)).max() > 0:
            assert lp.rel(got, want) <= bar, path


def test_init_cache_and_cross_fill_match(run):
    """``init_cache`` gives the reference's tree of shapes and dtypes;
    ``fill_cross_cache`` writes what ``_prefill_cross`` writes."""
    jsig, tsig = run["cache_sigs"]
    assert tsig == jsig
    if "cross" in run:
        # the memory goes through seamless's whole encoder first: worst
        # measured 0.0071 there, 0.0 at llama
        jcache, tcache = run["cross"]
        for (path, want), (_, got) in zip(lp.leaves(jcache),
                                          lp.leaves(tcache)):
            assert lp.rel(got, want) <= LOGIT_BAR[run["arch"]], path


def test_blocks_match_given_the_reference_input(run):
    """Teacher forcing: every block (DeepSeek's dense head block, the
    encoder layers, each period's blocks) and the final norm, given the
    reference's hidden state, returns the reference's next one."""
    arch, jcfg, tcfg = run["arch"], run["jcfg"], run["tcfg"]
    params, tparams = run["params"], run["tparams"]
    tokens, memory = run["tokens"], run["memory"]
    jpos, tpos = jnp.arange(tokens.shape[1]), torch.arange(tokens.shape[1])
    worst = 0.0

    def held(got, want):
        nonlocal worst
        worst = max(worst, lp.rel(got, want))

    def t_of(x):
        return torch.as_tensor(lp.f32(x)).to(torch.bfloat16)

    jmem = lp.j_memory(memory)
    if jcfg.encoder_layers:
        # each encoder layer (bidirectional attention + MLP), then the norm
        from repro.models import layers as JL
        from repro_torch.models import layers as TL

        enc_j = dataclasses.replace(jcfg, moe=None)
        enc_t = dataclasses.replace(tcfg, moe=None)
        mpos_j, mpos_t = jnp.arange(jmem.shape[1]), torch.arange(jmem.shape[1])
        h = jmem
        for i in range(jcfg.encoder_layers):
            jb = jax.tree.map(lambda a: a[i], params["encoder"])
            tb = tlm.period_slice(tparams["encoder"], i)
            a, _ = JL.attention(jb["mix"], JL.rms_norm(h, jb["norm1"]),
                                enc_j, mpos_j, causal=False)
            h_mid = h + a @ jb["mix"]["wo"]
            want = h_mid + JL.mlp(jb["ffn"], JL.rms_norm(h_mid, jb["norm2"]))
            th = t_of(h)
            a, _ = TL.attention(tb["mix"], TL.rms_norm(th, tb["norm1"]),
                                enc_t, mpos_t, causal=False)
            th_mid = th + a @ tb["mix"]["wo"]
            got = th_mid + TL.mlp(tb["ffn"], TL.rms_norm(th_mid, tb["norm2"]))
            held(got, want)
            h = want
        held(TL.rms_norm(t_of(h), tparams["enc_norm"]),
             JL.rms_norm(h, params["enc_norm"]))
        jmem = jlm.encode(params, jcfg, jmem)
    x = params["embed"][tokens].astype(jnp.bfloat16)
    held(tlm._embed(tparams, lp.t_tokens(tokens)), x)
    dense_j = dataclasses.replace(jcfg, moe=None)
    dense_t = dataclasses.replace(tcfg, moe=None)
    for jb, tb in zip(params.get("head_blocks", []),
                      tparams.get("head_blocks", [])):
        want, _ = jlm._apply_block(dense_j, "attn+mlp", jb, x, jpos, jmem,
                                   None, None)
        got, _ = tlm._apply_block(dense_t, "attn+mlp", tb, t_of(x), tpos,
                                  None if jmem is None else t_of(jmem),
                                  None, None)
        held(got, want)
        x = want
    for pi in range(jlm.n_body_periods(jcfg)):
        jp = jax.tree.map(lambda a: a[pi], params["blocks"])
        tp = tlm.period_slice(tparams["blocks"], pi)
        for i, kind in enumerate(jcfg.pattern):
            want, _ = jlm._apply_block(jcfg, kind, jp[f"b{i}"], x, jpos,
                                       jmem, None, None)
            got, _ = tlm._apply_block(tcfg, kind, tp[f"b{i}"], t_of(x), tpos,
                                      None if jmem is None else t_of(jmem),
                                      None, None)
            held(got, want)
            x = want
    held(tlm.L.rms_norm(t_of(x), tparams["final_norm"], tcfg.norm_eps),
         jlm.L.rms_norm(x, params["final_norm"], jcfg.norm_eps))
    assert worst <= BLOCK_REL, (arch, worst)


def test_reference_spread_bounds_the_bar():
    """The reference moves its own logits by this much when 1% of its
    embedding entries move one bf16 ulp: at xlstm and jamba more than the
    2e-2 bar, which is why their bars sit at their spread."""
    spreads = {}
    for arch in ("xlstm-1.3b", "jamba-1.5-large-398b"):
        jcfg, _ = lp.cfgs(arch)
        params = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
        tokens, _ = lp.inputs(jcfg)
        fwd = jax.jit(lambda p, t, cfg=jcfg: jlm.forward(p, cfg, t))
        base = fwd(params, tokens)
        rng = np.random.default_rng(0)
        bits = np.asarray(params["embed"]).view(np.uint16).copy()
        bits[rng.random(bits.shape) < 0.01] += 1
        moved = dict(params, embed=jnp.asarray(bits.view(ml_dtypes.bfloat16)))
        spreads[arch] = lp.rel(fwd(moved, tokens), base)
    assert spreads["xlstm-1.3b"] > lp.LOGIT_REL              # measured 0.120
    assert spreads["jamba-1.5-large-398b"] > lp.LOGIT_REL    # measured 0.028
    assert LOGIT_BAR["xlstm-1.3b"] <= spreads["xlstm-1.3b"]
    assert LOGIT_BAR["jamba-1.5-large-398b"] <= 2 * spreads["jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-8b", "xlstm-1.3b"])
def test_decode_matches_forward(arch):
    """The port's greedy decode logits == its teacher-forced forward
    logits (causality), at the reference test's limits, with the port's
    own weights (``torch.Generator``)."""
    _, tcfg = lp.cfgs(arch)
    params = tlm.init_lm(tcfg, torch.Generator().manual_seed(3), "cpu")
    tokens, _ = lp.inputs(tcfg, seq=8, seed=3)
    tokens = lp.t_tokens(tokens)
    full = tlm.forward(params, tcfg, tokens)
    cache = tlm.init_cache(tcfg, 2, 8, device="cpu")
    for t in range(8):
        logits, cache = tlm.decode_step(params, tcfg, cache,
                                        tokens[:, t:t + 1], t)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=0.15, atol=0.15)


def test_configs_are_the_references():
    """Registry, every full-size and reduced config, ``param_count``,
    ``sub_quadratic``, ``n_periods`` and the head dim: equal."""
    assert t_list_archs() == j_list_archs()
    for arch in ARCHS:
        for cfg_j, cfg_t in ((j_get_config(arch), t_get_config(arch)),
                             lp.cfgs(arch)):
            assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
            assert cfg_t.param_count() == cfg_j.param_count()
            assert cfg_t.sub_quadratic() == cfg_j.sub_quadratic()
            assert cfg_t.n_periods == cfg_j.n_periods
            assert cfg_t.resolved_head_dim == cfg_j.resolved_head_dim
            assert tlm.n_body_periods(cfg_t) == jlm.n_body_periods(cfg_j)
    with pytest.raises(KeyError):
        t_get_config("gpt-2")
    assert t_reduced(t_get_config("qwen3-8b")).name == "qwen3-8b-smoke"


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_tree_is_the_references(arch):
    """The port's ``init_lm`` gives the reference's tree: the same paths,
    shapes and dtypes, ``blocks`` stacked over periods; weights drawn
    from the generator (another seed, other weights)."""
    jcfg, tcfg = lp.cfgs(arch)
    want = jax.eval_shape(lambda: jlm.init_lm(jcfg, jax.random.PRNGKey(0)))
    got = tlm.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    want_sig = [(path, tuple(s.shape), np.dtype(s.dtype).name)
                for path, s in lp.leaves(want)]
    assert lp.signature(got) == want_sig
    other = tlm.init_lm(tcfg, torch.Generator().manual_seed(1), "cpu")
    assert not torch.equal(got["embed"], other["embed"])
