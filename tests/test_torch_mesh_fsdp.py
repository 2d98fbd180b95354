"""FSDP and the MoE's token-shard exchange under a mesh on the port
(``dist.sharding.fsdp_gathered``, ``models.layers.moe_layer`` under a
live mesh) against FSDP off, the single card and the reference.

* **FSDP.**  Gloo ranks on the CPU (``tests/_torch_dist.run_ranks``,
  ``tests/_torch_mesh_ranks.lm_mesh_rank``) on a (2, 2) data x model mesh
  run the reduced qwen3-8b and deepseek-v2-lite (MLA + MoE) with
  ``ShardingPlan(fsdp=True)`` and with FSDP off, from the reference's
  weights: the prefill, 3 cached decode steps, the gradient and one train
  step.  Each weight is gathered over ``data`` before its products, so the
  logits and the loss equal the FSDP-off run's bit for bit; every gradient
  leaf keeps its parameter's (FSDP) layout and passes
  ``train.grad.hold_leaf`` against the reference's gradient, and the
  leaves that are not bit-equal to FSDP off are named (``NOT_BIT_EQUAL``).
* **The MoE on token shards.**  ``moe_layer`` on the (2, 2) mesh with a
  capacity small enough that tokens overflow, once with the experts split
  over ``model`` (4 experts) and once with D split instead (3 experts,
  which do not divide 2): each copy's slot equals the reference's (so
  capacity drops the same tokens), the output equals the single card's
  within ``EXACT`` and the reference's within ``lp.LOGIT_REL`` (where the
  single card itself sits), the gradients the single card's within
  ``lp.LOGIT_REL``.
* **No whole buffer.**  ``roofline.analysis.CollectiveCounter`` around
  the layer's forward and backward, and around every ``moe_layer`` call of
  a gradient step of the reduced deepseek under FSDP: no collective's
  result holds as many elements as the (E, cap, D) buffer.

The (1, 2) and (2, 2) steps with FSDP off and four archs are
``tests/test_torch_mesh_lm.py``'s.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import build_prefill_step as j_prefill
from repro.models import layers as j_layers
from repro.models import lm as jlm

from repro_torch.models import layers as t_layers
from repro_torch.train.grad import hold_leaf
from repro_torch.train.tree import leaves

import _lm_parity as lp
from _torch_dist import run_ranks
from test_torch_lm import LOGIT_BAR
from test_torch_lm_layers import EXACT

FSDP_ARCHS = ["qwen3-8b", "deepseek-v2-lite-16b"]
SHAPE = (2, 2)
# Gradient leaves that FSDP does not give bit-equal to FSDP off, by arch:
# none (each gathered weight's gradient sums the same two bf16 partials,
# reduce-scattered where FSDP off all-reduces them).
NOT_BIT_EQUAL = {"qwen3-8b": set(), "deepseek-v2-lite-16b": set()}
# MoE cases: (arch, experts, capacity factor).  At MOE_X each overflows its
# capacity (384 and 512 slots against 512 and 683 copies an expert on
# average; 512 of 2,048 copies dropped), and its buffer (98,304 elements)
# outsizes a token shard's routed rows (65,536), which the combine moves
# whole, and what DTensor gathers of the expert weights, their gradients
# and the hidden (E, cap, W / model) in the backward (each expert 64 wide:
# W / model < D, as at every arch's published widths).  With 3 experts
# over 2 model ranks the expert width is split and ``down`` sums f32
# partials.
MOE_CASES = {"by_expert": ("deepseek-v2-lite-16b", 4, 0.75),
             "by_width": ("mixtral-8x22b", 3, 0.75)}
MOE_X = (16, 64)         # batch x sequence of the MoE cases


@functools.lru_cache(maxsize=None)
def _lm_case(arch: str):
    """The reference's prefill logits at ``tests/test_torch_lm.py``'s
    weights and inputs, its loss, gradients and spread at
    ``_lm_parity.grad_case``'s, and those weights and inputs as numpy."""
    jcfg, _ = lp.cfgs(arch)
    params = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    tokens, memory = lp.inputs(jcfg)
    assert memory is None
    prefill = np.asarray(jax.jit(j_prefill(jcfg))(params, tokens))
    loss, grads, spread, gparams, (gtokens, _) = lp.grad_case(arch)
    return prefill, (loss, grads, spread), (
        lp.to_numpy(params), tokens, lp.to_numpy(gparams), gtokens)


def _moe_cfgs(arch: str, experts: int, factor: float):
    jcfg, tcfg = lp.cfgs(arch)
    change = dict(n_experts=experts, capacity_factor=factor, d_ff_expert=64)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              **change)),
            dataclasses.replace(tcfg.moe, **change))


@functools.lru_cache(maxsize=None)
def _moe_case(label: str):
    """The reference's MoE weights, input, output and every copy's slot
    (its cumulative-sum rank, as the reference's ``moe_layer`` computes
    it), and the single card's output and gradients."""
    arch, experts, factor = MOE_CASES[label]
    jcfg, tmoe = _moe_cfgs(arch, experts, factor)
    jp = j_layers.init_moe(jcfg, jax.random.PRNGKey(17))
    rng = np.random.default_rng(18)
    jx, tx = lp.bf16_pair(rng, MOE_X + (jcfg.d_model,))
    want = np.asarray(j_layers.moe_layer(jp, jx, jcfg.moe)).astype(
        np.float32)
    xt = jx.reshape(-1, jcfg.d_model).astype(jnp.float32)
    _, eids = jax.lax.top_k(xt @ jp["router"].astype(jnp.float32),
                            tmoe.top_k)
    flat = eids.reshape(-1)
    onehot = jax.nn.one_hot(flat, tmoe.n_experts, dtype=jnp.int32)
    slots = np.asarray(jnp.take_along_axis(
        jnp.cumsum(onehot, axis=0) - 1, flat[:, None], axis=1)[:, 0])
    tp = lp.port_tree(jp)
    for t in leaves(tp):
        t.requires_grad_(True)
    one = t_layers.moe_layer(tp, tx, tmoe)
    one.float().sum().backward()
    return tmoe, lp.to_numpy(jp), lp.f32(tx), want, slots, lp.f32(one), [
        t.grad.float().numpy() for t in leaves(tp)]


@pytest.fixture(scope="module")
def fsdp_run():
    """Every FSDP_ARCHS case with FSDP on and off through one (2, 2)
    spawn."""
    cases = {}
    for arch in FSDP_ARCHS:
        for fsdp in (False, True):
            cases[arch + ("@fsdp" if fsdp else "")] = _lm_case(arch)[2] + (
                fsdp,)
    return run_ranks("_torch_mesh_ranks", "lm_mesh_rank",
                     SHAPE[0] * SHAPE[1], args=(SHAPE, cases))


@pytest.fixture(scope="module")
def moe_run():
    """Every MOE_CASES case and a reduced deepseek gradient step under
    FSDP through one (2, 2) spawn."""
    cases = {label: _moe_case(label)[:3] for label in MOE_CASES}
    return run_ranks("_torch_mesh_ranks", "moe_mesh_rank",
                     SHAPE[0] * SHAPE[1],
                     args=(SHAPE, cases, "deepseek-v2-lite-16b"))


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_logits_and_loss_equal_fsdp_off(fsdp_run, arch):
    """Prefill and decode logits and the loss with FSDP: bit for bit the
    FSDP-off run's on every rank, and within the arch's bar of the
    reference's prefill."""
    want = _lm_case(arch)[0]
    for res in fsdp_run:
        on, off = res[arch + "@fsdp"], res[arch]
        for a, b in zip([on["prefill"]] + on["decode"],
                        [off["prefill"]] + off["decode"]):
            assert np.array_equal(a, b), float(np.abs(a - b).max())
        assert on["loss"] == off["loss"]
        assert on["train_loss"] == off["train_loss"]
        assert lp.rel(on["prefill"], want) <= LOGIT_BAR[arch]
        assert on["cache_layouts_kept"]


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_gradients_keep_layout_and_hold(fsdp_run, arch):
    """Every gradient leaf with FSDP: laid out as its (data-sharded)
    parameter, within its bar of the reference's gradient; the leaves not
    bit-equal to FSDP off are exactly ``NOT_BIT_EQUAL``."""
    _, (_, want, spread), _ = _lm_case(arch)
    for res in fsdp_run:
        on, off = res[arch + "@fsdp"], res[arch]
        assert on["grad_layouts_kept"]
        held = {k: hold_leaf(torch.as_tensor(g), want[k], spread[k])
                for k, g in on["grads"]}
        assert all(v["ok"] for v in held.values()), {
            k: v for k, v in held.items() if not v["ok"]}
        apart = {k for (k, a), (_, b) in zip(on["grads"], off["grads"])
                 if not np.array_equal(a, b)}
        assert apart == NOT_BIT_EQUAL[arch]


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_train_step(fsdp_run, arch):
    """One AdamW step on the data-sharded weights and moments: in place,
    moving the weights, every layout kept."""
    for res in fsdp_run:
        on = res[arch + "@fsdp"]
        assert on["in_place"] and on["moved"] and on["layouts_kept"]


@pytest.mark.parametrize("label", list(MOE_CASES))
def test_moe_slots_drop_what_the_reference_drops(moe_run, label):
    """Every copy's slot, read on its token shard, is the reference's
    global one, and tokens overflow the capacity: the dropped set is the
    reference's and the single card's."""
    _, _, _, _, slots, _, _ = _moe_case(label)
    res = [r[label] for r in moe_run]
    cap = res[0]["capacity"]
    per = len(slots) // SHAPE[0]
    for r in res:
        lo = r["shard"] * per
        assert np.array_equal(r["slots"], slots[lo:lo + per])
    assert (slots >= cap).any() and (slots < cap).any()


@pytest.mark.parametrize("label", list(MOE_CASES))
def test_moe_on_token_shards_matches(moe_run, label):
    """The layer's output on every rank within EXACT of the single card's
    and within ``lp.LOGIT_REL`` of the reference's, as the single card's
    own is; its parameter gradients within ``lp.LOGIT_REL`` of the single
    card's."""
    _, _, _, want, _, one, one_grads = _moe_case(label)
    assert lp.rel(one, want) <= lp.LOGIT_REL
    for r in (r[label] for r in moe_run):
        assert np.isfinite(r["out"]).all()
        assert lp.rel(r["out"], one) <= EXACT
        assert lp.rel(r["out"], want) <= lp.LOGIT_REL
        for got, g in zip(r["grads"], one_grads):
            assert lp.rel(got, g) <= lp.LOGIT_REL


@pytest.mark.parametrize("label", list(MOE_CASES) + ["step"])
def test_moe_moves_no_whole_buffer(moe_run, label):
    """No collective of the layer (forward and backward), nor of any
    ``moe_layer`` call in a gradient step under FSDP, has a result as large
    as the (E, cap, D) buffer; the dispatch's reduce-scatter ran."""
    for r in (r[label] for r in moe_run):
        if label == "step":
            whole = r["buffer"]
        else:
            moe = _moe_case(label)[0]
            whole = moe.n_experts * r["capacity"] * r["out"].shape[-1]
        assert r["calls"]["reduce-scatter"] > 0
        assert max(r["largest"].values()) < whole, (r["largest"], whole)
