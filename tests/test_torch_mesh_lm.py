"""The LM under a mesh on the port (``repro_torch.dist.sharding``,
``dist.policy`` under a live mesh, ``launch.mesh.make_production_mesh``
and the steps' ``mesh=``) against the reference.

* **The plan.**  ``ShardingPlan.param_spec`` and ``cache_spec`` give the
  reference's spec for every leaf of the ten archs at their published
  sizes, on abstract meshes (1, 1), (4, 2), (16, 16) and (2, 16, 16),
  with and without FSDP; the port's trees (``init_lm`` / ``init_cache``
  under a ``FakeTensorMode``) have the reference's paths and shapes.
* **The policy.**  ``select_spec`` / ``ranked_spec`` (what ``constrain``
  / ``constrain_ranked`` apply) pick the reference's spec for the
  models' own candidate lists.  The reference's ``constrain`` under jit
  is not the comparison: that test is one of its known failures.
* **The steps.**  Gloo ranks on the CPU (``tests/_torch_dist.run_ranks``,
  ``tests/_torch_mesh_ranks.py``) on a (1, 2) and a (2, 2) data x model
  mesh run the sharded prefill, 3 cached decode steps, the train step's
  gradient and one train step of the reduced qwen3-8b, deepseek-v2-lite
  (MLA + MoE), jamba (Mamba + MoE) and xlstm, from the reference's
  weights, with the parameters split over ``model`` and the batch over
  ``data`` (FSDP off here: its specs are held above, its steps against
  FSDP off in ``tests/test_torch_mesh_fsdp.py``, and it runs in the dry
  run, ``tests/test_torch_roofline.py``).  Their whole outputs are held against the reference's
  unsharded steps and the port's single-card ones at the bars of
  ``tests/test_torch_lm.py`` (logits) and ``tests/_lm_parity.py`` (loss,
  and each gradient leaf by ``train.grad.hold_leaf`` given the
  reference's own spread).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.dist.policy import select_spec as j_select_spec
from repro.dist.policy import spec_viable as j_spec_viable
from repro.dist.sharding import ShardingPlan as JPlan
from repro.dist.sharding import _path_name as j_path_name
from repro.dist.topology import abstract_mesh as j_abstract_mesh
from repro.launch.mesh import dp_axes as j_dp_axes
from repro.launch.steps import build_prefill_step as j_prefill
from repro.launch.steps import build_serve_step as j_serve
from repro.models import layers as j_layers
from repro.models import lm as jlm
from repro.plan.cost import rank_specs as j_rank_specs

from repro_torch.configs import get_config as t_get_config
from repro_torch.dist import policy as tpolicy
from repro_torch.dist.sharding import ShardingPlan, leaf_paths
from repro_torch.dist.topology import abstract_mesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import layers as t_layers
from repro_torch.models import lm as tlm
from repro_torch.train.grad import hold_leaf
from repro_torch.train.tree import flatten_with_paths

import _lm_parity as lp
from _torch_dist import run_ranks
from _torch_mesh_ranks import DECODE_STEPS
from test_torch_lm import LOGIT_BAR

ARCHS = j_list_archs()
MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHE_SHAPE = (128, 32768)        # decode_32k's batch and sequence
STEP_ARCHS = ["qwen3-8b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b",
              "xlstm-1.3b"]
STEP_MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


def _meshes(sizes, names):
    return abstract_mesh(sizes, names), j_abstract_mesh(sizes, names)


@functools.lru_cache(maxsize=None)
def _reference_trees(arch: str):
    """(params, decode cache) of the reference at full size, shapes only."""
    cfg = j_get_config(arch)
    params = jax.eval_shape(lambda: jlm.init_lm(cfg, jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: jlm.init_cache(cfg, *CACHE_SHAPE))
    return params, cache


@functools.lru_cache(maxsize=None)
def _port_trees(arch: str):
    """The port's (params, decode cache) at full size, as fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = t_get_config(arch)
    with FakeTensorMode():
        return (tlm.init_lm(cfg, torch.Generator(), device="cpu"),
                tlm.init_cache(cfg, *CACHE_SHAPE, device="cpu"))


def _j_leaves(tree):
    return [(j_path_name(path), tuple(leaf.shape), leaf.dtype)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _t_leaves(tree):
    return [(path, tuple(t.shape), t.dtype) for path, t in leaf_paths(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_port_trees_are_the_references(arch):
    """Every parameter and cache leaf: the reference's path, shape and
    dtype (what the plan's specs are keyed and sized by)."""
    jp, jc = _reference_trees(arch)
    tp, tc = _port_trees(arch)
    for j, t in ((jp, tp), (jc, tc)):
        want, got = _j_leaves(j), _t_leaves(t)
        assert [(p, s) for p, s, _ in got] == [(p, s) for p, s, _ in want]
        assert [str(d).removeprefix("torch.") for _, _, d in got] == [
            np.dtype(d).name for _, _, d in want]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=["1x1", "4x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_specs_match_reference(arch, sizes, names, fsdp):
    """``param_spec`` of every parameter leaf and ``cache_spec`` of every
    decode-cache leaf equal the reference's."""
    tmesh, jmesh = _meshes(sizes, names)
    tplan, jplan = ShardingPlan(tmesh, fsdp=fsdp), JPlan(jmesh, fsdp=fsdp)
    jp, jc = _reference_trees(arch)
    want = [tuple(jplan.param_spec(p, s, dtype=d)) for p, s, d in _j_leaves(jp)]
    got = [tplan.param_spec(p, s, d) for p, s, d in _t_leaves(_port_trees(arch)[0])]
    assert got == want
    jdp, tdp = j_dp_axes(jmesh), dp_axes(tmesh)
    assert tdp == jdp
    want = [tuple(jplan.cache_spec(p, s, jdp, dtype=d))
            for p, s, d in _j_leaves(jc)]
    got = [tplan.cache_spec(p, s, tdp, d)
           for p, s, d in _t_leaves(_port_trees(arch)[1])]
    assert got == want


def test_plan_shards_something_at_production_size():
    """A guard on the comparison above: at (16, 16) the plans are not
    trivially replicated."""
    tmesh, _ = _meshes((16, 16), ("data", "model"))
    specs = [ShardingPlan(tmesh, fsdp=True).param_spec(p, s, d)
             for p, s, d in _t_leaves(_port_trees("qwen3-8b")[0])]
    flat = [e for spec in specs for e in spec]
    assert "model" in flat and "data" in flat


# ---------------------------------------------------------------------------
# the policy's choices: the models' own candidate lists
# ---------------------------------------------------------------------------

_DP = ("pod", "data")
POLICY_CASES = [
    # attention scores (B, KV, G, S_q, S_k), both packages' lists
    ((16, 8, 4, 512, 4096), t_layers._SCORE_SPECS),
    ((16, 2, 16, 512, 512), t_layers._SCORE_SPECS),
    ((3, 5, 4, 7, 9), t_layers._SCORE_SPECS),
    # MLA decode scores (B, H, S, T)
    ((128, 16, 1, 32768), [(_DP, "model", None, None),
                           ("data", "model", None, None),
                           (_DP, None, None, "model"),
                           ("data", None, None, "model")]),
    # MoE tokens and the period boundary
    ((4096, 2048), t_layers._TOKEN_SPECS),
    ((6, 2048), t_layers._TOKEN_SPECS),
    ((256, 4096, 4096), [(_DP, "model", None), ("data", "model", None),
                         (None, "model", None)]),
    # SSM carries
    ((16, 8192, 16), [(None, "model", None)]),
    ((16, 4, 512, 512), [(None, None, "model", None)]),
]


@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=["1x1", "4x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("case", range(len(POLICY_CASES)))
def test_constrain_picks_the_references_spec(case, sizes, names):
    """``select_spec`` (``constrain``) picks the reference's first viable
    spec for each candidate list the models constrain with."""
    shape, specs = POLICY_CASES[case]
    tmesh, jmesh = _meshes(sizes, names)
    want = j_select_spec(jmesh, shape, specs)
    assert tpolicy.select_spec(tmesh, shape, specs) == (
        None if want is None else tuple(want))


@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=["1x1", "4x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("shape,nbytes", [((64, 1280, 2048), 2),
                                          ((4, 40, 64), 2),
                                          ((160, 131072, 6144), 4),
                                          ((8, 24, 16), 4)])
def test_constrain_ranked_picks_the_references_spec(shape, nbytes, sizes,
                                                    names):
    """``ranked_spec`` (``constrain_ranked``) picks what the reference's
    ``constrain_ranked`` applies to the MoE dispatch buffer: the viable
    candidate its ``rank_specs`` ranks first."""
    tmesh, jmesh = _meshes(sizes, names)
    specs = t_layers.EXPERT_BUF_SPECS
    assert tuple(specs) == tuple(j_layers.EXPERT_BUF_SPECS)
    viable = [s for s in specs if j_spec_viable(jmesh, shape, s)]
    want = (tuple(viable[j_rank_specs(jmesh, shape, viable, nbytes)])
            if viable else None)
    assert tpolicy.ranked_spec(tmesh, shape, specs, nbytes) == want


def test_constrain_under_an_abstract_mesh_raises():
    """Only a run has ranks: under an abstract mesh both raise."""
    mesh = abstract_mesh((4, 2), ("data", "model"))
    with tpolicy.sharding_policy(mesh):
        with pytest.raises(TypeError, match="abstract mesh"):
            tpolicy.constrain(torch.ones(8, 8), [("data", None)])
        with pytest.raises(TypeError, match="abstract mesh"):
            tpolicy.constrain_ranked(torch.ones(8, 8), [("data", None)])


# ---------------------------------------------------------------------------
# the sharded steps over gloo ranks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _step_case(arch: str):
    """The reference's and the single-card port's outputs for ``arch``:
    prefill and DECODE_STEPS decode logits at ``tests/test_torch_lm.py``'s
    weights and inputs (where its bars were measured), the loss and
    gradients at ``_lm_parity.grad_case``'s."""
    jcfg, tcfg = lp.cfgs(arch)
    params = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    tokens, memory = lp.inputs(jcfg)
    assert memory is None
    want = {"prefill": jax.jit(j_prefill(jcfg))(params, tokens), "decode": []}
    step = jax.jit(j_serve(jcfg))
    cache = jlm.init_cache(jcfg, tokens.shape[0], 8)
    for t in range(DECODE_STEPS):
        logits, cache = step(params, cache, tokens[:, t:t + 1], jnp.int32(t))
        want["decode"].append(logits)
    tparams = lp.port_tree(params)
    one = {"prefill": tsteps.build_prefill_step(tcfg, device="cpu")(
        tparams, tokens), "decode": []}
    serve = tsteps.build_serve_step(tcfg, device="cpu")
    tcache = tlm.init_cache(tcfg, tokens.shape[0], 8, device="cpu")
    for t in range(DECODE_STEPS):
        logits, tcache = serve(tparams, tcache, tokens[:, t:t + 1], t)
        one["decode"].append(logits)

    _, _, _, gparams, (gtokens, _) = lp.grad_case(arch)
    one_loss, one_grads = tsteps.build_grad_step(tcfg, device="cpu")(
        lp.port_tree(gparams), gtokens)
    one["loss"] = float(one_loss)
    one["grads"] = dict(flatten_with_paths(one_grads))
    return want, one, (lp.to_numpy(params), tokens,
                       lp.to_numpy(gparams), gtokens)


@pytest.fixture(scope="module", params=list(STEP_MESHES))
def mesh_run(request):
    """Every STEP_ARCHS case through the ranks of one mesh."""
    shape = STEP_MESHES[request.param]
    cases = {arch: _step_case(arch)[2] + (False,) for arch in STEP_ARCHS}
    ranks = run_ranks("_torch_mesh_ranks", "lm_mesh_rank",
                      shape[0] * shape[1], args=(shape, cases))
    return request.param, ranks


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_prefill_and_decode_match(mesh_run, arch):
    """Every rank's whole prefill and decode logits: within the arch's
    bar of the reference's unsharded steps and of the port's single-card
    ones; the decode cache keeps its layout step to step."""
    _, ranks = mesh_run
    want, one, _ = _step_case(arch)
    bar = LOGIT_BAR[arch]
    for res in (r[arch] for r in ranks):
        assert res["cache_layouts_kept"]
        for got, w, o in zip([res["prefill"]] + res["decode"],
                             [want["prefill"]] + want["decode"],
                             [one["prefill"]] + one["decode"]):
            assert np.isfinite(got).all()
            assert lp.rel(got, w) <= bar
            assert lp.rel(got, o) <= bar


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_gradients_match(mesh_run, arch):
    """The train step's loss and gradients under the mesh: the loss within
    ``_lm_parity.LOSS_REL`` of the reference's, every leaf within its bar
    of the reference's gradient and of the single-card port's, each laid
    out as its parameter."""
    _, ranks = mesh_run
    loss, _, spread, _, _ = lp.grad_case(arch)
    _, one, _ = _step_case(arch)
    for res in (r[arch] for r in ranks):
        assert abs(res["loss"] - loss) <= lp.LOSS_REL * abs(loss)
        got = [(k, torch.as_tensor(g)) for k, g in res["grads"]]
        assert not lp.gradient_failures(arch, got)
        held = {k: hold_leaf(g, one["grads"][k].float(), spread[k])
                for k, g in got}
        assert all(v["ok"] for v in held.values()), {
            k: v for k, v in held.items() if not v["ok"]}
        assert res["grad_layouts_kept"]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_train_step(mesh_run, arch):
    """One train step under the mesh: its loss is the gradient's, its
    global norm (reduced across the shards by AdamW's clip) the norm of
    the whole gradient, and the update is in place, moves the weights and
    keeps every parameter's and moment's layout."""
    _, ranks = mesh_run
    for res in (r[arch] for r in ranks):
        norm = float(np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                                 for _, g in res["grads"])))
        assert res["train_loss"] == res["loss"]
        assert abs(res["grad_norm"] - norm) <= 1e-4 * norm
        assert res["in_place"] and res["moved"] and res["layouts_kept"]
