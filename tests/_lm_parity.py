"""Shared helpers of the LM parity tests (``tests/test_torch_lm*.py``).

Weights come from the reference's ``init_lm`` / ``init_*`` (``jax.random``)
and cross to the port as numpy through ``lm_params_from_numpy``; inputs
are made from numpy seeds and given to both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import lm as jlm

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import lm as tlm
from repro_torch.models.convert import lm_cache_from_numpy, lm_params_from_numpy

# The bar on logits and block outputs, as a share of max|reference|.
LOGIT_REL = 2e-2


def cfgs(arch: str):
    """(reference cfg, port cfg) of the reduced ``arch``."""
    return j_reduced(j_get_config(arch)), t_reduced(t_get_config(arch))


def to_numpy(tree):
    """A JAX pytree as numpy arrays (bf16 stays bf16)."""
    return jax.tree.map(np.asarray, tree)


def port_tree(tree):
    """A JAX pytree as the port's tensors on the CPU."""
    return lm_params_from_numpy(to_numpy(tree), device="cpu")


def port_cache(tree):
    return lm_cache_from_numpy(to_numpy(tree), device="cpu")


def f32(x) -> np.ndarray:
    """A JAX array or a torch tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel(got, want) -> float:
    """max|got - want| / max|want|."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def bf16_pair(rng, shape, scale: float = 1.0):
    """One standard-normal array as a JAX bf16 array and a torch bf16
    tensor holding the same bits."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).to(torch.bfloat16)


def inputs(cfg, batch=2, seq=16, seed=0):
    """tests/test_models_smoke.py's inputs: token ids and (for frontend
    archs) memory embeddings, as numpy f32."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    memory = None
    if cfg.frontend_tokens:
        memory = rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return tokens, memory


def j_memory(memory):
    return None if memory is None else jnp.asarray(memory).astype(jnp.bfloat16)


def t_memory(memory):
    return None if memory is None else torch.as_tensor(memory).to(torch.bfloat16)


def t_tokens(tokens) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens)).long()


def prefill_cross(params, cfg, cache, memory):
    """The reference test's ``_prefill_cross``
    (``tests/test_models_smoke.py:85``): every cross-attention cache slot
    holds the projected (encoded, for enc-dec) frontend memory."""
    from repro.models import layers as L

    if cfg.encoder_layers:
        memory = jlm.encode(params, cfg, memory)

    def fill(period_params, period_cache):
        for i, kind in enumerate(cfg.pattern):
            mixer = kind.split("+")[0]
            if mixer in ("xattn", "attnx"):
                p = (period_params[f"b{i}"]["cross"] if mixer == "attnx"
                     else period_params[f"b{i}"]["mix"])
                k = L._split_heads(memory @ p["wk"], cfg.n_kv_heads)
                v = L._split_heads(memory @ p["wv"], cfg.n_kv_heads)
                period_cache[f"b{i}"]["cross"] = {
                    "k": k.astype(jnp.bfloat16), "v": v.astype(jnp.bfloat16)}
        return period_cache

    blocks = jax.tree.map(lambda x: x, cache["blocks"])
    for pi in range(jlm.n_body_periods(cfg)):
        period_params = jax.tree.map(lambda x: x[pi], params["blocks"])
        period_cache = jax.tree.map(lambda x: x[pi], blocks)
        filled = fill(period_params, period_cache)
        blocks = jax.tree.map(
            lambda full, one: full.at[pi].set(one), blocks, filled)
    return dict(cache, blocks=blocks)


def leaves(tree) -> list:
    """(path, leaf) pairs of a nested dict/list tree, in key order."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out.append((path, t))

    walk(tree, ())
    return out


def signature(tree) -> list:
    """(path, shape, dtype name) of every leaf, either package's tree."""
    sig = []
    for path, leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            dtype = str(leaf.dtype).replace("torch.", "")
        else:
            dtype = np.asarray(leaf).dtype.name
        sig.append((path, tuple(leaf.shape), dtype))
    return sig


# The gradient bar (``repro_torch.train.grad.hold_leaf``): each leaf within
# 2e-2 of max|reference grad|, or twice the reference's own move where that
# is larger, up to 0.25; a leaf the reference moves more than that is held
# by its cosine distance and norm ratio instead.  The reference's own move
# is the largest over SPREAD_SEEDS draws of 1% of its embedding entries one
# bf16 ulp up.
SPREAD_SEEDS = 4


def moved_embed(params, seed: int):
    """The reference's params with 1% of the embedding entries one bf16
    ulp up (``tests/test_torch_lm.py::test_reference_spread_bounds_the_bar``'s
    perturbation)."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    bits = np.asarray(params["embed"]).view(np.uint16).copy()
    bits[rng.random(bits.shape) < 0.01] += 1
    return dict(params, embed=jnp.asarray(bits.view(ml_dtypes.bfloat16)))


@functools.lru_cache(maxsize=None)
def grad_case(arch: str, seed: int = 1):
    """The reference's loss and gradients of ``lm_loss(remat=True)`` for
    the reduced ``arch`` at ``tests/test_models_smoke.py``'s inputs, and
    each leaf's own move: (loss, {path: f32 grad}, {path: (rel, cos)
    spread}, params, inputs).  Cached: callers must not change them."""
    from repro_torch.train.grad import leaf_spread
    from repro_torch.train.tree import flatten_with_paths

    jcfg, _ = cfgs(arch)
    params = jlm.init_lm(jcfg, jax.random.PRNGKey(seed))
    tokens, memory = inputs(jcfg, seed=seed)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, tokens, j_memory(memory), remat=True)))

    def flat(grads):
        return {k: torch.tensor(f32(v))
                for k, v in flatten_with_paths(to_numpy(grads))}

    loss, grads = fn(params)
    want = flat(grads)
    draws = [flat(fn(moved_embed(params, s))[1]) for s in range(SPREAD_SEEDS)]
    spread = {k: leaf_spread(want[k], [d[k] for d in draws]) for k in want}
    return float(loss), want, spread, params, (tokens, memory)


# The loss is an f32 mean of bf16-derived logits' NLL: the two packages'
# roundings move it by up to ~2e-4 of itself at these sizes.
LOSS_REL = 1e-3


@functools.lru_cache(maxsize=None)
def port_gradients(arch: str, remat: bool = True):
    """The port's ``(loss, [(path, grad)])`` of ``lm_loss`` at
    :func:`grad_case`'s weights and inputs.  Cached (``__wrapped__`` is the
    uncached call)."""
    from repro_torch.train import value_and_grad
    from repro_torch.train.tree import flatten_with_paths

    _, _, _, params, (tokens, memory) = grad_case(arch)
    _, tcfg = cfgs(arch)
    loss, grads = value_and_grad(
        lambda p: tlm.lm_loss(p, tcfg, t_tokens(tokens), t_memory(memory),
                              remat=remat))(port_tree(params))
    return loss, flatten_with_paths(grads)


def gradient_failures(arch: str, got) -> dict:
    """{path: hold_leaf verdict} of every leaf of ``got`` (the port's
    ``[(path, grad)]``) that misses its bar against :func:`grad_case`."""
    from repro_torch.train.grad import hold_leaf

    _, want, spread, _, _ = grad_case(arch)
    assert [k for k, _ in got] == list(want)
    held = {k: hold_leaf(g, want[k], spread[k]) for k, g in got}
    return {k: v for k, v in held.items() if not v["ok"]}


def check_arch_gradients(arch: str) -> None:
    """The port's ``lm_loss`` gradient at ``remat=False`` and ``True``
    (bit-equal) against :func:`grad_case`'s: the loss within LOSS_REL,
    every leaf within its bar."""
    loss = grad_case(arch)[0]
    got = {remat: port_gradients(arch, remat) for remat in (False, True)}
    assert torch.equal(got[False][0], got[True][0])
    for (k, a), (_, b) in zip(got[False][1], got[True][1]):
        assert torch.equal(a, b), (arch, k)
    assert abs(float(got[True][0]) - loss) <= LOSS_REL * abs(loss)
    over = gradient_failures(arch, got[True][1])
    assert not over, (arch, over)
