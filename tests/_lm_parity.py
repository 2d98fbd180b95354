"""Shared helpers of the LM parity tests (``tests/test_torch_lm*.py``).

Weights come from the reference's ``init_lm`` / ``init_*`` (``jax.random``)
and cross to the port as numpy through ``lm_params_from_numpy``; inputs
are made from numpy seeds and given to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import lm as jlm

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
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
