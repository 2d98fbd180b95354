"""Shared transformer primitives (plain functions over tensor dicts).

The port of ``repro.models.layers``: GQA, MLA (DeepSeek latent attention,
absorbed decode path), sliding-window, qk-norm, QKV bias,
cross-attention, SwiGLU FFNs and scatter-based top-k MoE with shared
experts.

Conventions, as in the reference: params are nested dicts of tensors;
activations are bf16 with f32 softmax and normalization; every ``init_*``
returns the params of ONE layer, drawn from an explicit
``torch.Generator``.  ``torch.Generator`` does not reproduce
``jax.random``: tests that compare against the reference carry its
parameters across with :func:`repro_torch.models.convert.lm_params_from_numpy`.

Rounding follows the reference op for op.  Matrix products of two bf16
operands give bf16 (JAX's default result type); where the reference
multiplies bf16 by f32 (the MoE router, the xLSTM gates) JAX promotes to
f32, so the bf16 operand is widened here first.  Scores are rounded to
bf16 by their einsum before the f32 scale, probabilities are cast to the
query dtype before the PV product.  Every matrix product is a plain
``torch`` op: the reference computes them outside any Pallas kernel.

Rematerialization follows the reference's ``jax.checkpoint`` sites: under
autograd, :func:`remat` runs a piece of the forward through
``torch.utils.checkpoint`` (each query block of the blocked attention
here; the SSM time chunks, the loss chunks and, under ``remat=True``, the
body periods in ``ssm`` and ``lm``), so its activations are recomputed in
the backward pass instead of kept.  It changes memory, not values.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.dist.policy import (active_mesh, constrain, constrain_to,
                                     ranked_spec, sharding_policy)

Params = Dict[str, torch.Tensor]
Device = Union[None, str, torch.device]

NEG_INF = -1e30      # the reference's mask fill


@contextlib.contextmanager
def bf16_full_reduction():
    """bf16 matrix products reduce in f32 inside, as the reference's do
    (cuBLAS may otherwise reduce split-K partials in bf16); the caller's
    setting after.  The LM's entry points run under it."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = prev


def remat(fn, *args):
    """``fn(*args)``, recomputed in the backward pass when autograd records
    it (``torch.utils.checkpoint``, non-reentrant); a plain call when it
    does not.  The forward draws no random numbers, so no RNG state is
    kept."""
    if not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    mesh = active_mesh()

    def run(*a):
        # the recomputation may run on autograd's device thread: give it
        # the caller's (thread-local) sharding policy
        with sharding_policy(mesh):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


# ---------------------------------------------------------------------------
# norms + rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device: Device = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, head_dim); positions: (seq,) or (batch, seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., seq, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    while cos.ndim < x1.ndim:                                # broadcast over heads
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, device: Device = None) -> torch.Tensor:
    """Standard-normal f32 draws from ``gen`` (on its device), on ``device``."""
    out = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                      device=gen.device)
    return out.to(device) if device is not None else out


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Device = None) -> torch.Tensor:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return (normal(gen, (d_in, d_out), device) * scale).to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, ``x * logistic(x)``, with the logistic as XLA
    lowers it, ``1 / (1 + exp(-x))``, each op rounded to the input dtype
    (bf16 equals the reference bit for bit; ``F.silu`` rounds once and
    differs in ~40% of bf16 elements)."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as XLA lowers it:
    ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _ones(n: int, device: Device) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.bfloat16, device=device)


# ---------------------------------------------------------------------------
# GQA attention (full / sliding-window / cross / cached decode)
# ---------------------------------------------------------------------------


def init_attention(cfg: ArchConfig, gen: torch.Generator, device: Device = None,
                   cross: bool = False) -> Params:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    p: Params = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, device=device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, device=device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, device=device),
        "wo": dense_init(gen, cfg.n_heads * hd, d, device=device),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((width * hd,), dtype=torch.bfloat16,
                                  device=device)
    if cfg.qk_norm:
        p["q_norm"] = _ones(hd, device)
        p["k_norm"] = _ones(hd, device)
    return p


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    if _is_dtensor(x):
        x = _whole_heads(x, n_heads)
    return x.reshape(b, s, n_heads, -1)


def _whole_heads(x, n_heads: int):
    """``x`` (a DTensor) with its last dim sharded only where each rank
    gets whole heads: DTensor cannot split a shard that cuts a head, so
    a last dim sharded finer than the heads is replicated first."""
    from torch.distributed.tensor import Replicate

    last = x.ndim - 1
    shards = math.prod(x.device_mesh.size(i)
                       for i, pl in enumerate(x.placements)
                       if pl.is_shard(last))
    if n_heads % shards == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if pl.is_shard(last) else pl for pl in x.placements])


ATTN_Q_BLOCK = 512   # query-block size of the memory-bounded full-sequence path

_SCORE_SPECS = [
    (("pod", "data"), "model", None, None, None), ("data", "model", None, None, None),
    (("pod", "data"), None, "model", None, None), ("data", None, "model", None, None),
    (("pod", "data"), None, None, "model", None), ("data", None, None, "model", None),
    (("pod", "data"), None, None, None, "model"), ("data", None, None, None, "model"),
]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def along_whole_dim(fn, x, dim: int):
    """``fn(x)`` for an op along ``dim`` that maps each slice of ``dim``
    on its own (a roll, a shift): on a DTensor whose ``dim`` is whole on
    every rank, each rank applies it to its own shard (DTensor has no
    rule for such ops on the card's torch)."""
    if not _is_dtensor(x):
        return fn(x)
    if any(p.is_shard(dim) for p in x.placements):
        raise ValueError(f"dim {dim} is sharded")
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _grad_placements(place, out_place) -> list:
    """The placements of the gradient of a local input laid out by
    ``place`` whose result is laid out by ``out_place``: where the input is
    whole on every rank of a mesh dim the result splits, each rank's
    gradient is a partial sum over that dim."""
    from torch.distributed.tensor import Partial

    return [Partial() if p.is_replicate() and o.is_shard() else p
            for p, o in zip(place, out_place)]


class _SumOverGroup(torch.autograd.Function):
    """The sum of every rank's ``x`` over ``group``; the gradient of each
    rank's ``x`` is the (replicated) gradient of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def vocab_parallel_embedding(embed, tokens):
    """``embed[tokens]`` for an embedding table (a DTensor) whose rows are
    sharded over the mesh (Megatron's vocab-parallel embedding): each rank
    looks up the tokens whose rows it holds, zeros the rest, and the sum
    over the ranks holding the vocab is every token's row.  No rank reads
    another's rows.  (DTensor's own rule keeps a masked partial that
    cannot be read twice, nor take a gradient back.)"""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = embed.device_mesh
    vocab = [i for i, p in enumerate(embed.placements) if p.is_shard(0)]
    place = [p if i in vocab else Replicate()
             for i, p in enumerate(embed.placements)]
    if list(embed.placements) != place:
        embed = embed.redistribute(mesh, place)
    if not _is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tplace = [Replicate() if i in vocab else p
              for i, p in enumerate(tokens.placements)]
    if list(tokens.placements) != tplace:
        tokens = tokens.redistribute(mesh, tplace)
    # each rank's rows take the gradient of its own tokens: a partial sum
    # over the axes that split the batch
    rows = embed.to_local(grad_placements=_grad_placements(place, tplace))
    n, coord, lo = rows.shape[0], mesh.get_coordinate(), 0
    for i in vocab:
        lo = lo * mesh.size(i) + coord[i]
    lo *= n
    tok = tokens.to_local()
    mine = (tok >= lo) & (tok < lo + n)
    out = torch.where(mine[..., None], rows[(tok - lo).clamp(0, n - 1)], 0)
    for i in vocab:
        out = _SumOverGroup.apply(out, mesh.get_group(i))
    shape = tuple(tokens.shape) + (embed.shape[1],)
    return DTensor.from_local(out, mesh, tplace, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def row_product(a: torch.Tensor, w: torch.Tensor,
                equation: Optional[str] = None) -> torch.Tensor:
    """``a @ w`` (or ``torch.einsum(equation, a, w)`` when an equation
    contracting ``a``'s last dim is given: the MoE's expert ``down``)
    where ``a``'s last dim may be sharded: a row-parallel weight (``wo``,
    ``down``) or a product after a sharded carry (the SSM readouts and
    recurrences).

    Under a mesh where the contraction is sharded over ranks, each rank's
    partial product is kept in f32 and the partials are summed across the
    ranks in f32 before the one rounding to ``a``'s dtype, as the single
    card's product accumulates in f32 and rounds once.  (Partials rounded
    to bf16 on each rank and rounded again after their sum drift by ~2% of
    max|logits| over qwen3-8b's 36 layers.)  Elsewhere it is the plain
    product."""
    def product(x, y):
        return x @ y if equation is None else torch.einsum(equation, x, y)

    if not _is_dtensor(a) or not any(p.is_shard(a.ndim - 1)
                                     for p in a.placements):
        return product(a, w)
    from torch.distributed.tensor import Replicate

    y = product(a.float(), w.float())
    return y.redistribute(y.device_mesh, [
        Replicate() if p.is_partial() else p
        for p in y.placements]).to(a.dtype)


def whole_sequence(x):
    """``x`` (B, S, ...) with its sequence dim whole on every rank.

    Under a mesh the residual stream between periods is sharded over its
    sequence (the reference's sequence-parallel constraint); a block's
    products need every position, so the normed input is all-gathered
    over the sequence first, as Megatron's sequence parallelism does
    (DTensor would flatten a sharded sequence into a matmul's rows, which
    the card's torch refuses).  A plain tensor is returned as it is."""
    if not _is_dtensor(x) or not any(p.is_shard(1) for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(1) else p for p in x.placements])


def _head_local(fn, tensors, specs, out_spec, out_shape):
    """``fn`` over the local shards of ``tensors`` under the active mesh,
    each laid out by its spec first; its result is this rank's shard of a
    DTensor of ``out_shape`` laid out by ``out_spec``.

    Attention is head-local (Megatron's head parallelism): with the batch
    over the data axes and the heads over ``model`` no rank needs another
    rank's heads.  DTensor's einsum would flatten a sharded head dim into
    a batched matmul's batch, which it cannot do without a strided shard
    (the card's torch refuses it), so the heads' products run on the
    local shards here instead.  The policy is off inside: the local
    tensors are shards, not full copies."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import placements

    mesh = active_mesh()
    out_place = placements(mesh, out_spec)
    local = []
    for t, spec in zip(tensors, specs):
        if t is None or spec is None:
            local.append(t.full_tensor() if _is_dtensor(t) else t)
        else:
            t = constrain_to(t, spec)
            local.append(t.to_local(grad_placements=_grad_placements(
                t.placements, out_place)))
    with sharding_policy(None):
        out = fn(*local)
    stride = torch.empty(out_shape, device="meta").stride()
    return DTensor.from_local(out, mesh, out_place, run_check=False,
                              shape=torch.Size(out_shape), stride=stride)


def _batch_heads(batch: int, heads: int):
    """(batch entry, head entry) of the active mesh: the batch over the
    data axes as ``batch_spec`` shards a batch, the heads over ``model``
    when they divide (else every model rank holds them all)."""
    from repro_torch.dist.sharding import batch_spec
    from repro_torch.dist.topology import axis_sizes

    mesh = active_mesh()
    bspec = batch_spec(mesh, batch)
    msize = axis_sizes(mesh).get("model", 1)
    return (bspec[0] if bspec else None,
            "model" if msize > 1 and heads % msize == 0 else None)


def _sdpa(
    q: torch.Tensor,            # (B, S_q, H, hd)
    k: torch.Tensor,            # (B, S_k, KV, hd)
    v: torch.Tensor,            # (B, S_k, KV, hd_v)
    mask: Optional[torch.Tensor],  # broadcastable to (B, 1, S_q, S_k), bool
) -> torch.Tensor:
    if not (_is_dtensor(q) or _is_dtensor(k)):
        return _sdpa_local(q, k, v, mask)
    # under a mesh: the kv heads (and their query groups) over ``model``,
    # else the query positions (each attends on its own), else neither
    b, sq, h, _ = q.shape
    dp, heads = _batch_heads(b, k.shape[2])
    if mask is not None and mask.shape[0] != 1:
        raise ValueError("a per-sequence mask under a mesh")
    if heads is not None or _batch_heads(b, sq)[1] is None:
        spec = (dp, None, heads, None)
        return _head_local(_sdpa_local, (q, k, v, mask),
                           (spec, spec, spec, None), (dp, None, heads),
                           (b, sq, h * v.shape[3]))
    rows = (dp, "model", None, None)
    kv = (dp, None, None, None)
    mspec = ((None, None, "model", None)
             if mask is not None and mask.shape[2] == sq else None)
    return _head_local(_sdpa_local, (q, k, v, mask), (rows, kv, kv, mspec),
                       (dp, "model", None), (b, sq, h * v.shape[3]))


def _sdpa_local(
    q: torch.Tensor,            # (B, S_q, H, hd)
    k: torch.Tensor,            # (B, S_k, KV, hd)
    v: torch.Tensor,            # (B, S_k, KV, hd_v)
    mask: Optional[torch.Tensor],  # broadcastable to (B, 1, S_q, S_k), bool
) -> torch.Tensor:
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = constrain(scores / math.sqrt(hd), _SCORE_SPECS)
    if mask is not None:
        # mask is (B|1, 1, S_q|1, S_k); insert the head-group axis
        scores = torch.where(mask[:, :, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, -1)  # v head dim may differ from q (MLA)


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                 window: int) -> torch.Tensor:
    mask = k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask[None, None]


def _sdpa_blocked(
    q: torch.Tensor,            # (B, S_q, H, hd)
    k: torch.Tensor,            # (B, S_k, KV, hd)
    v: torch.Tensor,            # (B, S_k, KV, hd)
    q_pos: torch.Tensor,        # (S_q,)
    k_pos: torch.Tensor,        # (S_k,)
    causal: bool,
    window: int,
) -> torch.Tensor:
    """Query-blocked attention: the (S_q, S_k) scores exist one q-block
    at a time, bounding attention memory by B x H x q_block x S_k."""
    blk = ATTN_Q_BLOCK

    def one_block(q_b, qp_b):
        mask = _causal_mask(qp_b, k_pos, window) if causal else None
        return _sdpa(q_b, k, v, mask)

    outs = [remat(one_block, q[:, i:i + blk], q_pos[i:i + blk])
            for i in range(0, q.shape[1], blk)]
    return torch.cat(outs, dim=1)


def _write_slot(cache: torch.Tensor, new: torch.Tensor,
                start: torch.Tensor) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice(cache, new, (0, start, ...))``: a
    copy of ``cache`` with ``new`` written along dim 1 from ``start``
    (clamped so the update fits, as JAX clamps)."""
    s = new.shape[1]
    start = start.clamp(0, cache.shape[1] - s)
    idx = start + torch.arange(s, device=cache.device)
    if not _is_dtensor(cache):
        return cache.index_copy(1, idx, new.to(cache.dtype))
    # under a mesh: DTensor has no rule for index_copy, and the written dim
    # (the sequence) is never sharded, so each rank writes its own shard
    from torch.distributed.tensor import DTensor, Replicate

    mesh, place = cache.device_mesh, tuple(cache.placements)
    if any(p.is_shard(1) for p in place):
        raise ValueError("a decode cache sharded over its sequence")
    if not _is_dtensor(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    local = cache.to_local().index_copy(
        1, idx, new.redistribute(mesh, place).to_local().to(cache.dtype))
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=cache.shape, stride=cache.stride())


def _position(pos, device) -> torch.Tensor:
    """A decode position as a 0-d int64 tensor on ``device``: a Python int
    is filled there (no host-to-device copy, which would wait for the
    stream), a tensor is used as it is."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(pos), dtype=torch.int64, device=device)


def attention(
    p: Params,
    x: torch.Tensor,                            # (B, S, D)
    cfg: ArchConfig,
    positions: torch.Tensor,                    # (S,)
    kv_source: Optional[torch.Tensor] = None,   # cross-attn memory (B, S_kv, D)
    cache: Optional[Params] = None,             # decode cache
    cache_pos=None,                             # scalar write position
    causal: bool = True,
    cross: bool = False,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Unified attention: self/cross, full-sequence/decode, full/SWA.

    Returns (output BEFORE the wo projection, updated cache).  For
    cross-attention the cache holds the projected memory (filled once by
    the caller; during decode ``kv_source`` may be None).  The decode path
    returns a new cache and leaves the given one as it was.
    """
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = split_heads(q, cfg.n_heads)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)

    src = kv_source if kv_source is not None else x
    k = src @ p["wk"]
    v = src @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = split_heads(k, cfg.n_kv_heads)
    v = split_heads(v, cfg.n_kv_heads)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    if not cross:
        q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)

    if cache is None:
        # full-sequence path (training / encoder / prefill)
        s = x.shape[1]
        if not cross and s > ATTN_Q_BLOCK and s % ATTN_Q_BLOCK == 0:
            return _sdpa_blocked(q, k, v, positions, positions,
                                 causal=causal, window=cfg.swa_window), None
        mask = (_causal_mask(positions, positions, cfg.swa_window)
                if not cross and causal else None)
        return _sdpa(q, k, v, mask), None

    # --- cached decode -----------------------------------------------------
    if cross:
        # memory projected once by the caller; the cache carries (k, v)
        if kv_source is None:
            k, v = cache["k"], cache["v"]
        return _sdpa(q, k, v, None), {"k": k, "v": v}
    pos = _position(cache_pos, x.device)
    s_cache = cache["k"].shape[1]
    write = pos % s_cache if cfg.swa_window else pos
    new_k = _write_slot(cache["k"], k, write)
    new_v = _write_slot(cache["v"], v, write)
    idx = torch.arange(s_cache, device=x.device)
    valid = idx <= pos
    if cfg.swa_window:
        # rolling buffer: everything written so far is in-window
        valid = valid | (pos >= s_cache)
    out = _sdpa(q, new_k, new_v, valid[None, None, None, :])
    return out, {"k": new_k, "v": new_v}


def init_self_cache(cfg: ArchConfig, batch: int, max_seq: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Device = None) -> Params:
    s = min(max_seq, cfg.swa_window) if cfg.swa_window else max_seq
    shape = (batch, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2), absorbed decode path
# ---------------------------------------------------------------------------


def init_mla(cfg: ArchConfig, gen: torch.Generator, device: Device = None) -> Params:
    m = cfg.mla
    d = cfg.d_model
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    p: Params = {
        "wkv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            device=device),
        "kv_norm": _ones(m.kv_lora_rank, device),
        "wk_b": dense_init(gen, m.kv_lora_rank, cfg.n_heads * m.qk_nope_head_dim,
                           device=device),
        "wv_b": dense_init(gen, m.kv_lora_rank, cfg.n_heads * m.v_head_dim,
                           device=device),
        "wo": dense_init(gen, cfg.n_heads * m.v_head_dim, d, device=device),
    }
    if m.q_lora_rank:
        p["wq_a"] = dense_init(gen, d, m.q_lora_rank, device=device)
        p["q_norm"] = _ones(m.q_lora_rank, device)
        p["wq_b"] = dense_init(gen, m.q_lora_rank, cfg.n_heads * qd, device=device)
    else:
        p["wq"] = dense_init(gen, d, cfg.n_heads * qd, device=device)
    return p


def mla_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    cache: Optional[Params] = None,
    cache_pos=None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """MLA: KV compressed into a shared latent + a shared rope key.

    The full-sequence path expands k/v from the latent; the decode path
    absorbs wk_b/wv_b into the query/output so the cache stays
    (B, S, r + rope_dim).  Returns the output AFTER ``wo``.
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                     m.v_head_dim, m.kv_lora_rank)

    if m.q_lora_rank:
        q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope.transpose(1, 2), positions,
                        cfg.rope_theta).transpose(1, 2)

    kv_a = x @ p["wkv_a"]                                    # (B,S,r+dr)
    c_kv = rms_norm(kv_a[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., r:][:, :, None, :]                    # (B,S,1,dr)
    k_rope = apply_rope(k_rope.transpose(1, 2), positions,
                        cfg.rope_theta).transpose(1, 2)

    if cache is None:
        # full sequence: expand the latent into per-head k/v
        k_nope = (c_kv @ p["wk_b"]).reshape(b, s, h, dn)
        v = (c_kv @ p["wv_b"]).reshape(b, s, h, dv)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        out = _sdpa(qfull, k, v, _causal_mask(positions, positions, 0))
        return row_product(out, p["wo"]), None

    # --- absorbed decode: scores live in latent space ----------------------
    pos = _position(cache_pos, x.device)
    new_c = _write_slot(cache["c"], c_kv, pos)
    new_kr = _write_slot(cache["kr"], k_rope[:, :, 0, :], pos)
    wk_b = p["wk_b"].reshape(r, h, dn)
    wv_b = p["wv_b"].reshape(r, h, dv)

    def absorbed(q_nope, q_rope, new_c, new_kr, wk_b, wv_b):
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wk_b)  # absorb wk_b
        scores = (
            torch.einsum("bshr,btr->bhst", q_lat, new_c)
            + torch.einsum("bshd,btd->bhst", q_rope, new_kr)
        ).float() / math.sqrt(dn + dr)
        scores = constrain(scores, [
            (("pod", "data"), "model", None, None),
            ("data", "model", None, None),
            (("pod", "data"), None, None, "model"),
            ("data", None, None, "model"),
        ])
        valid = torch.arange(new_c.shape[1], device=new_c.device) <= pos
        scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q_nope.dtype)
        o_lat = torch.einsum("bhst,btr->bshr", probs, new_c)  # (B,S,H,r)
        out = torch.einsum("bshr,rhv->bshv", o_lat, wv_b)     # absorb wv_b
        return out.reshape(o_lat.shape[0], s, -1)

    args = (q_nope, q_rope, new_c, new_kr, wk_b, wv_b)
    if any(_is_dtensor(t) for t in args):
        dp, heads = _batch_heads(b, h)
        qs, cs, ws = (dp, None, heads, None), (dp, None, None), \
            (None, heads, None)
        out = _head_local(absorbed, args, (qs, qs, cs, cs, ws, ws),
                          (dp, None, heads), (b, s, h * dv))
    else:
        out = absorbed(*args)
    return row_product(out, p["wo"]), {"c": new_c, "kr": new_kr}


def init_mla_cache(cfg: ArchConfig, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Device = None) -> Params:
    m = cfg.mla
    return {
        "c": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype,
                         device=device),
        "kr": torch.zeros((batch, max_seq, m.qk_rope_head_dim), dtype=dtype,
                          device=device),
    }


# ---------------------------------------------------------------------------
# FFN: SwiGLU + scatter-based top-k MoE
# ---------------------------------------------------------------------------


def init_mlp(cfg: ArchConfig, gen: torch.Generator, device: Device = None,
             width: int = 0) -> Params:
    d = cfg.d_model
    w = width or cfg.d_ff
    return {
        "gate": dense_init(gen, d, w, device=device),
        "up": dense_init(gen, d, w, device=device),
        "down": dense_init(gen, w, d, device=device),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return row_product(silu(x @ p["gate"]) * (x @ p["up"]), p["down"])


def init_moe(cfg: ArchConfig, gen: torch.Generator, device: Device = None) -> Params:
    moe = cfg.moe
    d = cfg.d_model
    w = moe.d_ff_expert or cfg.d_ff
    e = moe.n_experts

    def stack(d_in, d_out):              # (E, d_in, d_out), as the reference
        return dense_init(gen, d_in, d_out * e, device=device).reshape(
            d_in, e, d_out).transpose(0, 1).contiguous()

    p: Params = {
        "router": dense_init(gen, d, e, dtype=torch.float32, device=device),
        "gate": stack(d, w),
        "up": stack(d, w),
        "down": stack(w, d),
    }
    if moe.n_shared:
        p["shared"] = init_mlp(cfg, gen, device, width=w * moe.n_shared)
    return p


# tokens (and routed copies) sharded over the batch axes
_TOKEN_SPECS = [(("pod", "data"), None), ("data", None)]

EXPERT_BUF_SPECS = (
    ("model", "data", None), ("model", None, None),
    (None, ("pod", "data"), None), (None, "data", None),
)


def moe_capacity(n_tokens: int, moe: MoEConfig) -> int:
    """Slots per expert, from shapes on the host (never from the data)."""
    cap = int(-(-n_tokens * moe.top_k // moe.n_experts) * moe.capacity_factor)
    return max(-(-cap // 8) * 8, 8)


def moe_layer(p: Params, x: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    """Token-dispatch MoE, as the reference's ``moe_layer``.

    Tokens go to their top-k experts' slots in a (E, capacity, D) buffer:
    a token's slot is its rank among the tokens routed to that expert (a
    cumulative sum of one-hots); tokens past the capacity are dropped
    (their values zeroed, added to the last slot).  Grouped expert GEMMs
    run over the buffer, and a gate-weighted ``index_add_`` combines each
    token's k outputs.  No value is read back to the host, so the layer
    can be captured in a CUDA graph.  On the card ``index_put_`` and
    ``index_add_`` use atomics, so bits may differ from run to run.

    Under a mesh the tokens stay on their shards and the buffer is never
    whole on a rank (:func:`_moe_on_token_shards`).
    """
    b, s, d = x.shape
    xt = constrain(x.reshape(b * s, d), _TOKEN_SPECS)
    out = (_moe_on_token_shards(p, xt, moe) if _is_dtensor(xt)
           else _moe_local(p, xt, moe))
    if "shared" in p:
        out = out + mlp(p["shared"], xt)
    return out.reshape(b, s, d)


def _route(x: torch.Tensor, router: torch.Tensor, k: int):
    """(gates (N, k), expert ids (N, k)) of tokens ``x``: the top k of the
    router's f32 logits, softmaxed."""
    logits = x.float() @ router.float()
    gates, eids = torch.topk(logits, k, dim=-1)
    return torch.softmax(gates, dim=-1), eids


def _slots(flat_e: torch.Tensor, e: int):
    """Each routed copy's rank among the copies routed to its expert (a
    cumulative sum of one-hots), and the copies routed to each expert."""
    onehot = (flat_e[:, None] == torch.arange(e, device=flat_e.device)).long()
    pos_all = onehot.cumsum(dim=0) - 1                      # (N*k, E)
    return pos_all.gather(1, flat_e[:, None])[:, 0], pos_all[-1] + 1


def _experts(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over the dispatch buffer (E, cap, D); a sharded
    contraction of ``down`` sums its partials in f32 (``row_product``)."""
    h = silu(torch.einsum("ecd,edw->ecw", buf, p["gate"]))
    h = h * torch.einsum("ecd,edw->ecw", buf, p["up"])
    return row_product(h, p["down"], "ecw,ewd->ecd")        # (E, cap, D)


def _moe_local(p: Params, xt: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    n, d = xt.shape
    e, k = moe.n_experts, moe.top_k
    gates, eids = _route(xt, p["router"], k)
    cap = moe_capacity(n, moe)
    flat_e = eids.reshape(-1)                               # (N*k,)
    pos, _ = _slots(flat_e, e)
    tok = torch.arange(n * k, device=xt.device) // k

    keep = pos < cap                                        # dropped overflow
    safe_pos = torch.where(keep, pos, cap - 1)
    val = torch.where(keep[:, None], xt[tok], 0)
    buf = torch.zeros((e, cap, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((flat_e, safe_pos), val, accumulate=True)
    out_buf = _experts(p, buf)
    gathered = torch.where(keep[:, None], out_buf[flat_e, safe_pos], 0)
    weighted = gathered * gates.reshape(-1)[:, None].to(xt.dtype)
    out = torch.zeros((n, d), dtype=xt.dtype, device=xt.device)
    return out.index_add(0, tok, weighted)


class _ReduceScatter(torch.autograd.Function):
    """The sum of every rank's ``x`` over ``group``, each rank keeping its
    chunk of ``dim``; the gradient is the all-gather of the chunks'."""

    @staticmethod
    def forward(ctx, x, dim, group):
        from torch.distributed import _functional_collectives as funcol

        ctx.dim, ctx.group = dim, group
        return funcol.wait_tensor(funcol.reduce_scatter_tensor(
            x.contiguous(), "sum", dim, group))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_gather_tensor(
            grad.contiguous(), ctx.dim, ctx.group)), None, None


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` over ``group``, concatenated along ``dim``.  Its
    gradient is the sum over the group of each rank's (a reduce-scatter)
    when the ranks used the whole for tokens of their own (``partial``),
    else this rank's chunk (``index``) of the gradient they share."""

    @staticmethod
    def forward(ctx, x, dim, group, index, partial):
        from torch.distributed import _functional_collectives as funcol

        ctx.dim, ctx.group, ctx.index, ctx.partial = dim, group, index, partial
        ctx.size = x.shape[dim]
        return funcol.wait_tensor(funcol.all_gather_tensor(
            x.contiguous(), dim, group))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed import _functional_collectives as funcol

        if ctx.partial:
            out = funcol.wait_tensor(funcol.reduce_scatter_tensor(
                grad.contiguous(), "sum", ctx.dim, ctx.group))
        else:
            out = grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
        return out, None, None, None, None


def token_shard_slots(flat_e: torch.Tensor, e: int, mesh, dims,
                      index: int) -> torch.Tensor:
    """The slot of each routed copy of token shard ``index`` (over mesh
    dims ``dims``, major to minor): its rank among the copies routed to
    its expert in the reference's global order, i.e. the local cumulative
    sum plus the copies the earlier shards route there (the per-expert
    counts of every shard gathered, the earlier ones summed)."""
    pos, counts = _slots(flat_e, e)
    if not dims:
        return pos
    from torch.distributed import _functional_collectives as funcol

    every = counts[None]
    for i in reversed(dims):                 # minor first: rows major-minor
        every = funcol.wait_tensor(funcol.all_gather_tensor(
            every, 0, mesh.get_group(i)))
    return pos + every[:index].sum(0)[flat_e]


def _moe_on_token_shards(p: Params, xt, moe: MoEConfig):
    """:func:`moe_layer` under a mesh: each rank routes its own tokens and
    the (E, cap, D) buffer is never whole on a rank.

    * **Slots.**  A copy's slot is its rank among every copy routed to
      its expert in the reference's global order: the local cumulative sum
      plus the copies of the earlier token shards (their per-expert counts
      gathered, E integers a shard), so capacity drops exactly the tokens
      the reference drops, and each shard's slots are one consecutive
      range per expert.
    * **Dispatch.**  The buffer's layout is the cost model's
      (``EXPERT_BUF_SPECS``, as ``constrain_ranked`` picks it).  Each rank
      scatters its kept copies into a local buffer of the part its model
      group holds (its experts where the layout splits them over
      ``model``, else its slice of D) with plain tensors; the slots of the
      token shards are disjoint, so their sum over the batch axes is exact:
      a reduce-scatter onto the capacity's shards (an all-reduce over a
      batch axis the layout does not split), then, for a D slice, an
      all-gather of D over ``model``.  Its gradient is the transpose.
    * **Combine.**  The inverse: each rank gathers the capacity of its part
      over the batch axes, reads its own copies' rows, and the rows are
      made whole over ``model`` (a sum of disjoint experts, or the D
      slices gathered); the gate-weighted sum into each token runs on the
      token's rank.
    * Nothing indexes a DTensor by a DTensor, so no DTensor rule is needed
      for either direction (the card's torch has none for an index
      sharded over two mesh dims).  Each collective is written out with
      its transpose, and each local view of a DTensor names the
      placements of its gradient.
    """
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.dist.sharding import placements

    mesh = xt.device_mesh
    n, d = xt.shape
    e, k = moe.n_experts, moe.top_k
    cap = moe_capacity(n, moe)
    coord = mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    tok_place = tuple(xt.placements)
    if not all(pl.is_replicate() or pl.is_shard(0) for pl in tok_place):
        raise ValueError(f"MoE tokens laid out as {tok_place}: each rank "
                         "must hold whole tokens")
    tok_dims = [i for i, pl in enumerate(tok_place) if pl.is_shard(0)]
    spec = ranked_spec(mesh, (e, cap, d), EXPERT_BUF_SPECS,
                       xt.element_size()) or (None, None, None)
    buf_place = placements(mesh, spec)
    cap_dims = [i for i, pl in enumerate(buf_place) if pl.is_shard(1)]
    m = names.index("model") if "model" in names else None
    if m is not None and mesh.size(m) == 1:
        m = None
    by_expert = m is None or buf_place[m].is_shard(0)
    msz, mi = (1, 0) if m is None else (mesh.size(m), coord[m])
    if not by_expert and d % msz:
        raise ValueError(f"d_model {d} does not split over {msz} model ranks")
    e_lo, e_n = (mi * (e // msz), e // msz) if by_expert else (0, e)
    d_lo, d_n = (0, d) if by_expert else (mi * (d // msz), d // msz)
    shard = 0
    for i in tok_dims:
        shard = shard * mesh.size(i) + coord[i]

    # routing: the same on every rank holding the tokens
    router = p["router"]
    if _is_dtensor(router):
        router = router.to_local(
            grad_placements=_grad_placements(router.placements, tok_place))
    gates, eids = _route(xt.to_local(grad_placements=tok_place), router, k)
    flat_e = eids.reshape(-1)                               # (N_local*k,)
    pos = token_shard_slots(flat_e, e, mesh, tok_dims, shard)
    keep = pos < cap                                        # dropped overflow
    safe_pos = torch.where(keep, pos, cap - 1)
    tok = torch.arange(flat_e.shape[0], device=flat_e.device) // k
    mine = keep & (flat_e >= e_lo) & (flat_e < e_lo + e_n)
    slot_e = (flat_e - e_lo).clamp(0, e_n - 1)

    # dispatch: this rank's part, summed over the token shards
    xd = xt.to_local(grad_placements=[
        Partial() if i == m or (i in cap_dims and i not in tok_dims) else pl
        for i, pl in enumerate(tok_place)])
    val = torch.where(mine[:, None], xd[:, d_lo:d_lo + d_n][tok], 0)
    buf = torch.zeros((e_n, cap, d_n), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((slot_e, safe_pos), val, accumulate=True)
    for i in range(mesh.ndim):                              # major to minor
        if i == m:
            continue
        group = mesh.get_group(i)
        if i in tok_dims and i in cap_dims:
            buf = _ReduceScatter.apply(buf, 1, group)
        elif i in tok_dims:
            buf = _SumOverGroup.apply(buf, group)
        elif i in cap_dims:
            buf = buf.chunk(mesh.size(i), 1)[coord[i]]
    if not by_expert:
        buf = _AllGather.apply(buf, 2, mesh.get_group(m), mi, False)
    shape = (e, cap, d)
    buf = DTensor.from_local(buf.contiguous(), mesh, buf_place,
                             run_check=False, shape=torch.Size(shape),
                             stride=torch.empty(shape, device="meta").stride())

    out_buf = constrain_to(_experts(p, buf), spec)

    # combine: this rank's part, whole over the capacity, read by its copies
    part = out_buf.to_local(grad_placements=[
        Partial() if (i in tok_dims and not pl.is_shard()) or (
            i == m and not by_expert) else pl
        for i, pl in enumerate(buf_place)])[..., d_lo:d_lo + d_n]
    for i in reversed(cap_dims):                            # minor first
        part = _AllGather.apply(part, 1, mesh.get_group(i), coord[i],
                                i in tok_dims)
    rows = torch.where(mine[:, None], part[slot_e, safe_pos], 0)
    if m is not None:
        rows = (_SumOverGroup.apply(rows, mesh.get_group(m)) if by_expert
                else _AllGather.apply(rows, 1, mesh.get_group(m), mi, False))
    weighted = rows * gates.reshape(-1)[:, None].to(xt.dtype)
    out = torch.zeros((xd.shape[0], d), dtype=xt.dtype, device=xt.device)
    out = out.index_add(0, tok, weighted)
    return DTensor.from_local(out, mesh, tok_place, run_check=False,
                              shape=torch.Size((n, d)), stride=(d, 1))
