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
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.dist.policy import constrain, constrain_ranked

Params = Dict[str, torch.Tensor]
Device = Union[None, str, torch.device]

NEG_INF = -1e30      # the reference's mask fill


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
    return x.reshape(b, s, n_heads, -1)


ATTN_Q_BLOCK = 512   # query-block size of the memory-bounded full-sequence path

_SCORE_SPECS = [
    (("pod", "data"), "model", None, None, None), ("data", "model", None, None, None),
    (("pod", "data"), None, "model", None, None), ("data", None, "model", None, None),
    (("pod", "data"), None, None, "model", None), ("data", None, None, "model", None),
    (("pod", "data"), None, None, None, "model"), ("data", None, None, None, "model"),
]


def _sdpa(
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
    outs = []
    for i in range(0, q.shape[1], blk):
        qp = q_pos[i:i + blk]
        mask = _causal_mask(qp, k_pos, window) if causal else None
        outs.append(_sdpa(q[:, i:i + blk], k, v, mask))
    return torch.cat(outs, dim=1)


def _write_slot(cache: torch.Tensor, new: torch.Tensor,
                start: torch.Tensor) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice(cache, new, (0, start, ...))``: a
    copy of ``cache`` with ``new`` written along dim 1 from ``start``
    (clamped so the update fits, as JAX clamps)."""
    s = new.shape[1]
    start = start.clamp(0, cache.shape[1] - s)
    idx = start + torch.arange(s, device=cache.device)
    return cache.index_copy(1, idx, new.to(cache.dtype))


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
        return out @ p["wo"], None

    # --- absorbed decode: scores live in latent space ----------------------
    pos = _position(cache_pos, x.device)
    new_c = _write_slot(cache["c"], c_kv, pos)
    new_kr = _write_slot(cache["kr"], k_rope[:, :, 0, :], pos)
    wk_b = p["wk_b"].reshape(r, h, dn)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wk_b)     # absorb wk_b
    scores = (
        torch.einsum("bshr,btr->bhst", q_lat, new_c)
        + torch.einsum("bshd,btd->bhst", q_rope, new_kr)
    ).float() / math.sqrt(dn + dr)
    scores = constrain(scores, [
        (("pod", "data"), "model", None, None), ("data", "model", None, None),
        (("pod", "data"), None, None, "model"), ("data", None, None, "model"),
    ])
    valid = torch.arange(new_c.shape[1], device=x.device) <= pos
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhst,btr->bshr", probs, new_c)     # (B,S,H,r)
    wv_b = p["wv_b"].reshape(r, h, dv)
    out = torch.einsum("bshr,rhv->bshv", o_lat, wv_b)        # absorb wv_b
    out = out.reshape(b, s, h * dv) @ p["wo"]
    return out, {"c": new_c, "kr": new_kr}


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
    return (silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


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
    """
    b, s, d = x.shape
    n = b * s
    e, k = moe.n_experts, moe.top_k
    xt = x.reshape(n, d)
    logits = xt.float() @ p["router"].float()
    gates, eids = torch.topk(logits, k, dim=-1)             # (N, k)
    gates = torch.softmax(gates, dim=-1)

    cap = moe_capacity(n, moe)
    flat_e = eids.reshape(-1)                               # (N*k,)
    # position of each routed token inside its expert's buffer
    onehot = (flat_e[:, None] == torch.arange(e, device=x.device)).long()
    pos_all = onehot.cumsum(dim=0) - 1                      # (N*k, E)
    pos = pos_all.gather(1, flat_e[:, None])[:, 0]
    tok = torch.arange(n * k, device=x.device) // k

    keep = pos < cap                                        # dropped overflow
    safe_pos = torch.where(keep, pos, cap - 1)
    val = torch.where(keep[:, None], xt[tok], 0)            # (N*k, D)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((flat_e, safe_pos), val, accumulate=True)
    buf = constrain_ranked(buf, EXPERT_BUF_SPECS)

    h = silu(torch.einsum("ecd,edw->ecw", buf, p["gate"]))
    h = h * torch.einsum("ecd,edw->ecw", buf, p["up"])
    out_buf = torch.einsum("ecw,ewd->ecd", h, p["down"])    # (E, cap, D)
    out_buf = constrain_ranked(out_buf, EXPERT_BUF_SPECS)

    gathered = torch.where(keep[:, None], out_buf[flat_e, safe_pos], 0)
    weighted = gathered * gates.reshape(-1)[:, None].to(x.dtype)
    out = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    out = out.index_add(0, tok, weighted)

    if "shared" in p:
        out = out + mlp(p["shared"], xt)
    return out.reshape(b, s, d)
