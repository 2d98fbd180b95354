"""Generic LM: periodic decoder (+ optional encoder) over ArchConfig.

The port of ``repro.models.lm``; one implementation covers the ten
architectures of ``repro_torch.configs``:

* the depth is ``n_periods`` repetitions of ``cfg.pattern``;
* each pattern entry is "<mixer>" or "<mixer>+<ffn>" with mixer in
  {attn, xattn, attnx, mamba, mlstm, slstm} and ffn in {mlp, moe};
  ``attn`` resolves to MLA when cfg.mla is set; ``attnx`` is self+cross
  (enc-dec decoders); ``xattn`` is cross-only (VLM cadence);
* ``first_dense`` leading blocks (DeepSeek's dense layer 0) are unstacked;
* full-sequence forwards use the cache-free paths; ``decode_step``
  threads per-layer caches through the same blocks.

The parameter tree keeps the reference's layout: ``blocks`` (and
``encoder``) stack every leaf over a leading period axis, as
``jax.vmap(init_period)`` makes it, and each period is a slice of it
(a view).  So weights cross between the packages leaf for leaf
(:mod:`repro_torch.models.convert`).  Caches are laid out the same way.
Entry points run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist.policy import constrain
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

Params = Dict[str, Any]


def _parse(entry: str) -> Tuple[str, Optional[str]]:
    if "+" in entry:
        mixer, ffn = entry.split("+")
        return mixer, ffn
    return entry, None


# ---------------------------------------------------------------------------
# tensor trees (nested dicts / lists of tensors)
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of same-structured dict/list trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def period_slice(tree, i: int):
    """Period ``i`` of a tree stacked over a leading period axis (views)."""
    return tree_map(lambda t: t[i], tree)


def _stacked(n: int, make: Callable[[int], Params]) -> Params:
    """``make(i)`` for i < n, stacked leaf by leaf over a leading axis;
    holds one item besides the stack at a time."""
    first = make(0)
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        item = first if i == 0 else make(i)
        tree_map(lambda dst, src: dst[i].copy_(src), out, item)
    return out


def _dense(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, moe=None)


def _first_dense(cfg: ArchConfig) -> int:
    return cfg.moe.first_dense if cfg.moe else 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(cfg: ArchConfig, kind: str, gen: torch.Generator,
                device) -> Params:
    mixer, ffn = _parse(kind)
    p: Params = {"norm1": L._ones(cfg.d_model, device)}
    if mixer == "attn":
        p["mix"] = (L.init_mla(cfg, gen, device) if cfg.mla is not None
                    else L.init_attention(cfg, gen, device))
    elif mixer == "xattn":
        p["mix"] = L.init_attention(cfg, gen, device, cross=True)
    elif mixer == "attnx":
        p["mix"] = L.init_attention(cfg, gen, device)
        p["cross"] = L.init_attention(cfg, gen, device, cross=True)
        p["norm_c"] = L._ones(cfg.d_model, device)
    elif mixer == "mamba":
        p["mix"] = S.init_mamba(cfg, gen, device)
    elif mixer == "mlstm":
        p["mix"] = S.init_mlstm(cfg, gen, device)
    elif mixer == "slstm":
        p["mix"] = S.init_slstm(cfg, gen, device)
    else:
        raise ValueError(f"unknown mixer {mixer}")
    if ffn is not None:
        p["norm2"] = L._ones(cfg.d_model, device)
        p["ffn"] = (L.init_moe(cfg, gen, device) if ffn == "moe"
                    else L.init_mlp(cfg, gen, device))
    return p


def init_lm(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
            device=None) -> Params:
    """Random LM parameters on ``device`` (the card unless given), drawn
    from ``generator`` (seed 0 on ``device`` when None).  A generator on
    the card draws full-size weights there without a host round trip."""
    dev = resolve_device(device)
    gen = (generator if generator is not None
           else torch.Generator(device=dev).manual_seed(0))
    d = cfg.d_model
    params: Params = {
        "embed": (L.normal(gen, (cfg.vocab, d), dev) * 0.02).to(torch.bfloat16),
        "final_norm": L._ones(d, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, d, cfg.vocab, device=dev)

    first = _first_dense(cfg)
    if first:
        params["head_blocks"] = [
            _init_block(_dense(cfg), "attn+mlp", gen, dev) for _ in range(first)
        ]

    n_periods = n_body_periods(cfg)
    assert n_periods * len(cfg.pattern) == cfg.n_layers - first, cfg.name
    params["blocks"] = _stacked(n_periods, lambda _: {
        f"b{i}": _init_block(cfg, kind, gen, dev)
        for i, kind in enumerate(cfg.pattern)
    })

    if cfg.encoder_layers:
        params["encoder"] = _stacked(
            cfg.encoder_layers,
            lambda _: _init_block(_dense(cfg), "attn+mlp", gen, dev))
        params["enc_norm"] = L._ones(d, dev)
    return params


def n_body_periods(cfg: ArchConfig) -> int:
    return (cfg.n_layers - _first_dense(cfg)) // len(cfg.pattern)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _apply_block(
    cfg: ArchConfig,
    kind: str,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    memory: Optional[torch.Tensor],
    cache: Optional[Params],
    cache_pos,
) -> Tuple[torch.Tensor, Optional[Params]]:
    mixer, ffn = _parse(kind)
    new_cache: Params = {}

    def sub(name):
        return None if cache is None else cache[name]

    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer == "attn":
        if cfg.mla is not None:
            out, c = L.mla_attention(p["mix"], h, cfg, positions,
                                     cache=sub("self"), cache_pos=cache_pos)
        else:
            out, c = L.attention(p["mix"], h, cfg, positions,
                                 cache=sub("self"), cache_pos=cache_pos)
            out = out @ p["mix"]["wo"]
        if c is not None:
            new_cache["self"] = c
    elif mixer == "xattn":
        out, c = L.attention(p["mix"], h, cfg, positions, kv_source=memory,
                             cache=sub("cross"), cache_pos=cache_pos,
                             causal=False, cross=True)
        out = out @ p["mix"]["wo"]
        if c is not None:
            new_cache["cross"] = c
    elif mixer == "attnx":
        out, c = L.attention(p["mix"], h, cfg, positions,
                             cache=sub("self"), cache_pos=cache_pos)
        out = out @ p["mix"]["wo"]
        if c is not None:
            new_cache["self"] = c
        x = x + out
        h = L.rms_norm(x, p["norm_c"], cfg.norm_eps)
        out, c = L.attention(p["cross"], h, cfg, positions, kv_source=memory,
                             cache=sub("cross"), cache_pos=cache_pos,
                             causal=False, cross=True)
        out = out @ p["cross"]["wo"]
        if c is not None:
            new_cache["cross"] = c
    elif mixer in ("mamba", "mlstm", "slstm"):
        block = {"mamba": S.mamba_block, "mlstm": S.mlstm_block,
                 "slstm": S.slstm_block}[mixer]
        out, c = block(p["mix"], h, cfg, state=sub("state"))
        if cache is not None:
            new_cache["state"] = c
    else:
        raise ValueError(mixer)
    x = x + out
    if ffn is not None:
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        if "router" in p["ffn"]:
            x = x + L.moe_layer(p["ffn"], h, cfg.moe)
        else:
            x = x + L.mlp(p["ffn"], h)
    return x, (new_cache if cache is not None else None)


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------


def encode(params: Params, cfg: ArchConfig,
           memory_embeds: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over precomputed frontend embeddings."""
    enc_cfg = _dense(cfg)
    x = memory_embeds
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.encoder_layers):
        blk = period_slice(params["encoder"], i)
        h = L.rms_norm(x, blk["norm1"], cfg.norm_eps)
        out, _ = L.attention(blk["mix"], h, enc_cfg, positions, causal=False)
        x = x + out @ blk["mix"]["wo"]
        h = L.rms_norm(x, blk["norm2"], cfg.norm_eps)
        x = x + L.mlp(blk["ffn"], h)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(torch.bfloat16)


def forward_hidden(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,                       # (B, S) integer ids
    memory: Optional[torch.Tensor] = None,      # frontend embeds (B, T, D)
) -> torch.Tensor:
    """Full-sequence causal forward -> final-norm hidden states (B, S, D)."""
    x = _embed(params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    if cfg.encoder_layers and memory is not None:
        memory = encode(params, cfg, memory)

    for blk in params.get("head_blocks", []):
        x, _ = _apply_block(_dense(cfg), "attn+mlp", blk, x, positions,
                            memory, None, None)

    for pi in range(n_body_periods(cfg)):
        period = period_slice(params["blocks"], pi)
        for i, kind in enumerate(cfg.pattern):
            x, _ = _apply_block(cfg, kind, period[f"b{i}"], x, positions,
                                memory, None, None)
        x = constrain(x, [(("pod", "data"), "model", None),
                          ("data", "model", None), (None, "model", None)])
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full logits (B, S, vocab) f32."""
    x = forward_hidden(params, cfg, tokens, memory)
    return (x @ head(params, cfg).to(x.dtype)).float()


def lm_loss(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy with a sequence-chunked head (its value;
    the gradient is ROADMAP A14).

    The head and logsumexp run per chunk of ``cfg.loss_chunk`` positions,
    bounding the f32 logits by B x chunk x vocab; the final position has
    no next token and is weighted out.
    """
    x = forward_hidden(params, cfg, tokens, memory)
    targets = torch.roll(tokens, -1, dims=1)             # y_t = token_{t+1}
    b, s, _ = x.shape
    w_head = head(params, cfg).to(x.dtype)
    chunk = min(cfg.loss_chunk, s)
    if s % chunk:
        raise ValueError("loss_chunk must divide seq_len")
    weight = torch.ones((b, s), dtype=torch.float32, device=x.device)
    weight[:, -1] = 0.0
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        logits = (x[:, c0:c0 + chunk] @ w_head).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, targets[:, c0:c0 + chunk, None].long())[..., 0]
        total = total + ((lse - tgt) * weight[:, c0:c0 + chunk]).sum()
    return total / (b * (s - 1))


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def _cross_kv(cfg: ArchConfig, batch: int, device) -> Params:
    shape = (batch, cfg.frontend_tokens or 1, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                      device) -> Params:
    mixer, _ = _parse(kind)
    if mixer == "attn":
        if cfg.mla is not None:
            return {"self": L.init_mla_cache(cfg, batch, max_seq, device=device)}
        return {"self": L.init_self_cache(cfg, batch, max_seq, device=device)}
    if mixer == "xattn":
        return {"cross": _cross_kv(cfg, batch, device)}
    if mixer == "attnx":
        return {"self": L.init_self_cache(cfg, batch, max_seq, device=device),
                "cross": _cross_kv(cfg, batch, device)}
    init_state = {"mamba": S.init_mamba_state, "mlstm": S.init_mlstm_state,
                  "slstm": S.init_slstm_state}.get(mixer)
    if init_state is None:
        raise ValueError(mixer)
    return {"state": init_state(cfg, batch, device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> Params:
    """Zeroed decode caches in the reference's layout: ``head_blocks`` a
    list, ``blocks`` stacked over periods."""
    dev = resolve_device(device)
    cache: Params = {}
    first = _first_dense(cfg)
    if first:
        cache["head_blocks"] = [
            _init_block_cache(cfg, "attn+mlp", batch, max_seq, dev)
            for _ in range(first)
        ]
    cache["blocks"] = _stacked(n_body_periods(cfg), lambda _: {
        f"b{i}": _init_block_cache(cfg, kind, batch, max_seq, dev)
        for i, kind in enumerate(cfg.pattern)
    })
    return cache


def fill_cross_cache(params: Params, cfg: ArchConfig, cache: Params,
                     memory: torch.Tensor) -> Params:
    """A copy of ``cache`` with every cross-attention slot holding the
    projected frontend memory (encoded first for enc-dec archs): the
    prefill of the cross caches, which ``decode_step`` only reads."""
    if cfg.encoder_layers:
        memory = encode(params, cfg, memory)
    blocks = tree_map(lambda t: t.clone(), cache["blocks"])
    for pi in range(n_body_periods(cfg)):
        period = period_slice(params["blocks"], pi)
        for i, kind in enumerate(cfg.pattern):
            mixer = _parse(kind)[0]
            if mixer not in ("xattn", "attnx"):
                continue
            p = period[f"b{i}"]["cross" if mixer == "attnx" else "mix"]
            slot = blocks[f"b{i}"]["cross"]
            slot["k"][pi] = L.split_heads(memory @ p["wk"], cfg.n_kv_heads)
            slot["v"][pi] = L.split_heads(memory @ p["wv"], cfg.n_kv_heads)
    return dict(cache, blocks=blocks)


def decode_step(
    params: Params,
    cfg: ArchConfig,
    cache: Params,
    tokens: torch.Tensor,               # (B, 1) next token ids
    pos,                                # current position: int or 0-d tensor
) -> Tuple[torch.Tensor, Params]:
    """One autoregressive step; returns (logits (B, vocab) f32, new cache).
    The given cache is left as it was."""
    x = _embed(params, tokens)
    pos = L._position(pos, x.device)
    positions = pos.reshape(1)
    new_cache: Params = {}

    if "head_blocks" in params:
        hb: List[Params] = []
        for blk, c in zip(params["head_blocks"], cache["head_blocks"]):
            x, nc = _apply_block(_dense(cfg), "attn+mlp", blk, x, positions,
                                 None, c, pos)
            hb.append(nc)
        new_cache["head_blocks"] = hb

    periods = []
    for pi in range(n_body_periods(cfg)):
        period = period_slice(params["blocks"], pi)
        pcache = period_slice(cache["blocks"], pi)
        ncs = {}
        for i, kind in enumerate(cfg.pattern):
            x, ncs[f"b{i}"] = _apply_block(cfg, kind, period[f"b{i}"], x,
                                           positions, None, pcache[f"b{i}"],
                                           pos)
        periods.append(ncs)
    new_cache["blocks"] = tree_map(lambda *ts: torch.stack(ts), *periods)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ head(params, cfg).to(x.dtype)).float()
    return logits, new_cache
