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
Under a mesh with FSDP, each block's leaves, the embedding, the norms
and the head are gathered over ``data`` where they are used
(``dist.sharding.fsdp_gathered``), one period at a time.
Entry points run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist.policy import constrain
from repro_torch.dist.sharding import fsdp_gathered
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.train.tree import tree_map

Params = Dict[str, Any]


def _parse(entry: str) -> Tuple[str, Optional[str]]:
    if "+" in entry:
        mixer, ffn = entry.split("+")
        return mixer, ffn
    return entry, None


# ---------------------------------------------------------------------------
# tensor trees (nested dicts / lists of tensors)
# ---------------------------------------------------------------------------


def period_slice(tree, i: int):
    """Period ``i`` of a tree stacked over a leading period axis (views)."""
    return tree_map(lambda t: t[i], tree)


def unstack_periods(tree, n: int) -> List[Params]:
    """Every period of a stacked tree, as views from one ``unbind`` per
    leaf: under autograd each leaf's gradient is then stacked once, where
    ``n`` :func:`period_slice` calls would each add a full-size gradient."""
    split: List[Tuple[torch.Tensor, ...]] = []
    tree_map(lambda t: split.append(t.unbind(0)), tree)

    def period(i: int) -> Params:
        parts = iter(split)
        return tree_map(lambda _: next(parts)[i], tree)

    return [period(i) for i in range(n)]


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


def _residual(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``x + out``.  Under a mesh, onto a sequence-sharded residual
    ``out`` is first laid out as ``x`` (its slice of the sequence) by an
    explicit redistribute, whose gradient comes back whole: an implicit
    one inside the add would hand ``out``'s product a sequence-sharded
    gradient, which the card's torch cannot flatten into the product's
    rows."""
    if L._is_dtensor(x) and L._is_dtensor(out) \
            and any(p.is_shard(1) for p in x.placements) \
            and tuple(out.placements) != tuple(x.placements):
        out = out.redistribute(x.device_mesh, x.placements)
    return x + out


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

    h = L.whole_sequence(L.rms_norm(x, p["norm1"], cfg.norm_eps))
    if mixer == "attn":
        if cfg.mla is not None:
            out, c = L.mla_attention(p["mix"], h, cfg, positions,
                                     cache=sub("self"), cache_pos=cache_pos)
        else:
            out, c = L.attention(p["mix"], h, cfg, positions,
                                 cache=sub("self"), cache_pos=cache_pos)
            out = L.row_product(out, p["mix"]["wo"])
        if c is not None:
            new_cache["self"] = c
    elif mixer == "xattn":
        out, c = L.attention(p["mix"], h, cfg, positions, kv_source=memory,
                             cache=sub("cross"), cache_pos=cache_pos,
                             causal=False, cross=True)
        out = L.row_product(out, p["mix"]["wo"])
        if c is not None:
            new_cache["cross"] = c
    elif mixer == "attnx":
        out, c = L.attention(p["mix"], h, cfg, positions,
                             cache=sub("self"), cache_pos=cache_pos)
        out = L.row_product(out, p["mix"]["wo"])
        if c is not None:
            new_cache["self"] = c
        x = _residual(x, out)
        h = L.whole_sequence(L.rms_norm(x, p["norm_c"], cfg.norm_eps))
        out, c = L.attention(p["cross"], h, cfg, positions, kv_source=memory,
                             cache=sub("cross"), cache_pos=cache_pos,
                             causal=False, cross=True)
        out = L.row_product(out, p["cross"]["wo"])
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
    x = _residual(x, out)
    if ffn is not None:
        h = L.whole_sequence(L.rms_norm(x, p["norm2"], cfg.norm_eps))
        if "router" in p["ffn"]:
            x = _residual(x, L.moe_layer(p["ffn"], h, cfg.moe))
        else:
            x = _residual(x, L.mlp(p["ffn"], h))
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
    for blk in unstack_periods(params["encoder"], cfg.encoder_layers):
        blk = fsdp_gathered(blk)
        h = L.rms_norm(x, blk["norm1"], cfg.norm_eps)
        out, _ = L.attention(blk["mix"], h, enc_cfg, positions, causal=False)
        x = _residual(x, L.row_product(out, blk["mix"]["wo"]))
        h = L.rms_norm(x, blk["norm2"], cfg.norm_eps)
        x = _residual(x, L.mlp(blk["ffn"], h))
    return L.rms_norm(x, fsdp_gathered(params["enc_norm"]), cfg.norm_eps)


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    embed = fsdp_gathered(params["embed"])
    if L._is_dtensor(embed):
        return L.vocab_parallel_embedding(embed, tokens).to(torch.bfloat16)
    return embed[tokens].to(torch.bfloat16)


def forward_hidden(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,                       # (B, S) integer ids
    memory: Optional[torch.Tensor] = None,      # frontend embeds (B, T, D)
    remat: bool = False,
) -> torch.Tensor:
    """Full-sequence causal forward -> final-norm hidden states (B, S, D).

    ``remat``: each body period is recomputed in the backward pass
    (``layers.remat``), as the reference's ``jax.checkpoint`` of its scan
    body, so autograd keeps one activation per period.
    """
    x = _embed(params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    if cfg.encoder_layers and memory is not None:
        memory = encode(params, cfg, memory)

    for blk in params.get("head_blocks", []):
        x, _ = _apply_block(_dense(cfg), "attn+mlp", fsdp_gathered(blk), x,
                            positions, memory, None, None)

    def body(h, period, memory):
        period = fsdp_gathered(period)
        for i, kind in enumerate(cfg.pattern):
            h, _ = _apply_block(cfg, kind, period[f"b{i}"], h, positions,
                                memory, None, None)
        return constrain(h, [(("pod", "data"), "model", None),
                             ("data", "model", None), (None, "model", None)])

    for period in unstack_periods(params["blocks"], n_body_periods(cfg)):
        x = L.remat(body, x, period, memory) if remat else body(
            x, period, memory)
    return L.whole_sequence(L.rms_norm(x, fsdp_gathered(params["final_norm"]),
                                       cfg.norm_eps))


def head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    """The output projection (D, vocab), gathered over ``data`` under
    FSDP."""
    return fsdp_gathered(params["embed"].T if cfg.tie_embeddings
                         else params["lm_head"])


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            memory: Optional[torch.Tensor] = None,
            remat: bool = False) -> torch.Tensor:
    """Full logits (B, S, vocab) f32.  ``remat`` is :func:`forward_hidden`'s
    (the same logits; only the backward pass's memory differs)."""
    x = forward_hidden(params, cfg, tokens, memory, remat=remat)
    return (x @ head(params, cfg).to(x.dtype)).float()


def lm_loss(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            memory: Optional[torch.Tensor] = None,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross entropy with a sequence-chunked head.

    The head and logsumexp run per chunk of ``cfg.loss_chunk`` positions,
    each chunk recomputed in the backward pass (``layers.remat``), which
    bounds the f32 logits by B x chunk x vocab in either pass; the final
    position has no next token and is weighted out.  ``remat`` is
    :func:`forward_hidden`'s.  Its gradient is autograd's
    (``repro_torch.train.value_and_grad``, ``launch.steps.build_train_step``).
    """
    x = forward_hidden(params, cfg, tokens, memory, remat=remat)
    targets = L.along_whole_dim(                          # y_t = token_{t+1}
        lambda t: torch.roll(t, -1, dims=1), tokens, 1).long()
    b, s, _ = x.shape
    w_head = head(params, cfg)
    chunk = min(cfg.loss_chunk, s)
    if s % chunk:
        raise ValueError("loss_chunk must divide seq_len")
    weight = torch.ones((b, s), dtype=torch.float32, device=x.device)
    weight[:, -1] = 0.0

    def chunk_nll(x_c, y_c, w_c, w_head):
        logits = (x_c @ w_head.to(x_c.dtype)).float()
        lse = torch.logsumexp(logits, dim=-1)
        if L._is_dtensor(logits):
            # DTensor's gather over a vocab-sharded dim fails to reduce its
            # mask; picking the target by a one-hot sum is the same value
            # and keeps the logits sharded
            vocab = torch.arange(logits.shape[-1], device=y_c.device)
            tgt = torch.where(vocab == y_c[..., None], logits, 0.0).sum(-1)
        else:
            tgt = logits.gather(-1, y_c[..., None])[..., 0]
        return ((lse - tgt) * w_c).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + L.remat(chunk_nll, x[:, sl], targets[:, sl],
                                weight[:, sl], w_head)
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
        period = fsdp_gathered(period_slice(params["blocks"], pi))
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
            x, nc = _apply_block(_dense(cfg), "attn+mlp", fsdp_gathered(blk),
                                 x, positions, None, c, pos)
            hb.append(nc)
        new_cache["head_blocks"] = hb

    periods = []
    for pi in range(n_body_periods(cfg)):
        period = fsdp_gathered(period_slice(params["blocks"], pi))
        pcache = period_slice(cache["blocks"], pi)
        ncs = {}
        for i, kind in enumerate(cfg.pattern):
            x, ncs[f"b{i}"] = _apply_block(cfg, kind, period[f"b{i}"], x,
                                           positions, None, pcache[f"b{i}"],
                                           pos)
        periods.append(ncs)
    new_cache["blocks"] = tree_map(lambda *ts: torch.stack(ts), *periods)
    x = L.rms_norm(x, fsdp_gathered(params["final_norm"]), cfg.norm_eps)
    logits = (x[:, 0] @ head(params, cfg).to(x.dtype)).float()
    return logits, new_cache
