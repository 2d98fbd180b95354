"""State-space / recurrent blocks: Mamba (Jamba) and xLSTM (mLSTM, sLSTM).

The port of ``repro.models.ssm``.  Every block has the contract of
attention: ``block(params, x, cfg, state=None) -> (y, new_state)``.
Full-sequence mode (``state=None``) runs the recurrence over time inside;
single-step mode (state given, S == 1) is the decode step.  State size is
constant in sequence length.

The reference scans time with ``chunked_scan``, a two-level scan that
rematerializes chunks in the backward pass; the forward is a plain loop
over time with the same carries, which is what these blocks run.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.dist.policy import constrain
from repro_torch.models.layers import Device, dense_init, normal, silu, softplus

Params = Dict[str, torch.Tensor]


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -softplus(-x)


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------


def _ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    ssm = cfg.ssm or SSMConfig()
    d_in = ssm.expand * cfg.d_model
    dt_rank = ssm.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, ssm.d_state


def init_mamba(cfg: ArchConfig, gen: torch.Generator, device: Device = None) -> Params:
    ssm = cfg.ssm or SSMConfig()
    d = cfg.d_model
    d_in, dt_rank, d_state = _ssm_dims(cfg)
    a = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=device).expand(d_in, d_state)
    return {
        "in_proj": dense_init(gen, d, 2 * d_in, device=device),
        "conv": (normal(gen, (ssm.d_conv, d_in), device) * 0.1).to(torch.bfloat16),
        "conv_b": torch.zeros((d_in,), dtype=torch.bfloat16, device=device),
        "x_proj": dense_init(gen, d_in, dt_rank + 2 * d_state, device=device),
        "dt_proj": dense_init(gen, dt_rank, d_in, device=device),
        "dt_bias": torch.full((d_in,), -4.6, dtype=torch.float32,
                              device=device),   # softplus ~ 0.01
        "a_log": torch.log(a).contiguous(),
        "d_skip": torch.ones((d_in,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, d_in, d, device=device),
    }


def mamba_block(
    p: Params,
    x: torch.Tensor,                    # (B, S, D)
    cfg: ArchConfig,
    state: Optional[Params] = None,
) -> Tuple[torch.Tensor, Params]:
    ssm = cfg.ssm or SSMConfig()
    b, s, _ = x.shape
    d_in, dt_rank, d_state = _ssm_dims(cfg)

    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)          # (B,S,d_in) each

    # depthwise causal conv over time
    if state is None:
        pad = torch.zeros((b, ssm.d_conv - 1, d_in), dtype=xi.dtype,
                          device=x.device)
        xpad = torch.cat([pad, xi], dim=1)
        conv_state_out = xpad[:, -(ssm.d_conv - 1):, :] if ssm.d_conv > 1 else None
    else:
        xpad = torch.cat([state["conv"].to(xi.dtype), xi], dim=1)
        conv_state_out = xpad[:, -(ssm.d_conv - 1):, :]
    w = p["conv"].float()                                # (K, d_in)
    xc = sum(xpad[:, k:k + s, :].float() * w[k]
             for k in range(ssm.d_conv)) + p["conv_b"].float()
    xc = silu(xc).to(x.dtype)

    proj = xc @ p["x_proj"]                              # (B,S,dt_rank+2N)
    dt = softplus((proj[..., :dt_rank] @ p["dt_proj"]).float() + p["dt_bias"])
    b_ssm = proj[..., dt_rank:dt_rank + d_state].float()
    c_ssm = proj[..., dt_rank + d_state:].float()
    a = -torch.exp(p["a_log"])                           # (d_in, N)
    dtx = dt * xc.float()                                # (B,S,d_in)

    h = (state["ssm"].float() if state is not None
         else torch.zeros((b, d_in, d_state), dtype=torch.float32,
                          device=x.device))
    ys = []
    for t in range(s):
        # discretize per step: the (B, S, d_in, N) tensors never exist
        da_t = torch.exp(dt[:, t, :, None] * a)          # (B,d_in,N)
        h = h * da_t + dtx[:, t, :, None] * b_ssm[:, t, None, :]
        h = constrain(h, [(None, "model", None)])
        ys.append(torch.einsum("bdn,bn->bd", h, c_ssm[:, t]))
    y = torch.stack(ys, dim=1)                           # (B,S,d_in)
    y = y + xc.float() * p["d_skip"]
    y = (y.to(x.dtype) * silu(z)) @ p["out_proj"]

    new_state = {
        "ssm": h,
        "conv": (conv_state_out if conv_state_out is not None
                 else torch.zeros((b, max(ssm.d_conv - 1, 1), d_in),
                                  dtype=x.dtype, device=x.device)),
    }
    return y, new_state


def init_mamba_state(cfg: ArchConfig, batch: int, device: Device = None) -> Params:
    ssm = cfg.ssm or SSMConfig()
    d_in, _, d_state = _ssm_dims(cfg)
    return {
        "ssm": torch.zeros((batch, d_in, d_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, max(ssm.d_conv - 1, 1), d_in),
                            dtype=torch.bfloat16, device=device),
    }


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------


def init_mlstm(cfg: ArchConfig, gen: torch.Generator, device: Device = None) -> Params:
    d = cfg.d_model
    d_in = 2 * d                         # projection factor 2 (xLSTM paper)
    h = cfg.n_heads
    hd = d_in // h

    def blockdiag():                     # per-head projection (H, hd, hd)
        return torch.stack([dense_init(gen, hd, hd, device=device)
                            for _ in range(h)])

    return {
        "up_proj": dense_init(gen, d, 2 * d_in, device=device),
        "wq": blockdiag(),
        "wk": blockdiag(),
        "wv": blockdiag(),
        "wi": dense_init(gen, d_in, h, dtype=torch.float32, device=device),
        "wf": dense_init(gen, d_in, h, dtype=torch.float32, device=device),
        "wo_gate": blockdiag(),
        "down_proj": dense_init(gen, d_in, d, device=device),
    }


def mlstm_block(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    state: Optional[Params] = None,
) -> Tuple[torch.Tensor, Params]:
    """mLSTM: per-head matrix memory C (hd x hd) with exponential gating.

    Recurrence (xLSTM eq. 19-27, stabilized):
      C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
      h_t = (C_t q_t) / max(|n_t^T q_t|, 1)
    """
    b, s, _ = x.shape
    h = cfg.n_heads
    xm, z = (x @ p["up_proj"]).chunk(2, dim=-1)          # (B,S,d_in)
    d_in = xm.shape[-1]
    hd = d_in // h
    xh = xm.reshape(b, s, h, hd)

    def headproj(w):                     # block-diagonal per-head matmul
        return torch.einsum("bshd,hde->bhse", xh, w)     # (B,H,S,hd)

    # the reference divides bf16 by a weakly typed scalar: the scalar is
    # rounded to bf16 first
    scale = float(torch.tensor(math.sqrt(hd)).to(x.dtype))
    q = (headproj(p["wq"]) / scale).float()
    k = headproj(p["wk"]).float()
    v = headproj(p["wv"]).float()
    # bf16 @ f32 promotes to f32 in JAX
    i_pre = (xm.float() @ p["wi"]).transpose(1, 2)       # (B,H,S)
    f_pre = (xm.float() @ p["wf"]).transpose(1, 2)

    if state is None:
        c = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, h, hd), dtype=torch.float32, device=x.device)
        m = torch.zeros((b, h), dtype=torch.float32, device=x.device)
    else:
        c, n, m = state["c"], state["n"], state["m"]
    ys = []
    for t in range(s):
        q_t, k_t, v_t = q[:, :, t], k[:, :, t], v[:, :, t]
        i_t, f_t = i_pre[:, :, t], f_pre[:, :, t]
        log_f = _log_sigmoid(f_t)
        m_new = torch.maximum(log_f + m, i_t)
        i_g = torch.exp(i_t - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g[..., None, None] * c + i_g[..., None, None] * (
            v_t[..., :, None] * k_t[..., None, :])
        c = constrain(c, [(None, None, "model", None)])
        n = f_g[..., None] * n + i_g[..., None] * k_t
        m = m_new
        num = torch.einsum("bhvk,bhk->bhv", c, q_t)
        den = torch.clamp(torch.einsum("bhk,bhk->bh", n, q_t).abs(), min=1.0)
        ys.append(num / den[..., None])
    y = torch.stack(ys, dim=1).reshape(b, s, d_in).to(x.dtype)   # (B,S,H,hd)
    og = torch.einsum("bshd,hde->bshe", xh, p["wo_gate"]).reshape(b, s, d_in)
    y = y * silu(og)
    out = (y * silu(z)) @ p["down_proj"]
    return out, {"c": c, "n": n, "m": m}


def init_mlstm_state(cfg: ArchConfig, batch: int, device: Device = None) -> Params:
    d_in = 2 * cfg.d_model
    h = cfg.n_heads
    hd = d_in // h
    return {
        "c": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "m": torch.zeros((batch, h), dtype=torch.float32, device=device),
    }


def init_slstm(cfg: ArchConfig, gen: torch.Generator, device: Device = None) -> Params:
    d = cfg.d_model
    f32 = torch.float32
    return {
        "wz": dense_init(gen, d, d, device=device),
        "wi": dense_init(gen, d, d, dtype=f32, device=device),
        "wf": dense_init(gen, d, d, dtype=f32, device=device),
        "wo": dense_init(gen, d, d, dtype=f32, device=device),
        "r": dense_init(gen, d, d, device=device),   # recurrent mix of h_{t-1}
        "out_proj": dense_init(gen, d, d, device=device),
    }


def slstm_block(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    state: Optional[Params] = None,
) -> Tuple[torch.Tensor, Params]:
    """sLSTM: scalar memory with exponential input gate (stabilized)."""
    b, s, d = x.shape
    z_in = (x @ p["wz"]).float()
    # bf16 @ f32 promotes to f32 in JAX
    x32 = x.float()
    i_in = x32 @ p["wi"]
    f_in = x32 @ p["wf"]
    o_in = x32 @ p["wo"]

    if state is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        c, n, m, h = zeros, zeros, zeros, zeros
    else:
        c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    ys = []
    for t in range(s):
        rec = (h.to(x.dtype) @ p["r"]).float()
        zt = torch.tanh(z_in[:, t] + rec)
        log_f = _log_sigmoid(f_in[:, t])
        i_t = i_in[:, t]
        m_new = torch.maximum(log_f + m, i_t)
        i_g = torch.exp(i_t - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = constrain(f_g * c + i_g * zt, [(None, "model")])
        n = f_g * n + i_g
        m = m_new
        h = torch.sigmoid(o_in[:, t]) * c / torch.clamp(n, min=1.0)
        ys.append(h)
    y = torch.stack(ys, dim=1).to(x.dtype) @ p["out_proj"]
    return y, {"c": c, "n": n, "m": m, "h": h}


def init_slstm_state(cfg: ArchConfig, batch: int, device: Device = None) -> Params:
    zeros = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"c": zeros, "n": zeros.clone(), "m": zeros.clone(), "h": zeros.clone()}
