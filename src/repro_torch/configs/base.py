"""Architecture configuration schema for the assigned model pool."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0            # always-on shared experts (DeepSeek MoE)
    d_ff_expert: int = 0         # expert FFN width (0 -> use d_ff)
    capacity_factor: float = 1.25
    every: int = 1               # MoE layer every N blocks (else dense FFN)
    first_dense: int = 0         # leading dense-FFN layers (DeepSeek: 1)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0         # 0 -> full-rank queries (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba / xLSTM block parameters."""

    kind: str = "mamba"          # mamba | mlstm | slstm
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    swa_window: int = 0          # 0 -> full attention
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # block pattern, repeated over the depth: e.g. ("attn",) for a vanilla
    # decoder, ("attn",) + ("mamba",)*7 for Jamba's 1:7 interleave,
    # ("attn",)*4 + ("xattn",) for Llama-3.2-Vision's cross-attn cadence.
    pattern: Tuple[str, ...] = ("attn",)
    # encoder-decoder (seamless): encoder layers use bidirectional attention
    encoder_layers: int = 0
    # modality frontend stub: number of precomputed embedding tokens the
    # input_specs provide (image patches / audio frames)
    frontend_tokens: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # scan-over-layers unroll factor (1 = while loop; dry-run body-cost
    # estimation lowers 1- and 2-period variants fully unrolled)
    scan_unroll: int = 1
    # sequence chunk for the CE loss head (bounds fp32 logits memory)
    loss_chunk: int = 512

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}"
        )
        return self.n_layers // len(self.pattern)

    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode: bounded state or bounded window."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.swa_window > 0

    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def param_count(self) -> int:
        """Total parameters (embedding + blocks + head), analytic."""
        d = self.d_model
        hd = self.resolved_head_dim
        total = self.vocab * d          # embed
        if not self.tie_embeddings:
            total += self.vocab * d     # lm head
        per_pattern = 0
        for kind in self.pattern:
            per_pattern += self._block_params(kind)
        total += per_pattern * self.n_periods
        total += self.encoder_layers * self._block_params("attn")
        if self.encoder_layers:  # cross-attn in every decoder layer
            total += self.n_layers * self._attn_params()
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.mla is not None:
            m = self.mla
            qd = m.qk_nope_head_dim + m.qk_rope_head_dim
            q = d * self.n_heads * qd if not m.q_lora_rank else (
                d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qd
            )
            kv = d * (m.kv_lora_rank + m.qk_rope_head_dim)
            kv += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            o = self.n_heads * m.v_head_dim * d
            return q + kv + o
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def _ffn_params(self, width: int) -> int:
        return 3 * self.d_model * width  # SwiGLU gate/up/down

    def _block_params(self, kind: str) -> int:
        d = self.d_model
        mixer, _, ffn = kind.partition("+")
        p = 0
        if ffn == "moe":
            moe = self.moe
            w = moe.d_ff_expert or self.d_ff
            p += moe.n_experts * self._ffn_params(w)
            p += moe.n_shared * self._ffn_params(w)
            p += d * moe.n_experts  # router
        elif ffn == "mlp":
            p += self._ffn_params(self.d_ff)
        kind = mixer
        if kind in ("attn", "xattn", "attnx"):
            p += self._attn_params() + 2 * d
            if kind == "attnx":
                p += self._attn_params() + d
            return p
        if kind == "mamba":
            ssm = self.ssm or SSMConfig()
            d_in = ssm.expand * d
            dt_rank = ssm.dt_rank or -(-d // 16)
            return p + (
                2 * d * d_in          # in_proj (x, z)
                + d_in * ssm.d_conv   # conv
                + d_in * (dt_rank + 2 * ssm.d_state)
                + dt_rank * d_in
                + d_in * ssm.d_state  # A
                + d_in                # D
                + d_in * d            # out_proj
                + 2 * d
            )
        if kind == "mlstm":
            d_in = 2 * d
            hd = d_in // self.n_heads
            return p + (2 * d * d_in + 4 * self.n_heads * hd * hd
                        + 2 * d_in * self.n_heads + d_in * d + 2 * d)
        if kind == "slstm":
            return p + (4 * d * d + d * d + d * d + 2 * d)
        raise ValueError(f"unknown block kind {kind}")
