"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

_MODULES: Dict[str, str] = {
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}


def list_archs() -> List[str]:
    return list(_MODULES.keys())


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {list_archs()}")
    return importlib.import_module(_MODULES[name]).config()


def reduced(cfg: ArchConfig, seq_friendly: bool = True) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests.

    Preserves the structural features (pattern, MLA/MoE/SSM, qk-norm, bias,
    SWA, enc-dec, frontend) while shrinking width/depth/vocab so one
    forward + train step runs in seconds on CPU.
    """
    pattern_len = len(cfg.pattern)
    first = cfg.moe.first_dense if cfg.moe else 0
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            n_shared=min(cfg.moe.n_shared, 1),
            d_ff_expert=64 if cfg.moe.d_ff_expert else 0,
        )
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(
            kv_lora_rank=32,
            q_lora_rank=cfg.mla.q_lora_rank and 32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=pattern_len + first,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        swa_window=8 if cfg.swa_window else 0,
        moe=moe,
        mla=mla,
        encoder_layers=2 if cfg.encoder_layers else 0,
        frontend_tokens=12 if cfg.frontend_tokens else 0,
    )
