"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434 (hf).

27L d_model=2048 16H (MLA) d_ff_expert=1408 vocab=102400,
MoE 64 routed top-6 + 2 shared, MLA kv_lora=512, first layer dense FFN.
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,              # dense FFN width (layer 0)
        vocab=102_400,
        rope_theta=10_000.0,
        moe=MoEConfig(
            n_experts=64,
            top_k=6,
            n_shared=2,
            d_ff_expert=1408,
            first_dense=1,
        ),
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=0,       # V2-Lite: no query compression
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        pattern=("attn+moe",),
    )
