"""mixtral-8x22b [moe] — arXiv:2401.04088 (hf).

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, 8 experts top-2, SWA.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=32_768,
        head_dim=128,
        rope_theta=1_000_000.0,
        swa_window=4096,
        moe=MoEConfig(n_experts=8, top_k=2),
        pattern=("attn+moe",),
    )
