"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 (hf).

72L d_model=8192 64H (GQA kv=8) d_ff=24576, Mamba+attention 1:7 interleave,
MoE 16 experts top-2 on alternating layers.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab=65_536,
        head_dim=128,
        moe=MoEConfig(n_experts=16, top_k=2),
        ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
        # period of 8: one attention layer per 8 (1:7), MoE every other
        pattern=(
            "attn+moe", "mamba+mlp", "mamba+moe", "mamba+mlp",
            "mamba+moe", "mamba+mlp", "mamba+moe", "mamba+mlp",
        ),
    )
