"""qwen3-8b [dense] — hf:Qwen/Qwen3-8B.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936, qk_norm.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12288,
        vocab=151_936,
        head_dim=128,
        rope_theta=1_000_000.0,
        qk_norm=True,
        pattern=("attn+mlp",),
    )
