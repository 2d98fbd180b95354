"""qwen2.5-14b [dense] — hf:Qwen/Qwen2.5-14B.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-14b",
        family="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=13824,
        vocab=152_064,
        head_dim=128,
        rope_theta=1_000_000.0,
        qkv_bias=True,
        pattern=("attn+mlp",),
    )
