"""llama-3.2-vision-11b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; cross-attention
image layers every 5th block.  The vision frontend is a STUB per the
assignment: input_specs provide precomputed patch embeddings.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=128_256,
        head_dim=128,
        rope_theta=500_000.0,
        pattern=("attn+mlp",) * 4 + ("xattn+mlp",),
        frontend_tokens=1601,    # 1600 patches + 1 cls (448^2 / 14^2)
    )
