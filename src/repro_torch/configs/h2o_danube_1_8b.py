"""h2o-danube-1.8b [dense] — arXiv:2401.16818 (hf).

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, llama+mistral mix, SWA.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab=32_000,
        rope_theta=10_000.0,
        swa_window=4096,
        pattern=("attn+mlp",),
    )
