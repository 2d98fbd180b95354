"""xlstm-1.3b [ssm] — arXiv:2405.04517.

48L d_model=2048 4H, sLSTM + mLSTM blocks (7:1 interleave), no separate FFN
(xLSTM blocks carry their own 2x up-projection), vocab=50304.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50_304,
        ssm=SSMConfig(kind="mlstm"),
        pattern=("mlstm",) * 7 + ("slstm",),
        tie_embeddings=True,
    )
