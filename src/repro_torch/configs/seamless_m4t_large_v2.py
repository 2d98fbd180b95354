"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596 (hf).

Encoder-decoder backbone: 24 encoder + 24 decoder layers, d_model=1024,
16H, d_ff=8192, vocab=256206.  The speech/text modality frontend is a STUB
per the assignment: input_specs provide precomputed frame embeddings that
feed the encoder; every decoder block cross-attends to the encoder output.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=256_206,
        pattern=("attnx+mlp",),
        encoder_layers=24,
        frontend_tokens=1024,    # precomputed audio frame embeddings
    )
