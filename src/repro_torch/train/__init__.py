"""Training substrate: optimizer, checkpointing, fault-tolerant loop.

The port of ``repro.train``; ``value_and_grad`` (``train.grad``) takes the
place of ``jax.value_and_grad`` for the port's steps.
"""

from repro_torch.train.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_at,
)
from repro_torch.train.compression import (
    compressed_psum,
    compression_ratio,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.train import checkpoint
from repro_torch.train.grad import value_and_grad
from repro_torch.train.trainer import (
    StepFailure,
    TrainerConfig,
    TrainerReport,
    run,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "lr_at",
    "compressed_psum",
    "compression_ratio",
    "quantize_int8",
    "dequantize_int8",
    "checkpoint",
    "value_and_grad",
    "StepFailure",
    "TrainerConfig",
    "TrainerReport",
    "run",
]
