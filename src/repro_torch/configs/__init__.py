"""Architecture configs of the LM/SSM pool.

The port's own copy of ``repro.configs`` (plain dataclasses, no JAX), so
the port imports nothing of the reference package.
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.configs.registry import get_config, list_archs, reduced

__all__ = [
    "ArchConfig",
    "MLAConfig",
    "MoEConfig",
    "SSMConfig",
    "get_config",
    "list_archs",
    "reduced",
]
