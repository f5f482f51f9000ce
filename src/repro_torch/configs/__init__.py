from repro_torch.configs.base import ModelConfig, MoESettings, MLASettings, SSMSettings
from repro_torch.configs.shapes import SHAPES, InputShape, smoke_shape
from repro_torch.configs.registry import (
    ARCH_IDS, get_config, all_configs, supports_shape, config_for_shape,
    LONG_500K_SKIPS,
)

__all__ = [
    "ModelConfig", "MoESettings", "MLASettings", "SSMSettings",
    "SHAPES", "InputShape", "smoke_shape",
    "ARCH_IDS", "get_config", "all_configs", "supports_shape",
    "config_for_shape", "LONG_500K_SKIPS",
]
