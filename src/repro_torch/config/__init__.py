from .base import (SHAPES, CacheConfig, ModelConfig, MoEConfig,
                   OptimizerConfig, RuntimeConfig, ShapeConfig, SSMConfig,
                   reduced)
from .registry import get_config, list_archs, register

__all__ = ["CacheConfig", "ModelConfig", "MoEConfig", "OptimizerConfig",
           "RuntimeConfig", "SHAPES", "SSMConfig", "ShapeConfig", "reduced",
           "get_config", "list_archs", "register"]
