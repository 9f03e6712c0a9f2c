from .base import CacheConfig, ModelConfig, MoEConfig, reduced
from .registry import get_config, register

__all__ = ["CacheConfig", "ModelConfig", "MoEConfig", "reduced",
           "get_config", "register"]
