from .base import CacheConfig, ModelConfig, MoEConfig, SSMConfig, reduced
from .registry import get_config, register

__all__ = ["CacheConfig", "ModelConfig", "MoEConfig", "SSMConfig", "reduced",
           "get_config", "register"]
