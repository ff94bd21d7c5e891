"""Architecture configs (one module per arch) + registry."""
from .base import ModelConfig, reduced_for_smoke
from .registry import ARCHS, get_config

__all__ = ["ModelConfig", "reduced_for_smoke", "ARCHS", "get_config"]
