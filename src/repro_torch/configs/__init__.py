"""Architecture configs (one module per arch) + registry."""
from .base import ModelConfig, reduced_for_smoke
from .registry import (ARCHS, SHAPES, InputShape, decode_state_specs, get_config, input_specs,
                       shape_applicability)

__all__ = ["ModelConfig", "reduced_for_smoke", "ARCHS", "SHAPES", "InputShape", "get_config",
           "input_specs", "decode_state_specs", "shape_applicability"]
