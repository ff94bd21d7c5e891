"""Model definitions of every family (dense, moe, vlm, audio, ssm, hybrid) in PyTorch."""
from .params import ParamSpec, count_params, from_numpy, init_params, stack_specs
from .transformer import DecodeState, Model

__all__ = [
    "DecodeState",
    "Model",
    "ParamSpec",
    "count_params",
    "from_numpy",
    "init_params",
    "stack_specs",
]
