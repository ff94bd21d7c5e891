"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built with ``nvcc``
at first use) behind device-dispatching entry points.

Layout per kernel: ``csrc/<name>.cu`` (the kernel, plain C interface),
``<name>.py`` (its ctypes wrapper and launch counter), plus the shared
``ops.py`` (dispatch by device), ``ref.py`` (plain PyTorch versions) and
``_build.py`` (nvcc + ctypes).
"""
from .ops import decode_attention, flash_attention, launch_counts, mamba2_ssd, \
    reset_launch_counts, rwkv6_wkv

__all__ = ["decode_attention", "flash_attention", "rwkv6_wkv", "mamba2_ssd",
           "launch_counts", "reset_launch_counts"]
