"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built with ``nvcc``
at first use) behind device-dispatching entry points.

Layout per kernel: ``csrc/<name>.cu`` (the kernel, plain C interface),
``<name>.py`` (its ctypes wrapper and launch counter), plus the shared
``ops.py`` (dispatch by device), ``ref.py`` (plain PyTorch versions) and
``_build.py`` (nvcc + ctypes); ``cost.py`` declares what one call of
each kernel costs.
"""
from .ops import decode_attention, flash_attention, launch_counts, mamba2_ssd, \
    reset_launch_counts, rwkv6_wkv

__all__ = ["decode_attention", "flash_attention", "rwkv6_wkv", "mamba2_ssd",
           "launch_counts", "reset_launch_counts", "CERT_SHAPES"]

# Canonical certification shapes per public kernel entry point: (dtype_short,
# shape) per positional argument, the reference's (its kernel sweeps'
# shapes).  The static certifier (``repro_torch.analysis.cert``) counts each
# entry point at exactly these shapes.
CERT_SHAPES = {
    "flash_attention": (
        ("f32", (1, 128, 4, 32)),          # q (B, S, H, D)
        ("f32", (1, 128, 4, 32)),          # k
        ("f32", (1, 128, 4, 32)),          # v
    ),
    "decode_attention": (
        ("f32", (2, 4, 32)),               # q (B, H, D)
        ("f32", (2, 128, 4, 32)),          # k cache (B, C, K, D)
        ("f32", (2, 128, 4, 32)),          # v cache
        ("i32", (128,)),                   # ring-buffer positions
        ("i32", ()),                       # next_pos
    ),
    "rwkv6_wkv": (
        ("f32", (1, 64, 2, 16)),           # r (B, T, H, D)
        ("f32", (1, 64, 2, 16)),           # k
        ("f32", (1, 64, 2, 16)),           # v
        ("f32", (1, 64, 2, 16)),           # logw
        ("f32", (2, 16)),                  # u (H, D)
    ),
    "mamba2_ssd": (
        ("f32", (1, 64, 8, 16)),           # x (B, S, H, P); H % head_block
        ("f32", (1, 64, 8)),               # dt
        ("f32", (8,)),                     # a
        ("f32", (1, 64, 16)),              # B (B, S, N)
        ("f32", (1, 64, 16)),              # C
    ),
}
