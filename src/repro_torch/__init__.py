"""PyTorch/CUDA port of the serving slice of ``repro`` (dense transformer
prefill + decode), with hand-written Hopper kernels for the two attention
kernels on that path.

The JAX package ``repro`` stays the reference: every module here mirrors
its counterpart's layout and semantics, and the parity tests
(``tests/test_torch_*.py``) hold the port against it on the same inputs.
This package imports ``torch`` and ``numpy`` only, never ``jax`` or
``repro``.
"""
