"""PyTorch/CUDA port of the serving slices of ``repro`` (prefill + decode of
the dense, RWKV6 and Zamba2-hybrid families), with hand-written Hopper
kernels for the four kernels on those paths: flash and decode attention,
the RWKV6 WKV scan and the Mamba2 SSD scan; and of the perception path:
single-stream pipelines and the anytime ladder (``perception``,
``anytime``), batched multi-camera serving (``batched``) and the
observability layer (``obs``).

The JAX package ``repro`` stays the reference: every module here mirrors
its counterpart's layout and semantics, and the parity tests
(``tests/test_torch_*.py``) hold the port against it on the same inputs.
This package imports ``torch`` and ``numpy`` only, never ``jax`` or
``repro``.
"""
