"""PyTorch/CUDA port of the serving slices of ``repro`` (prefill + decode of
every model family: dense, moe, vlm, the audio encoder, RWKV6 and the
Zamba2 hybrid), with hand-written Hopper kernels for the four kernels on
those paths: flash and decode attention,
the RWKV6 WKV scan and the Mamba2 SSD scan; of training (``train``:
AdamW, the loop, data and checkpoints, with a hand-written backward
kernel for flash attention); and of the perception path:
single-stream pipelines and the anytime ladder (``perception``,
``anytime``), batched multi-camera serving (``batched``), the
observability layer (``obs``), scenario replay (``scenarios``) and
deterministic fault injection at one shard (``chaos``).

The JAX package ``repro`` stays the reference: every module here mirrors
its counterpart's layout and semantics, and the parity tests
(``tests/test_torch_*.py``) hold the port against it on the same inputs.
This package imports ``torch`` and ``numpy`` only, never ``jax`` or
``repro``.
"""
