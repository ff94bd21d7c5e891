"""I/O middleware models: for now the simulated clock the batched engine
and the observability layer share (the pub/sub broker and the transport
models come with the multi-tenant runtime)."""
from .clock import SimClock

__all__ = ["SimClock"]
