"""Serving runtime: the single-stream instrumented engine."""
from .engine import Engine, ServeConfig, make_prefill_step, make_serve_step

__all__ = ["Engine", "ServeConfig", "make_prefill_step", "make_serve_step"]
