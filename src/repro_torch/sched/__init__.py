"""Runtime scheduling simulation (paper Insight 4): the discrete-event
CPU/accelerator simulator that the anytime ladder maps its rungs onto, and
the multi-tenant contention curve built on it."""
from .contention import contention_curve, contention_tasks
from .simulator import SimConfig, SimResult, StageSpec, TaskSpec, simulate

__all__ = [
    "SimConfig", "SimResult", "StageSpec", "TaskSpec", "simulate",
    "contention_curve", "contention_tasks",
]
