"""Runtime scheduling simulation (paper Insight 4): the discrete-event
CPU/accelerator simulator that the anytime ladder maps its rungs onto."""
from .simulator import SimConfig, SimResult, StageSpec, TaskSpec, simulate

__all__ = ["SimConfig", "SimResult", "StageSpec", "TaskSpec", "simulate"]
