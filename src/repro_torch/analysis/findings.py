"""Rule catalog and finding records for the port's timing-hazard analyzer
(the port of the reference's ``repro/analysis/findings.py``).

Each rule is keyed to one of the source paper's six variation axes
(data, I/O, model, runtime, hardware, end-to-end perception system): the
static patterns are the *code-level root causes* of the inference time
variation the paper measures.  The codes, axes and titles are the
reference's, so findings of the two linters read alike; the hints name the
PyTorch and CUDA forms of each fix (TV004's "donation" is the port's async
hand-off: a ``non_blocking`` copy that may still be reading or writing a
host buffer).

A ``Finding`` carries a formatting-stable ``key`` (path + scope + rule +
a hash of the offending statement's AST, which ``ast.dump`` renders
without line/column info) so the committed baseline survives
whitespace-only and comment-only edits but breaks when the hazardous code
itself changes or a new hazard appears.
"""
from __future__ import annotations

import dataclasses

__all__ = ["AXES", "Rule", "RULES", "Finding"]

# the paper's six perspectives on inference-time variation
AXES = ("data", "io", "model", "runtime", "hardware", "end_to_end")


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    axis: str
    title: str
    hint: str


RULES: dict[str, Rule] = {
    r.code: r
    for r in [
        Rule(
            "TV001",
            "io",
            "implicit host sync in a hot path",
            "read the whole output tree back ONCE per tick (core.timing.to_host, "
            "or a non_blocking copy into pinned memory and one event wait) "
            "outside the loop, then post-process host arrays; never "
            ".item()/.tolist()/.cpu()/float()/np.asarray a CUDA tensor per "
            "iteration",
        ),
        Rule(
            "TV002",
            "runtime",
            "retrace hazard",
            "capture the CUDA graph (torch.cuda.graph) or torch.compile once, "
            "at setup, and replay it per tick; keep shapes and dtypes static "
            "(pad + mask instead of reshaping), and never branch in Python on "
            "a device value — use torch.where",
        ),
        Rule(
            "TV003",
            "data",
            "unseeded or time-dependent randomness",
            "thread an explicit seed: np.random.default_rng(seed) / "
            "torch.Generator(device).manual_seed(seed) passed as generator=; "
            "the global torch generator and wall-clock-derived seeds break "
            "scenario-replay determinism and the golden fixtures",
        ),
        Rule(
            "TV004",
            "hardware",
            "buffer-donation misuse",
            "a non_blocking copy is still in flight when the call returns: "
            "record a torch.cuda.Event after it and event.synchronize() (or "
            "Stream.synchronize / torch.cuda.synchronize) before rewriting "
            "its host source or reading its host destination; rotate pinned "
            "staging buffers so the tick path rarely waits",
        ),
        Rule(
            "TV005",
            "model",
            "unjitted device computation invoked per tick",
            "capture the callable once (torch.cuda.graph, or hand it to a "
            "capturing executor as its step_fn, or torch.compile it at "
            "setup) so per-tick invocations replay one graph instead of "
            "launching op by op",
        ),
        Rule(
            "TV006",
            "end_to_end",
            "unfenced timing measurement around async dispatch",
            "fence before closing the timed interval (torch.cuda.synchronize, "
            "event.synchronize, core.timing.fence) or time on the device with "
            "torch.cuda.Event(enable_timing=True) and elapsed_time — otherwise "
            "the measurement records the launch, not the work (see "
            "core.timing.StageTimer)",
        ),
        Rule(
            "TV007",
            "data",
            "mutable default argument",
            "default expressions evaluate ONCE at def time: a mutable "
            "default (or constructed config instance) is silently shared "
            "by every call and every instance — use `arg=None` and build "
            "the fresh value inside the body",
        ),
        Rule(
            "TV008",
            "runtime",
            "fault-swallowing retry in a hot path",
            "a bare/broad except that only passes, or a `while True` retry "
            "whose handler never raises/breaks, turns a transient fault "
            "into a silent unbounded stall — bound the retries, back off "
            "between attempts, and surface the failure (see "
            "chaos.recovery.FleetResilience)",
        ),
    ]
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One hazard occurrence.  ``key`` is the baseline identity; ``line``
    and ``col`` are presentation only (they move under formatting)."""

    rule: str
    axis: str
    path: str          # root-relative posix path
    line: int
    col: int
    scope: str         # dotted scope within the module ("<module>" at top)
    message: str
    hint: str
    key: str
    suppressed: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        sup = "  [suppressed]" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.axis}] {self.message}{sup}\n"
                f"    scope: {self.scope}\n"
                f"    fix:   {self.hint}")
