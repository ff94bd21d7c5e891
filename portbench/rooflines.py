"""A kernel's share of its roofline over the traced stretch, for the metric
readers: the least time of each of its calls (``work``, from the call's
shapes, which the span that launched it gives) summed, over the device time
of all the kernel's launches summed.  A call is one launch of the kernel's
``main`` function; its other functions' time is counted with it."""
from __future__ import annotations

from typing import Callable, Optional

from .timeline import Trace
from .work import Work


def share(trace: Trace, functions: tuple, main: str,
          work_of: Callable[[dict], Work]) -> Optional[float]:
    """The share in %, or None where the stretch launched none of them."""
    least = device = 0.0
    for span in trace.spans:
        mine = [(a, b, n) for a, b, n in trace.ops_in(span) if any(f in n for f in functions)]
        calls = sum(1 for _, _, n in mine if main in n)
        if calls:
            least += calls * work_of(span.shape).seconds()
            device += sum(b - a for a, b, _ in mine) * 1e-9
    return 100.0 * least / device if device > 0 else None
