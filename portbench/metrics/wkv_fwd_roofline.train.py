"""The WKV scan's forward kernel's share of its roofline over the traced
stretch (train cells), in %: each call's least time from its shapes
(work.wkv_fwd) over the device time of its launches. The profiler names of
its functions are pinned here."""
from portbench import rooflines, work

FUNCTIONS = ('wkv_scores_kernel', 'wkv_fwd_kernel')
MAIN = 'wkv_fwd_kernel'


def _work(c: dict, s: dict):
    h = c["num_heads"]
    k = c["d_model"] // h
    return work.wkv_fwd(s["batch"], s["length"], h, k)


def read(trace, cell):
    return rooflines.share(trace, FUNCTIONS, MAIN, lambda s: _work(cell.config, s))
