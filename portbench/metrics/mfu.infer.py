"""The model's share of the card's bf16 peak over the traced stretch of
prompts: the useful operations of its prefills (``work.serve_flops``, 2 N D
with the head on the last position) over the stretch's wall time times 989
TFLOP/s, in %."""
from portbench import work


def read(trace, cell):
    flops = sum(work.serve_flops(cell.config, cell.n_params, s.shape["batch"], s.shape["length"])
                for s in trace.spans)
    return 100.0 * flops / (trace.wall_s * work.PEAKS["bf16"])
