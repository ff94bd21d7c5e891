"""The training step's share of the card's bf16 peak over the traced steps: 6 N
D a step (``work.train_flops``) over the stretch's wall time times 989
TFLOP/s, in %."""
from portbench import work


def read(trace, cell):
    flops = sum(work.train_flops(cell.config, cell.n_params, s.shape["batch"], s.shape["length"])
                for s in trace.spans)
    return 100.0 * flops / (trace.wall_s * work.PEAKS["bf16"])
