"""The device's idle share of the traced stretch (train cells): the wall time
in which no kernel, copy or fill ran (the union of their intervals on the
profiler's one timeline) over the stretch's own wall time, in %."""


def read(trace, cell):
    return 100.0 * trace.idle_share()
