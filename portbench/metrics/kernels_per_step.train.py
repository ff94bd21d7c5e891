"""Device kernels a training step launches, from the profiler's timeline: the
kernels (not copies or fills) that start inside the traced steps, over the
steps."""
NOT_KERNELS = ("Memcpy", "Memset")


def read(trace, cell):
    n = sum(1 for s in trace.spans for _, _, name in trace.ops_in(s)
            if not name.startswith(NOT_KERNELS))
    return n / len(trace.spans)
