"""`rlod::roi_align_avg_bwd`'s share of its roofline: over the profiled
calls, Σ max(bytes / 3.35 TB/s, ops / 67 TFLOP/s) at each call's input
shapes (`port_bench.counts`) over Σ device time of the kernels each call
launched. A call without device time fails the run. Moves
`train_device_ms`."""

from port_bench.roofline import share


def read(span, run):
    return share(span["trace"], "rlod::roi_align_avg_bwd")
