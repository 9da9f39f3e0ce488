"""`rlod::layer1`'s share of its roofline (layer1's three bottlenecks on
the stem's output, bf16): over the profiled calls, Σ max(bytes / 3.35
TB/s, FLOPs / 989 TFLOP/s) at each call's input shapes
(`port_bench.counts`) over Σ device time of the kernels each call
launched. A call without device time fails the run. Moves
`serve_device_ms`."""

from port_bench.roofline import share


def read(span, run):
    return share(span["trace"], "rlod::layer1")
