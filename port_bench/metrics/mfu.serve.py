"""The whole request's share of the H100's bf16 peak (989 TFLOP/s): the
benchmark's analytic FLOPs of each request at its blob's shape and 300
rois, summed over the window's requests, over the sum of their latencies;
the profiled requests are left out. Moves `serve_device_ms`."""

from port_bench.counts import PEAK_BF16


def read(span, run):
    skip = set(span["profiled"])
    flops = sum(f for i, f in enumerate(span["flops"]) if i not in skip)
    secs = sum(ms for i, ms in enumerate(span["latency_ms"]) if i not in skip) / 1e3
    return 100.0 * flops / secs / PEAK_BF16 if secs > 0 else None
