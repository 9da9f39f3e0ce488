"""The 95th percentile of the window's request latencies, as
`latency_p50_ms.serve` takes them; the profiled requests are left out.
Moves `serve_device_ms`."""

from port_bench.harness import percentile


def read(span, run):
    skip = set(span["profiled"])
    lat = [ms for i, ms in enumerate(span["latency_ms"]) if i not in skip]
    return percentile(lat, 95) if lat else None
