"""The median of the window's request latencies (the call to
`Detector.detect` until the detections are numpy on the host), by the
harness's clock; the profiled requests are left out. The host sets most
of it, so it swings with the host's speed from run to run and stands here
beside `serve_device_ms`, which it moves."""

from port_bench.harness import percentile


def read(span, run):
    skip = set(span["profiled"])
    lat = [ms for i, ms in enumerate(span["latency_ms"]) if i not in skip]
    return percentile(lat, 50) if lat else None
