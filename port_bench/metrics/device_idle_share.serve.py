"""Share of a request's latency in which nothing ran on the card: 1 − b /
w, with b the union of device intervals (kernels, copies, memsets) a
request over the profiled requests, from the profiler's trace, and w the
mean latency of the requests the profiler did not slow. Moves
`serve_device_ms`."""


def read(span, run):
    trace, skip = span["trace"], set(span["profiled"])
    lat = [ms for i, ms in enumerate(span["latency_ms"]) if i not in skip]
    if trace is None or not skip or not lat:
        return None
    return 100.0 * (1.0 - trace.busy_s() / len(skip) / (sum(lat) / len(lat) / 1e3))
