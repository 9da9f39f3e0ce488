"""Host milliseconds a request inside `ops.nms.nms_sorted_mask` (the RPN's
and the post-process's per-class greedy NMS; each reads the device between
its tiles), by the harness's host-clock span around each call over the
window's requests, started once the device has finished the work queued
before the call, so it times the NMS alone; the profiled requests are
left out. Moves `serve_device_ms`."""

from port_bench.spans import outside


def read(span, run):
    n = len(span["latency_ms"]) - len(span["profiled"])
    calls = outside(span["nms_calls"], span)
    return sum(calls) / n if n > 0 and calls else None
