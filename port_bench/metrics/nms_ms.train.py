"""Host milliseconds a train step inside `ops.nms.nms_sorted_mask` (the
RPN proposal layer's greedy NMS, which reads the device between its
tiles), by the harness's host-clock span around each call over the
window's steps, started once the device has finished the work queued
before the call (the trunk's and the RPN's), so it times the NMS alone;
the profiled steps are left out, as the profiler slows this loop of small
ops several-fold. Moves `train_device_ms`."""

from port_bench.spans import outside


def read(span, run):
    steps = span["steps"] - len(span["profiled"])
    calls = outside(span["nms_calls"], span)
    return sum(calls) / steps if steps > 0 and calls else None
