"""Median host milliseconds a request in the detector's `blob` (subtract
the pixel means, resize by the short side, pad to multiples of 32:
`data/blob.py`), by a host-clock span the harness puts around the
detector instance's `blob` in the traced run; the profiled requests are
left out. Moves `serve_device_ms`."""

import statistics

from port_bench.spans import outside


def read(span, run):
    ms = outside(span["prep_ms"], span)
    return statistics.median(ms) if ms else None
