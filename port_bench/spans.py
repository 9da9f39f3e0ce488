"""Host-clock spans the harness puts around calls into the program in a
traced run, without editing it: a module's or an object's attribute
replaced by a timed wrapper for the length of a `with` block."""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def timed(owner, name: str, sink: list, on: bool = True, sync=None):
    """While open, each call of `owner.name` appends (end time, ms) to
    `sink`; `on` false leaves it as it is. `sync` given, each call waits
    for it before its clock starts, so the span leaves out the device
    work queued before the call, which the call's first read would wait
    for."""
    if not on:
        yield
        return
    inner = getattr(owner, name)

    def wrapper(*args, **kwargs):
        if sync is not None:
            sync()
        t = time.perf_counter()
        out = inner(*args, **kwargs)
        end = time.perf_counter()
        sink.append((end, (end - t) * 1e3))
        return out

    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, inner)


def outside(calls: list, span: dict) -> list:
    """The calls' ms that ended in the window but not in its profiled part."""
    lo, hi = span["t_start"], span["t_end"]
    p0 = span.get("prof_t") or hi
    p1 = p0 + span.get("prof_span", 0.0)
    return [ms for end, ms in calls if lo <= end <= hi and not p0 <= end <= p1]
