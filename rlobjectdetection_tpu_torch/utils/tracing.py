"""Spans and counters at the port's layer boundaries, kept in memory.

    from rlobjectdetection_tpu_torch.utils import tracing

    tracing.enable()
    with tracing.span("serve.request", shape=im.shape):
        ...
        tracing.count("nms.host_syncs", 7)
    tracing.spans()    # [{name, id, parent, root, thread, attrs, counts, profiled,
                       #   t_start, t_end}]
    tracing.totals()   # {"nms.host_syncs": 7, ...}
    tracing.enabled()  # True: a count that reads the card is taken now

The recorder is off until `enable()`. Off, and with no `torch.profiler`
recording, `span()` returns one shared object that does nothing: it reads
no clock and keeps nothing. `count()` adds to the process's totals whether
the recorder is on or off.

On, a span records its name, its start and end (`time.perf_counter_ns()`,
the clock of the benchmark's window edges), its thread, its parent (the
span open on its thread when it opened), its root (the outermost span open
on its thread then: every span of one request or step shares it), its
attributes, and the counts made while it was the innermost open span of
its thread. A reader windows those counts by the end of the span that
holds them. Each thread keeps its own stack of open spans and its own
totals, so spans opened on a loader's worker threads stay apart and no
counter update is lost; finished spans go to one shared list (an append is
atomic under the interpreter lock).

While a `torch.profiler` is recording, a span also opens
`torch.profiler.record_function(name)`: it then appears in the profiler's
trace as a `user_annotation` on the profiler's clock, beside the kernels,
and its record says `profiled`. The in-memory span reads its clock right
after the annotation opens and right after it closes (where each clock
read lies nearest the profiler's), so one offset maps the spans onto the
trace, taken from the pairs of a profiled span and its twin annotation (a
thread the profiler does not trace, such as a loader's worker started
before it, leaves its spans without twins). Under
`torch.compile` or `torch.export` tracing a span is the no-op, so a traced
graph holds no profiler op.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_on = False
_spans: list = []
_thread_totals: list = []        # each thread's counter totals
_ids = itertools.count(1)
_local = threading.local()


class _NoSpan:
    """The span handed out while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _NoSpan()


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _totals() -> dict:
    """This thread's counter totals."""
    try:
        return _local.totals
    except AttributeError:
        _local.totals = {}
        _thread_totals.append(_local.totals)
        return _local.totals


class _Span:
    __slots__ = ("name", "attrs", "rec", "rf", "stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.rec, self.rf = name, attrs, None, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if _on:
            stack = _stack()
            parent = stack[-1] if stack else None
            sid = next(_ids)
            self.rec = {"name": self.name, "id": sid,
                        "parent": None if parent is None else parent["id"],
                        "root": sid if parent is None else parent["root"],
                        "thread": threading.get_ident(), "attrs": self.attrs, "counts": {},
                        "profiled": self.rf is not None,
                        "t_start": time.perf_counter_ns(), "t_end": None}
            self.stack = stack
            stack.append(self.rec)
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        if rec is not None:
            rec["t_end"] = time.perf_counter_ns()
            self.stack.pop()
            _spans.append(rec)
        return False

    def set(self, **attrs) -> None:
        """Adds attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager around one piece of work at a layer boundary."""
    if not (_on or _profiler._is_profiler_enabled) or torch.compiler.is_compiling():
        return NOOP
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name`: to the process totals always, and
    while the recorder is on to the innermost span open on this thread."""
    try:
        totals = _local.totals
    except AttributeError:
        totals = _totals()
    totals[name] = totals.get(name, 0) + n
    if _on:
        stack = getattr(_local, "stack", None)
        if stack:
            counts = stack[-1]["counts"]
            counts[name] = counts.get(name, 0) + n


def enable() -> None:
    """Starts recording spans in memory."""
    global _on
    _on = True


def enabled() -> bool:
    """Whether the recorder is on (for a count that costs a read of the
    card, taken only while recording)."""
    return _on


def disable() -> None:
    """Stops recording; the spans recorded so far stay."""
    global _on
    _on = False


def reset() -> None:
    """Drops the recorded spans and zeroes the totals (call it while no
    other thread counts)."""
    _spans.clear()
    for totals in list(_thread_totals):
        totals.clear()


def spans() -> list:
    """The finished spans, in the order they ended."""
    return list(_spans)


def totals() -> dict:
    """The process-wide counter totals, summed over threads."""
    out: dict = {}
    for totals_ in list(_thread_totals):
        for name, n in list(totals_.items()):
            out[name] = out.get(name, 0) + n
    return out
