"""The program's spans in a traced window: while `annotated_window()` is
open, the measured window's profiler (`window.StepWindow`'s) is an
`AnnotatedProfiled`, whose trace also keeps, for each `user_annotation`
name (each span of `rlobjectdetection_tpu_torch/utils/tracing.py` opens
one while a profiler records), the device seconds of the kernels, copies
and memsets launched inside it: a launch (its `cuda_runtime` event, joined
to the device activity by its correlation id) counts where its host
thread had the annotation open. Work that autograd's thread launches for
a backward is outside every forward span."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

from . import window
from .trace import DEVICE_CATS, Profiled, Trace


def annotation_device_s(events: list) -> dict:
    """{annotation name: device seconds launched inside it} of a chrome
    trace's events."""
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e:
            spans.setdefault((e["tid"], e["name"]), []).append((e["ts"], e["ts"] + e["dur"]))
    index = {}
    for (tid, name), v in spans.items():
        v.sort()
        index.setdefault(tid, []).append((name, [s for s, _ in v], [x for _, x in v]))
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    out = {}
    for k in events:
        if k.get("cat") not in DEVICE_CATS:
            continue
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None:
            continue
        t = launch["ts"]
        for name, starts, ends in index.get(launch["tid"], ()):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] >= t:
                out[name] = out.get(name, 0.0) + k["dur"] / 1e6
    return out


class AnnotatedProfiled(Profiled):
    """`Profiled` whose trace carries `annotation_s`
    (`annotation_device_s` of its events); a profiler's trace is exported
    once, so this exit parses it for both."""

    def __exit__(self, *exc):
        import torch

        self.sync()
        with torch.profiler.record_function("port_bench.window_end"):
            pass
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", dir=self.tmpdir)
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        marks = {e["name"]: e["ts"] for e in events
                 if e.get("name", "").startswith("port_bench.window_")}
        self.trace = Trace(events, (marks["port_bench.window_start"],
                                    marks["port_bench.window_end"]))
        self.trace.annotation_s = annotation_device_s(events)
        return False


@contextlib.contextmanager
def annotated_window():
    """While open, the windows' profiler is `AnnotatedProfiled`."""
    saved = window.Profiled
    window.Profiled = AnnotatedProfiled
    try:
        yield
    finally:
        window.Profiled = saved
