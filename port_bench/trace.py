"""A `torch.profiler` window and what the benchmark reads from its trace:
device kernel intervals, each attributed to the `rlod::` op whose host call
launched it (by the launch's correlation id and the op's host interval),
busy time (the union of kernel intervals), idle gaps labelled by the host
op running at the time, and the input shapes of each op call
(`record_shapes`). `DeviceBusy` records the card's activity alone over a
whole measured window, for the end-to-end device metrics."""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """The parsed chrome trace of one profiler window."""

    def __init__(self, events: list, window_us: tuple):
        self.window_us = window_us
        self.kernels = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                              key=lambda e: e["ts"])
        self.ops = [e for e in events if e.get("cat") == "cpu_op"]
        launches = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
        rlod = {}
        for e in self.ops:
            if e["name"].startswith("rlod::"):
                rlod.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
        for v in rlod.values():
            v.sort()
        self.op_of = []
        for k in self.kernels:
            launch = launches.get(k.get("args", {}).get("correlation"))
            owner = (None if launch is None
                     else _enclosing(rlod.get(launch["tid"], []), launch["ts"]))
            self.op_of.append(None if owner is None else owner + (launch["tid"],))

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of device activity, `[(start_us, end_us)]` in order."""
        return union((k["ts"], k["ts"] + k["dur"]) for k in self.kernels)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def op_device_s(self, op: str) -> list:
        """Device seconds under each host call of `op`, in call order, with
        the call's input shapes, types and concrete inputs."""
        calls = sorted((e for e in self.ops if e["name"] == op), key=lambda e: e["ts"])
        index = {(e["tid"], e["ts"]): i for i, e in enumerate(calls)}
        secs = [0.0] * len(calls)
        for k, owner in zip(self.kernels, self.op_of):
            if owner is not None and owner[2] == op:
                i = index.get((owner[3], owner[0]))
                if i is not None:
                    secs[i] += k["dur"] / 1e6
        return [(s, e.get("args", {})) for s, e in zip(secs, calls)]

    def breakdown(self, label) -> dict:
        """The ten device entries that took most time (kernels by name, and
        the `rlod::` ops by their kernels' time), and the ten longest idle
        gaps, each named by the deepest host op running at its middle."""
        by = {}
        for k, owner in zip(self.kernels, self.op_of):
            by[k["name"][:120]] = by.get(k["name"][:120], 0.0) + k["dur"] / 1e6
            op = owner[2] if owner is not None else label(k["name"])
            if op is not None:
                by[op] = by.get(op, 0.0) + k["dur"] / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        busy = self.busy_intervals()
        edges = [self.window_us[0]] + [x for s, e in busy for x in (s, e)] + [self.window_us[1]]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._host_at(t0 + d / 2), d / 1e6] for d, t0 in gaps]}

    def _host_at(self, t: float) -> str:
        best = None
        for e in self.ops:
            if e["ts"] <= t <= e["ts"] + e["dur"] and (best is None or e["dur"] < best["dur"]):
                best = e
        return "host: " + (best["name"][:100] if best is not None else "outside any op")


def union(intervals) -> list:
    """The union of `(start, end)` intervals sorted by start, `[[start, end]]`."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _enclosing(spans: list, t: float, depth: int = 4):
    """The innermost (latest-starting) of sorted `spans` holding time t, as
    (start, end, name), or None; `rlod::` ops nest at most `depth` deep."""
    i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
    for j in range(i, max(i - depth, -1), -1):
        if spans[j][0] <= t <= spans[j][1]:
            return spans[j]
    return None


class Profiled:
    """`with Profiled(sync) as p: ...` profiles CPU and CUDA activity with
    input shapes; `p.trace` is the parsed `Trace` afterwards. The window's
    edges are the host clock around synchronised ends."""

    def __init__(self, sync, tmpdir: str | None = None):
        self.sync, self.tmpdir, self.trace = sync, tmpdir, None

    def __enter__(self):
        import torch

        self.sync()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA], record_shapes=True)
        self.prof.__enter__()
        with torch.profiler.record_function("port_bench.window_start"):
            pass
        return self

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
        return False


class DeviceBusy:
    """`with DeviceBusy(sync) as d: ...` records the card's activity alone
    (kernels, copies, memsets; no host ops, so a launch costs the host only
    some microseconds more) between synchronised ends; `d.busy_s` is then
    the union of the device intervals in seconds, and `d.activities` their
    count."""

    def __init__(self, sync):
        self.sync, self.busy_s, self.activities = sync, None, 0

    def __enter__(self):
        import torch

        self.sync()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        self.sync()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        cuda = torch.autograd.DeviceType.CUDA
        spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in self.prof.profiler.kineto_results.events()
                       if e.device_type() == cuda)
        self.activities = len(spans)
        self.busy_s = sum(e - s for s, e in union(spans)) / 1e9
        return False
