"""Device milliseconds a train step of the FPN neck's forward: the kernels
launched inside the program's span `model.fpn` (its `user_annotation` in
the profiler's trace, `port_bench/annotations.py`) over the profiled
steps. None where the program has no such span. Moves `train_device_ms`."""


def read(span, run):
    trace, profiled = span["trace"], len(span["profiled"])
    secs = getattr(trace, "annotation_s", {}).get("model.fpn") if trace is not None else None
    return secs * 1e3 / profiled if secs is not None and profiled else None
