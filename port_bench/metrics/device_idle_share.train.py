"""Share of a train step's wall time in which nothing ran on the card:
1 − b / w, with b the union of device intervals (kernels, copies, memsets)
a step over the profiled steps, from the profiler's trace, and w the
window's seconds a step over the steps the profiler did not slow. (The
profiler slows the host several-fold, so the traced sub-window's own idle
share, which the result's `busy_s` / `window_s` give, reads high.) Moves
`train_device_ms`."""


def read(span, run):
    trace, profiled = span["trace"], len(span["profiled"])
    steps = span["steps"] - profiled
    if trace is None or profiled == 0 or steps <= 0:
        return None
    wall = (span["window"] - span["prof_span"]) / steps
    return 100.0 * (1.0 - trace.busy_s() / profiled / wall)
