"""The whole train step's share of the H100's bf16 peak (989 TFLOP/s):
the benchmark's analytic FLOPs of the window's steps (forward of every
layer, backward of the trained ones, at each batch's canvas and 128 rois
an image) over the window's seconds; the profiled steps and their time are
left out. Moves `train_device_ms`."""

from port_bench.counts import PEAK_BF16


def read(span, run):
    skip = set(span["profiled"])
    flops = sum(f for i, f in enumerate(span["flops"]) if i not in skip)
    steady = span["window"] - span["prof_span"]
    return 100.0 * flops / steady / PEAK_BF16 if steady > 0 else None
