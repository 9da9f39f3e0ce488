"""The RL train step's share of the H100's float32 peak (67 TFLOP/s; TF32
is off): the benchmark's analytic FLOPs of the window's steps (the frozen
trunk's forward at each batch's canvas; forward and backward of layer4,
fc8 and fc over every detection slot) over the window's seconds; the
profiled steps and their time are left out. Moves
`rl_train_images_per_s`."""

from port_bench.counts import PEAK_F32


def read(span, run):
    skip = set(span["profiled"])
    flops = sum(f for i, f in enumerate(span["flops"]) if i not in skip)
    steady = span["window"] - span["prof_span"]
    return 100.0 * flops / steady / PEAK_F32 if steady > 0 else None
