"""`rlod::res_stage`'s share of its roofline (layer2 and layer3 of the
frozen trunk in float32 on the stage kernel): over the profiled calls,
Σ max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s) at each call's input shapes
(`port_bench.counts`) over Σ device time of the kernels each call
launched. A call without device time fails the run. Moves
`rl_train_images_per_s`."""

from port_bench.roofline import share


def read(span, run):
    return share(span["trace"], "rlod::res_stage")
