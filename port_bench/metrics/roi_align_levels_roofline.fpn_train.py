"""`rlod::roi_align_levels`'s share of its roofline (the FPN box head's
multi-level RoIAlignV2, forward): over the profiled calls, Σ max(bytes /
3.35 TB/s, ops / 67 TFLOP/s) at each call's input shapes
(`port_bench/counts_fpn.py`: the four maps and the rois read and the
pooled output written once; 8 f32 operations a channel for one bilinear
sample a bin) over Σ device time of the kernels each call launched. A
call without device time fails the run. Moves `train_device_ms`."""

from port_bench.counts_fpn import share


def read(span, run):
    return share(span["trace"], "rlod::roi_align_levels")
