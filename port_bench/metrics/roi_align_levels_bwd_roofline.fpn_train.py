"""`rlod::roi_align_levels_bwd`'s share of its roofline (the features'
gradient of the FPN box head's RoIAlignV2): over the profiled calls, Σ
max(bytes / 3.35 TB/s, ops / 67 TFLOP/s) at each call's shapes
(`port_bench/counts_fpn.py`: the gradient and rois read and the four
levels' gradients written once; 8 f32 operations a channel for one
bilinear sample a bin) over Σ device time of the kernels each call
launched (the f32 zeroing and the cast to bf16 included). Moves
`train_device_ms`."""

from port_bench.counts_fpn import share


def read(span, run):
    return share(span["trace"], "rlod::roi_align_levels_bwd")
