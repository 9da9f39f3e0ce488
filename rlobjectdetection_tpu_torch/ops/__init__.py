"""Tensor ops of the port: box geometry, anchors, NMS, RoIAlign, the frozen-BN
fold, and the wrappers of the hand-written CUDA kernels (`*_kernel.py`)."""
