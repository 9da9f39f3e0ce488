"""PyTorch + CUDA port of the RL-steered Faster R-CNN detector.

Counterpart of the JAX package `rlobjectdetection_tpu`, which stays the
reference: public functions keep its layouts (images `[B, H, W, 3]`, NHWC
feature maps, RPN maps `[B, H, W, 2A]` / `[B, H, W, 4A]`, rois `[B, R, 5]`),
so the two can be held against each other on the same inputs.

Every TPU kernel of the JAX package is a hand-written CUDA kernel here
(`csrc/*.cu`, built with nvcc for sm_90a at first use, see `ops/_build.py`).
Entry points run on the GPU unless the caller passes `device="cpu"`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
