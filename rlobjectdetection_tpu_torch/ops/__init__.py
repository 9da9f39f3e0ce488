"""Tensor ops of the port: box geometry, anchors, NMS, RoIAlign, the frozen-BN
fold, and the wrappers of the hand-written CUDA kernels (`*_kernel.py`),
registered as `torch.library` ops (`library.py`) when the package is
imported."""

from . import library  # noqa: F401  (registers the rlod:: ops)
