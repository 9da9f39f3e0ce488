"""VGG-16's rounding-decided branches, for holding two runs of one train
step against each other (the kernels against their plain versions, the
port against the JAX package).

Where a 2×2 max-pool window's two largest inputs lie within rounding of
each other, the last bit of a conv sum decides which one takes the window's
gradient; where a conv output lies within rounding of 0, it decides whether
the ReLU passes it. Every conv below takes the difference: one such window
or gate moves a leaf's largest update by a few 1e-3. `record` notes one
run's decisions; `replay` has another run keep its own forward but take
those decisions: each pool sends a window's gradient to the recorded
element, and a conv3_1..conv5_3 output on the other side of 0 from the
recorded run's takes its sign (the value negated, the gradient
untouched). Blocks 1-2 take no gradient, so their decisions do not matter.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .vgg import VGG16_CFG, VGGBase

# the convs a train step differentiates (blocks 3-5)
TRAINED_CONVS = tuple(f"conv{b}_{i}" for b, n, _ in VGG16_CFG if b > 2 for i in range(1, n + 1))


def first_max_nhwc(x: np.ndarray) -> torch.Tensor:
    """Each 2×2/2 window's first largest element (window order (0,0),
    (0,1), (1,0), (1,1), the one XLA's and PyTorch's max-pool gradients
    take) of an NHWC array, as `max_pool2d`'s flat indices into each NCHW
    plane."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    win = x[:, :2 * h2, :2 * w2].reshape(b, h2, 2, w2, 2, c).transpose(0, 5, 1, 3, 2, 4)
    first = win.reshape(b, c, h2, w2, 4).argmax(-1)
    rows = 2 * np.arange(h2)[:, None] + first // 2
    return torch.from_numpy(rows * w + 2 * np.arange(w2)[None, :] + first % 2)


@contextlib.contextmanager
def _swapped(base: VGGBase, pool, conv_hook):
    base.pool = pool
    hooks = [getattr(base, n).register_forward_hook(conv_hook(n)) for n in TRAINED_CONVS]
    try:
        yield
    finally:
        del base.pool
        for h in hooks:
            h.remove()


def record(base: VGGBase, ties: dict):
    """Within the context, `base`'s forward fills `ties`: "pool" {channels:
    each window's argmax, as `max_pool2d` returns it} and "positive" {conv
    name: its output > 0}."""
    pools, positive = ties.setdefault("pool", {}), ties.setdefault("positive", {})

    def pool(x):
        out, idx = F.max_pool2d(x, 2, 2, return_indices=True)
        pools[x.shape[1]] = idx
        return out

    def conv_hook(name):
        return lambda m, inp, out: positive.__setitem__(name, (out > 0).detach())

    return _swapped(base, pool, conv_hook)


class _RoutedPool(torch.autograd.Function):
    """The 2×2/2 max-pool's own forward; the backward sends each window's
    gradient to `idx` (flat indices into each NCHW plane). `counts["routed"]`
    keeps the largest gap between a window's max and its value at `idx`,
    relative to the input's largest magnitude."""

    @staticmethod
    def forward(ctx, x, idx, counts):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        out = F.max_pool2d(x, 2, 2)
        n, c, h, w = x.shape
        at = x.reshape(n, c, h * w).gather(2, idx.reshape(n, c, -1))
        gap = (out.reshape(n, c, -1) - at).max() / x.abs().max().clamp_min(1e-30)
        counts["routed"] = max(counts["routed"], float(gap))
        return out

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        n, c, h, w = ctx.shape
        dx = grad.new_zeros((n, c, h * w)).scatter_(2, idx.reshape(n, c, -1),
                                                    grad.reshape(n, c, -1))
        return dx.reshape(n, c, h, w), None, None


def replay(base: VGGBase, ties: dict, counts: dict | None = None):
    """Within the context, `base`'s forward takes the decisions in `ties`
    (as `record` fills them) where its own would differ. `counts`, if given, gets the number of pools routed
    ("pools") and of conv outputs whose sign was flipped ("flipped"), and
    how far from its own decisions the run was taken, each relative to the
    layer's largest magnitude: the largest gap between a window's max and
    its value at the recorded element ("routed"), and the largest flipped
    output ("flipped_max"). Both stay at rounding size where only ties
    were decided apart."""
    counts = {} if counts is None else counts
    counts.update(pools=0, flipped=0, routed=0.0, flipped_max=0.0)

    def pool(x):
        counts["pools"] += 1
        return _RoutedPool.apply(x, ties["pool"][x.shape[1]].to(x.device), counts)

    def conv_hook(name):
        def hook(m, inp, out):
            flip = (out > 0) != ties["positive"][name].to(out.device)
            size = out.detach().abs()
            counts["flipped"] += int(flip.sum())
            counts["flipped_max"] = max(counts["flipped_max"], float(
                torch.where(flip, size, 0).max() / size.max().clamp_min(1e-30)))
            return out + torch.where(flip, -2 * out, 0).detach()
        return hook

    return _swapped(base, pool, conv_hook)
