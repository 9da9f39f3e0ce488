"""The forward-only kernel wrappers raise where they would cut a gradient;
RoIAlignAvg, which has a backward kernel, passes the gradient.

`fused_stem`, `fused_layer1` and `fused_vgg_block1` have no backward
(neither has the JAX package's Pallas kernels, whose custom_vjps raise). On
the CPU each runs its plain version, which autograd could differentiate; the
wrapper must not, or the CPU would give a gradient the card cannot. So, on
the CPU: each raises when grad is enabled and its input, or a weight it
reads, requires grad. `roi_align_avg` instead gives the features' gradient
of its plain backward (`roi_align.roi_align_avg_backward`, what the CPU
runs in place of the backward kernel). Under `torch.no_grad()`, and with
frozen weights and a plain input, every wrapper returns exactly its plain
result.
"""

import numpy as np
import pytest
import torch

from rlobjectdetection_tpu_torch.models.backbones.resnet import ResLayer
from rlobjectdetection_tpu_torch.ops import (layer1_kernel, roi_align, roi_align_kernel,
                                             stem_kernel, vgg_block1_kernel)
import torch_threads  # noqa: F401  (xdist workers share the cores)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _roi_align(rng):
    feats = _t(rng.randn(2, 6, 7, 8))
    rois = _t([[0, 2, 3, 60, 50], [1, -8, 4, 30, 90], [1, 10, 10, 40, 20]])
    return dict(x=feats, weights=[],
                run=lambda x, w: roi_align_kernel.roi_align_avg(x, rois),
                plain=lambda x, w: roi_align.roi_align_avg(x, rois))


def _stem(rng):
    w = [_t(rng.randn(64, 3, 7, 7) * 0.1), _t(rng.rand(64) + 0.5), _t(rng.randn(64)),
         _t(rng.randn(64) * 0.2), _t(rng.rand(64) + 0.3)]
    return dict(x=_t(rng.randn(1, 13, 15, 3)), weights=w,
                run=lambda x, w: stem_kernel.fused_stem(x, *w, dtype=torch.float32),
                plain=lambda x, w: stem_kernel.stem_plain(x, *w, dtype=torch.float32))


def _layer1(rng):
    layer = ResLayer(64, 64, 3, 1).requires_grad_(False)
    with torch.no_grad():
        for name, buf in layer.named_buffers():
            r = rng.randn(*buf.shape).astype(np.float32) * 0.1
            buf.copy_(_t(np.abs(r) + 0.5 if name.endswith(("scale", "var")) else r))
    plain = lambda x, w: layer1_kernel.layer1_plain(
        x, layer1_kernel.pack_layer1(layer, torch.float32), torch.float32)
    return dict(x=_t(np.abs(rng.randn(1, 5, 6, 64))), weights=list(layer.parameters()),
                run=lambda x, w: layer1_kernel.fused_layer1(x, layer, dtype=torch.float32),
                plain=plain)


def _vgg_block1(rng):
    w = [_t(rng.randn(64, 3, 3, 3) * 0.2), _t(rng.randn(64)),
         _t(rng.randn(64, 64, 3, 3) * 0.05), _t(rng.randn(64))]
    return dict(x=_t(rng.randn(1, 8, 10, 3) * 3), weights=w,
                run=lambda x, w: vgg_block1_kernel.fused_vgg_block1(x, *w, dtype=torch.float32),
                plain=lambda x, w: vgg_block1_kernel.vgg_block1_plain(x, *w,
                                                                      dtype=torch.float32))


OPS = {"roi_align_avg": _roi_align, "fused_stem": _stem, "fused_layer1": _layer1,
       "fused_vgg_block1": _vgg_block1}


@pytest.mark.parametrize("op", [op for op in OPS if op != "roi_align_avg"])
def test_raises_when_the_input_requires_grad(op):
    case = OPS[op](np.random.RandomState(1))
    x = case["x"].requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{op} is forward-only"):
        case["run"](x, case["weights"])


def test_roi_align_avg_passes_the_gradient():
    """Features that require grad get their gradient: exactly the plain
    backward's, for rois partly outside the map on two images."""
    case = OPS["roi_align_avg"](np.random.RandomState(1))
    x = case["x"].requires_grad_(True)
    out = case["run"](x, case["weights"])
    assert out.requires_grad and torch.equal(out.detach(), case["plain"](x.detach(), []))
    g = torch.from_numpy(np.random.RandomState(5).randn(*out.shape).astype(np.float32))
    out.backward(g)
    rois = _t([[0, 2, 3, 60, 50], [1, -8, 4, 30, 90], [1, 10, 10, 40, 20]])
    want = roi_align.roi_align_avg_backward(g, rois, tuple(x.shape), torch.float32)
    assert torch.equal(x.grad, want) and want.abs().sum() > 0


@pytest.mark.parametrize("op", [op for op in OPS if op != "roi_align_avg"])
def test_raises_when_a_weight_requires_grad(op):
    """RoIAlignAvg reads no weight; its rois are coordinates."""
    case = OPS[op](np.random.RandomState(2))
    case["weights"][-1].requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{op} is forward-only"):
        case["run"](case["x"], case["weights"])


@pytest.mark.parametrize("op", OPS)
def test_returns_the_plain_result_under_no_grad(op):
    case = OPS[op](np.random.RandomState(3))
    x = case["x"].requires_grad_(True)
    for w in case["weights"]:
        w.requires_grad_(True)
    with torch.no_grad():
        got = case["run"](x, case["weights"])
        want = case["plain"](x, case["weights"])
    assert not got.requires_grad
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", OPS)
def test_returns_the_plain_result_with_frozen_weights(op):
    """Grad enabled, nothing requires grad: how every ported path calls it."""
    case = OPS[op](np.random.RandomState(4))
    assert torch.is_grad_enabled()
    got = case["run"](case["x"], case["weights"])
    assert not got.requires_grad
    assert torch.equal(got, case["plain"](case["x"], case["weights"]))
