"""The FPN detector's weights, made on the device from the configuration's
`weights_seed` as `weights.py` makes the C4 detector's: one draw of
normal numbers cut into every weight, scaled to the published initialisers
(lecun-normal trunk, neck and box-head fc layers, normal(0.01) RPN convs
and class scores, normal(0.001) box regression, zero biases), every frozen
BN's mean and variance taken from its input on the calibration blob by the
reference's float32 trunk, and each residual branch's last BN scaled by
`residual_scale`."""

from __future__ import annotations

import math

import torch

from .reference import fpn
from .weights import _std, calibration_blob, full_f32


def make(c: dict, dev: str, calib=None) -> dict:
    """{name: float32 tensor on `dev`}; `calib` (data `[1, H, W, 3]`) replaces
    the calibration blob drawn from the seed."""
    seed = c["weights_seed"]
    calib_data = calibration_blob(c, seed, dev)[0] if calib is None else calib.to(dev)
    shapes = fpn.param_shapes(c["num_classes"], len(c["anchor_ratios"]))
    g = torch.Generator(device=dev).manual_seed(int(seed))
    drawn = [n for n in shapes if n.endswith(".weight")]
    flat = torch.randn(sum(math.prod(shapes[n]) for n in drawn), generator=g, device=dev)
    p, at = {}, 0
    for n in drawn:
        k = math.prod(shapes[n])
        p[n] = flat[at:at + k].view(shapes[n]) * _std(n, shapes[n])
        at += k
    for n, s in shapes.items():
        if n not in p:
            p[n] = (torch.ones if n.endswith((".scale", ".var")) else torch.zeros)(s, device=dev)

    def calibrate(name, x):
        p[name + ".mean"] = x.double().mean(dim=(0, 2, 3)).float()
        p[name + ".var"] = x.double().var(dim=(0, 2, 3)).float()

    with full_f32(), torch.no_grad():
        fpn.trunk(p, calib_data, hook=calibrate)
    for n in p:
        if n.endswith(("bn3.scale", "bn3.bias")):
            p[n] = p[n] * c["residual_scale"]
    return {n: t.contiguous() for n, t in p.items()}
