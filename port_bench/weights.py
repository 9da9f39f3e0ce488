"""The detector's weights, made on the device from the seed in a few large
calls: lecun-normal trunk and head convolutions, normal(0.01) RPN convs
and class scores, normal(0.001) box regression, zero biases (the
published initialisers), then every frozen BN's mean and variance taken
from its input on a calibration blob by the reference's float32 forward,
and each residual branch's last BN scaled by `residual_scale`, as a
pretrained trunk's branches are small against their identity path. With
unit BNs the features grow through the 33 blocks and SGD at lr 0.01 turns
the losses to NaN within an epoch. The seed is the configuration's
`weights_seed`, not the run's: weights drawn anew for every run changed
how much work the RPN's NMS does (5-19 ms a request) and so the cells'
rates from seed to seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import detector, loader
from .traffic import gen


def _std(name: str, shape) -> float:
    if name.startswith(("rpn.", "RCNN_cls_score")):
        return 0.01
    if name.startswith("RCNN_bbox_pred"):
        return 0.001
    return math.sqrt(1.0 / math.prod(shape[1:]))


def calibration_blob(c: dict, seed: int, device: str):
    """A 640×480 image of the traffic's kind drawn from the seed, as the
    test-time blob: (data `[1, H, W, 3]`, im_info `[1, 3]`) on `device`."""
    rng = np.random.default_rng(int(seed))
    boxes = gen.boxes_for(rng, 7, 640, 480, {"max_area_share": 0.4})
    im = gen.draw(rng, 640, 480, boxes, rng.integers(1, c["num_classes"], len(boxes)))
    blob = loader.test_blob(im[:, :, ::-1].astype(np.float32), c["test"]["scales"][0])
    return [torch.from_numpy(a).to(device) for a in blob]


def make(c: dict, dev: str) -> dict:
    """{name: float32 tensor on `dev`} from the configuration's
    `weights_seed`: one model for every run's seed, as a deployment serves
    (and fine-tunes) one model while its traffic varies."""
    seed = c["weights_seed"]
    calib_data, calib_info = calibration_blob(c, seed, dev)
    shapes = detector.param_shapes(c["num_classes"], len(c["anchor_scales"])
                                   * len(c["anchor_ratios"]))
    g = torch.Generator(device=dev).manual_seed(int(seed))
    drawn = [n for n, s in shapes.items() if n.endswith(".weight")]
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

    with full_f32():
        detector.detect_forward(p, calib_data, calib_info, c, hook=calibrate)
    for n in p:
        if n.endswith(("bn3.scale", "bn3.bias")):
            p[n] = p[n] * c["residual_scale"]
    return {n: t.contiguous() for n, t in p.items()}


class full_f32:
    """float32 matrix products and convolutions without TF32, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
