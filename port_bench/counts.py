"""The benchmark's yardstick of work: analytic FLOPs of the detector's train
step and of a served request, and the operations and bytes of each
`rlod::` op's work at its input shapes; the H100's published peaks; and the
map from the kernels' symbol names to the op that launches them (used only
to label the breakdown: device time is attributed to the enclosing op).

A convolution of c_in → c_out with a k×k window at an output of h×w costs
2·c_in·k²·c_out·h·w FLOPs an image. Bytes count each input read once and
each output written once, whatever a kernel reads again.
"""

from __future__ import annotations

import math
import subprocess

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16 = 989e12
PEAK_F32 = 67e12            # float32 outside the tensor cores (TF32 off)
PEAK_BYTES = 3.35e12

BLOCKS = {101: (3, 4, 23, 3)}

# kernel symbol (a substring of the profiler's name) → the op that launches it
KERNEL_OPS = {
    "stem_kernel": "rlod::stem",
    "layer1_kernel": "rlod::layer1",
    "bottleneck_kernel": "rlod::layer1",
    "bottleneck_wgmma": "rlod::res_stage",
    "bottleneck_fma": "rlod::res_stage",
    "res_stage": "rlod::res_stage",
    "roi_align_avg_bwd": "rlod::roi_align_avg_bwd",
    "roi_align_bwd": "rlod::roi_align_avg_bwd",
    "roi_align_avg": "rlod::roi_align_avg",
    "vgg_block1": "rlod::vgg_block1",
}


def kernel_op(name: str) -> str | None:
    for sym, op in KERNEL_OPS.items():
        if sym in name:
            return op
    return None


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def conv_flops(cin: int, cout: int, k: int, h: int, w: int) -> float:
    return 2.0 * cin * k * k * cout * h * w


def _s2(x: int) -> int:
    """Output size of a 1×1 stride-2 convolution (no padding)."""
    return (x - 1) // 2 + 1


def stage_flops(cin: int, planes: int, blocks: int, h: int, w: int) -> float:
    """A bottleneck stage whose blocks run at h×w (after any stride)."""
    f = 0.0
    for i in range(blocks):
        c = cin if i == 0 else planes * 4
        f += (conv_flops(c, planes, 1, h, w) + conv_flops(planes, planes, 3, h, w)
              + conv_flops(planes, planes * 4, 1, h, w))
        if i == 0:
            f += conv_flops(cin, planes * 4, 1, h, w)
    return f


def trunk_parts(h: int, w: int, layers: int = 101) -> dict:
    """FLOPs an image of conv1 (+ pool), layer1, layer2, layer3 and the RPN
    on an h×w blob, and the feature map's size."""
    b = BLOCKS[layers]
    h1, w1 = (h - 1) // 2 + 1, (w - 1) // 2 + 1                 # 7×7/2, pad 3
    hp, wp = math.ceil((h1 - 3) / 2) + 1, math.ceil((w1 - 3) / 2) + 1
    h2, w2 = _s2(hp), _s2(wp)
    h3, w3 = _s2(h2), _s2(w2)
    return {"conv1": conv_flops(3, 64, 7, h1, w1),
            "layer1": stage_flops(64, 64, b[0], hp, wp),
            "layer2": stage_flops(256, 128, b[1], h2, w2),
            "layer3": stage_flops(512, 256, b[2], h3, w3),
            "rpn": conv_flops(1024, 512, 3, h3, w3) + conv_flops(512, 72, 1, h3, w3),
            "feat_hw": (h3, w3), "layer1_hw": (hp, wp)}


def head_flops(rois: int, num_classes: int, layers: int = 101, pooled: int = 7) -> float:
    """layer4 (stride 2: 4×4 from 7×7) and the classifiers over `rois`."""
    s = _s2(pooled)
    return rois * (stage_flops(1024, 512, BLOCKS[layers][3], s, s)
                   + 2.0 * 2048 * num_classes * 5)


def train_step_flops(batch: int, h: int, w: int, rois_per_image: int, num_classes: int,
                     fixed_blocks: int = 1) -> float:
    """Forward of every layer, backward (data and weight gradients, 2× the
    forward) of the trained ones: layer(fixed_blocks+1)..layer3, RPN, head."""
    t = trunk_parts(h, w)
    fwd_frozen = t["conv1"] + sum(t[f"layer{i}"] for i in range(1, fixed_blocks + 1))
    trained = (sum(t[f"layer{i}"] for i in range(fixed_blocks + 1, 4)) + t["rpn"]
               + head_flops(rois_per_image, num_classes))
    return batch * (fwd_frozen + 3.0 * trained)


def serve_flops(h: int, w: int, rois: int, num_classes: int) -> float:
    t = trunk_parts(h, w)
    return (t["conv1"] + t["layer1"] + t["layer2"] + t["layer3"] + t["rpn"]
            + head_flops(rois, num_classes))


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def _item(dtype: str) -> int:
    return {"c10::BFloat16": 2, "BFloat16": 2, "c10::Half": 2, "Half": 2, "float": 4,
            "Float": 4, "double": 8, "long": 8, "int": 4, "bool": 1}.get(dtype, 4)


def roi_align_avg_bwd_work(shapes, dtypes, feat_shape, pooled: int = 7):
    """(ops, bytes, peak FLOP/s) of `rlod::roi_align_avg_bwd(grad [R, P, P, C],
    rois [R, 5], feat_shape, scale)`: 4 ops a pooled cell for the 2×2 mean's
    share and 8 a sample (its weights times the gradient into four corners)
    at all (P+1)² samples (a sample outside the map costs its test alone:
    the count is of the most these shapes need); bytes: the gradient and
    the rois read, the feature gradient `feat_shape` written. The sums run
    in float32 on the CUDA cores."""
    r, p, _, c = (int(s) for s in shapes[0])
    a = p + 1
    ops = c * r * (8.0 * a * a + 4.0 * p * p)
    item = _item(dtypes[0])
    return ops, item * (_numel(shapes[0]) + _numel(feat_shape)) + 4 * _numel(shapes[1]), \
        PEAK_F32


def layer1_work(shapes, dtypes):
    """`rlod::layer1(x [B, H, W, 64], packs, dtype)`: its three bottlenecks
    at H×W; bytes: x, the weights and the `[B, H, W, 256]` output."""
    b, h, w, _ = (int(s) for s in shapes[0])
    item = _item(dtypes[0])
    weights = stage_flops(64, 64, 3, 1, 1) / 2.0
    ops = b * stage_flops(64, 64, 3, h, w)
    return ops, item * (b * h * w * (64 + 256) + weights), PEAK_BF16


def res_stage_work(shapes, dtypes):
    """`rlod::res_stage(x [B, H, W, Cin], packs, dtype)` at the stage's
    output grid H×W (the stride-2 entry reads the even-coordinate grid):
    layer2 for Cin 256, layer3 for Cin 512."""
    b, h, w, cin = (int(s) for s in shapes[0])
    planes, blocks = {256: (128, 4), 512: (256, 23)}[cin]
    item = _item(dtypes[0])
    ops = b * stage_flops(cin, planes, blocks, h, w)
    weights = stage_flops(cin, planes, blocks, 1, 1) / 2.0
    return ops, item * (b * h * w * (cin + planes * 4)) + 4 * weights, \
        (PEAK_F32 if item == 4 else PEAK_BF16)


OP_WORK = {"rlod::roi_align_avg_bwd": roi_align_avg_bwd_work,
           "rlod::layer1": layer1_work,
           "rlod::res_stage": res_stage_work}


def rl_step_flops(batch: int, h: int, w: int, rois: int, num_acts: int = 56) -> float:
    """The RL net's train step: the frozen trunk's forward at the batch's
    canvas, and forward and backward (3× the forward) of layer4 at stride
    1 (7×7), fc8 and fc over every detection slot of the batch."""
    t = trunk_parts(h, w)
    trunk = t["conv1"] + t["layer1"] + t["layer2"] + t["layer3"]
    head = (stage_flops(1024, 512, BLOCKS[101][3], 7, 7)
            + 2.0 * 2048 * 4096 + 2.0 * 4096 * num_acts)
    return batch * trunk + 3.0 * rois * head
