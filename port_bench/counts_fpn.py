"""The FPN detector's yardstick of work, beside `counts.py`'s: analytic
FLOPs of its train step, and the operations and bytes of the multi-level
RoIAlignV2 ops (`rlod::roi_align_levels` and its backward) at a call's
input shapes, with their share of the roofline over a trace's calls.

Convolutions and fc layers count 2 FLOPs a multiply-add (`counts.py`'s
`conv_flops`). RoIAlignV2's operations count one bilinear sample a bin
(the least an adaptive grid takes: 4 multiply-adds, 8 f32 operations, a
channel), whatever grid the rois ask for; its bytes count each input read
once and each output written once (the backward writes all four levels'
gradients in full).
"""

from __future__ import annotations

import json
import math

from .counts import PEAK_BYTES, PEAK_F32, _item, _numel, _s2, conv_flops, stage_flops, trunk_parts

LEVEL_CHANNELS = (256, 512, 1024, 2048)     # C2..C5
FPN_CHANNELS, ANCHORS, HEAD_DIM, POOLED = 256, 3, 1024, 7


def fpn_parts(h: int, w: int) -> dict:
    """FLOPs an image of the trunk (conv1, layer1..layer4 on the whole map),
    the neck, the RPN head over P2..P6, on an h×w blob."""
    t = trunk_parts(h, w)
    hw = [t["layer1_hw"]]
    for _ in range(3):
        hw.append((_s2(hw[-1][0]), _s2(hw[-1][1])))
    p6 = (_s2(hw[3][0]), _s2(hw[3][1]))
    neck = sum(conv_flops(c, FPN_CHANNELS, 1, *s) + conv_flops(FPN_CHANNELS, FPN_CHANNELS, 3, *s)
               for c, s in zip(LEVEL_CHANNELS, hw))
    rpn = sum(conv_flops(FPN_CHANNELS, FPN_CHANNELS, 3, *s)
              + conv_flops(FPN_CHANNELS, 5 * ANCHORS, 1, *s) for s in hw + [p6])
    return {"conv1": t["conv1"], "layer1": t["layer1"], "layer2": t["layer2"],
            "layer3": t["layer3"], "layer4": stage_flops(1024, 512, 3, *hw[3]),
            "neck": neck, "rpn": rpn}


def box_head_flops(rois: int, num_classes: int) -> float:
    return rois * 2.0 * (FPN_CHANNELS * POOLED * POOLED * HEAD_DIM + HEAD_DIM * HEAD_DIM
                         + HEAD_DIM * 5 * num_classes)


def fpn_train_step_flops(batch: int, h: int, w: int, rois_per_image: int, num_classes: int,
                         fixed_blocks: int = 1) -> float:
    """Forward of every layer, backward (2× the forward) of the trained ones:
    layer(fixed_blocks+1)..layer4, the neck, the RPN and the box head."""
    p = fpn_parts(h, w)
    frozen = p["conv1"] + sum(p[f"layer{i}"] for i in range(1, fixed_blocks + 1))
    trained = (sum(p[f"layer{i}"] for i in range(fixed_blocks + 1, 5)) + p["neck"] + p["rpn"]
               + box_head_flops(rois_per_image, num_classes))
    return batch * (frozen + 3.0 * trained)


def roi_align_levels_work(shapes, dtypes):
    """(ops, bytes, peak) of `rlod::roi_align_levels(p2, p3, p4, p5, rois)`."""
    maps, rois = shapes[:4], shapes[4]
    r, c = int(rois[0]), int(maps[0][-1])
    ops = 8.0 * r * POOLED * POOLED * c
    nbytes = _item(dtypes[0]) * (sum(_numel(s) for s in maps) + r * POOLED * POOLED * c)
    return ops, nbytes + 4 * _numel(rois), PEAK_F32


def roi_align_levels_bwd_work(shapes, dtypes, feat_shapes):
    """(ops, bytes, peak) of `rlod::roi_align_levels_bwd(grad, rois,
    feat_shapes)`: the gradient and rois read, the four maps' gradients
    (`feat_shapes`, four (B, H, W, C)) written."""
    grad, rois = shapes[0], shapes[1]
    r, c = int(grad[0]), int(grad[-1])
    ops = 8.0 * r * POOLED * POOLED * c
    out = sum(math.prod(int(x) for x in s) for s in feat_shapes)
    return ops, _item(dtypes[0]) * (_numel(grad) + out) + 4 * _numel(rois), PEAK_F32


def _level_shapes(args: dict, forward_dims: list, i: int) -> list:
    """The four maps' shapes of a backward call: its concrete `feat_shapes`
    argument where the trace records it, else the matching forward call's."""
    concrete = args.get("Concrete Inputs") or []
    if len(concrete) > 2 and concrete[2]:
        flat = json.loads(concrete[2])
        return [flat[4 * k:4 * k + 4] for k in range(4)]
    return forward_dims[min(i, len(forward_dims) - 1)][:4]


def share(trace, op: str) -> float | None:
    """100 · Σ max(bytes / peak bytes, ops / peak ops) / Σ device seconds of
    the profiled calls of `op` (`rlod::roi_align_levels` or its `_bwd`).
    Raises when a call launched no device work; None without a trace or
    without a call of `op` (a program that has no such op)."""
    if trace is None:
        return None
    calls = trace.op_device_s(op)
    if not calls:
        return None
    forward = [a.get("Input Dims") for _, a in trace.op_device_s("rlod::roi_align_levels")]
    bound = device = 0.0
    for i, (secs, args) in enumerate(calls):
        if secs <= 0:
            raise RuntimeError(f"{op}: call {i} has no device time under it in the trace")
        dims, types = args.get("Input Dims"), args.get("Input type")
        if op.endswith("_bwd"):
            ops, nbytes, peak = roi_align_levels_bwd_work(dims, types,
                                                          _level_shapes(args, forward, i))
        else:
            ops, nbytes, peak = roi_align_levels_work(dims, types)
        bound += max(nbytes / PEAK_BYTES, ops / peak)
        device += secs
    return 100.0 * bound / device
