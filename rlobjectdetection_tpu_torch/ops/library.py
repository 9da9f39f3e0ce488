"""The port's kernels as `torch.library` custom ops, namespace `rlod`.

Each op takes the kernel's packed operands (packed weights as `Tensor` or
`Tensor?[]`) and has two implementations, chosen by its input's device:
on a CUDA tensor the hand-written kernel (`csrc/*.cu` through the ctypes
launches of `ops/*_kernel.py`), on a CPU tensor the plain PyTorch version
of the same arithmetic. A `register_fake` gives each output's shape and
dtype, so `torch.export` traces a model through the ops as opaque calls
and an exported program launches the same kernels. `rlod::roi_align_avg`
carries its backward (`rlod::roi_align_avg_bwd`, a kernel too).
`rlod::nms_sorted_mask` is the greedy NMS of `ops/nms.py`: on a CUDA tensor
the bitmask kernel of `csrc/nms.cu` (`ops/nms_kernel.py`), on a CPU tensor
the op's plain body, Jacobi sweeps that wait on the host between steps.
`rlod::roi_align_levels` is the FPN detector's multi-level RoIAlignV2
(`ops/roi_align_levels.py`), with its backward `rlod::roi_align_levels_bwd`.
`rlod::frozen_bn_act` is a ResNet bottleneck's frozen-BN epilogue (the BN
affine, the residual and the ReLU; `ops/frozen_bn_act.py`), with its
backward `rlod::frozen_bn_act_bwd`: on a CUDA tensor the kernels of
`csrc/frozen_bn_act.cu`, on a CPU tensor the modules' arithmetic.
`rlod::image_blob` builds a served image's blob (`ops/image_blob.py`): on
a CUDA tensor `csrc/image_blob.cu`, on a CPU tensor the numpy resize's
arithmetic in PyTorch.

Importing this module registers the ops; it imports no model code, so a
program exported with the ops replays after `import
rlobjectdetection_tpu_torch.ops.library` alone. The kernel wrappers
(`fused_stem`, `fused_layer1`, `fused_res_stage`, `fused_vgg_block1`,
`roi_align_avg`; `ops/nms.py::nms_sorted_mask`) call these ops, and each
kernel's launch count lives on its wrapper as before (the NMS's on
`nms_kernel.launch_nms`).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import (layer1_kernel, nms_kernel, res_stage_kernel, roi_align_kernel, stem_kernel,
               vgg_block1_kernel)
from . import frozen_bn_act as fba
from . import image_blob as ib
from . import roi_align_levels as levels
from .nms import _nms_sorted_mask
from .res_stage_kernel import blocks_of
from .vgg_block1_kernel import VGG_KEYS

# each kernel's wrapper, which counts its launches (`.launches`)
WRAPPERS = {"stem": stem_kernel.fused_stem, "layer1": layer1_kernel.fused_layer1,
            "roi_align_avg": roi_align_kernel.roi_align_avg,
            "roi_align_avg_bwd": roi_align_kernel.roi_align_avg_bwd,
            "vgg_block1": vgg_block1_kernel.fused_vgg_block1,
            "res_stage": res_stage_kernel.fused_res_stage,
            "nms_sorted_mask": nms_kernel.launch_nms,
            "roi_align_levels": levels.roi_align_levels,
            "roi_align_levels_bwd": levels.roi_align_levels_bwd,
            "frozen_bn_act": fba.launch_frozen_bn_act,
            "frozen_bn_act_bwd": fba.launch_frozen_bn_act_bwd,
            "image_blob": ib.launch_image_blob}


# -- the stem ------------------------------------------------------------------


@torch.library.custom_op("rlod::stem", mutates_args=(), device_types="cpu")
def stem(x: torch.Tensor, w: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    return stem_kernel.stem_plain_packed(x, (w, mul, add), dtype)


@stem.register_kernel("cuda")
def _(x, w, mul, add, dtype):
    return stem_kernel.launch_stem(x, (w, mul, add), dtype)


@stem.register_fake
def _(x, w, mul, add, dtype):
    b, h, wd, _ = x.shape
    _, _, ph, pw = stem_kernel.stem_out_shapes(h, wd)
    return x.new_empty((b, ph, pw, 64), dtype=dtype)


# -- layer1 and the residual stage ---------------------------------------------


@torch.library.custom_op("rlod::layer1", mutates_args=(), device_types="cpu")
def layer1(x: torch.Tensor, packs: List[Optional[torch.Tensor]],
           dtype: torch.dtype) -> torch.Tensor:
    return layer1_kernel.layer1_plain(x, blocks_of(packs), dtype)


@layer1.register_kernel("cuda")
def _(x, packs, dtype):
    return layer1_kernel.launch_layer1(x, blocks_of(packs), dtype)


@layer1.register_fake
def _(x, packs, dtype):
    return x.new_empty((*x.shape[:3], 256), dtype=dtype)


@torch.library.custom_op("rlod::res_stage", mutates_args=(), device_types="cpu")
def res_stage(x: torch.Tensor, packs: List[Optional[torch.Tensor]],
              dtype: torch.dtype) -> torch.Tensor:
    return res_stage_kernel.res_stage_plain(x, blocks_of(packs), dtype)


@res_stage.register_kernel("cuda")
def _(x, packs, dtype):
    return res_stage_kernel.launch_res_stage(x, blocks_of(packs), dtype)


@res_stage.register_fake
def _(x, packs, dtype):
    return x.new_empty((*x.shape[:3], 4 * packs[0].shape[0]), dtype=dtype)


# -- VGG-16 block 1 ------------------------------------------------------------


@torch.library.custom_op("rlod::vgg_block1", mutates_args=(), device_types="cpu")
def vgg_block1(x: torch.Tensor, packs: List[Optional[torch.Tensor]],
               dtype: torch.dtype) -> torch.Tensor:
    return vgg_block1_kernel.vgg_block1_plain_packed(x, dict(zip(VGG_KEYS, packs)), dtype)


@vgg_block1.register_kernel("cuda")
def _(x, packs, dtype):
    return vgg_block1_kernel.launch_vgg_block1(x, dict(zip(VGG_KEYS, packs)), dtype)


@vgg_block1.register_fake
def _(x, packs, dtype):
    b, h, w, _ = x.shape
    return x.new_empty((b, h // 2, w // 2, 64), dtype=dtype)


# -- RoIAlignAvg, forward and backward ---------------------------------------------


@torch.library.custom_op("rlod::roi_align_avg", mutates_args=())
def roi_align_avg(features: torch.Tensor, rois: torch.Tensor, pooled_size: int,
                  spatial_scale: float) -> torch.Tensor:
    return roi_align_kernel._forward(features, rois, pooled_size, spatial_scale)


@roi_align_avg.register_fake
def _(features, rois, pooled_size, spatial_scale):
    return features.new_empty((rois.shape[0], pooled_size, pooled_size, features.shape[-1]))


@torch.library.custom_op("rlod::roi_align_avg_bwd", mutates_args=())
def roi_align_avg_bwd(grad: torch.Tensor, rois: torch.Tensor, feat_shape: List[int],
                      spatial_scale: float) -> torch.Tensor:
    return roi_align_kernel.roi_align_avg_bwd(grad, rois, tuple(feat_shape), spatial_scale)


@roi_align_avg_bwd.register_fake
def _(grad, rois, feat_shape, spatial_scale):
    return grad.new_empty(tuple(feat_shape))


def _roi_setup(ctx, inputs, output):
    features, rois, _, spatial_scale = inputs
    ctx.save_for_backward(rois)
    ctx.feat_shape = list(features.shape)
    ctx.spatial_scale = spatial_scale


def _roi_backward(ctx, grad):
    (rois,) = ctx.saved_tensors
    dfeat = roi_align_avg_bwd(grad.contiguous(), rois, ctx.feat_shape, ctx.spatial_scale)
    return dfeat, None, None, None


roi_align_avg.register_autograd(_roi_backward, setup_context=_roi_setup)


# -- multi-level RoIAlignV2 (the FPN box head's pooler), forward and backward -----


@torch.library.custom_op("rlod::roi_align_levels", mutates_args=())
def roi_align_levels(p2: torch.Tensor, p3: torch.Tensor, p4: torch.Tensor, p5: torch.Tensor,
                     rois: torch.Tensor) -> torch.Tensor:
    return levels._forward(p2, p3, p4, p5, rois)


@roi_align_levels.register_fake
def _(p2, p3, p4, p5, rois):
    return p2.new_empty((rois.shape[0], levels.POOLED, levels.POOLED, p2.shape[-1]))


@torch.library.custom_op("rlod::roi_align_levels_bwd", mutates_args=())
def roi_align_levels_bwd(grad: torch.Tensor, rois: torch.Tensor, feat_shapes: List[int]
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return levels.roi_align_levels_bwd(grad, rois, feat_shapes)


@roi_align_levels_bwd.register_fake
def _(grad, rois, feat_shapes):
    return tuple(grad.new_empty(s) for s in levels._level_shapes(feat_shapes))


def _levels_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[4])
    ctx.feat_shapes = [int(x) for f in inputs[:4] for x in f.shape]


def _levels_backward(ctx, grad):
    (rois,) = ctx.saved_tensors
    return (*roi_align_levels_bwd(grad.contiguous(), rois, ctx.feat_shapes), None)


roi_align_levels.register_autograd(_levels_backward, setup_context=_levels_setup)


# -- the frozen BN's epilogue in a bottleneck, forward and backward ----------------


@torch.library.custom_op("rlod::frozen_bn_act", mutates_args=(), device_types="cpu")
def frozen_bn_act(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                  r: Optional[torch.Tensor], mul_r: Optional[torch.Tensor],
                  add_r: Optional[torch.Tensor]) -> torch.Tensor:
    return fba.frozen_bn_act_plain(x, mul, add, r, mul_r, add_r)


@frozen_bn_act.register_kernel("cuda")
def _(x, mul, add, r, mul_r, add_r):
    return fba.launch_frozen_bn_act(x, mul, add, r, mul_r, add_r)


@frozen_bn_act.register_fake
def _(x, mul, add, r, mul_r, add_r):
    return torch.empty_like(x, memory_format=torch.channels_last)


@torch.library.custom_op("rlod::frozen_bn_act_bwd", mutates_args=(), device_types="cpu")
def frozen_bn_act_bwd(g: torch.Tensor, y: torch.Tensor, mul: torch.Tensor,
                      mul_r: Optional[torch.Tensor], residual: bool) -> List[torch.Tensor]:
    return fba.frozen_bn_act_plain_bwd(g, y, mul, mul_r, residual)


@frozen_bn_act_bwd.register_kernel("cuda")
def _(g, y, mul, mul_r, residual):
    return fba.launch_frozen_bn_act_bwd(g, y, mul, mul_r, residual)


@frozen_bn_act_bwd.register_fake
def _(g, y, mul, mul_r, residual):
    return [torch.empty_like(y, memory_format=torch.channels_last)
            for _ in range(2 if residual else 1)]


def _bn_act_setup(ctx, inputs, output):
    _, mul, _, r, mul_r, _ = inputs
    ctx.save_for_backward(output, mul, mul_r)
    ctx.residual = r is not None


def _bn_act_backward(ctx, grad):
    y, mul, mul_r = ctx.saved_tensors
    want_r = ctx.residual and ctx.needs_input_grad[3]
    grads = frozen_bn_act_bwd(grad, y, mul, mul_r, want_r)
    return grads[0], None, None, grads[1] if want_r else None, None, None


frozen_bn_act.register_autograd(_bn_act_backward, setup_context=_bn_act_setup)


# -- a served image's blob -----------------------------------------------------------


@torch.library.custom_op("rlod::image_blob", mutates_args=(), device_types="cpu")
def image_blob(image: torch.Tensor, means: torch.Tensor, scale: float, size: List[int],
               pad: List[int]) -> torch.Tensor:
    return ib.image_blob_plain(image, means, scale, size, pad)


@image_blob.register_kernel("cuda")
def _(image, means, scale, size, pad):
    return ib.launch_image_blob(image, means, scale, size, pad)


@image_blob.register_fake
def _(image, means, scale, size, pad):
    return image.new_empty((1, *pad, 3), dtype=torch.float32)


# -- NMS -------------------------------------------------------------------------


@torch.library.custom_op("rlod::nms_sorted_mask", mutates_args=())
def nms_sorted_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
                    tile_size: int, max_keep: Optional[int]) -> torch.Tensor:
    return _nms_sorted_mask(boxes, valid, iou_threshold, tile_size, max_keep)


@nms_sorted_mask.register_kernel("cuda")
def _(boxes, valid, iou_threshold, tile_size, max_keep):
    return nms_kernel.launch_nms(boxes, valid, iou_threshold, tile_size, max_keep)


@nms_sorted_mask.register_fake
def _(boxes, valid, iou_threshold, tile_size, max_keep):
    return valid.new_empty(valid.shape, dtype=torch.bool)
