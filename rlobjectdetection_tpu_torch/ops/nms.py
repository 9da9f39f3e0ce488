"""Greedy NMS with fixed-shape outputs (counterpart of
`rlobjectdetection_tpu/ops/nms.py`).

Same semantics as the JAX package: boxes sorted by descending score (stable,
so equal scores keep their input order), a box is suppressed iff a surviving
earlier box overlaps it with IoU > threshold (+1 width convention), and the
top survivors are compacted by a cumulative sum with zero padding. The keep
set equals the JAX one exactly: small problems (N <= 2·tile) compare
`inter > thr·union` over one N×N adjacency, larger ones compare the divided
IoU tile by tile, as the JAX small-mask and tiled paths do.

Within a tile the "suppresses" relation is a DAG in score order, so a Jacobi
iteration reaches its unique fixpoint, the sequential greedy result, in at
most the depth of the longest suppression chain. All functions take any
leading batch dimensions (the per-class NMS of post-processing runs the
classes as one batch). That loop is the op's plain body, which runs on CPU
tensors; on CUDA tensors the op is the bitmask kernel of `csrc/nms.cu`
(`ops/nms_kernel.py`), with no host read. The JAX package has no NMS
kernel: it retired both of its Pallas variants.
"""

from __future__ import annotations

import torch

from ..utils import tracing
from .boxes import _inter_union, bbox_overlaps

NEG_INF = -1e10


def _suppresses(a: torch.Tensor, b: torch.Tensor, thr: float, small: bool):
    """`[..., T, S]` bool: IoU(a_t, b_s) > thr, in the JAX path's own form."""
    if small:
        inter, union = _inter_union(a, b)
        return inter > thr * union
    return bbox_overlaps(a, b) > thr


def nms_sorted_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
                    tile_size: int = 256, max_keep: int | None = None) -> torch.Tensor:
    """Greedy keep-mask `[..., N]` for boxes `[..., N, 4]` already sorted by
    descending score; `valid` `[..., N]` marks the boxes that may be kept
    (an invalid box neither keeps nor suppresses). A box is suppressed by a
    kept earlier one whose IoU with it (+1 convention, f32) exceeds the
    threshold, compared as `inter > thr·union` for N <= 2·tile_size and as
    `inter / union > thr` above.

    Runs as the op `rlod::nms_sorted_mask` (`ops/library.py`), which
    `torch.export` keeps opaque: on CPU tensors its plain body
    `_nms_sorted_mask`, on CUDA tensors the kernel of `csrc/nms.cu`. With
    `max_keep` None the two give the same mask to the bit. With `max_keep`
    each lane's mask is the same up to and including its `max_keep`-th
    survivor, where the kernel stops that lane (False after it), while the
    body stops at a tile boundary once every lane has kept that many and
    may mark more after it; the first `max_keep` survivors, all that
    `nms_select` reads, are the same."""
    return torch.ops.rlod.nms_sorted_mask(boxes, valid, float(iou_threshold), int(tile_size),
                                          max_keep)


def _nms_sorted_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
                     tile_size: int, max_keep: int | None) -> torch.Tensor:
    """`nms_sorted_mask`'s body: Jacobi steps within a tile, tiles in score
    order, each step's convergence and each tile's stop read on the host.
    Runs in the span `model.nms` and counts those blocking reads to
    `nms.host_syncs`."""
    with tracing.span("model.nms"):
        n = boxes.shape[-2]
        small = n <= 2 * tile_size
        tile = max(n, 1) if small else tile_size
        keep = torch.zeros(valid.shape, dtype=torch.bool, device=boxes.device)
        syncs = 0
        for start in range(0, n, tile):
            end = min(start + tile, n)
            tb = boxes[..., start:end, :]
            tv = valid[..., start:end]
            t = end - start
            lower = torch.ones(t, t, dtype=torch.bool, device=boxes.device).tril(-1)
            adj = _suppresses(tb, tb, iou_threshold, small) & lower & tv[..., None, :]
            if start > 0:
                cross = _suppresses(tb, boxes[..., :start, :], iou_threshold, small)
                sup_prev = (cross & keep[..., None, :start]).any(-1)
            else:
                sup_prev = torch.zeros_like(tv)
            sup = sup_prev | adj.any(-1)
            while True:
                new = sup_prev | (adj & ~sup[..., None, :]).any(-1)
                syncs += 1
                if torch.equal(new, sup):
                    break
                sup = new
            keep[..., start:end] = tv & ~sup
            if max_keep is not None and end < n:
                syncs += 1
                if bool((keep.sum(-1) >= max_keep).all()):
                    break
        tracing.count("nms.host_syncs", syncs)
    return keep


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        valid: torch.Tensor | None = None, tile_size: int = 256,
        max_keep: int | None = None):
    """Greedy NMS on unsorted boxes `[..., N, 4]`, scores `[..., N]`.

    Returns (order, keep): `order` sorts by descending score (stable, like
    `jnp.argsort`), `keep` is the keep mask aligned to that order."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    skey = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-skey, dim=-1, stable=True)
    sboxes = torch.take_along_dim(boxes, order[..., None], dim=-2)
    svalid = torch.take_along_dim(valid, order, dim=-1)
    keep = nms_sorted_mask(sboxes, svalid, iou_threshold, tile_size=tile_size,
                           max_keep=max_keep)
    return order, keep


def nms_select(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_out: int, valid: torch.Tensor | None = None, tile_size: int = 256):
    """NMS, then the top `max_out` survivors in score order, zero-padded.

    Returns (sel_boxes `[..., max_out, 4]`, sel_scores `[..., max_out]`,
    sel_valid `[..., max_out]`). Survivors are already in score order, so the
    m-th output is the first index where cumsum(keep) reaches m+1."""
    order, keep = nms(boxes, scores, iou_threshold, valid=valid,
                      tile_size=tile_size, max_keep=max_out)
    n = keep.shape[-1]
    csum = keep.to(torch.int32).cumsum(-1, dtype=torch.int32)
    m = torch.arange(max_out, dtype=torch.int32, device=keep.device)
    want = (m + 1).expand(keep.shape[:-1] + (max_out,)).contiguous()
    top_idx = torch.searchsorted(csum.contiguous(), want).clamp_max(max(n - 1, 0))
    sel_valid = m < csum[..., -1:]
    sel_in_sorted = torch.take_along_dim(order, top_idx, dim=-1)
    sel_boxes = torch.take_along_dim(boxes, sel_in_sorted[..., None], dim=-2)
    sel_boxes = torch.where(sel_valid[..., None], sel_boxes, torch.zeros_like(sel_boxes))
    sel_scores = torch.take_along_dim(scores, sel_in_sorted, dim=-1)
    sel_scores = torch.where(sel_valid, sel_scores, torch.zeros_like(sel_scores))
    return sel_boxes, sel_scores, sel_valid
