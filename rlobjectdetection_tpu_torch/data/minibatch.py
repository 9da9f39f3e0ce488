"""Minibatch assembly (copy of the rest of the JAX package's
`data/minibatch.py`; its image read, resize and pad live in `blob.py`).

Each image is read as BGR, flipped where its roidb entry says so, mean
subtracted and resized by its shortest side to a scale drawn from the list;
its gt boxes are every foreground entry scaled to the resized image; the
images of a batch are zero-padded to a common size rounded up to a
multiple of 32.
"""

from __future__ import annotations

import numpy as np

from .blob import PIXEL_MEANS_BGR, pad_shape, prep_im_for_blob, read_image_bgr


def im_list_to_blob(ims, multiple: int = 32) -> np.ndarray:
    """Zero-pad a list of `[H, W, 3]` images to their common max shape,
    rounded up to `multiple`: `[N, H, W, 3]` float32."""
    max_shape = np.array([im.shape[:2] for im in ims]).max(axis=0)
    ph, pw = pad_shape(int(max_shape[0]), int(max_shape[1]), multiple)
    blob = np.zeros((len(ims), ph, pw, 3), dtype=np.float32)
    for i, im in enumerate(ims):
        blob[i, : im.shape[0], : im.shape[1], :] = im
    return blob


def load_entry_image_gt(entry, scales, rng):
    """One roidb entry's image and gt: read, flip, draw a scale, mean
    subtract and resize; gt from the foreground classes scaled to the
    resized image. Returns (im, gt_boxes `[G, 5]`, im_scale)."""
    im = read_image_bgr(entry["image"])
    if entry.get("flipped", False):
        im = im[:, ::-1, :]
    scale = scales[rng.randint(0, len(scales))]
    im, im_scale = prep_im_for_blob(im, PIXEL_MEANS_BGR, scale)
    return im, gt_from_entry(entry, im_scale), im_scale


def gt_from_entry(entry, im_scale: float) -> np.ndarray:
    """gt boxes `[G, 5]` (x1, y1, x2, y2, cls): every non-background entry,
    COCO crowd boxes included (USE_ALL_GT upstream), scaled by im_scale."""
    gt_inds = np.where(entry["gt_classes"] != 0)[0]
    gt_boxes = np.zeros((len(gt_inds), 5), dtype=np.float32)
    gt_boxes[:, :4] = entry["boxes"][gt_inds, :].astype(np.float32) * im_scale
    gt_boxes[:, 4] = entry["gt_classes"][gt_inds]
    return gt_boxes


def get_minibatch(roidb_entries, scales, multiple: int = 32,
                  rng: np.random.RandomState | None = None):
    """A minibatch of roidb entries, a scale drawn for each image.

    Returns dict(data `[N, H, W, 3]`, im_info `[N, 3]` (h, w, scale),
    gt_boxes: a list of `[G, 5]`)."""
    rng = rng or np.random
    ims, im_scales, gt_list = [], [], []
    for entry in roidb_entries:
        im, gt_boxes, im_scale = load_entry_image_gt(entry, scales, rng)
        ims.append(im)
        im_scales.append(im_scale)
        gt_list.append(gt_boxes)
    im_info = np.array([[im.shape[0], im.shape[1], s] for im, s in zip(ims, im_scales)],
                       dtype=np.float32)
    return {"data": im_list_to_blob(ims, multiple), "im_info": im_info, "gt_boxes": gt_list}


def pad_gt_boxes(gt_list, max_num: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-image gt boxes padded with zero rows to `[N, max_num, 5]`, and
    the counts `[N]` (at most max_num each)."""
    n = len(gt_list)
    out = np.zeros((n, max_num, 5), dtype=np.float32)
    num = np.zeros((n,), dtype=np.int32)
    for i, g in enumerate(gt_list):
        k = min(len(g), max_num)
        out[i, :k] = g[:k]
        num[i] = k
    return out, num
