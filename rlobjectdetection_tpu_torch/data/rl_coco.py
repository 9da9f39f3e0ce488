"""RL refinement input, after the resize (copy of the normalisation in
`rlobjectdetection_tpu/data/rl_coco.py::COCODataset.__getitem__` and of
`COCODataLoader.collate`).

A sample is (image `[H, W, 3]` normalised RGB, bboxes `[n, 7]` = (x1, y1, x2,
y2, score, cat, img_id) in resized-image coordinates, labels
`[n, num_acts, 3]` = (action, target ±1, weight), im_info = [h, w, scale,
orig_h, orig_w, filename]).
"""

from __future__ import annotations

import numpy as np

from .blob import pad_shape


def normalize_image(rgb: np.ndarray, mean, std) -> np.ndarray:
    """`[H, W, 3]` RGB pixels in 0..255 → (x / 255 - mean) / std, float32
    (ToTensor's scaling, then the RLConfig.normalize_* statistics)."""
    img = np.asarray(rgb, dtype=np.float32) / 255.0
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def collate(samples, num_acts: int, pad_multiple: int = 32) -> dict:
    """Batch samples: images zero-padded to the batch max H/W rounded up to
    `pad_multiple`; detections padded to the batch max rounded up to a
    multiple of 16 (zero label weight there), with a batch-id column
    prepended, so bboxes is `[B, N, 8]` = (batch_id, x1, y1, x2, y2, score,
    cat, img_id). Returns {data, bboxes, labels, num_dts, im_info}."""
    b = len(samples)
    ph, pw = pad_shape(max(s[0].shape[0] for s in samples),
                       max(s[0].shape[1] for s in samples), pad_multiple)
    max_n = max(max(s[1].shape[0] for s in samples), 1)
    max_n = -(-max_n // 16) * 16
    imgs = np.zeros((b, ph, pw, 3), dtype=np.float32)
    bboxes = np.zeros((b, max_n, 8), dtype=np.float32)
    labels = np.zeros((b, max_n, num_acts, 3), dtype=np.float32)
    num_dts = np.zeros((b,), dtype=np.int32)
    im_infos = []
    for i, (img, bx, lb, info) in enumerate(samples):
        imgs[i, : img.shape[0], : img.shape[1]] = img
        n = bx.shape[0]
        num_dts[i] = n
        if n:
            bboxes[i, :n, 0] = i
            bboxes[i, :n, 1:] = bx
            labels[i, :n] = lb
        im_infos.append(info)
    return {"data": imgs, "bboxes": bboxes, "labels": labels,
            "num_dts": num_dts, "im_info": im_infos}
