"""The data layer's arithmetic in NumPy: the training roidb of a COCO-style
split (flipped copies appended, aspect ratios sorted), the epoch's batch
plan, one batch's assembly (decode, flip, mean subtraction, OpenCV
INTER_LINEAR resize by the shortest side, gt shuffle, the straddle batch's
square crop, zero padding to multiples of 32), and the test-time blob.

Random draws follow the faster-rcnn.pytorch loader as the benchmark
defines it: the plan from RandomState(SeedSequence((seed, epoch))), each
image of a batch from RandomState(SeedSequence((batch seed, position))).
"""

from __future__ import annotations

import numpy as np
from PIL import Image

PIXEL_MEANS = np.array([[[102.9801, 115.9465, 122.7717]]], dtype=np.float32)


def read_bgr(path: str) -> np.ndarray:
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.float32)[:, :, ::-1].copy()


def _taps(n_out: int, n_in: int, scale: float):
    src = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = (src - i0).astype(np.float32)
    frac[i0 < 0] = 0.0
    i0[i0 < 0] = 0
    hi = i0 >= n_in - 1
    frac[hi] = 0.0
    i0[hi] = n_in - 1
    return i0, np.minimum(i0 + 1, n_in - 1), frac


def resize(im: np.ndarray, scale: float) -> np.ndarray:
    """INTER_LINEAR resize (half-pixel centres, edges clamped)."""
    h, w = im.shape[:2]
    y0, y1, fy = _taps(int(np.rint(h * scale)), h, scale)
    x0, x1, fx = _taps(int(np.rint(w * scale)), w, scale)
    fy = fy[:, None, None]
    rows = im[y0] * (1.0 - fy) + im[y1] * fy
    fx = fx[None, :, None]
    return (rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx).astype(np.float32)


def prep(im: np.ndarray, target: int):
    """Means subtracted, shortest side resized to `target`: (im, scale)."""
    im = im.astype(np.float32, copy=False) - PIXEL_MEANS
    scale = float(target) / float(min(im.shape[:2]))
    return resize(im, scale), scale


def up32(x: int) -> int:
    return (x + 31) // 32 * 32


def test_blob(im_bgr: np.ndarray, target: int):
    """`[1, H, W, 3]` blob and im_info `[1, 3]` of one served image."""
    im, scale = prep(im_bgr, target)
    blob = np.zeros((1, up32(im.shape[0]), up32(im.shape[1]), 3), np.float32)
    blob[0, :im.shape[0], :im.shape[1]] = im
    return blob, np.array([[im.shape[0], im.shape[1], scale]], np.float32)


def train_roidb(records):
    """records: the split's images in id order, each {path, width, height,
    boxes `[G, 4]` (inclusive pixels), classes `[G]`} → (roidb with the
    flipped copies appended, sorted ratios, their order)."""
    roidb = [dict(r, flipped=False) for r in records]
    for r in records:
        b = np.asarray(r["boxes"], np.float32).copy()
        b[:, [2, 0]] = r["width"] - 1 - b[:, [0, 2]]
        roidb.append(dict(r, boxes=b, flipped=True))
    ratios = np.array([e["width"] / float(e["height"]) for e in roidb])
    if ratios.min() < 0.5 or ratios.max() > 2:
        raise ValueError("the reference loader has no crop for ratios outside [0.5, 2]")
    order = np.argsort(ratios)
    return roidb, ratios[order], order


def _stream(seed: int, pos: int) -> np.random.RandomState:
    return np.random.RandomState(np.random.SeedSequence((int(seed), int(pos))).generate_state(4))


def plan(n: int, ratios, order, batch: int, seed: int, epoch: int):
    """One epoch's batches: [(indices, target ratio, batch seed)]."""
    rng = _stream(seed, epoch)
    nb = n // batch
    tail = n - nb * batch
    off = int(rng.randint(0, tail + 1)) if tail else 0
    out = []
    for s in rng.permutation(nb) * batch + off:
        lo, hi = ratios[s], ratios[s + batch - 1]
        target = lo if hi < 1 else (hi if lo > 1 else 1.0)
        out.append(([int(order[i]) for i in range(s, s + batch)], float(target),
                    int(rng.randint(0, 2 ** 31))))
    return out


def assemble(roidb, job, scales, max_gt: int) -> dict:
    """One training batch: data `[N, H, W, 3]`, im_info `[N, 3]` (the padded
    canvas and each image's scale), gt_boxes `[N, max_gt, 5]`."""
    idxs, ratio, seed = job
    ims, gts, scales_used = [], [], []
    for pos, i in enumerate(idxs):
        e, rng = roidb[i], _stream(seed, pos)
        im = read_bgr(e["path"])
        if e["flipped"]:
            im = im[:, ::-1, :]
        target = scales[rng.randint(0, len(scales))]
        im, s = prep(im, target)
        gt = np.zeros((len(e["classes"]), 5), np.float32)
        gt[:, :4] = np.asarray(e["boxes"]).astype(np.float32) * s
        gt[:, 4] = e["classes"]
        rng.shuffle(gt)
        if ratio == 1.0:
            trim = min(im.shape[:2])
            im = im[:trim, :trim]
            if len(gt):
                gt = gt.copy()
                gt[:, :4] = np.clip(gt[:, :4], 0, trim)
        gt = gt[(gt[:, 0] != gt[:, 2]) & (gt[:, 1] != gt[:, 3])]
        ims.append(im)
        gts.append(gt)
        scales_used.append(s)
    ph, pw = up32(max(i.shape[0] for i in ims)), up32(max(i.shape[1] for i in ims))
    data = np.zeros((len(ims), ph, pw, 3), np.float32)
    gt_pad = np.zeros((len(ims), max_gt, 5), np.float32)
    info = np.zeros((len(ims), 3), np.float32)
    for k, (im, gt, s) in enumerate(zip(ims, gts, scales_used)):
        data[k, :im.shape[0], :im.shape[1]] = im
        gt_pad[k, :min(len(gt), max_gt)] = gt[:max_gt]
        info[k] = (ph, pw, s)
    return {"data": data, "im_info": info, "gt_boxes": gt_pad}
