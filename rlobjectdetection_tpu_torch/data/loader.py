"""Aspect-ratio-grouped batch loader (copy of the JAX package's
`data/loader.py`).

Images are sorted by aspect ratio; each batch is a contiguous block with
one target ratio (the leftmost if the block is all tall, the rightmost if
all wide, 1.0 if it straddles); images that need a crop get a gt-aware
random crop window; tall and wide batches zero-pad to the target-ratio
canvas while a ratio-1.0 straddle batch crops every image to the top-left
min(h, w) square, and training im_info reports the canvas; gt boxes are
padded to MAX_NUM_GT_BOXES. Batches are NHWC numpy blobs whose padded
H×W is rounded up to multiples of `pad_multiple`, so a batch's shape comes
from a bounded set. Plans are keyed on (seed, epoch) and each batch carries
its own seed, so batches can be assembled in any order on worker threads
(`prefetch.AsyncLoader`). Under data parallelism each rank assembles only
its rows of every batch (`HostShardLoader`), on the global batch's canvas
(`RoiBatchLoader.predict_train_canvas`).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .blob import pad_shape
from .minibatch import load_entry_image_gt, pad_gt_boxes


class DetectionBatch(dict):
    """dict with keys: data [N,H,W,3], im_info [N,3], gt_boxes [N,Gmax,5],
    num_boxes [N]."""


def _img_rng(seed: int, pos: int) -> np.random.RandomState:
    """Deterministic per-image stream derived from (batch seed, position in
    the GLOBAL batch). Any contiguous slice of a batch then reproduces the
    corresponding rows of the full assembly bit-for-bit — the property the
    multi-host sliced input pipeline (HostShardLoader) rests on."""
    return np.random.RandomState(
        np.random.SeedSequence((int(seed), int(pos))).generate_state(4))


def compute_batch_ratios(ratio_list: np.ndarray, batch_size: int) -> np.ndarray:
    """Per-sample target ratio, constant within each contiguous batch block
    (roibatchLoader.py:38-54)."""
    n = len(ratio_list)
    out = np.zeros(n, dtype=np.float64)
    num_batch = int(np.ceil(n / batch_size))
    for i in range(num_batch):
        left = i * batch_size
        right = min((i + 1) * batch_size - 1, n - 1)
        if ratio_list[right] < 1:
            target = ratio_list[left]
        elif ratio_list[left] > 1:
            target = ratio_list[right]
        else:
            target = 1.0
        out[left : right + 1] = target
    return out


def _crop_to_ratio(im, gt_boxes, ratio, rng):
    """gt-aware crop toward the target ratio (roibatchLoader.py:88-158)."""
    h, w = im.shape[:2]
    if gt_boxes.shape[0] == 0:
        return im, gt_boxes
    if ratio < 1:
        min_y = int(gt_boxes[:, 1].min())
        max_y = int(gt_boxes[:, 3].max())
        trim = min(int(np.floor(w / ratio)), h)
        box_region = max_y - min_y + 1
        if min_y == 0:
            y_s = 0
        elif box_region < trim:
            y_s_min = max(max_y - trim, 0)
            y_s_max = min(min_y, h - trim)
            y_s = y_s_min if y_s_min >= y_s_max else rng.randint(y_s_min, y_s_max)
        else:
            add = (box_region - trim) // 2
            y_s = min_y if add == 0 else rng.randint(min_y, min_y + add)
        im = im[y_s : y_s + trim, :, :]
        gt_boxes = gt_boxes.copy()
        gt_boxes[:, 1] = np.clip(gt_boxes[:, 1] - y_s, 0, trim - 1)
        gt_boxes[:, 3] = np.clip(gt_boxes[:, 3] - y_s, 0, trim - 1)
    else:
        # ratio >= 1 — the reference's else branch (roibatchLoader.py:125):
        # at exactly 1.0 (straddle batch) a wide need_crop image still gets
        # this gt-aware width crop BEFORE the unconditional square crop
        min_x = int(gt_boxes[:, 0].min())
        max_x = int(gt_boxes[:, 2].max())
        trim = min(int(np.ceil(h * ratio)), w)
        box_region = max_x - min_x + 1
        if min_x == 0:
            x_s = 0
        elif box_region < trim:
            x_s_min = max(max_x - trim, 0)
            x_s_max = min(min_x, w - trim)
            x_s = x_s_min if x_s_min >= x_s_max else rng.randint(x_s_min, x_s_max)
        else:
            add = (box_region - trim) // 2
            x_s = min_x if add == 0 else rng.randint(min_x, min_x + add)
        im = im[:, x_s : x_s + trim, :]
        gt_boxes = gt_boxes.copy()
        gt_boxes[:, 0] = np.clip(gt_boxes[:, 0] - x_s, 0, trim - 1)
        gt_boxes[:, 2] = np.clip(gt_boxes[:, 2] - x_s, 0, trim - 1)
    return im, gt_boxes


class RoiBatchLoader:
    """Training loader yielding fixed-shape NHWC batches."""

    def __init__(self, roidb, ratio_list, ratio_index, batch_size: int,
                 scales=(600,), max_num_gt: int = 20, pad_multiple: int = 32,
                 seed: int = 3, training: bool = True):
        self.roidb = roidb
        self.ratio_list = ratio_list
        self.ratio_index = ratio_index
        self.batch_size = batch_size
        self.scales = scales
        self.max_num_gt = max_num_gt
        self.pad_multiple = pad_multiple
        self.training = training
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self._epoch = 0  # next batch_plan()'s epoch stream (see set_epoch)
        self.batch_ratios = compute_batch_ratios(ratio_list, batch_size)
        # training drops the len % batch_size tail each epoch (drop_last): the
        # reference sampler emits those as one short leftover batch
        # (trainval_net.py:139-146), but a ragged batch would break both the
        # fixed-shape compile set and DP mesh divisibility here; eval keeps
        # every image (short final batch allowed)
        self.num_batches = len(roidb) // batch_size if training else int(
            np.ceil(len(roidb) / batch_size)
        )

    def __len__(self):
        return self.num_batches

    def _image_gt(self, entry, rng):
        """Decode + flip + scale-pick + BGR/mean/resize for one entry.
        Override point for pre-packed input sources (data/packed.py) — any
        override must consume the SAME rng draws so downstream randomness
        (gt shuffle, crop windows) stays bit-aligned with the live path."""
        return load_entry_image_gt(entry, self.scales, rng)

    def _load_one(self, index: int, target_ratio: float, rng):
        entry = self.roidb[index]
        im, gt_boxes, im_scale = self._image_gt(entry, rng)
        rng.shuffle(gt_boxes)

        if self.training and entry.get("need_crop", 0):
            im, gt_boxes = _crop_to_ratio(im, gt_boxes, target_ratio, rng)

        if self.training and target_ratio == 1.0:
            # straddle batch (ratios span 1.0): the reference crops EVERY image
            # to the top-left min(h, w) square and clamps gt to [0, trim] —
            # note trim, not trim-1, its quirk (roibatchLoader.py:180-186)
            trim = min(im.shape[0], im.shape[1])
            im = im[:trim, :trim]
            if gt_boxes.shape[0]:
                gt_boxes = gt_boxes.copy()
                gt_boxes[:, :4] = np.clip(gt_boxes[:, :4], 0, trim)

        # drop degenerate boxes after crop (roibatchLoader.py:189-191)
        keep = (gt_boxes[:, 0] != gt_boxes[:, 2]) & (gt_boxes[:, 1] != gt_boxes[:, 3])
        gt_boxes = gt_boxes[keep]
        return im, gt_boxes, im_scale

    def _assemble(self, indices, target_ratio: float, rng=None,
                  pad_hw: tuple[int, int] | None = None,
                  pad_count: int | None = None, seed: int | None = None,
                  index_offset: int = 0,
                  strict_pad: bool = False) -> DetectionBatch:
        """pad_hw/pad_count force the blob to a fixed [pad_count, *pad_hw, 3]
        canvas (bucketed eval batching: every batch of a bucket — including the
        final partial one — reuses ONE compiled shape; padding rows carry
        im_info = (ph, pw, 1) and zero pixels, and are dropped by the caller).

        seed/index_offset switch to per-image rng streams (_img_rng): image i
        uses stream (seed, index_offset + i), so a slice of a batch assembled
        at its global offset is bit-identical to the same rows of the full
        assembly. strict_pad errors instead of growing past pad_hw (multi-host
        slices must all agree on the global canvas)."""
        rng = rng if rng is not None else self.rng
        ims, gts, scales = [], [], []
        for i, idx in enumerate(indices):
            r = _img_rng(seed, index_offset + i) if seed is not None else rng
            im, gt, s = self._load_one(idx, target_ratio, r)
            ims.append(im)
            gts.append(gt)
            scales.append(s)
        max_h = max(im.shape[0] for im in ims)
        max_w = max(im.shape[1] for im in ims)
        if pad_hw is None:
            ph, pw = pad_shape(max_h, max_w, self.pad_multiple)
        else:
            # grow (never crash) if a planned canvas under-predicted the
            # resize's rounding by an ulp — quantized, so growth stays bucketed
            ph, pw = pad_hw
            if max_h > ph or max_w > pw:
                if strict_pad:
                    raise ValueError(
                        f"decoded batch ({max_h}x{max_w}) exceeds the planned "
                        f"canvas {pad_hw} — multi-host slices must agree on "
                        f"the global shape")
                ph, pw = pad_shape(max(max_h, ph), max(max_w, pw), self.pad_multiple)
        n = pad_count if pad_count is not None else len(ims)
        blob = np.zeros((n, ph, pw, 3), dtype=np.float32)
        im_info = np.tile(np.array([ph, pw, 1.0], dtype=np.float32), (n, 1))
        for i, im in enumerate(ims):
            blob[i, : im.shape[0], : im.shape[1]] = im
            if self.training:
                # the reference reports the PADDED canvas as im_info during
                # training (roibatchLoader.py:169-178, 185-186): anchors over
                # the zero-pad region stay valid negative candidates and
                # proposals clip to the canvas, not the image
                im_info[i] = (ph, pw, scales[i])
            else:
                im_info[i] = (im.shape[0], im.shape[1], scales[i])
        gt_pad, num = pad_gt_boxes(gts + [np.zeros((0, 5), np.float32)] * (n - len(ims)),
                                   self.max_num_gt)
        return DetectionBatch(
            data=blob, im_info=im_info, gt_boxes=gt_pad, num_boxes=num
        )

    def set_epoch(self, epoch: int) -> None:
        """Pin the NEXT batch_plan() to epoch's stream (DistributedSampler
        idiom): plans are a pure function of (loader seed, epoch), so a
        resumed run replays exactly the batch order the uninterrupted run
        would have used. The reference's sampler re-permutes from one global
        torch stream (RCNN_bases/trainval_net.py:123-146), so its resumed
        runs restart the permutation sequence — repaired by spec here
        (deterministic resume), consistent with SURVEY §2.7 policy."""
        self._epoch = int(epoch)

    def batch_plan(self):
        """One epoch's worth of (indices, target_ratio, batch_seed) descriptors.

        Deriving a fresh RandomState per batch (rather than threading one
        sequential stream through every decode) makes batches independent —
        the prerequisite for the async multi-worker pipeline (data/prefetch.py)
        producing bit-identical batches in any completion order. The plan rng
        itself is keyed on (seed, epoch) — not a long-lived stream — so every
        host and every resumed process derives the identical epoch plan.
        """
        ep_rng = np.random.RandomState(
            np.random.SeedSequence(
                (int(self.seed), int(self._epoch))).generate_state(4))
        self._epoch += 1
        n = len(self.roidb)
        plan = []
        if self.training:
            # the reference sampler (RCNN_bases/trainval_net.py:123-146): random
            # permutation of whole batches over the ratio-sorted index. The
            # reference trains its short leftover batch every epoch; fixed
            # shapes force drop_last here, so rotate the block grid by a fresh
            # per-epoch offset — otherwise the dropped tail is permanently the
            # same widest-aspect images
            tail = n - self.num_batches * self.batch_size
            off = int(ep_rng.randint(0, tail + 1)) if tail else 0
            starts = ep_rng.permutation(self.num_batches) * self.batch_size + off
            for s in starts:
                idxs = [int(self.ratio_index[i]) for i in range(s, s + self.batch_size)]
                # per-block target ratio, the compute_batch_ratios rule on the
                # shifted block (roibatchLoader.py:38-54)
                rl = self.ratio_list[s]
                rr = self.ratio_list[s + self.batch_size - 1]
                target = rl if rr < 1 else (rr if rl > 1 else 1.0)
                plan.append((idxs, float(target),
                             int(ep_rng.randint(0, 2 ** 31))))
        else:
            for s in range(0, n, self.batch_size):
                idxs = list(range(s, min(s + self.batch_size, n)))
                plan.append((idxs, 1.0, int(ep_rng.randint(0, 2 ** 31))))
        return plan

    def assemble_job(self, job) -> DetectionBatch:
        """Assemble one batch_plan() entry (the AsyncLoader work unit)."""
        idxs, ratio, seed = job
        return self._assemble(idxs, ratio, seed=seed)

    def predict_train_canvas(self, indices, target_ratio: float, seed: int,
                             index_offset: int = 0) -> tuple[int, int]:
        """The padded (H, W) `_assemble` gives this batch, without decoding
        an image: from the roidb's sizes, each image's rng stream (the scale
        pick is its first draw) and the crop rules of `_load_one` /
        `_crop_to_ratio` (a crop window's position is random, its extent is
        not). Every rank of a data-parallel run agrees on the global canvas
        this way while it assembles only its own rows."""
        hs, ws = [], []
        for i, idx in enumerate(indices):
            e = self.roidb[idx]
            r = _img_rng(seed, index_offset + i)
            scale = self.scales[r.randint(0, len(self.scales))]
            h0, w0 = int(e["height"]), int(e["width"])
            s = float(scale) / min(h0, w0)
            # the resize's size rounds half to even, as python's round()
            rh, rw = int(round(h0 * s)), int(round(w0 * s))
            has_gt = bool(np.any(e["gt_classes"] != 0))
            if self.training and e.get("need_crop", 0) and has_gt:
                if target_ratio < 1:
                    rh = min(int(np.floor(rw / target_ratio)), rh)
                else:
                    rw = min(int(np.ceil(rh * target_ratio)), rw)
            if self.training and target_ratio == 1.0:
                rh = rw = min(rh, rw)
            hs.append(rh)
            ws.append(rw)
        return pad_shape(max(hs), max(ws), self.pad_multiple)

    def __iter__(self) -> Iterator[DetectionBatch]:
        for job in self.batch_plan():
            yield self.assemble_job(job)


class HostShardLoader:
    """A rank's view of a `RoiBatchLoader` under data parallelism: rows
    `[start, start + size)` of every batch of the shared, epoch-keyed plan.

    Each image's rng stream is keyed on its position in the GLOBAL batch,
    so the rows equal those rows of the full assembly to the bit, and the
    canvas is the global batch's (`predict_train_canvas`), so every rank's
    rows have one shape (a canvas that an image outgrows raises rather than
    grows). Works with `AsyncLoader` (`batch_plan` / `assemble_job`) and
    `trainval_net.train_epochs` (`set_epoch`)."""

    def __init__(self, loader: RoiBatchLoader, start: int, size: int):
        self.loader = loader
        self.start = start
        self.size = size

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def batch_plan(self):
        plan = []
        for idxs, ratio, seed in self.loader.batch_plan():
            canvas = self.loader.predict_train_canvas(idxs, ratio, seed)
            plan.append((idxs[self.start:self.start + self.size], ratio, seed, canvas))
        return plan

    def assemble_job(self, job) -> DetectionBatch:
        idxs, ratio, seed, canvas = job
        return self.loader._assemble(idxs, ratio, seed=seed, index_offset=self.start,
                                     pad_hw=canvas, strict_pad=True)

    def __iter__(self) -> Iterator[DetectionBatch]:
        for job in self.batch_plan():
            yield self.assemble_job(job)


def eval_bucket_plan(roidb, scale: int, batch_size: int,
                     pad_multiple: int = 32):
    """Shape-bucketed eval batching plan.

    The reference evaluates one image at a time. Grouping images whose
    padded shape matches lets eval run at batch > 1 with no extra padding,
    over a bounded set of shapes (one a bucket).

    Shapes are predicted from roidb width/height with the round-half-to-even
    size the resize (`blob._resize`, `np.rint`) gives, so planned canvases
    equal the batch-1 path's padded shapes. If a last-ulp rounding
    difference ever under-predicts, `_assemble(pad_hw=...)` grows the canvas
    rather than failing. Returns [(indices, (ph, pw)), ...] covering every
    image exactly once, buckets in descending frequency.
    """
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, e in enumerate(roidb):
        h, w = int(e["height"]), int(e["width"])
        s = float(scale) / min(h, w)
        ph, pw = pad_shape(int(round(h * s)), int(round(w * s)), pad_multiple)
        buckets.setdefault((ph, pw), []).append(i)
    plan = []
    for shape, idxs in sorted(buckets.items(), key=lambda kv: -len(kv[1])):
        for s0 in range(0, len(idxs), batch_size):
            plan.append((idxs[s0 : s0 + batch_size], shape))
    return plan
