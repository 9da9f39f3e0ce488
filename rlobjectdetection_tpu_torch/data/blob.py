"""Image → blob preparation (copy of `PIXEL_MEANS_BGR`, `prep_im_for_blob`
and `pad_shape` from `rlobjectdetection_tpu/data/minibatch.py`).

BGR pixels, caffe pixel means subtracted, shortest side resized to the
target scale (the MAX_SIZE clamp is off unless `max_size` is given), padded
sizes rounded up to multiples of 32. The resize is OpenCV's INTER_LINEAR
(half-pixel centres, edge clamp) written in numpy, so the port needs no cv2.
"""

from __future__ import annotations

import numpy as np

PIXEL_MEANS_BGR = np.array([[[102.9801, 115.9465, 122.7717]]], dtype=np.float32)


def read_image_bgr(path: str) -> np.ndarray:
    """`[H, W, 3]` float32 BGR."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.float32)[:, :, ::-1].copy()


def prep_im_for_blob(im: np.ndarray, pixel_means, target_size: int,
                     max_size: int | None = None):
    """Mean-subtract + shortest-side resize. Returns (im, im_scale)."""
    im = im.astype(np.float32, copy=False) - pixel_means
    im_scale = blob_scale(*im.shape[:2], target_size, max_size)
    return _resize(im, im_scale), im_scale


def blob_scale(h: int, w: int, target_size: int, max_size: int | None = None) -> float:
    """The resize factor that takes an h×w image's short side to
    `target_size` (its long side to at most `max_size`, where given)."""
    im_scale = float(target_size) / float(min(h, w))
    if max_size is not None and np.round(im_scale * max(h, w)) > max_size:
        im_scale = float(max_size) / float(max(h, w))
    return im_scale


def resized_shape(h: int, w: int, scale: float) -> tuple[int, int]:
    """The size `_resize` gives an h×w image at `scale`."""
    return int(np.rint(h * scale)), int(np.rint(w * scale))


def linear_taps(n_out: int, n_in: int, scale: float):
    """Source index pairs and weights of INTER_LINEAR along one axis."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = (src - i0).astype(np.float32)
    frac[i0 < 0] = 0.0
    i0[i0 < 0] = 0
    hi = i0 >= n_in - 1
    frac[hi] = 0.0
    i0[hi] = n_in - 1
    return i0, np.minimum(i0 + 1, n_in - 1), frac


def _resize(im: np.ndarray, scale: float) -> np.ndarray:
    """`cv2.resize(im, None, fx=scale, fy=scale, interpolation=INTER_LINEAR)`."""
    h, w = im.shape[:2]
    oh, ow = resized_shape(h, w, scale)
    y0, y1, fy = linear_taps(oh, h, scale)
    x0, x1, fx = linear_taps(ow, w, scale)
    fy = fy[:, None, None]
    rows = im[y0] * (1.0 - fy) + im[y1] * fy
    fx = fx[None, :, None]
    return (rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx).astype(np.float32)


def pad_shape(h: int, w: int, multiple: int = 32) -> tuple[int, int]:
    """Round a blob size up to a multiple."""
    r = lambda x: ((x + multiple - 1) // multiple) * multiple
    return r(h), r(w)
