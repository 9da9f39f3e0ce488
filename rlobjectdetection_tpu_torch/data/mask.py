"""pycocotools.mask's API over the port's RLE core (`native.py`,
`csrc/maskrle.cpp`): a copy of the JAX package's `data/mask.py`.

It takes the three COCO segmentation encodings: polygon lists,
uncompressed RLE dicts (`{"size": [h, w], "counts": [...]}`) and compressed
COCO strings (maskApi.c's rleToString / rleFrString, the 5-bit delta code,
written here in Python: the C core works on raw uint32 run arrays).
"""

from __future__ import annotations

import numpy as np

from .. import native


def rle_to_string(counts) -> str:
    """COCO compressed counts string (maskApi.c:rleToString): runs are
    delta-coded against counts[i-2], then emitted as 5-bit groups (+48) with a
    continuation bit, sign-extended like LEB128."""
    cnts = [int(c) for c in counts]
    out = []
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def string_to_rle_counts(s: str) -> list[int]:
    cnts: list[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        while True:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            i += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:
                    x |= -1 << (5 * k)
                break
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def _to_native(obj, h: int | None = None, w: int | None = None) -> native.RLE:
    """Any COCO segmentation object → native RLE."""
    if isinstance(obj, native.RLE):
        return obj
    if isinstance(obj, dict):
        hh, ww = obj["size"]
        counts = obj["counts"]
        if isinstance(counts, (str, bytes)):
            if isinstance(counts, bytes):
                counts = counts.decode("ascii")
            counts = string_to_rle_counts(counts)
        return native.RLE(int(hh), int(ww), np.asarray(counts, np.uint32))
    # polygon(s)
    if h is None or w is None:
        raise ValueError("polygon segmentation needs image h, w")
    polys = obj if isinstance(obj[0], (list, np.ndarray)) else [obj]
    rles = [native.from_poly(p, h, w) for p in polys]
    out = rles[0]
    for r in rles[1:]:
        out = native.merge(out, r, intersect=False)
    return out


def frPyObjects(pyobj, h: int, w: int):
    """polygons / uncompressed RLEs / boxes → RLE(s) (mask.py:frPyObjects)."""
    if isinstance(pyobj, np.ndarray) and pyobj.ndim == 2 and pyobj.shape[1] == 4:
        return [native.from_bbox(b, h, w) for b in pyobj]
    if isinstance(pyobj, list) and pyobj and isinstance(pyobj[0], (list, np.ndarray)):
        # pycocotools: a list of 4-element sequences is xywh BOXES, not
        # polygons (_mask.pyx frPyObjects: len(pyobj[0]) == 4 → frBbox;
        # polygons have >= 6 coordinates)
        if len(pyobj[0]) == 4:
            return [native.from_bbox(b, h, w) for b in pyobj]
        return [_to_native(p, h, w) for p in pyobj]
    if isinstance(pyobj, list) and pyobj and isinstance(pyobj[0], dict):
        return [_to_native(p) for p in pyobj]
    return _to_native(pyobj, h, w)


def merge(rles, intersect: bool = False) -> native.RLE:
    out = _to_native(rles[0])
    for r in rles[1:]:
        out = native.merge(out, _to_native(r), intersect)
    return out


def ann_to_rle(ann: dict, coco) -> native.RLE:
    """An annotation's segmentation → native RLE, using the image size from the
    COCO index (coco.py:annToRLE equivalent); memoized on the ann dict."""
    if "_rle" in ann:
        return ann["_rle"]
    img = coco.imgs[ann["image_id"]]
    h, w = img["height"], img["width"]
    seg = ann["segmentation"]
    if isinstance(seg, list):
        rle = _to_native(seg, h, w)
    else:
        rle = _to_native(seg)
    ann["_rle"] = rle
    return rle


def encode(mask: np.ndarray) -> dict:
    """binary [H, W] mask → compressed COCO RLE dict."""
    r = native.encode(mask)
    return {"size": [r.h, r.w], "counts": rle_to_string(r.counts)}


def decode(obj) -> np.ndarray:
    return native.decode(_to_native(obj))


def area(obj) -> int:
    return native.area(_to_native(obj))


def toBbox(obj) -> np.ndarray:
    return native.to_bbox(_to_native(obj))


def iou(dt, gt, iscrowd=None) -> np.ndarray:
    """IoU matrix for RLEs/segmentation objects or [N,4] xywh boxes.
    Empty sides yield an empty matrix (pycocotools returns [])."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), dtype=np.float64)
    if isinstance(dt, np.ndarray) or (
        isinstance(dt[0], (list, np.ndarray)) and len(dt[0]) == 4
    ):
        return native.iou(dt, gt, iscrowd)
    return native.iou([_to_native(d) for d in dt],
                      [_to_native(g) for g in gt], iscrowd)
