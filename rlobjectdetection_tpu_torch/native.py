"""ctypes binding of the RLE mask core, built with g++ at first use (the
port's copy of the JAX package's `native.py`).

`csrc/maskrle.cpp` (pycocotools' mask core in C++: encode, decode, merge,
area, IoU with the crowd rule, bbox, from bbox, from polygon, on
column-major run counts) is compiled with `g++ -O2 -shared -fPIC` into
`rlobjectdetection_tpu_torch/build/` (ignored by git), under a name keyed
on a hash of the source's contents, so an edited source is rebuilt and a
stale library is never loaded. Each build writes a file of its own process
and moves it into place with `os.replace`, so processes that build at once
each load a whole library. A failed build raises with the compiler's
output; there is no Python fallback. Only the segm paths need the library:
bbox IoU is `coco_api.iou_xywh`, in numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "maskrle.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_LIB = None


def lib_path() -> Path:
    """The library's path for the source as it is now."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libmaskrle-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this source's is not built yet; returns its
    path. Raises RuntimeError with g++'s output on failure."""
    target = lib_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the RLE mask library cannot be built ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    dp = ctypes.POINTER(ctypes.c_double)
    c_int = ctypes.c_int
    for name, res, args in (
            ("rle_encode", c_int, [u8p, c_int, c_int, u32p]),
            ("rle_decode", None, [u32p, c_int, c_int, c_int, u8p]),
            ("rle_area", ctypes.c_uint64, [u32p, c_int]),
            ("rle_merge2", c_int, [u32p, c_int, u32p, c_int, c_int, u32p]),
            ("rle_iou_pair", ctypes.c_double, [u32p, c_int, u32p, c_int, c_int]),
            ("rle_iou_matrix", None, [u32p, i32p, i32p, c_int, u32p, i32p, i32p, c_int,
                                      u8p, dp]),
            ("bb_iou", None, [dp, c_int, dp, c_int, u8p, dp]),
            ("rle_to_bbox", None, [u32p, c_int, c_int, c_int, dp]),
            ("rle_from_bbox", c_int, [dp, c_int, c_int, u32p]),
            ("rle_from_poly", c_int, [dp, c_int, c_int, c_int, u32p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _LIB = lib
    return lib


class RLE:
    """An RLE mask: (h, w, counts uint32 array, column-major runs)."""

    __slots__ = ("h", "w", "counts")

    def __init__(self, h: int, w: int, counts: np.ndarray):
        self.h = h
        self.w = w
        self.counts = np.ascontiguousarray(counts, dtype=np.uint32)


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def encode(mask: np.ndarray) -> RLE:
    """mask: `[H, W]` (row-major array; the runs are column-major, as COCO's)."""
    lib = get_lib()
    h, w = mask.shape
    col = np.ascontiguousarray(mask.astype(np.uint8).reshape(-1, order="F"))
    counts = np.zeros(h * w + 2, dtype=np.uint32)
    m = lib.rle_encode(_u8p(col), h, w, _u32p(counts))
    return RLE(h, w, counts[:m].copy())


def decode(rle: RLE) -> np.ndarray:
    out = np.zeros(rle.h * rle.w, dtype=np.uint8)
    get_lib().rle_decode(_u32p(rle.counts), len(rle.counts), rle.h, rle.w, _u8p(out))
    return out.reshape((rle.h, rle.w), order="F")


def area(rle: RLE) -> int:
    return int(get_lib().rle_area(_u32p(rle.counts), len(rle.counts)))


def merge(a: RLE, b: RLE, intersect: bool = False) -> RLE:
    out = np.zeros(len(a.counts) + len(b.counts) + 2, dtype=np.uint32)
    m = get_lib().rle_merge2(_u32p(a.counts), len(a.counts), _u32p(b.counts),
                             len(b.counts), int(intersect), _u32p(out))
    return RLE(a.h, a.w, out[:m].copy())


def iou(dt, gt, iscrowd=None) -> np.ndarray:
    """IoU matrix `[N, K]`. dt/gt: lists of RLE, or `[N, 4]` xywh arrays (bbox
    mode). A crowd gt's IoU is the intersection over the dt's area."""
    lib = get_lib()

    def _crowd(k):
        if iscrowd is None:
            return np.zeros(k, dtype=np.uint8)
        c = np.ascontiguousarray(np.asarray(iscrowd, dtype=np.uint8))
        if len(c) != k:
            # the C side reads iscrowd[0..k): a short array would be read past its end
            raise ValueError(f"iscrowd length {len(c)} != number of gt {k}")
        return c

    if isinstance(dt, np.ndarray) or (dt and isinstance(dt[0], (list, np.ndarray))):
        dtb = np.ascontiguousarray(np.asarray(dt, dtype=np.float64)).reshape(-1, 4)
        gtb = np.ascontiguousarray(np.asarray(gt, dtype=np.float64)).reshape(-1, 4)
        n, k = len(dtb), len(gtb)
        out = np.zeros((n, k), dtype=np.float64)
        lib.bb_iou(_dp(dtb), n, _dp(gtb), k, _u8p(_crowd(k)), _dp(out))
        return out
    n, k = len(dt), len(gt)
    out = np.zeros((n, k), dtype=np.float64)
    if n == 0 or k == 0:
        return out

    def _pack(rles):
        lens = np.array([len(r.counts) for r in rles], dtype=np.int32)
        offs = np.zeros(len(rles), dtype=np.int32)
        np.cumsum(lens[:-1], out=offs[1:])
        return np.ascontiguousarray(np.concatenate([r.counts for r in rles])), offs, lens

    dflat, doff, dlen = _pack(dt)
    gflat, goff, glen = _pack(gt)
    # the whole matrix in one call
    lib.rle_iou_matrix(_u32p(dflat), _i32p(doff), _i32p(dlen), n,
                       _u32p(gflat), _i32p(goff), _i32p(glen), k,
                       _u8p(_crowd(k)), _dp(out))
    return out


def to_bbox(rle: RLE) -> np.ndarray:
    bb = np.zeros(4, dtype=np.float64)
    get_lib().rle_to_bbox(_u32p(rle.counts), len(rle.counts), rle.h, rle.w, _dp(bb))
    return bb


def from_bbox(bb, h: int, w: int) -> RLE:
    bbd = np.ascontiguousarray(np.asarray(bb, dtype=np.float64))
    counts = np.zeros(2 * w + 4, dtype=np.uint32)
    m = get_lib().rle_from_bbox(_dp(bbd), h, w, _u32p(counts))
    return RLE(h, w, counts[:m].copy())


def from_poly(xy, h: int, w: int) -> RLE:
    pts = np.ascontiguousarray(np.asarray(xy, dtype=np.float64)).reshape(-1)
    counts = np.zeros(h * w + 2, dtype=np.uint32)
    m = get_lib().rle_from_poly(_dp(pts), len(pts) // 2, h, w, _u32p(counts))
    return RLE(h, w, counts[:m].copy())
