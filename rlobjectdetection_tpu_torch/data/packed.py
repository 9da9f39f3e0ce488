"""Pre-packed input: the per-pixel work of batch assembly done once, offline
(copy of the JAX package's `data/packed.py`).

The live loader decodes each JPEG, flips it, subtracts the pixel means and
resizes it in float32 on every pass. `pack_roidb` stores each entry's
prepared image (one memory-mappable `.npy` per (image, flipped, scale))
and an index, `pack_index.json`, of its `im_scale` and shape; the keys and
the file layout are the JAX package's, so either package reads the other's
pack. `PackedRoiBatchLoader` swaps the store in behind `RoiBatchLoader`:
assembly becomes an mmap read and a canvas copy.

A stored array is what the live `load_entry_image_gt` gives (read, flip,
mean subtract, resize, in that order), and the loader consumes the same rng
draws as the live one (one randint for the scale), so every later random
choice (gt shuffle, crop windows, straddle trims), and so every batch, is
the live loader's to the bit.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

from .blob import PIXEL_MEANS_BGR, prep_im_for_blob, read_image_bgr
from .loader import RoiBatchLoader
from .minibatch import gt_from_entry

_INDEX = "pack_index.json"
_VERSION = 1


def _key(image_path: str, flipped: bool, scale: int) -> str:
    h = hashlib.sha1(f"{image_path}|{int(bool(flipped))}|{int(scale)}"
                     .encode()).hexdigest()[:20]
    return f"{h}_s{int(scale)}{'_f' if flipped else ''}"


def _write_whole(path: str, write) -> None:
    """`write(file)` into a temporary file beside `path`, then rename it
    to `path` (atomic on one file system)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def pack_roidb(roidb, scales, root: str, verbose: bool = True) -> str:
    """Prepare every (entry, scale) combination of `roidb` into `root`.

    Entries that share an image path but differ in `flipped` pack apart
    (the flip comes before the resize, so the pixels differ). Entries
    already in the pack are kept, so a second call packs only what is new
    and rewrites nothing. Each file is written whole under another name
    and then renamed into place, so a reader (or another writer, as the
    ranks of two hosts on a shared directory are) never sees a part of
    one."""
    os.makedirs(root, exist_ok=True)
    index_path = os.path.join(root, _INDEX)
    index = {}
    existed = os.path.exists(index_path)
    if existed:
        with open(index_path) as f:
            index = json.load(f)
        if index.get("__version__", _VERSION) != _VERSION:
            raise ValueError(f"{index_path}: pack version {index['__version__']}, "
                             f"this reader knows {_VERSION}")
    index.setdefault("__version__", _VERSION)

    done = 0
    for entry in roidb:
        flipped = bool(entry.get("flipped", False))
        base = read_image_bgr(entry["image"])
        if flipped:
            base = base[:, ::-1, :]
        for scale in scales:
            key = _key(entry["image"], flipped, scale)
            if key in index:
                continue
            im, im_scale = prep_im_for_blob(base, PIXEL_MEANS_BGR, scale)
            _write_whole(os.path.join(root, key + ".npy"),
                         lambda f: np.save(f, np.ascontiguousarray(im, dtype=np.float32)))
            index[key] = {"im_scale": im_scale, "shape": [int(s) for s in im.shape]}
            done += 1
    if done or not existed:
        _write_whole(index_path, lambda f: f.write(json.dumps(index).encode()))
    if verbose:
        print(f"packed {done} new arrays into {root} ({len(index) - 1} total)")
    return root


def pack_timed(roidb, scales, root: str) -> dict:
    """`pack_roidb` as the CLIs run it: prints and returns the seconds it
    took and the bytes and arrays of the whole pack."""
    t0 = time.perf_counter()
    pack_roidb(roidb, scales, root, verbose=False)
    seconds = time.perf_counter() - t0
    names = [n for n in os.listdir(root) if n.endswith(".npy")]
    nbytes = sum(os.path.getsize(os.path.join(root, n)) for n in names)
    print(f"pack: {len(names)} arrays, {nbytes} bytes in {root} ({seconds:.3f}s)", flush=True)
    return dict(seconds=seconds, bytes=nbytes, arrays=len(names))


class PackedImageStore:
    """The read side of `pack_roidb`: mmap-backed lookups, no decode work."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, _INDEX)) as f:
            self.index = json.load(f)
        if self.index.get("__version__", _VERSION) != _VERSION:
            raise ValueError(f"{root}: pack version {self.index['__version__']}, "
                             f"this reader knows {_VERSION}")

    def get(self, image_path: str, flipped: bool, scale: int):
        """-> (float32 `[H, W, 3]` read-only mmap view, im_scale)."""
        key = _key(image_path, flipped, scale)
        meta = self.index.get(key)
        if meta is None:
            raise KeyError(
                f"{image_path} (flipped={flipped}, scale={scale}) is not in the pack at "
                f"{self.root}: run pack_roidb with this roidb and these scales")
        arr = np.load(os.path.join(self.root, key + ".npy"), mmap_mode="r")
        return arr, float(meta["im_scale"])


class PackedRoiBatchLoader(RoiBatchLoader):
    """`RoiBatchLoader` whose images come from a `PackedImageStore`.

    Consumes the live `_image_gt`'s rng draws (one randint for the scale),
    so its batches are the live loader's under the same seed and plan."""

    def __init__(self, *args, pack_root: str, **kwargs):
        super().__init__(*args, **kwargs)
        self.store = PackedImageStore(pack_root)

    def _image_gt(self, entry, rng):
        scale = self.scales[rng.randint(0, len(self.scales))]
        im, im_scale = self.store.get(entry["image"], bool(entry.get("flipped", False)),
                                      scale)
        return im, gt_from_entry(entry, im_scale), im_scale
