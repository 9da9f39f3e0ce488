"""Host-side batch assembly, live against packed (the port's counterpart of
the JAX package's `tools/bench_loader.py`).

    python -m rlobjectdetection_tpu_torch.engine.bench_loader [--images N] \
        [--bs B] [--root D] [--passes P]

makes N synthetic 640×480 JPEGs (COCO's modal size) under D (default
`output/loader_bench`), packs them at scale 800 (`data/packed.py`; the pack's
seconds and bytes are printed), then times `RoiBatchLoader` batch assembly
(decode, BGR, mean subtract, resize to ~800×1067, pad) against
`PackedRoiBatchLoader`'s (an mmap read and a canvas copy), each serial and
on `AsyncLoader` threads, over P passes with the page cache warm. Prints a
line a configuration and, last, a JSON object of the images/s of each. No
device is used: this measures the host that feeds the card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..data.loader import RoiBatchLoader
from ..data.packed import PackedRoiBatchLoader, pack_timed
from ..data.prefetch import AsyncLoader

SCALE = 800
WORKERS = (1, 4, 8)                  # AsyncLoader threads timed beside serial


def make_jpegs(root: str, n: int, w: int = 640, h: int = 480) -> list[str]:
    """n JPEGs of smooth low-frequency content with noise (a photo's entropy)."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w]
    paths = []
    for i in range(n):
        p = os.path.join(root, f"im{i:04d}.jpg")
        base = 96 + 80 * np.sin(xx / (20 + i % 7)) * np.cos(yy / (25 + i % 5))
        img = (base[..., None] + rng.randn(h, w, 3) * 12
               + rng.randint(0, 60)).clip(0, 255).astype(np.uint8)
        if not os.path.exists(p):
            Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    return paths


def build_roidb(paths, w: int = 640, h: int = 480) -> list[dict]:
    """A roidb over `paths`: 1-7 boxes an image of 80 classes."""
    rng = np.random.RandomState(1)
    roidb = []
    for p in paths:
        nb = rng.randint(1, 8)
        boxes = np.zeros((nb, 4), dtype=np.uint16)
        x1, y1 = rng.randint(0, w - 60, nb), rng.randint(0, h - 60, nb)
        boxes[:, 0], boxes[:, 1] = x1, y1
        boxes[:, 2] = x1 + rng.randint(20, 55, nb)
        boxes[:, 3] = y1 + rng.randint(20, 55, nb)
        roidb.append({"image": p, "flipped": False, "boxes": boxes,
                      "gt_classes": rng.randint(1, 81, nb).astype(np.int32),
                      "width": w, "height": h, "need_crop": 0})
    return roidb


def run(root: str, n: int = 64, bs: int = 8, passes: int = 3) -> dict:
    """Pack, then each configuration's images/s. Returns {"pack_s",
    "pack_bytes", "<config>": images/s, ...}."""
    roidb = build_roidb(make_jpegs(os.path.join(root, "jpeg"), n))
    ratios = np.array([e["width"] / e["height"] for e in roidb])
    order = np.argsort(ratios, kind="stable")
    pack_root = os.path.join(root, "pack")
    pack = pack_timed(roidb, (SCALE,), pack_root)
    kw = dict(batch_size=bs, scales=(SCALE,), max_num_gt=20)

    def live():
        return RoiBatchLoader(roidb, ratios[order], order, **kw)

    def packed():
        return PackedRoiBatchLoader(roidb, ratios[order], order, pack_root=pack_root, **kw)

    for make in (live, packed):          # warm the page cache for both
        for _ in make():
            pass
    configs = [("live serial", live, None), ("packed serial", packed, None)]
    configs += [(f"{name} async nw={w}", make, w) for w in WORKERS
                for name, make in (("live", live), ("packed", packed))]
    out = {"pack_s": pack["seconds"], "pack_bytes": pack["bytes"]}
    for label, make, nw in configs:
        t0 = time.perf_counter()
        count = 0
        for _ in range(passes):
            loader = make()
            for batch in (loader if nw is None else AsyncLoader(loader, nw)):
                count += batch["data"].shape[0]
        rate = count / (time.perf_counter() - t0)
        out[label] = rate
        print(f"{label:24s} {rate:8.2f} img/s host-side", flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Host batch assembly, live against packed")
    p.add_argument("--images", default=64, type=int)
    p.add_argument("--bs", default=8, type=int)
    p.add_argument("--passes", default=3, type=int)
    p.add_argument("--root", default=os.path.join("output", "loader_bench"))
    args = p.parse_args(argv)
    out = run(args.root, args.images, args.bs, args.passes)
    print(f"scale-{SCALE} assembly over {os.cpu_count()} cores: live serial "
          f"{out['live serial']:.1f} img/s, packed serial {out['packed serial']:.1f} img/s")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
