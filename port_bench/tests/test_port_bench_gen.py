"""The traffic generators: the same seed gives the same bytes, another seed
other bytes, and every seed the sizes and box counts the traffic states."""

from __future__ import annotations

import json
import os

import numpy as np

from conftest import ROOT, TINY_SIZES
from port_bench.traffic import gen


def _split(images: int = 16) -> dict:
    with open(os.path.join(ROOT, "port_bench", "traffic", "coco_train_live.json")) as f:
        spec = json.load(f)["split"]
    spec["images"] = images
    return spec


def _bytes(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = fh.read()
    return out


def test_same_seed_same_bytes_other_seed_other_bytes(tmp_path):
    spec = _split(8)
    seed = 2 ** 31 + 77
    gen.coco_split(str(tmp_path / "a"), seed, spec)
    gen.coco_split(str(tmp_path / "b"), seed, spec)
    gen.coco_split(str(tmp_path / "c"), seed + 1, spec)
    a, b, c = (_bytes(str(tmp_path / k)) for k in "abc")
    assert a == b
    assert a.keys() == c.keys() and a != c
    pool = gen.serve_pool(seed, dict(spec, images=4))
    again = gen.serve_pool(seed, dict(spec, images=4))
    assert all(np.array_equal(x, y) for x, y in zip(pool, again))


def test_sizes_and_box_counts_as_stated(tmp_path):
    spec = _split(256)
    counts = {}
    for seed in (3, 2 ** 31 + 5):
        recs = gen.coco_split(str(tmp_path / str(seed)), seed, spec)
        sizes = sorted((r["width"], r["height"]) for r in recs)
        assert sizes == sorted(tuple(s) for s in spec["sizes"] for _ in range(256 // 8))
        n = np.array([len(r["classes"]) for r in recs])
        assert n.min() >= spec["boxes_per_image"]["min"]
        assert n.max() <= spec["boxes_per_image"]["max"]
        assert abs(n.mean() - spec["boxes_per_image"]["mean"]) < 0.5
        counts[seed] = sorted(n.tolist())
        for r in recs:
            b = np.asarray(r["boxes"])
            assert (b[:, 0] >= 0).all() and (b[:, 2] < r["width"]).all()
            assert (b[:, 1] >= 0).all() and (b[:, 3] < r["height"]).all()
            assert (b[:, 2] > b[:, 0]).all() and (b[:, 3] > b[:, 1]).all()
            assert ((1 <= r["classes"]) & (r["classes"] <= spec["classes"])).all()
    a, b = counts.values()
    assert a == b      # the same work for every seed, in another order


def test_serve_pool_blocks_hold_every_size():
    spec = dict(_split(), images=20, sizes=TINY_SIZES)
    for seed in (5, 2 ** 31 + 9):
        shapes = [(im.shape[1], im.shape[0]) for im in gen.serve_pool(seed, spec)]
        for b in range(0, 20, 8):
            block = shapes[b:b + 8]
            assert sorted(block) == sorted(tuple(s) for s in TINY_SIZES[:len(block)])
