"""The port's data layer against the JAX package's, on the same inputs.

Each package writes its synthetic VOC devkit and COCO tree from the same
seed into a root of its own (both read `$RLOD_DATA_DIR` and cache roidbs
as pickles under it, so neither can read the other's pickle). Then:

- the fixtures: equal XML text, JSON objects and decoded images;
- `combined_roidb`: equal entries, ratio_list and ratio_index, with equal
  dtypes (VOC with flips, COCO with crowd boxes);
- `RoiBatchLoader`: equal plans, im_info, gt_boxes and num_boxes, and pixels
  within rtol 1e-4, atol 1e-3 (the JAX loader resizes with cv2, the port
  with its numpy INTER_LINEAR; the bound of
  `test_torch_ops.py::test_prep_im_for_blob_matches_jax`);
- `eval_bucket_plan`: equal plans, and canvases equal to what the port
  assembles;
- `AsyncLoader` and `device_prefetch`: the plain loop's batches in its
  order, and a clean early stop;
- no module of the data layer or of `engine/test_net.py` loads cv2 or
  pycocotools.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from rlobjectdetection_tpu.data.imdb import combined_roidb as jax_combined_roidb
from rlobjectdetection_tpu.data.imdb import rank_roidb_ratio as jax_rank_roidb_ratio
from rlobjectdetection_tpu.data import loader as jax_loader
from rlobjectdetection_tpu.data import synthetic as jax_synthetic
from rlobjectdetection_tpu_torch.data import imdb, loader, prefetch, synthetic
import torch_threads  # noqa: F401  (xdist workers share the cores)

PIXEL_RTOL, PIXEL_ATOL = 1e-4, 1e-3
VOC_CLASSES = ("aeroplane", "bicycle", "bird")


@contextlib.contextmanager
def data_dir(root):
    prev = os.environ.get("RLOD_DATA_DIR")
    os.environ["RLOD_DATA_DIR"] = str(root)
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("RLOD_DATA_DIR", None)
        else:
            os.environ["RLOD_DATA_DIR"] = prev


def make_fixtures(module, root):
    module.make_voc_devkit(str(root), num_images=5, image_size=(72, 96), classes=VOC_CLASSES)
    return module.make_coco_dataset(str(root), num_images=6, image_size=(80, 64),
                                    crowd_fraction=0.4)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(jax root, port root), each holding its own package's fixtures."""
    jroot, proot = tmp_path_factory.mktemp("jax_data"), tmp_path_factory.mktemp("port_data")
    make_fixtures(jax_synthetic, jroot)
    make_fixtures(synthetic, proot)
    return jroot, proot


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if "cache" not in d)


@pytest.mark.parametrize("kind", ["voc", "coco"])
def test_synthetic_fixtures_match_jax(roots, kind):
    jroot, proot = roots
    sub = "VOCdevkit2007" if kind == "voc" else "coco"
    names = _files(jroot / sub)
    assert names == _files(proot / sub) and names
    for name in names:
        a, b = jroot / sub / name, proot / sub / name
        if name.endswith(".jpg"):
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        elif name.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text())
        else:
            assert a.read_text() == b.read_text(), name


ROIDB_KEYS = ("boxes", "gt_classes", "gt_overlaps", "max_classes", "max_overlaps", "flipped",
              "width", "height", "need_crop", "seg_areas", "img_id")


def _roidbs(roots, name, training, flipped):
    jroot, proot = roots
    with data_dir(jroot):
        want = jax_combined_roidb(name, training=training, use_flipped=flipped)
    with data_dir(proot):
        got = imdb.combined_roidb(name, training=training, use_flipped=flipped)
    return got, want


@pytest.mark.parametrize("name,training,flipped", [
    ("voc_2007_trainval", True, True),
    ("voc_2007_test", False, False),
    ("coco_2014_minival", True, True),
])
def test_combined_roidb_matches_jax(roots, name, training, flipped):
    (gdb, groidb, gratio, gindex), (wdb, wroidb, wratio, windex) = _roidbs(
        roots, name, training, flipped)
    assert gdb.name == wdb.name and list(gdb.classes) == list(wdb.classes)
    assert len(groidb) == len(wroidb) > 0
    for g, w in zip(groidb, wroidb):
        for k in ROIDB_KEYS:
            gv, wv = np.asarray(g[k]), np.asarray(w[k])
            assert gv.dtype == wv.dtype and np.array_equal(gv, wv), k
    assert gratio.dtype == wratio.dtype and np.array_equal(gratio, wratio)
    assert gindex.dtype == windex.dtype and np.array_equal(gindex, windex)
    if flipped:
        assert any(e["flipped"] for e in groidb)
    if name.startswith("coco"):
        assert any((e["gt_overlaps"] == -1).any() for e in groidb)   # crowd boxes


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in ("im_info", "gt_boxes", "num_boxes"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["data"].shape == want["data"].shape
    np.testing.assert_allclose(got["data"], want["data"], rtol=PIXEL_RTOL, atol=PIXEL_ATOL)


def _hand_roidb(tmp_path, sizes, seed=5):
    """A roidb over PNGs of the given (h, w), two gt boxes each."""
    rng = np.random.RandomState(seed)
    roidb = []
    for i, (h, w) in enumerate(sizes):
        path = str(tmp_path / f"im{i}.png")
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
        x1, y1 = rng.randint(0, w // 3, 2), rng.randint(0, h // 3, 2)
        x2, y2 = x1 + rng.randint(8, w // 2, 2), y1 + rng.randint(8, h // 2, 2)
        roidb.append({"image": path, "width": w, "height": h, "flipped": bool(i % 2),
                      "boxes": np.stack([x1, y1, x2, y2], 1).astype(np.uint16),
                      "gt_classes": np.array([1 + i % 3, 2], np.int32)})
    return roidb


def test_training_loader_matches_jax(tmp_path):
    """Batch 2 over two epochs (`set_epoch`), two scales: a tall block, a
    straddle block (every image cropped to its top-left square) and a wide
    block with a need_crop image; the plans and batches are equal."""
    sizes = [(200, 160), (160, 200), (100, 400), (400, 100), (120, 150), (150, 120)]
    roidb = _hand_roidb(tmp_path, sizes)
    ratio_list, ratio_index = imdb.rank_roidb_ratio(roidb)
    jratio, jindex = jax_rank_roidb_ratio([dict(e) for e in roidb])
    assert np.array_equal(ratio_list, jratio) and np.array_equal(ratio_index, jindex)
    assert sum(e["need_crop"] for e in roidb) == 2
    kw = dict(scales=(64, 96), max_num_gt=5, seed=3)
    got = loader.RoiBatchLoader(roidb, ratio_list, ratio_index, 2, **kw)
    want = jax_loader.RoiBatchLoader(roidb, jratio, jindex, 2, **kw)
    np.testing.assert_array_equal(got.batch_ratios, want.batch_ratios)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        plan = got.batch_plan()
        assert plan == want.batch_plan()
        assert sorted(r for _, r, _ in plan) == [0.5, 1.0, 2.0]
        for job in plan:
            _assert_batches_equal(got.assemble_job(job), want.assemble_job(job))
    got.set_epoch(0)
    want.set_epoch(0)
    for g, w in zip(got, want):           # __iter__ replays epoch 0's plan
        _assert_batches_equal(g, w)


def test_eval_loader_matches_jax(roots):
    (_, groidb, gratio, gindex), (_, wroidb, wratio, windex) = _roidbs(
        roots, "voc_2007_test", False, False)
    kw = dict(scales=(96,), max_num_gt=20, training=False)
    got = list(loader.RoiBatchLoader(groidb, gratio, gindex, 1, **kw))
    want = list(jax_loader.RoiBatchLoader(wroidb, wratio, windex, 1, **kw))
    assert len(got) == len(want) == len(groidb)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
        assert g["data"].shape == (1, 96, 128, 3)


def test_eval_bucket_plan_matches_jax_and_the_assembled_canvas(tmp_path):
    """Sizes whose resize lands on x.5 (64 × 95 at 96 → 142.5, rounded half
    to even) and two orientations; batch 2 with a short last batch."""
    sizes = [(64, 95), (72, 96), (96, 72), (64, 97), (80, 80), (72, 96), (64, 93)]
    roidb = _hand_roidb(tmp_path, sizes)
    plan = loader.eval_bucket_plan(roidb, 96, 2)
    assert plan == jax_loader.eval_bucket_plan(roidb, 96, 2)
    assert sorted(i for idxs, _ in plan for i in idxs) == list(range(len(sizes)))
    kw = dict(scales=(96,), max_num_gt=5, training=False)
    ratio_list, ratio_index = np.ones(len(roidb)), np.arange(len(roidb))
    got_loader = loader.RoiBatchLoader(roidb, ratio_list, ratio_index, 1, **kw)
    want_loader = jax_loader.RoiBatchLoader(roidb, ratio_list, ratio_index, 1, **kw)
    for idxs, hw in plan:
        g = got_loader._assemble(idxs, 1.0, pad_hw=hw, pad_count=2)
        # the port's resize: no image outgrows the planned canvas
        assert g["data"].shape == (2, *hw, 3)
        _assert_batches_equal(g, want_loader._assemble(idxs, 1.0, pad_hw=hw, pad_count=2))
        if len(idxs) == 1:   # a padding row: zero pixels, the canvas as im_info
            assert not g["data"][1].any() and tuple(g["im_info"][1]) == (*hw, 1.0)


def _voc_loader(roots):
    (_, roidb, ratio_list, ratio_index), _ = _roidbs(roots, "voc_2007_trainval", True, True)
    return loader.RoiBatchLoader(roidb, ratio_list, ratio_index, 2, scales=(64, 96),
                                 max_num_gt=8, seed=3)


def test_async_loader_and_device_prefetch_match_the_plain_loop(roots):
    ld = _voc_loader(roots)
    ld.set_epoch(0)
    plain = list(ld)
    ld.set_epoch(0)
    async_batches = list(prefetch.AsyncLoader(ld, num_workers=3))
    ld.set_epoch(0)
    cpu = torch.device("cpu")
    staged = list(prefetch.device_prefetch(
        prefetch.AsyncLoader(ld, num_workers=2),
        lambda b: {k: prefetch.to_device(v, cpu) for k, v in b.items()}, device=cpu))
    assert len(plain) == len(async_batches) == len(staged) == len(ld) > 1
    for p, a, s in zip(plain, async_batches, staged):
        for k in p:
            np.testing.assert_array_equal(a[k], p[k], err_msg=k)
            assert isinstance(s[k], torch.Tensor)
            np.testing.assert_array_equal(s[k].numpy(), p[k], err_msg=k)


def test_device_prefetch_puts_depth_ahead_in_order():
    puts, out = [], []

    def put(x):
        puts.append(x)
        return x * 10

    for v in prefetch.device_prefetch(range(6), put, "cpu", depth=2):
        out.append(v)
        # item i is yielded only once item i+2 is put
        assert len(puts) >= min(len(out) + 2, 6), (len(puts), out)
    assert out == [0, 10, 20, 30, 40, 50]


def test_prefetch_stops_cleanly_early(roots):
    """A consumer that breaks off after one batch: the source is closed and
    AsyncLoader's worker threads are joined."""
    ld = _voc_loader(roots)
    before = threading.active_count()
    gen = prefetch.device_prefetch(prefetch.AsyncLoader(ld, num_workers=3),
                                   lambda b: b, device="cpu")
    first = next(gen)
    assert first["data"].shape[0] == 2
    gen.close()
    deadline = time.time() + 30
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_data_layer_loads_neither_cv2_nor_pycocotools():
    """The card's machine has neither: importing every new module
    leaves both unloaded (and JAX with them)."""
    mods = ["imdb", "ds_utils", "voc_eval", "pascal_voc", "coco_api", "coco_eval", "coco",
            "factory", "minibatch", "loader", "prefetch", "synthetic"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module('rlobjectdetection_tpu_torch.data.' + m)\n"
        "importlib.import_module('rlobjectdetection_tpu_torch.engine.test_net')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('cv2', 'pycocotools', "
        "'jax', 'rlobjectdetection_tpu'))\n"
        "assert not bad, bad\n")
    repo = os.path.join(os.path.dirname(__file__), "..")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
