"""The port's RL data pipeline against the JAX package's, on the CPU:
`action_dious`, the weight statistic, `COCOTransform`, `COCODataset`,
`COCODataLoader` (serial and through `AsyncLoader`), the eval's bf16 wire
and `generate_labels`.

The fixture is a synthetic COCO split of 6 images of 72×96 with one crowd
gt; its detections are each gt box jittered 8 times by N(0, 3) px (from a
numpy seed), plus one detection of a category its image has no gt of.
Everything here is numpy and PIL on both sides, so every result is held
equal, bit for bit; only the threaded weight sums, which add in another
order, are held to 1e-12 of their value."""

import json
import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from rlobjectdetection_tpu.config import RLConfig as JaxRLConfig
from rlobjectdetection_tpu.data import rl_coco as jax_rl
from rlobjectdetection_tpu.models.rl import Action as JaxAction
from rlobjectdetection_tpu_torch.config import RLConfig
from rlobjectdetection_tpu_torch.data import rl_coco
from rlobjectdetection_tpu_torch.data.prefetch import AsyncLoader
from rlobjectdetection_tpu_torch.data.synthetic import make_coco_dataset
from rlobjectdetection_tpu_torch.engine import generate_labels
from rlobjectdetection_tpu_torch.engine.rl import wire_tensor
from rlobjectdetection_tpu_torch.models.rl import Action

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SIZES, MAX_SIZE = (48, 80), 120      # a short-side range: the draws matter
KEYS = ("data", "bboxes", "labels", "num_dts")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(gt json, detections json, image dir)."""
    root = str(tmp_path_factory.mktemp("rl_data"))
    ann = make_coco_dataset(root, num_images=6, split="val", year="2014", image_size=(72, 96))
    with open(ann) as f:
        gt = json.load(f)
    gt["annotations"][1]["iscrowd"] = 1
    with open(ann, "w") as f:
        json.dump(gt, f)
    rng = np.random.RandomState(0)
    dets = []
    for a in gt["annotations"]:
        for _ in range(8):
            b = np.asarray(a["bbox"]) + np.r_[rng.randn(2) * 3, rng.randn(2) * 3]
            dets.append({"image_id": a["image_id"], "category_id": a["category_id"],
                         "bbox": [float(v) for v in b], "score": float(rng.rand())})
    img0 = gt["images"][0]["id"]
    have = {a["category_id"] for a in gt["annotations"] if a["image_id"] == img0}
    missing = next(c["id"] for c in gt["categories"] if c["id"] not in have)
    dets.append({"image_id": img0, "category_id": missing, "bbox": [10.0, 12.0, 30.0, 20.0],
                 "score": 0.5})
    dt_file = os.path.join(root, "dets.json")
    with open(dt_file, "w") as f:
        json.dump(dets, f)
    return ann, dt_file, os.path.join(root, "coco", "images", "val2014")


def actions():
    cfg = RLConfig()
    return (Action(list(cfg.act_delta), iou_thres=cfg.act_iou_thres, wtrans=cfg.act_wtrans),
            JaxAction(list(cfg.act_delta), iou_thres=cfg.act_iou_thres,
                      wtrans=JaxRLConfig.act_wtrans))


def datasets(fixture, transform=True, **kw):
    """(port dataset, JAX dataset) over the fixture."""
    ann, dt_file, img_dir = fixture
    cfg = RLConfig()
    port_action, jax_action = actions()
    norm = dict(normalize_mean=cfg.normalize_mean, normalize_std=cfg.normalize_std)
    port = rl_coco.COCODataset(
        img_dir, ann, dt_file, port_action,
        transform_fn=rl_coco.COCOTransform(SIZES, MAX_SIZE, flip=True) if transform else None,
        **norm, **kw)
    ref = jax_rl.COCODataset(
        img_dir, ann, dt_file, jax_action,
        transform_fn=jax_rl.COCOTransform(SIZES, MAX_SIZE, flip=True) if transform else None,
        **norm, **kw)
    return port, ref


def assert_batches_equal(got, want):
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["im_info"] == want["im_info"]


def test_action_dious_match_jax(fixture):
    """Every detection, against its own category's gt (crowd by IoF), an
    empty list (the zero box) and another category's gt: the same IoU and
    ΔIoU, bit for bit."""
    port, ref = datasets(fixture, transform=False, max_stat_dets=0)
    port_action, jax_action = actions()
    cases = 0
    for (img, cat), dts in port.dt_boxes.items():
        for dt in dts:
            for gts in (port.gt_boxes.get((img, cat), []), [],
                        port.gt_boxes.get((img, cat % 3 + 1), [])):
                got = rl_coco.action_dious(port_action, dt["bbox"], gts)
                want = jax_rl.action_dious(jax_action, dt["bbox"], gts)
                assert got[0] == want[0]
                np.testing.assert_array_equal(got[1], want[1])
                cases += 1
    assert any(g.get("iscrowd") for gts in port.gt_boxes.values() for g in gts)
    assert cases > 3 * 64


@pytest.mark.parametrize("max_dets", [5000, None])
@pytest.mark.parametrize("workers", [0, 4])
def test_weight_statistics_match_jax(fixture, workers, max_dets):
    """`get_weights_statistics` on the dataset's own dicts: counts exactly,
    weight sums to 1e-12 of their value (threads add in another order);
    more than 64 detections, so 4 workers take the threaded path; the
    dataset's pos/neg ratios likewise."""
    port, ref = datasets(fixture, transform=False, max_stat_dets=0)
    port_action, jax_action = actions()
    assert sum(len(v) for v in port.dt_boxes.values()) > 64
    got = rl_coco.get_weights_statistics(port.imgIds, port.catIds, port.dt_boxes,
                                         port.gt_boxes, port_action, maxDets=max_dets,
                                         num_workers=workers)
    want = jax_rl.get_weights_statistics(ref.imgIds, ref.catIds, ref.dt_boxes, ref.gt_boxes,
                                         jax_action, maxDets=max_dets, num_workers=workers)
    serial = jax_rl.get_weights_statistics(ref.imgIds, ref.catIds, ref.dt_boxes, ref.gt_boxes,
                                           jax_action, maxDets=max_dets)
    assert got[:2] == want[:2] == serial[:2]
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-12)
    np.testing.assert_allclose(got[2:], serial[2:], rtol=1e-12)
    port_ds, ref_ds = datasets(fixture, transform=False, max_stat_dets=max_dets,
                               stat_workers=workers)
    assert (port_ds.pos_tot, port_ds.neg_tot) == (ref_ds.pos_tot, ref_ds.neg_tot)
    np.testing.assert_allclose([port_ds.pos_wratio, port_ds.neg_wratio],
                               [ref_ds.pos_wratio, ref_ds.neg_wratio], rtol=1e-12)
    # the statistic reads the dicts and inserts no key
    assert set(port_ds.dt_boxes) == set(ref_ds.dt_boxes)


def test_coco_transform_matches_jax(fixture):
    """A short side drawn from 48..80, the 120 cap, flips: the same image
    bits, boxes and scale from the same per-item stream, and from the
    transforms' own streams called in turn."""
    from PIL import Image

    _, _, img_dir = fixture
    port = rl_coco.COCOTransform(SIZES, MAX_SIZE, flip=True)
    ref = jax_rl.COCOTransform(SIZES, MAX_SIZE, flip=True)
    boxes = np.asarray([[3.0, 4.0, 40.0, 50.0, 0.9, 1.0, 7.0],
                        [10.5, 0.0, 95.0, 71.0, 0.3, 2.0, 7.0]], np.float32)
    flips, sizes = 0, set()
    for k, name in enumerate(sorted(os.listdir(img_dir)) * 2):
        img = Image.open(os.path.join(img_dir, name)).convert("RGB")
        for rng_pair in ((np.random.RandomState(k), np.random.RandomState(k)), (None, None)):
            got = port(img, boxes, rng=rng_pair[0])
            want = ref(img, boxes, rng=rng_pair[1])
            assert got[0] == want[0]
            np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
            np.testing.assert_array_equal(got[2], want[2])
            flips += bool(got[2][0, 0] != boxes[0, 0] * got[0])
            sizes.add(got[1].size)
    assert flips and len(sizes) > 2


@pytest.mark.parametrize("transform", [True, False])
def test_dataset_items_match_jax(fixture, transform):
    """`__getitem__(idx, rng)` for every image: pixels, boxes (x2 = x + w,
    no −1), labels, im_info; the dataset's statistic and ratios too."""
    port, ref = datasets(fixture, transform=transform)
    assert (port.pos_tot, port.neg_tot, port.pos_weights, port.neg_weights) == (
        ref.pos_tot, ref.neg_tot, ref.pos_weights, ref.neg_weights)
    assert port.imgIds == ref.imgIds and port.catIds == ref.catIds
    for idx in range(len(port)):
        got = port.__getitem__(idx, rng=np.random.RandomState([3, 0, idx]))
        want = ref.__getitem__(idx, rng=np.random.RandomState([3, 0, idx]))
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]
    # the image whose extra detection has no gt of its category: all −1
    img0 = port.imgIds[0]
    bboxes, labels = port.label_detections(img0)
    lonely = ~np.isin(bboxes[:, 5], [c for c in port.catIds if port.gt_boxes.get((img0, c))])
    assert lonely.sum() == 1 and (labels[lonely][..., 1] == -1).all()


def test_loader_epochs_match_jax_serial_and_threaded(fixture):
    """Batch 2 with shuffle over epochs 0 and 1 (`set_epoch`), then the
    epoch after without one: every batch equal to the JAX loader's; the
    same epochs through `AsyncLoader(4 threads)` equal to the serial ones."""
    port, ref = datasets(fixture)
    loader = rl_coco.COCODataLoader(port, batch_size=2, shuffle=True)
    ref_loader = jax_rl.COCODataLoader(ref, batch_size=2, shuffle=True)
    assert len(loader) == len(ref_loader) == 3
    serial = []
    for epoch in (0, 1, None):
        if epoch is not None:
            loader.set_epoch(epoch)
            ref_loader.set_epoch(epoch)
        got, want = list(loader), list(ref_loader)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert_batches_equal(g, w)
        serial.append(got)
    assert any(not np.array_equal(a["bboxes"], b["bboxes"]) for a, b in zip(*serial[:2]))
    for epoch, want in zip((0, 1), serial):
        loader.set_epoch(epoch)
        threaded = list(AsyncLoader(loader, num_workers=4))
        assert len(threaded) == len(want)
        for g, w in zip(threaded, want):
            assert_batches_equal(g, w)


def test_bf16_wire_matches_ml_dtypes():
    """The host cast of the eval's bf16 wire rounds as ml_dtypes does:
    normalised pixels, values halfway between two bf16 numbers (ties to
    even), subnormals and infinities, bit for bit; f32 ships as is."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 33, 65, 3).astype(np.float32) * 3
    base = rng.randn(64).astype(np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
    ties = np.concatenate([base | np.uint32(0x8000), base | np.uint32(0x18000)])
    special = np.asarray([0.0, -0.0, 1e-40, -3e-39, np.inf, -np.inf, 3.4e38], np.float32)
    for arr in (x, ties.view(np.float32), special):
        got = wire_tensor(arr, "bf16")
        assert got.dtype == torch.bfloat16
        want = arr.astype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      want.view(np.uint16))
    # NaN stays NaN (torch and ml_dtypes write other payload bits)
    assert torch.isnan(wire_tensor(np.asarray([np.nan], np.float32), "bf16")).all()
    assert torch.equal(wire_tensor(x, "f32"), torch.from_numpy(x))
    with pytest.raises(ValueError):
        wire_tensor(x, "f16")


@pytest.mark.parametrize("delta_alpha", [None, (["0.1", "0.05"], "0.5")])
def test_generate_labels_matches_jax_tool(fixture, tmp_path, monkeypatch, delta_alpha):
    """`engine/generate_labels.py` and `tools/generate_labels.py` on the same
    files (the default 56 actions, and 16 at alpha 0.5): equal json."""
    sys.path.insert(0, REPO)
    from tools import generate_labels as jax_tool

    ann, dt_file, _ = fixture
    extra = [] if delta_alpha is None else ["--delta", *delta_alpha[0],
                                            "--alpha", delta_alpha[1]]
    want_path, got_path = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    monkeypatch.setattr(sys, "argv", ["generate_labels.py", "--ann_file", ann, "--dt_file",
                                      dt_file, "--out", want_path, *extra])
    jax_tool.main()
    generate_labels.main(["--ann_file", ann, "--dt_file", dt_file, "--out", got_path, *extra])
    with open(want_path) as f:
        want = json.load(f)
    with open(got_path) as f:
        got = json.load(f)
    assert got == want
    assert len(got[0]["dious"]) == (56 if delta_alpha is None else 16)
    assert any(d["iou"] == 0.0 for d in got) and any(d["iou"] > 0.5 for d in got)
