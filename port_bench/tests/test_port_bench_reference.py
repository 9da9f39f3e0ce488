"""The frozen reference against the port at tiny sizes on the CPU: the
loader's batches to the bit, NMS's keep sets, and a whole train driver run
and serve driver run in float32, where the port and the reference must
agree to rounding."""

from __future__ import annotations

import numpy as np
import torch

from conftest import drive, tiny
from port_bench.reference import boxes as ref_boxes
from port_bench.reference import loader as ref_loader
from port_bench.traffic import gen


def test_loader_batches_equal_the_ports(tmp_path, monkeypatch):
    from rlobjectdetection_tpu_torch.data.imdb import combined_roidb
    from rlobjectdetection_tpu_torch.data.loader import RoiBatchLoader

    _, tr = tiny("coco_train_live")
    recs = gen.coco_split(str(tmp_path), 2 ** 31 + 3, tr["split"])
    monkeypatch.setenv("RLOD_DATA_DIR", str(tmp_path))
    _, roidb, ratios, order = combined_roidb("coco_2014_train", training=True, use_flipped=True)
    port = RoiBatchLoader(roidb, ratios, order, 2, scales=(96,), max_num_gt=50, seed=12345)
    mine, my_ratios, my_order = ref_loader.train_roidb(recs)
    assert np.array_equal(my_ratios, ratios) and np.array_equal(my_order, order)
    for epoch in (1, 2):
        port.set_epoch(epoch)
        jobs = port.batch_plan()
        assert jobs == ref_loader.plan(len(mine), my_ratios, my_order, 2, 12345, epoch)
        for job in jobs:
            got, want = port.assemble_job(job), ref_loader.assemble(mine, job, (96,), 50)
            for k in ("data", "im_info", "gt_boxes"):
                assert np.array_equal(got[k], want[k]), k


def test_nms_keeps_the_ports_set():
    from rlobjectdetection_tpu_torch.ops.nms import nms

    g = torch.Generator().manual_seed(0)
    xy = torch.rand(400, 2, generator=g) * 200
    wh = torch.rand(400, 2, generator=g) * 60 + 4
    boxes = torch.cat([xy, xy + wh], 1)
    scores = torch.rand(400, generator=g)
    order, keep = nms(boxes, scores, 0.5, tile_size=64)
    want = ref_boxes.greedy_nms(boxes, scores, 0.5)
    assert order[keep].tolist() == want.tolist()


def test_train_run_in_f32_agrees_with_the_reference(tmp_path):
    res = drive("coco_train_live", tmp_path, dtype="float32")
    shown = {k: v["value"] for k, v in res["compared"].items()}
    assert shown["batch_gap"] == 0.0
    assert shown["loss_gap"] < 1e-4 and shown["grad_gap"] < 1e-3 and shown["update_gap"] < 1e-3


def test_serve_run_in_f32_agrees_with_the_reference(tmp_path):
    res = drive("coco_serve_closed", tmp_path, dtype="float32")
    shown = {k: v["value"] for k, v in res["compared"].items()}
    assert shown["score_gap"] < 1e-4 and shown["box_gap"] < 1e-3
    assert shown["det_count_gap"] == 0


def test_rl_run_agrees_with_the_reference(tmp_path):
    """The RL cell runs float32 as configured: labels and pixels exact, the
    action values and the steps to float32 rounding."""
    res = drive("coco_rl_train", tmp_path)
    shown = {k: v["value"] for k, v in res["compared"].items()}
    assert shown["batch_gap"] == 0.0
    assert shown["pred_gap"] < 1e-5 and shown["loss_gap"] < 1e-5
    assert shown["grad_gap"] < 1e-4 and shown["update_gap"] < 1e-4
