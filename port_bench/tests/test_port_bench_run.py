"""A whole run: without a card it fails and prints no result; with the
timed path broken underneath, `correct` comes out false; on the card, the
control (the reference in fp8 in the program's place) comes out false."""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from conftest import ROOT, drive

F32_LIMITS = {"train": {"batch_gap": 0.0, "loss_gap": 1e-3, "grad_gap": 1e-2,
                        "update_gap": 1e-2, "grad_gap_median": 1e-3,
                        "update_gap_median": 1e-3, "rpn_gap": 1e-3, "rpn_foreign": 0,
                        "rpn_missing": 0},
              "serve": {"score_gap": 1e-3, "box_gap": 1e-2, "det_count_gap": 0.0,
                        "det_missing": 0, "rpn_gap": 1e-3, "rpn_foreign": 0,
                        "rpn_missing": 0, "rpn_nms_excess": 1e-6, "det_nms_excess": 1e-6}}


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, ROOT)
    import port_bench.run as bench_run

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = bench_run.main(["--workload", "res101.train.packed", "--seed", "1",
                             "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == "" and "CUDA" in err.getvalue()


def test_no_card_no_result_in_a_process():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "res101.serve",
                        "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_sound_run_is_correct(tmp_path):
    assert drive("coco_train_live", tmp_path, dtype="float32", limits=F32_LIMITS)["correct"]


def test_frozen_step_is_caught(tmp_path, monkeypatch):
    """A step that returns its state unchanged."""
    from rlobjectdetection_tpu_torch import engine

    real = engine.make_train_step

    class Still:
        def __init__(self, opt):
            self.opt, self.state = opt, getattr(opt, "state", {})

        def zero_grad(self, set_to_none=True):
            self.opt.zero_grad(set_to_none=set_to_none)

        def step(self):
            pass

    monkeypatch.setattr(engine, "make_train_step",
                        lambda model, opt, sched, **kw: real(model, Still(opt), Still(sched)))
    res = drive("coco_train_live", tmp_path, dtype="float32", limits=F32_LIMITS)
    assert not res["correct"]
    assert res["compared"]["update_gap"]["value"] > 0.5


def test_half_batch_is_caught(tmp_path, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from rlobjectdetection_tpu_torch import engine

    real = engine.make_train_step

    def halved(model, opt, sched, **kw):
        step = real(model, opt, sched, **kw)
        return lambda batch, g, d=None: step({k: v[: len(v) // 2] for k, v in batch.items()},
                                             g, d)

    monkeypatch.setattr(engine, "make_train_step", halved)
    res = drive("coco_train_live", tmp_path, dtype="float32", limits=F32_LIMITS)
    assert not res["correct"]


def test_altered_answer_is_caught(tmp_path, monkeypatch):
    """One detection's score altered where it is produced."""
    from rlobjectdetection_tpu_torch.engine import serve

    real = serve.Detector.detect

    def altered(self, im):
        boxes, scores, classes, valid = real(self, im)
        scores = scores.copy()
        scores[0] *= 1.01
        return boxes, scores, classes, valid

    monkeypatch.setattr(serve.Detector, "detect", altered)
    res = drive("coco_serve_closed", tmp_path, dtype="float32", limits=F32_LIMITS)
    assert not res["correct"]
    assert res["compared"]["score_gap"]["value"] > 5e-3


@pytest.mark.parametrize("traffic", ["coco_serve_closed", "coco_train_live"])
def test_under_keeping_rpn_nms_is_caught(tmp_path, monkeypatch, traffic):
    """The RPN's NMS dropping boxes that overlap a kept one at IoU 0.3 to
    0.7: the proposals the reference takes agree with the head's numbers,
    so only the proposal check sees it."""
    from rlobjectdetection_tpu_torch.models import rpn

    real = rpn.nms_select
    monkeypatch.setattr(rpn, "nms_select", lambda boxes, scores, thresh, *a, **kw:
                        real(boxes, scores, 0.3, *a, **kw))
    res = drive(traffic, tmp_path, dtype="float32", limits=F32_LIMITS)
    assert not res["correct"]
    assert res["compared"]["rpn_missing"]["value"] > 0


def test_misplaced_proposals_are_caught(tmp_path, monkeypatch):
    """The proposal layer's decode a pixel off."""
    from rlobjectdetection_tpu_torch.models import rpn

    real = rpn.bbox_transform_inv
    monkeypatch.setattr(rpn, "bbox_transform_inv", lambda *a, **kw: real(*a, **kw) + 1.0)
    res = drive("coco_serve_closed", tmp_path, dtype="float32", limits=F32_LIMITS)
    assert not res["correct"]
    assert res["compared"]["rpn_foreign"]["value"] > 0


def test_wrong_top_detections_are_caught(tmp_path, monkeypatch):
    """The post-process returning the next `max_per_image` detections in
    place of the best: each is some proposal's and class's output, as many
    as the reference returns."""
    from rlobjectdetection_tpu_torch.engine import serve

    real = serve.postprocess_detections

    def lower(*a, max_per_image, **kw):
        out = real(*a, max_per_image=2 * max_per_image, **kw)
        return tuple(t[max_per_image:] for t in out)

    monkeypatch.setattr(serve, "postprocess_detections", lower)
    res = drive("coco_serve_closed", tmp_path, dtype="float32", limits=F32_LIMITS)
    assert not res["correct"]
    assert res["compared"]["det_missing"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["res101.train.packed", "res101.serve"])
def test_control_fails_on_the_card(cuda, workload):
    """The reference in fp8 in the program's place, at the cell's own size,
    on three seeds: `correct` false on each."""
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", workload,
                            "--seed", str(seed), "--seconds", "1", "--trace", "0",
                            "--control", "1"], cwd=ROOT, capture_output=True, text=True,
                           timeout=900)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False
