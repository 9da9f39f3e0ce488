"""The port's spans and counters (`utils/tracing.py`), on the CPU.

- off: `span()` is the shared no-op, nothing is recorded, the totals still
  count;
- on: nesting, parent and root ids (one root a request or step), counts on
  the innermost span, spans of worker threads kept apart under a shortened
  switch interval;
- `nms.host_syncs` of the NMS op equals the blocking reads the test counts
  itself (`torch.equal` and `Tensor.__bool__` calls), small and tiled;
- `Detector.detect` on the `tiny` backbone records the `serve.*` /
  `model.*` tree, and `train_epochs` over a tiny loader `train.step`,
  `data.next`, `data.h2d` and `data.assemble`;
- the FPN detector's step and request record `model.fpn` (the neck),
  `model.rpn` and `model.proposals` over all levels, and count
  `fpn.nms_lanes` (B·5 a proposal layer) and `fpn.rois_p2` ..
  `fpn.rois_p5` (the rois pooled from each level);
- under `torch.profiler` every span has a `user_annotation` twin, and one
  offset maps each twin within 100 µs; under `torch.export` no span is
  recorded and no profiler op enters the graph.
"""

import json
import statistics
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from rlobjectdetection_tpu_torch import config
from rlobjectdetection_tpu_torch.device import pageable_to
from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step
from rlobjectdetection_tpu_torch.engine.serve import Detector
from rlobjectdetection_tpu_torch.engine.trainval_net import train_epochs
from rlobjectdetection_tpu_torch.models import FasterRCNN, build_detector
from rlobjectdetection_tpu_torch.ops.roi_align_levels import roi_levels
from rlobjectdetection_tpu_torch.ops import library  # noqa: F401  (registers rlod::)
from rlobjectdetection_tpu_torch.ops.nms import nms_sorted_mask
from rlobjectdetection_tpu_torch.utils import tracing
import torch_threads  # noqa: F401  (xdist workers share the cores)

CFG = config.Config(
    TRAIN=config.TrainConfig(RPN_PRE_NMS_TOP_N=256, RPN_POST_NMS_TOP_N=64, BATCH_SIZE=32,
                             SCALES=(64,)),
    TEST=config.TestConfig(RPN_PRE_NMS_TOP_N=128, RPN_POST_NMS_TOP_N=32, SCALES=(96,),
                           MAX_DETS_PER_IMAGE=10),
    DTYPE="float32", NMS_TILE=64, ANCHOR_SCALES=(2, 3, 5))
SERVE_TREE = {"serve.prep": "serve.request", "serve.h2d": "serve.request",
              "model.trunk": "serve.request", "model.rpn": "serve.request",
              "model.proposals": "serve.request", "model.head": "serve.request",
              "serve.postprocess": "serve.request", "serve.d2h": "serve.request"}


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _detector():
    model = FasterRCNN(4, "tiny", CFG, device="cpu", seed=3)
    return Detector(model, CFG, "cpu")


def _image(seed=0, shape=(70, 100, 3)):
    return np.random.RandomState(seed).randint(0, 255, shape).astype(np.uint8)


def test_off_records_nothing_and_totals_still_count():
    assert tracing.span("a") is tracing.NOOP
    assert tracing.span("b", shape=(1, 2)) is tracing.NOOP
    with tracing.span("a") as sp:
        sp.set(images=2)
        tracing.count("x", 3)
        tracing.count("x")
    assert tracing.spans() == []
    assert tracing.totals() == {"x": 4}
    tracing.reset()
    assert tracing.totals() == {}


def test_on_nesting_parents_roots_and_counts():
    tracing.enable()
    for request in range(2):
        with tracing.span("req", n=request) as req:
            with tracing.span("a"):
                tracing.count("c", 2)
                with tracing.span("b"):
                    tracing.count("c", 5)
                tracing.count("c", 1)
            with tracing.span("d") as d:
                d.set(images=4)
            req.set(done=True)
            tracing.count("c", 10)
    tracing.count("c", 100)                        # no open span: the totals alone
    spans = tracing.spans()
    assert [s["name"] for s in spans] == ["b", "a", "d", "req"] * 2
    ids = _by_id(spans)
    for r in (0, 1):
        b, a, d, req = spans[4 * r:4 * r + 4]
        assert req["parent"] is None and req["root"] == req["id"]
        assert req["attrs"] == {"n": r, "done": True}
        assert a["parent"] == req["id"] and d["parent"] == req["id"]
        assert b["parent"] == a["id"] and ids[b["parent"]]["name"] == "a"
        assert {s["root"] for s in (b, a, d, req)} == {req["id"]}
        assert (req["counts"], a["counts"], b["counts"]) == ({"c": 10}, {"c": 3}, {"c": 5})
        assert d["counts"] == {} and d["attrs"] == {"images": 4}
        assert req["t_start"] <= a["t_start"] <= b["t_start"] <= b["t_end"] <= a["t_end"]
        assert a["t_end"] <= d["t_start"] <= d["t_end"] <= req["t_end"]
        assert len({s["thread"] for s in (b, a, d, req)}) == 1
        assert not any(s["profiled"] for s in (b, a, d, req))
    assert spans[3]["root"] != spans[7]["root"]
    assert tracing.totals() == {"c": 2 * 18 + 100}
    tracing.disable()
    with tracing.span("after"):
        pass
    assert len(tracing.spans()) == 8


def test_worker_threads_keep_their_own_spans_and_counts():
    """More threads than cores, switching every microsecond: each thread's
    spans nest within that thread, no span or count is lost."""
    threads, rounds = 16, 200
    start = threading.Barrier(threads)

    def work(k):
        start.wait(timeout=30)
        for i in range(rounds):
            with tracing.span("outer", worker=k):
                with tracing.span("inner"):
                    tracing.count("n")
                tracing.count("m", 2)
        return threading.get_ident()

    tracing.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            idents = [f.result(timeout=60) for f in [pool.submit(work, k)
                                                     for k in range(threads)]]
    finally:
        sys.setswitchinterval(interval)
    spans = tracing.spans()
    assert len(spans) == 2 * threads * rounds
    assert tracing.totals() == {"n": threads * rounds, "m": 2 * threads * rounds}
    ids = _by_id(spans)
    for s in spans:
        if s["name"] == "inner":
            outer = ids[s["parent"]]
            assert outer["name"] == "outer" and outer["thread"] == s["thread"]
            assert s["root"] == outer["id"] and s["counts"] == {"n": 1}
        else:
            assert s["parent"] is None and s["counts"] == {"m": 2}
    workers = {s["attrs"]["worker"]: s["thread"] for s in spans if s["name"] == "outer"}
    assert len(workers) == threads and set(workers.values()) <= set(idents)


def _boxes(rng, n):
    xy = rng.rand(n, 2) * 200
    wh = 10 + rng.rand(n, 2) * 60
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return torch.from_numpy(boxes[np.argsort(-rng.rand(n))])


@pytest.mark.parametrize("n,tile,max_keep", [(40, 256, None), (300, 64, None),
                                             (300, 64, 20), (2, 256, 1)])
def test_nms_host_syncs_count_the_blocking_reads(monkeypatch, n, tile, max_keep):
    rng = np.random.RandomState(n + tile)
    boxes = torch.stack([_boxes(rng, n), _boxes(rng, n)])
    valid = torch.from_numpy(rng.rand(2, n) > 0.1)
    reads = []
    equal, to_bool = torch.equal, torch.Tensor.__bool__

    def counted_equal(a, b):
        reads.append("equal")
        return equal(a, b)

    def counted_bool(t):
        reads.append("bool")
        return to_bool(t)

    tracing.enable()
    monkeypatch.setattr(torch, "equal", counted_equal)
    monkeypatch.setattr(torch.Tensor, "__bool__", counted_bool)
    keep = nms_sorted_mask(boxes, valid, 0.5, tile_size=tile, max_keep=max_keep)
    monkeypatch.undo()
    assert keep.shape == valid.shape
    (nms_span,) = tracing.spans()
    assert nms_span["name"] == "model.nms"
    assert nms_span["counts"] == {"nms.host_syncs": len(reads)}
    assert tracing.totals() == {"nms.host_syncs": len(reads)}
    tiled = n > 2 * tile
    if max_keep is None:                           # a sweep at least for every tile
        assert reads.count("equal") >= (-(-n // tile) if tiled else 1)
    assert ("bool" in reads) == (max_keep is not None and tiled)


def test_pageable_copies_count_their_bytes():
    arr = np.zeros((5, 4), np.float32)
    assert pageable_to(arr, torch.device("cpu")).data_ptr() == arr.ctypes.data
    assert tracing.totals() == {}
    t = pageable_to(arr, torch.device("meta"))
    assert t.device.type == "meta" and t.shape == (5, 4)
    assert tracing.totals() == {"h2d.pageable_bytes": 80}


def test_detect_records_the_serve_tree():
    det = _detector()
    det.detect(_image(1))
    tracing.enable()
    for k in range(2):
        det.detect(_image(k, (70 + 10 * k, 100, 3)))
    spans = tracing.spans()
    requests = [s for s in spans if s["name"] == "serve.request"]
    assert [r["attrs"] for r in requests] == [{"shape": (70, 100, 3)}, {"shape": (80, 100, 3)}]
    ids = _by_id(spans)
    for req in requests:
        mine = [s for s in spans if s["root"] == req["id"] and s is not req]
        names = sorted(s["name"] for s in mine)
        assert names == sorted(list(SERVE_TREE) + ["model.nms", "model.nms"])
        for s in mine:
            parent = ids[s["parent"]]["name"]
            if s["name"] == "model.nms":
                assert parent in ("model.proposals", "serve.postprocess")
                assert s["counts"]["nms.host_syncs"] >= 1
            else:
                assert parent == SERVE_TREE[s["name"]]
            assert req["t_start"] <= s["t_start"] <= s["t_end"] <= req["t_end"]
    assert {ids[s["parent"]]["name"] for s in spans if s["name"] == "model.nms"} == {
        "model.proposals", "serve.postprocess"}


class _Loader:
    """Batches of two 64×64 images with one gt box each, as a loader's
    `batch_plan` / `assemble_job` jobs."""

    def __init__(self, steps: int):
        self.steps = steps

    def set_epoch(self, epoch):
        self.epoch = epoch

    def batch_plan(self):
        return [(self.epoch, i) for i in range(self.steps)]

    def assemble_job(self, job):
        rng = np.random.RandomState(job)
        gt = np.zeros((2, 4, 5), np.float32)
        gt[:, 0] = [8, 10, 40, 50, 1]
        return {"data": (rng.randn(2, 64, 64, 3) * 30).astype(np.float32),
                "im_info": np.array([[64, 64, 1.0]] * 2, np.float32), "gt_boxes": gt,
                "num_boxes": np.ones(2, np.int32)}


def test_train_epochs_records_steps_and_data_spans():
    model = FasterRCNN(4, "tiny", CFG, device="cpu", seed=3)
    opt, sched, _ = build_optimizer(model, "tiny", 0.001)
    step = make_train_step(model, opt, sched)
    tracing.enable()
    global_step, _ = train_epochs(
        model, _Loader(3), step,
        lambda g: (torch.Generator().manual_seed(g), torch.Generator().manual_seed(g + 99)),
        epochs=2, num_workers=2)
    assert global_step == 6
    spans = tracing.spans()
    ids = _by_id(spans)
    main = threading.get_ident()
    steps = [s for s in spans if s["name"] == "train.step"]
    assert [s["attrs"]["global_step"] for s in steps] == list(range(6))
    for st in steps:
        inner = {s["name"] for s in spans if s["root"] == st["id"] and s is not st}
        assert inner == {"model.trunk", "model.rpn", "model.proposals", "model.nms",
                         "model.anchor_target", "model.proposal_target", "model.head",
                         "model.loss", "train.backward", "train.optimizer"}
    nexts = [s for s in spans if s["name"] == "data.next"]
    assert len(nexts) == 2 * (3 + 1)               # each epoch's batches and its end
    assert all(s["parent"] is None and s["thread"] == main for s in nexts + steps)
    puts = [s for s in spans if s["name"] == "data.h2d"]
    assert len(puts) == 6 and all(ids[s["parent"]]["name"] == "data.next" for s in puts)
    jobs = [s for s in spans if s["name"] == "data.assemble"]
    assert len(jobs) == 6 and all(s["attrs"] == {"images": 2} for s in jobs)
    assert all(s["thread"] != main and s["parent"] is None for s in jobs)


def test_profiler_twins_map_by_one_offset(tmp_path):
    det = _detector()
    det.detect(_image(0))
    tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            pass
        det.detect(_image(1))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(tracing.spans(), key=lambda s: s["t_start"])
    twins = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"] != "warm"), key=lambda e: e["ts"])
    assert [e["name"] for e in twins] == [s["name"] for s in spans]
    assert all(s["profiled"] for s in spans)
    assert len(spans) == len(SERVE_TREE) + 3
    offset = statistics.median(e["ts"] - s["t_start"] / 1e3 for e, s in zip(twins, spans))
    for e, s in zip(twins, spans):
        assert abs(e["ts"] - (s["t_start"] / 1e3 + offset)) <= 100, (s["name"], e, s)
        assert abs(e["ts"] + e["dur"] - (s["t_end"] / 1e3 + offset)) <= 100, (s["name"], e, s)


FPN_CFG = config.Config(
    TRAIN=config.TrainConfig(RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=40, BATCH_SIZE=32,
                             SCALES=(64,)),
    TEST=config.TestConfig(RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=20, SCALES=(64,),
                           MAX_DETS_PER_IMAGE=10),
    DTYPE="float32", NMS_TILE=64)
FPN_STEP = {"model.trunk", "model.fpn", "model.rpn", "model.proposals", "model.nms",
            "model.anchor_target", "model.proposal_target", "model.head", "model.loss",
            "train.backward", "train.optimizer"}


def test_fpn_step_records_its_spans_and_level_counts():
    model = build_detector(4, "resnet50_fpn", FPN_CFG, device="cpu", seed=3)
    opt, sched, _ = build_optimizer(model, "resnet50_fpn", 0.001)
    batch = {k: torch.from_numpy(v) for k, v in _Loader(1).assemble_job((1, 0)).items()}
    tracing.enable()
    make_train_step(model, opt, sched)(batch, torch.Generator().manual_seed(4))
    out_rois = []
    head = model._scores
    model._scores = lambda feats, rois: (out_rois.append(rois), head(feats, rois))[1]
    make_train_step(model, opt, sched)(batch, torch.Generator().manual_seed(5))
    spans = tracing.spans()
    ids = _by_id(spans)
    steps = [s for s in spans if s["name"] == "train.step"]
    assert len(steps) == 2
    for st in steps:
        mine = [s for s in spans if s["root"] == st["id"] and s is not st]
        assert {s["name"] for s in mine} == FPN_STEP
        assert {ids[s["parent"]]["name"] for s in mine if s["name"] == "model.fpn"} == {
            "train.step"}
        props = [s for s in mine if s["name"] == "model.proposals"]
        assert len(props) == 1 and props[0]["counts"]["fpn.nms_lanes"] == 2 * 5
        heads = [s for s in mine if s["name"] == "model.head"]
        assert len(heads) == 1
        assert sum(heads[0]["counts"].get(f"fpn.rois_p{k}", 0) for k in range(2, 6)) == 2 * 32
    per = torch.bincount(roi_levels(out_rois[0].reshape(-1, 5)), minlength=4).tolist()
    last = [s for s in spans if s["name"] == "model.head"][-1]["counts"]
    assert [last.get(f"fpn.rois_p{k}", 0) for k in range(2, 6)] == per
    assert tracing.totals()["fpn.nms_lanes"] == 2 * 2 * 5


def test_fpn_request_records_the_neck_under_the_request():
    model = build_detector(4, "resnet50_fpn", FPN_CFG, device="cpu", seed=3)
    det = Detector(model, FPN_CFG, "cpu")
    tracing.enable()
    det.detect(_image(2, (60, 80, 3)))
    spans = tracing.spans()
    ids = _by_id(spans)
    (req,) = [s for s in spans if s["name"] == "serve.request"]
    mine = {s["name"]: ids[s["parent"]]["name"] for s in spans if s["root"] == req["id"]
            and s is not req and s["name"] != "model.nms"}
    assert mine == {**SERVE_TREE, "model.fpn": "serve.request"}
    (head,) = [s for s in spans if s["name"] == "model.head"]
    assert sum(head["counts"][f"fpn.rois_p{k}"] for k in range(2, 6)
               if f"fpn.rois_p{k}" in head["counts"]) == 20


class _Spanned(torch.nn.Module):
    def forward(self, x):
        with tracing.span("inside"):
            return x * 2 + 1


def test_export_records_no_span_and_no_profiler_op():
    tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        program = torch.export.export(_Spanned(), (torch.ones(3),))
    assert tracing.spans() == []
    targets = [str(n.target) for n in program.graph.nodes]
    assert not any("profiler" in t for t in targets), targets
    assert torch.equal(program.module()(torch.ones(3)), torch.full((3,), 3.0))
