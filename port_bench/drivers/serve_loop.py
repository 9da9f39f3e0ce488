"""Serving cells: one client in a closed loop calling `Detector.detect`
(prep, forward, post-process, detections as numpy on the host) over a
pool of decoded images, cycled in order. Set-up serves every image size of
the pool twice. With `--trace 1` a profiler covers `profile_requests`
requests from 40% into the window, and host-clock spans around the
detector's `blob` (host prep) and around `ops.nms.nms_sorted_mask` time
every request of the window (the NMS's span starts after the device has
finished the work queued before it).

The proposal layer's inputs (the RPN's scores and deltas) and output of
each request are kept (references to the port's own tensors). Correct:
once the window has closed and the model is freed, a sample of the
window's requests drawn from the seed, the largest blob among them, is run
through the reference in float32 (TF32 off): its own blob from the pool
image, its own trunk and RPN, its own head at the port's proposals, its
own post-process. Held: the RPN's outputs against the reference's; the
port's proposals against its RPN outputs (each kept box a top-N
candidate's decoded box, in score order, and no candidate dropped that
greedy NMS keeps); each detection the port returned as the reference's
output of some proposal and class (its score's relative gap and its box's
gap in pixels at the nearest such box); the greedy NMS thresholds over the
kept proposals and each class's detections; no (proposal, class) left out
whose score puts it in the top `max_per_image` and that no returned
detection of its class suppresses; and as many detections as the
reference returns.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from .. import harness, spans, weights
from ..harness import WindowClosed
from ..reference import boxes as ref_boxes
from ..reference import detector as ref_det
from ..reference import loader as ref_loader
from ..traffic import gen
from .train_loop import port_config


def run(r) -> dict:
    import torch

    c, tr = r.config, r.traffic
    pool = gen.serve_pool(r.seed, tr["pool"])
    w0 = weights.make(c, r.device)
    r.log(f"pool of {len(pool)} images and weights made")
    if r.control:
        result = {"attempted": 0, "failed": 0, "metrics": {},
                  "peak": torch.cuda.max_memory_allocated() if r.device == "cuda" else 0}
        sample = list(range(tr["check_requests"]))
        served = [_control_request(w0, pool[i % len(pool)], c, r.device) for i in sample]
    else:
        served, result = _port_run(r, pool, w0)
        rng = np.random.default_rng(harness.seed_ints(r.seed, 2)[0])
        n = len(served)
        sample = sorted(rng.choice(n, min(n, tr["check_requests"]), replace=False).tolist())
        largest = max(range(min(n, len(pool))), key=lambda i: pool[i].shape[0] * pool[i].shape[1])
        sample = sorted(set(sample) | {largest})
        served = [served[i] for i in sample]
    numbers = _judge(r, c, w0, pool, sample, served)
    ok, shown = harness.judge(numbers, c["limits"]["serve"])
    result["correct"] = ok and result["failed"] == 0
    result["compared"] = shown
    return result


def _port_run(r, pool, w0):
    import torch

    from rlobjectdetection_tpu_torch.engine import serve
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.ops import nms as nms_mod

    from ..trace import DeviceBusy, Profiled

    c, tr, dev = r.config, r.traffic, r.device
    cfg = port_config(c)
    model = FasterRCNN(c["num_classes"], c["backbone"], cfg, device=dev, seed=3)
    model.load_state_dict(w0)
    detector = serve.Detector(model, cfg, dev)
    kept = []
    propose = model._propose

    def keeping(*a, **kw):
        out = propose(*a, **kw)
        kept.append((out[0][0], out[2][0], a[0][0], a[1][0]))
        return out

    model._propose = keeping
    sizes = {}
    for i, im in enumerate(pool):
        sizes.setdefault(im.shape, i)
    for _ in range(2):
        for i in sizes.values():
            detector.detect(pool[i])
    harness.sync(dev)
    kept.clear()
    r.log(f"warmed {len(sizes)} image sizes: {sorted(sizes)}")

    prep, nms_calls = [], []
    lat, served, prof, profiled, shapes = [], [], None, [], []
    trace = prof_t = None
    prof_span = 0.0
    busy = DeviceBusy(lambda: harness.sync(dev)) if dev == "cuda" and not r.trace else None
    harness.sync(dev)
    with spans.timed(detector, "blob", prep, on=r.trace), \
            spans.timed(nms_mod, "nms_sorted_mask", nms_calls, on=r.trace,
                        sync=lambda: harness.sync(dev)), \
            busy or contextlib.nullcontext():
        t_start = time.perf_counter()
        try:
            i = 0
            while True:
                im = pool[i % len(pool)]
                t = time.perf_counter()
                dets = detector.detect(im)
                lat.append((time.perf_counter() - t) * 1e3)
                served.append(dets)
                shapes.append(im.shape)
                if prof is not None:
                    profiled.append(i)
                i += 1
                el = time.perf_counter() - t_start
                if r.trace and trace is None:
                    if prof is None and el >= 0.4 * r.seconds:
                        prof, prof_t = Profiled(lambda: harness.sync(dev), r.workdir), \
                            time.perf_counter()
                        prof.__enter__()
                    elif prof is not None and len(profiled) == tr["profile_requests"]:
                        prof.__exit__(None, None, None)
                        trace, prof = prof.trace, None
                        prof_span = time.perf_counter() - prof_t
                if el >= r.seconds and prof is None:
                    raise WindowClosed
        except WindowClosed:
            pass
        harness.sync(dev)
        window = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    r.log(f"window {window:.3f} s: {len(lat)} requests, p50 {np.percentile(lat, 50):.3f} ms, "
          f"p95 {np.percentile(lat, 95):.3f} ms"
          + (f", card busy {busy.busy_s:.4f} s in {busy.activities} activities" if busy else ""))
    metrics = {}
    if busy is not None:
        metrics["serve_device_ms"] = {"value": busy.busy_s * 1e3 / len(lat), "unit": "ms/request"}
    out = [(d,) + tuple(x.cpu() for x in kept[k]) for k, d in enumerate(served)]
    span = {"window": window, "t_start": t_start, "t_end": t_start + window, "latency_ms": lat,
            "prep_ms": prep, "nms_calls": nms_calls, "profiled": profiled, "trace": trace,
            "prof_t": prof_t, "prof_span": prof_span,
            "flops": [_request_flops(c, s) for s in shapes]}
    del detector, model, propose, kept
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out, {"attempted": len(lat), "failed": 0, "metrics": metrics, "peak": peak,
                 "span": span, "setup_s": t_start - r.t0}


def _request_flops(c: dict, shape) -> float:
    from ..counts import serve_flops

    blob = ref_loader.up32(round(shape[0] * c["test"]["scales"][0] / min(shape[:2]))), \
        ref_loader.up32(round(shape[1] * c["test"]["scales"][0] / min(shape[:2])))
    return serve_flops(blob[0], blob[1], c["test"]["rpn_post_nms_top_n"], c["num_classes"])


def _control_request(w0, im, c, dev):
    """The reference in fp8 serving one image as the port would: its own
    RPN outputs, proposals and detections."""
    import torch

    blob, info = ref_loader.test_blob(im, c["test"]["scales"][0])
    data, info = torch.from_numpy(blob).to(dev), torch.from_numpy(info).to(dev)
    out = {}
    with weights.full_f32():
        rois, prob, bbox = ref_det.detect_forward(w0, data, info, c, ref_det.Precision(True),
                                                  out=out)
    boxes, scores, classes = ref_det.postprocess(rois, prob, bbox, info[0], c)
    valid = rois[:, 1:5].abs().sum(1) > 0                     # the kept rows
    dets = (boxes, scores, classes, np.ones(len(scores), bool))
    return (dets, rois.cpu(), valid.cpu()) + tuple(x.cpu() for x in out["rpn"])


def _excess(boxes, thresh: float) -> float:
    """How far the largest IoU of two kept boxes lies above the NMS
    threshold, in float64 from the float32 boxes (0 where none does): greedy
    NMS keeps no pair above it, to the float32 rounding of an IoU."""
    if len(boxes) < 2:
        return 0.0
    ov = ref_boxes.iou(boxes.double(), boxes.double()).fill_diagonal_(0.0)
    return max(0.0, float(ov.max()) - thresh)


def _det_missing(per_class, prob, b, s, k, near, c: dict) -> int:
    """(Proposal, class) outputs left out of the returned detections that
    the post-process keeps: in the top `max_per_image` by the reference's
    score (beyond the score limit's band) and suppressed by no returned
    detection of the class ahead of them (IoU above TEST.NMS, less 0.02 for
    the boxes' rounding). Compared in the reference's boxes and scores."""
    import torch

    t = c["test"]
    band = c["limits"]["serve"]["score_gap"]
    cut = float(s.min()) if len(s) == t["max_per_image"] else None
    bad = 0
    for j in range(1, prob.shape[1]):
        sel = k == j
        taken = torch.zeros(prob.shape[0], dtype=torch.bool, device=prob.device)
        taken[near[sel]] = True
        bad += ref_boxes.unsuppressed(per_class[:, j], prob[:, j], taken, b[sel], s[sel],
                                      t["nms"], cut=cut, score_abs=1e-7, score_rel=band,
                                      iou_eps=0.02)
    return bad


def _judge(r, c, w0, pool, sample, served) -> dict:
    import torch

    dev = r.device
    t0 = time.perf_counter()
    worst = {"score_gap": 0.0, "box_gap": 0.0, "det_count_gap": 0.0, "det_missing": 0,
             "rpn_gap": 0.0, "rpn_foreign": 0, "rpn_missing": 0,
             "rpn_nms_excess": 0.0, "det_nms_excess": 0.0}
    t = c["test"]
    for idx, ((boxes, scores, classes, valid), rois, rvalid, rpn_s, rpn_d) in zip(sample,
                                                                                   served):
        im = pool[idx % len(pool)]
        blob, info = ref_loader.test_blob(im, c["test"]["scales"][0])
        data, info = torch.from_numpy(blob).to(dev), torch.from_numpy(info).to(dev)
        rois = rois[rvalid].to(dev)
        rpn_s, rpn_d = rpn_s.to(dev), rpn_d.to(dev)
        out = {}
        with weights.full_f32():
            _, prob, bbox = ref_det.detect_forward(w0, data, info, c, rois=rois, out=out)
            per_class = ref_det.class_boxes(rois, bbox, info[0], c)
            _, ref_scores, _ = ref_det.postprocess(rois, prob, bbox, info[0], c)
            foreign, missing = ref_det.proposal_faults(
                rpn_s, rpn_d, info[0], rois, c, t["rpn_pre_nms_top_n"],
                t["rpn_post_nms_top_n"], t["rpn_nms_thresh"])
        worst["rpn_gap"] = max(worst["rpn_gap"], ref_det.rpn_gap((rpn_s, rpn_d), out["rpn"]))
        worst["rpn_foreign"] += foreign
        worst["rpn_missing"] += missing
        worst["rpn_nms_excess"] = max(worst["rpn_nms_excess"],
                                      _excess(rois[:, 1:5], t["rpn_nms_thresh"]))
        b = torch.from_numpy(np.asarray(boxes)[valid]).to(dev)
        s = torch.from_numpy(np.asarray(scores)[valid]).to(dev)
        k = torch.from_numpy(np.asarray(classes)[valid].astype(np.int64)).to(dev)
        for j in torch.unique(k).tolist():
            worst["det_nms_excess"] = max(worst["det_nms_excess"], _excess(b[k == j], t["nms"]))
        cand = per_class[:, k].permute(1, 0, 2)                     # [M, R, 4]
        dist = (cand - b[:, None]).abs().amax(-1)                   # [M, R]
        near = dist.argmin(1)
        m = torch.arange(len(k), device=dev)
        p_ref = prob[near, k]
        worst["box_gap"] = max(worst["box_gap"], float(dist[m, near].max()))
        worst["score_gap"] = max(worst["score_gap"], float(((s - p_ref).abs() / p_ref).max()))
        worst["det_count_gap"] = max(worst["det_count_gap"], abs(len(s) - len(ref_scores)))
        with weights.full_f32():
            worst["det_missing"] += _det_missing(per_class, prob, b, s, k, near, c)
    r.log(f"reference: {len(sample)} requests in {time.perf_counter() - t0:.1f} s")
    return worst
