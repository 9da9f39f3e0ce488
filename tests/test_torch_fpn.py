"""The FPN detector (`models/fpn.py`, `--net res101_fpn`) against the
benchmark's plain reference (`port_bench/reference/fpn.py`), on the CPU in
f32 at a small size: ResNet-101 with seeded random weights (frozen BN
calibrated on the batch's first image), 3 classes, a batch of 2 images of
96×128 (P2 24×32 … P6 2×2, every level holding anchors and rois).

- the neck's P2..P6 and the RPN head's outputs;
- the proposal layer, level by level, at the train and test top-N; the
  keep set of lane NMS equals a Detectron2-style `batched_nms` over the
  levels (boxes offset by level), and the port's proposals pass the
  benchmark's own proposal check;
- the level assignment (threshold compares against ⌊4 + log2(·)⌋), the
  RoIAlignV2 plain formulation forward and its gradient against the
  reference's naive one under autograd, and the backward kernel's
  row-by-column rule emulated in numpy against the plain backward;
- the eval detections after the test-time post-process;
- one train step: the four losses, each trained leaf's gradient as SGD
  takes it (d = g + wd·p) and its update, with the reference fed the
  port's proposals and the same sampling uniforms;
- the 2-rank data-parallel step (gloo) against the one-process step;
- the CLIs: `trainval_net --net res101_fpn` trains a checkpoint that
  `test_net` evaluates, and an unknown `--net` exits 2 in each detector
  CLI;
- the benchmark cell's driver at a tiny size (correct against the
  reference), its FLOP count and the span-annotation reader.

Tolerances are relative to each tensor's largest magnitude; the reason is
given at each.
"""

import json
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import weights_fpn  # noqa: E402
from port_bench.reference import boxes as ref_boxes  # noqa: E402
from port_bench.reference import fpn as ref  # noqa: E402
from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step  # noqa: E402
from rlobjectdetection_tpu_torch.engine.detect import postprocess_detections  # noqa: E402
from rlobjectdetection_tpu_torch.engine.serve import build_config  # noqa: E402
from rlobjectdetection_tpu_torch.models import build_detector  # noqa: E402
from rlobjectdetection_tpu_torch.ops import library  # noqa: E402,F401  (registers rlod::)
from rlobjectdetection_tpu_torch.ops import roi_align_levels as L  # noqa: E402
import torch_threads  # noqa: E402,F401  (xdist workers share the cores)

NUM_CLASSES = 3
# f32 convolutions in another algorithm (the port's channels-last against
# the reference's NCHW) differ by f32 rounding: 1e-5 of a map's largest
F32_REL = 1e-5


def _rel(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _config() -> dict:
    with open(os.path.join(ROOT, "port_bench", "configs", "res101_fpn_coco.json")) as f:
        c = json.load(f)
    c["num_classes"] = NUM_CLASSES
    c["train"].update(rpn_pre_nms_top_n=300, rpn_post_nms_top_n=100, rois_per_image=64)
    c["test"].update(rpn_pre_nms_top_n=200, rpn_post_nms_top_n=50, max_per_image=20)
    return c


def _port_cfg(c: dict):
    t, e = c["train"], c["test"]
    return build_config("coco", [
        "DTYPE", "float32", "TRAIN.RPN_PRE_NMS_TOP_N", str(t["rpn_pre_nms_top_n"]),
        "TRAIN.RPN_POST_NMS_TOP_N", str(t["rpn_post_nms_top_n"]),
        "TRAIN.BATCH_SIZE", str(t["rois_per_image"]),
        "TEST.RPN_PRE_NMS_TOP_N", str(e["rpn_pre_nms_top_n"]),
        "TEST.RPN_POST_NMS_TOP_N", str(e["rpn_post_nms_top_n"]),
        "TEST.MAX_DETS_PER_IMAGE", str(e["max_per_image"])], net="res101_fpn")


def _batch():
    g = torch.Generator().manual_seed(0)
    data = torch.randn(2, 96, 128, 3, generator=g) * 60
    info = torch.tensor([[96.0, 128.0, 1.0], [96.0, 120.0, 1.0]])
    gt = torch.zeros(2, 50, 5)
    gt[0, 0] = torch.tensor([10.0, 20.0, 60.0, 90.0, 1.0])
    gt[1, :2] = torch.tensor([[30.0, 30.0, 110.0, 90.0, 2.0], [5.0, 5.0, 40.0, 30.0, 1.0]])
    return {"data": data, "im_info": info, "gt_boxes": gt}


def _uniform(seed: int):
    g = torch.Generator().manual_seed(seed)
    return lambda shape: torch.rand(shape, generator=g)


@pytest.fixture(scope="module")
def setup():
    c = _config()
    batch = _batch()
    w0 = weights_fpn.make(c, "cpu", calib=batch["data"][:1])
    model = build_detector(NUM_CLASSES, "resnet101_fpn", _port_cfg(c), device="cpu")
    model.load_state_dict(w0)
    return c, batch, w0, model


@pytest.fixture(scope="module")
def features(setup):
    c, batch, w0, model = setup
    with torch.no_grad():
        got = model.features(batch["data"], fwd_only=True)
        logits, deltas, hw = model.rpn(got)
        want = ref.neck(w0, ref.trunk(w0, batch["data"]))
        rl, rd, rhw = ref.rpn(w0, want)
    return got, want, (logits, deltas, hw), (rl, rd, rhw)


def test_neck_outputs_match_reference(features):
    got, want, _, _ = features
    assert [tuple(p.shape[-2:]) for p in got] == [(24, 32), (12, 16), (6, 8), (3, 4), (2, 2)]
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and _rel(g, w) <= F32_REL, (k, _rel(g, w))


def test_rpn_outputs_match_reference(features):
    _, _, (logits, deltas, hw), (rl, rd, rhw) = features
    assert hw == rhw and logits.shape == rl.shape and deltas.shape == rd.shape
    assert _rel(logits, rl) <= F32_REL and _rel(deltas, rd) <= F32_REL


@pytest.mark.parametrize("phase", ["train", "test"])
def test_level_proposals_match_reference(setup, features, phase):
    """The same RPN outputs into both proposal layers: the same boxes kept in
    the same order (the port's NMS compares IoU as inter > thr·union, the
    reference as IoU > thr: no pair here lies within rounding of 0.7)."""
    c, batch, w0, model = setup
    _, _, (logits, deltas, hw), _ = features
    ph = getattr(model.cfg, phase.upper())
    rois, scores, valid = model._propose(logits, deltas, hw, batch["im_info"], ph)
    p = c[phase]
    want, want_valid = ref.proposals(logits, deltas, hw, batch["im_info"], c,
                                     p["rpn_pre_nms_top_n"], p["rpn_post_nms_top_n"],
                                     p["rpn_nms_thresh"])
    assert torch.equal(valid, want_valid) and int(valid.sum()) > 0
    assert (rois - want).abs().max() <= 1e-4
    for b in range(2):
        faults = ref.proposal_faults(logits[b], deltas[b], hw, batch["im_info"][b],
                                     rois[b][valid[b]], scores[b][valid[b]], c,
                                     p["rpn_pre_nms_top_n"], p["rpn_post_nms_top_n"],
                                     p["rpn_nms_thresh"])
        assert faults == (0, 0)


def test_lane_nms_keeps_what_batched_nms_keeps(setup, features):
    """Detectron2's `batched_nms` runs one NMS over every level's boxes
    shifted apart by level (no two levels overlap), then keeps the top N:
    the port's lanes of one level each, merged by score, keep that set."""
    c, batch, w0, model = setup
    _, _, (logits, deltas, hw), _ = features
    t = c["train"]
    rois, _, valid = model._propose(logits, deltas, hw, batch["im_info"], model.cfg.TRAIN)
    anc, sizes = ref.anchors(hw, c["anchor_ratios"], logits.device)
    for b in range(2):
        cands = ref.level_candidates(logits[b], deltas[b], anc, sizes, batch["im_info"][b],
                                     t["rpn_pre_nms_top_n"])
        boxes = torch.cat([x[2] for x in cands])
        scores = torch.cat([x[1] for x in cands])
        ok = torch.cat([x[3] for x in cands])
        lvl = torch.cat([torch.full((len(x[1]),), i) for i, x in enumerate(cands)])
        shifted = boxes + (lvl.float() * (boxes.max() + 1.0))[:, None]
        keep = ref_boxes.greedy_nms(shifted, scores, t["rpn_nms_thresh"],
                                    max_keep=t["rpn_post_nms_top_n"], valid=ok)
        want = {tuple(r) for r in boxes[torch.from_numpy(keep)].tolist()}
        got = {tuple(r) for r in rois[b][valid[b]][:, 1:].tolist()}
        assert got == want and len(got) == min(t["rpn_post_nms_top_n"], int(ok.sum()))


def test_level_assignment_matches_the_log2_formula():
    """2 + [v ≥ ½] + [v ≥ 1] + [v ≥ 2] against ⌊4 + log2(√area / 224 +
    1e-8)⌋ in [2, 5], over random boxes and the boundaries' exact sizes."""
    g = torch.Generator().manual_seed(3)
    side = torch.exp(torch.empty(4000, 2).uniform_(0.0, math.log(1500.0), generator=g))
    edges = torch.tensor([[s, s] for s in (56.0, 112.0, 224.0, 448.0, 896.0, 111.99, 112.01)])
    wh = torch.cat([side, edges])
    x1 = torch.rand(len(wh), generator=g) * 100
    rois = torch.stack([torch.zeros(len(wh)), x1, x1, x1 + wh[:, 0], x1 + wh[:, 1]], 1)
    got = L.roi_levels(rois) + 2
    assert torch.equal(got, ref.roi_levels(rois))
    assert set(got.tolist()) == {2, 3, 4, 5}


def _pool_inputs(seed: int = 4):
    """P2..P5 of two 512×640 images (8 channels) and 80 rois of sides 8 to
    900 pixels (every level), some crossing the image's edges."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(2, 128, 160, 8), (2, 64, 80, 8), (2, 32, 40, 8), (2, 16, 20, 8)]
    feats = [torch.randn(s, generator=g) for s in shapes]
    side = torch.exp(torch.empty(80, 2).uniform_(math.log(8.0), math.log(900.0), generator=g))
    ctr = torch.rand(80, 2, generator=g) * torch.tensor([640.0, 512.0])
    rois = torch.cat([(torch.arange(80) % 2).float()[:, None], ctr - side / 2, ctr + side / 2], 1)
    rois[:4, 3] = rois[:4, 1]               # zero width: no sample, a zero bin
    rois[4:8, 1:] = torch.tensor([-30.0, -30.0, -10.0, -10.0])      # outside the image
    assert set(L.roi_levels(rois[8:]).tolist()) == {0, 1, 2, 3}
    return feats, rois


def test_roi_align_plain_matches_reference():
    """The plain formulation (padded sample grids) against the reference's
    naive one (grouped by grid), both f32: the same samples summed in
    other orders."""
    feats, rois = _pool_inputs()
    got = L.roi_align_levels_plain(feats, rois)
    want = ref.roi_align_v2([f.permute(0, 3, 1, 2) for f in feats], rois).permute(0, 2, 3, 1)
    assert _rel(got, want) <= F32_REL and got[:8].abs().max() == 0


def test_roi_align_op_gradient_matches_reference_autograd():
    """`rlod::roi_align_levels`'s autograd on CPU tensors (the plain
    backward) against autograd through the reference: sums of the same
    terms in other orders."""
    feats, rois = _pool_inputs(5)
    a = [f.clone().requires_grad_() for f in feats]
    b = [f.clone().permute(0, 3, 1, 2).requires_grad_() for f in feats]
    w = torch.randn(len(rois), 7, 7, 8, generator=torch.Generator().manual_seed(1))
    (L.roi_align_levels(a, rois) * w).sum().backward()
    (ref.roi_align_v2(b, rois) * w.permute(0, 3, 1, 2)).sum().backward()
    for x, y in zip(a, b):
        assert _rel(x.grad, y.grad.permute(0, 2, 3, 1)) <= F32_REL


def _emulate_backward(grad, rois, shapes, maxr: int = 8):
    """`csrc/roi_align_levels.cu`'s backward rule in numpy (float64 sums):
    each output row's y samples summed into the rows they touch (Wy), its
    bins' x samples streamed left to right into two columns' sums, each
    finished column added into every touched row."""
    f32 = np.float32
    out = [np.zeros(s, np.float64) for s in shapes]

    def sample(start, b, p, i, n):
        return f32(f32(start + f32(f32(p) * b)) + f32(f32(f32(i) + f32(0.5)) * b) / f32(n))

    def corners(x, size):
        if x < -1 or x > size:
            return None
        x = max(x, f32(0))
        lo = int(x)
        if lo >= size - 1:
            return size - 1, size - 1, f32(0)
        return lo, lo + 1, f32(x - lo)

    for r, roi in enumerate(rois):
        k = int(L.roi_levels(torch.from_numpy(roi[None]))[0])
        s = f32(1.0 / (1 << (k + 2)))
        sx, sy = f32(f32(roi[1] * s) - f32(0.5)), f32(f32(roi[2] * s) - f32(0.5))
        rw = f32(f32(f32(roi[3] * s) - f32(0.5)) - sx)
        rh = f32(f32(f32(roi[4] * s) - f32(0.5)) - sy)
        bh, bw = f32(rh / f32(7)), f32(rw / f32(7))
        gh, gw = math.ceil(bh), math.ceil(bw)
        if gh <= 0 or gw <= 0:
            continue
        h, w = shapes[k][1], shapes[k][2]
        db = out[k][min(max(int(roi[0]), 0), shapes[k][0] - 1)]
        for py in range(7):
            ys = [y for y in (corners(sample(sy, bh, py, i, gh), h) for i in range(gh)) if y]
            if not ys:
                continue
            lo = ys[0][0]
            if ys[-1][1] - lo >= maxr:          # a tall roi: each sample into its corners
                for px in range(7):
                    gv = grad[r, py, px] / max(gh * gw, 1)
                    for y0, y1, ly in ys:
                        for i in range(gw):
                            x = corners(sample(sx, bw, px, i, gw), w)
                            if x is not None:
                                x0, x1, lx = x
                                for yy, wy_ in ((y0, 1 - ly), (y1, ly)):
                                    db[yy, x0] += wy_ * (1 - lx) * gv
                                    db[yy, x1] += wy_ * lx * gv
                continue
            wy = np.zeros(maxr)
            for y0, y1, ly in ys:
                wy[y0 - lo] += 1 - ly
                wy[y1 - lo] += ly
            col, a0, a1 = -2, np.zeros(shapes[k][3]), np.zeros(shapes[k][3])

            def flush(cl, acc):
                for j in range(maxr):
                    if wy[j] != 0:
                        db[lo + j, cl] += wy[j] * acc
                acc[:] = 0

            for px in range(7):
                gv = grad[r, py, px] / max(gh * gw, 1)
                for i in range(gw):
                    x = corners(sample(sx, bw, px, i, gw), w)
                    if x is None:
                        continue
                    x0, x1, lx = x
                    if x0 != col:
                        if col >= 0:
                            flush(col, a0)
                        if x0 == col + 1:
                            a0[:], a1[:] = a1, 0
                        elif col >= 0:
                            flush(col + 1, a1)
                        col = x0
                    a0 += (1 - lx) * gv
                    if x1 == x0:
                        a0 += lx * gv
                    else:
                        a1 += lx * gv
            if col >= 0:
                flush(col, a0)
                if col + 1 < w:
                    flush(col + 1, a1)
    return out


def test_backward_kernel_rule_matches_plain_backward():
    """The kernel's rows-by-columns sums (emulated) against the plain
    per-sample backward: the same products summed in other orders."""
    feats, rois = _pool_inputs(6)
    shapes = [tuple(f.shape) for f in feats]
    grad = torch.randn(len(rois), 7, 7, 8, generator=torch.Generator().manual_seed(2))
    want = L.roi_align_levels_plain_backward(grad, rois, shapes, torch.float32)
    got = _emulate_backward(grad.double().numpy(), rois.numpy(), shapes)
    for k, (a, b) in enumerate(zip(got, want)):
        assert _rel(torch.from_numpy(a), b) <= F32_REL, k


def test_eval_detections_match_reference(setup):
    """The eval forward and the test-time post-process (score > 0.05, NMS
    0.5 within each class, the 20 best): the same detections."""
    c, batch, w0, model = setup
    data, info = batch["data"][:1], batch["im_info"][:1]
    with torch.no_grad():
        out = model(data, info)
    boxes, scores, classes, valid = postprocess_detections(
        out["rois"][0], out["cls_prob"][0], out["bbox_pred"][0], info[0], out["roi_valid"][0],
        num_classes=NUM_CLASSES, max_per_image=c["test"]["max_per_image"],
        nms_thresh=model.cfg.TEST.NMS, score_thresh=model.test_score_thresh)
    rois, rvalid, prob, bbox = ref.detect_forward(w0, data, info, c)
    assert torch.equal(out["roi_valid"][0], rvalid)
    assert _rel(out["cls_prob"][0], prob) <= F32_REL
    wb, ws, wc = ref.postprocess(rois, rvalid, prob, bbox, info[0], c)
    n = int(valid.sum())
    assert n == len(ws) > 0
    assert np.abs(scores[:n].numpy() - ws).max() <= 1e-5
    assert np.array_equal(classes[:n].numpy(), wc)
    assert np.abs(boxes[:n].numpy() - wb).max() <= 1e-3


def test_box_l1_takes_the_other_sign_only_at_a_rounding_tie():
    """The reference's L1 band and the comparison's rule for it: the band is
    the foreground residuals within 2^-5 of the largest prediction, found by
    the reference alone; `absorb_flips` takes out of a gradient's (or an
    update's) gap the share of a band residual whose sign the other
    computation took the other way round, and counts it; a flip outside the
    band stays in the gap."""
    pred = torch.tensor([[1e-4, -0.5, 0.3, 2.0], [-1e-4, 0.2, 0.0, 0.0]], requires_grad=True)
    target = torch.tensor([[0.0, 0.0, 0.0, 1.0], [0.0, 0.2, 0.0, 0.0]])
    fg = torch.tensor([True, False])
    l1, band = ref.box_l1(pred, target, fg)
    assert torch.equal(l1.detach(), (pred - target).abs().detach())
    # row 0: the first residual lies in the band (1e-4 ≤ 2^-5 · 2); row 1 is
    # background
    assert band.tolist() == [[True, False, False, False], [False] * 4]
    res = (pred - target).detach()
    x = torch.randn(2, 5, generator=torch.Generator().manual_seed(0))
    for head, (wn, bn) in ref.LAST_LAYER.items():
        shape = (8, 5, 1, 1) if head == "rpn" else (8, 5)
        entries = {head: ref.band_entries(res, band, 4 * torch.tensor([1, 0]), x, 3.0)}

        def grad(signs):
            """The last layer's gradient of Σ signs · res / 3 over row 0
            (outputs 4..7)."""
            w, b = torch.zeros(8, 5), torch.zeros(8)
            w[4:] = signs[:, None] * x[0] / 3.0
            b[4:] = signs / 3.0
            return {wn: w.reshape(shape), bn: b}

        want = grad(torch.sign(res[0]))
        for flipped, absorbed in ((0, True), (1, False)):
            signs = torch.sign(res[0])
            signs[flipped] *= -1
            got = grad(signs)
            for w in (1.0, -0.5):       # a first gradient; an update's share of it
                diff = {n: w * (got[n] - want[n]) for n in want}
                flips = ref.absorb_flips(diff, [entries], [w])
                gap = sum(float(d.norm()) for d in diff.values())
                assert (flips, gap < 1e-6) == ((1, True) if absorbed else (0, False)), (
                    head, flipped, w)


@pytest.fixture(scope="module")
def train_step(setup):
    """One port step (f32, SGD at lr 0.01 with weight decay on every trained
    leaf) and the reference's step on the same batch, uniforms and the
    port's proposals."""
    c, batch, w0, _ = setup
    model = build_detector(NUM_CLASSES, "resnet101_fpn", _port_cfg(c), device="cpu")
    model.load_state_dict(w0)
    t = c["train"]
    opt, sched, _ = build_optimizer(model, "resnet101_fpn", 0.01, weight_decay=t["weight_decay"],
                                    double_bias=False, bias_decay=True)
    given = []
    propose = model._propose

    def recording(*a):
        out = propose(*a)
        given.append((out[0].clone(), out[2].clone()))
        return out

    model._propose = recording
    metrics = make_train_step(model, opt, sched)(batch, _uniform(5))
    d = {n: opt.state[p]["momentum_buffer"].clone() for n, p in model.named_parameters()
         if p.requires_grad}
    after = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    p = {n: v.clone() for n, v in w0.items()}
    ref_c = dict(c, train=dict(t, lr=0.01, warmup_iters=0))
    hist, want_d, names, _, _ = ref.train_steps(p, [batch], given, [_uniform(5)], ref_c)
    return metrics, d, after, hist[0], want_d, names, p, w0


def test_train_losses_match_reference(train_step):
    metrics, _, _, hist, _, _, _, _ = train_step
    for k in ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "loss"):
        assert abs(float(metrics[k]) - hist[k]) <= 1e-5 * abs(hist[k]), k
    assert float(metrics["fg_cnt"]) == float(hist["fg"]) > 0


def _leaf_gaps(got: dict, want: dict, names) -> list:
    """Each leaf's ‖got − want‖ / ‖want‖, sorted."""
    return sorted(float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30))
                  for n in names)


# A ReLU whose input lies within rounding of 0 passes or stops its gradient
# by the last bit of the sums before it (`models/backbones/resnet_ties.py`):
# one such gate moves its block's gradients by a few 1e-3 (1.4e-3 of
# layer3.block1.conv1's norm on this batch). So the worst leaf is held at
# 1e-2 and the median leaf, which no gate reaches, at the rounding of sums
# in other orders (3e-7 measured).
WORST_LEAF, MEDIAN_LEAF = 1e-2, 1e-5


def test_train_gradients_and_update_match_reference(train_step):
    """Each trained leaf's d (= g + wd·p) and update (lr·the momentum, lr·d
    at the first step) against the reference's."""
    _, d, after, _, want_d, names, p, w0 = train_step
    assert sorted(names) == sorted(d) and len(names) == 123
    for gaps in (_leaf_gaps(d, want_d, names),
                 _leaf_gaps({n: after[n] - w0[n] for n in names},
                            {n: p[n] - w0[n] for n in names}, names)):
        assert gaps[-1] <= WORST_LEAF and gaps[len(gaps) // 2] <= MEDIAN_LEAF, gaps[-3:]


def test_two_rank_step_matches_one_process(setup):
    """The FPN step over 2 gloo ranks (one image each) against the
    one-process step on the batch of 2, from the calibrated weights (each
    run its own copy: a run's SGD updates its weights in place): the
    losses to 1e-5 (1e-7 measured), gradients and updates by the leaves'
    gaps of `test_train_gradients_and_update_match_reference` (the ranks'
    convolutions see one image, the one process two: oneDNN's blocking
    orders the sums otherwise, and rounding-decided ReLU gates follow; the
    gradient is a mean over ranks, a reassociated sum)."""
    from rlobjectdetection_tpu_torch.parallel.dryrun import launch, run_spec

    c, b, w0, _ = setup
    batch = {k: v.numpy() for k, v in b.items()}
    batch["num_boxes"] = np.asarray([1, 2], np.int32)
    spec = dict(kind="detector", backbone="resnet101_fpn", num_classes=NUM_CLASSES,
                cfg=_port_cfg(c), batch=batch, draw_seed=7, lr=0.01, device="cpu")
    one = run_spec({**spec, "state": {k: v.clone() for k, v in w0.items()}})
    two = launch(2, {**spec, "state": {k: v.clone() for k, v in w0.items()}})
    for k in ("loss", "rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "fg_cnt", "bg_cnt"):
        g, w = two[0]["metrics"][k], one["metrics"][k]
        assert all(r["metrics"][k] == g for r in two), k
        assert abs(g - w) <= 1e-5 * abs(w) + 1e-9, (k, g, w)
    assert one["metrics"]["fg_cnt"] > 0 and one["grads"]
    names = list(one["grads"])
    for gaps in (_leaf_gaps(two[0]["grads"], one["grads"], names),
                 _leaf_gaps(two[0]["params"], one["params"], names)):
        assert gaps[-1] <= WORST_LEAF and gaps[len(gaps) // 2] <= MEDIAN_LEAF, gaps[-3:]


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    from rlobjectdetection_tpu_torch.data import synthetic

    root = tmp_path_factory.mktemp("fpn_coco")
    for split, first in (("train", 1000), ("valminusminival", 2000), ("minival", 3000)):
        synthetic.make_coco_dataset(str(root), num_images=2, split=split, year="2014",
                                    image_size=(72, 96), first_id=first)
    return root


def test_trainval_net_trains_and_test_net_serves_res101_fpn(coco_root, tmp_path, monkeypatch):
    from rlobjectdetection_tpu_torch.engine import test_net, trainval_net

    monkeypatch.setenv("RLOD_DATA_DIR", str(coco_root))
    monkeypatch.chdir(tmp_path)
    small = ["DTYPE", "float32", "TRAIN.SCALES", "[96]", "TEST.SCALES", "[96]",
             "TRAIN.RPN_PRE_NMS_TOP_N", "200", "TRAIN.RPN_POST_NMS_TOP_N", "50",
             "TRAIN.BATCH_SIZE", "32", "TEST.RPN_PRE_NMS_TOP_N", "100",
             "TEST.RPN_POST_NMS_TOP_N", "30", "TEST.MAX_DETS_PER_IMAGE", "10",
             "TRAIN.USE_FLIPPED", "False"]
    out = trainval_net.main(["--dataset", "coco", "--net", "res101_fpn", "--bs", "2",
                             "--epochs", "1", "--lr", "0.001", "--nw", "0", "--device", "cpu",
                             "--save_dir", str(tmp_path / "models"), "--set", *small])
    assert out["step"] == 2 and os.path.exists(out["checkpoints"][0])
    stats = test_net.main(["--dataset", "coco", "--net", "res101_fpn", "--device", "cpu",
                           "--load_dir", str(tmp_path / "models"), "--s", "1",
                           "--checkepoch", "1", "--set", *small])
    assert len(stats) == 12


@pytest.mark.parametrize("cli", ["trainval_net", "serve", "test_net", "demo", "export_model"])
def test_unknown_net_exits_2(cli):
    import importlib

    mod = importlib.import_module(f"rlobjectdetection_tpu_torch.engine.{cli}")
    with pytest.raises(SystemExit) as e:
        if cli == "serve":
            mod.main(["--image_dir", ".", "--net", "res101_fpn2"])
        else:
            mod.parse_args(["--net", "res101_fpn2"])
    assert e.value.code == 2


def test_fpn_recipe_config():
    cfg = build_config("coco", None, net="res101_fpn")
    assert (cfg.TRAIN.RPN_PRE_NMS_TOP_N, cfg.TRAIN.RPN_POST_NMS_TOP_N, cfg.TRAIN.BATCH_SIZE,
            cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N, cfg.TEST.NMS) == (
        2000, 1000, 512, 1000, 1000, 0.5)
    assert build_config("coco", None).TRAIN.RPN_PRE_NMS_TOP_N == 12000


def test_benchmark_cell_is_correct_at_a_tiny_size(tmp_path):
    """The cell's driver on the CPU at 96 px, f32, with limits for f32 (the
    cell's are for bf16 against f32): correct, and every compared number
    present."""
    from port_bench import harness
    from port_bench.drivers import fpn_train_loop

    c = _config()
    c["num_classes"] = 81                   # the traffic's 80 classes and background
    with open(os.path.join(ROOT, "port_bench", "traffic", "coco_train_packed_fpn.json")) as f:
        tr = json.load(f)
    c["dtype"] = "float32"
    c["train"].update(scales=[96], rois_per_image=32)
    c["test"].update(scales=[96])
    c["limits"]["train"] = {"batch_gap": 0.0, "loss_gap": 1e-3, "grad_gap": 1e-2,
                            "update_gap": 1e-2, "grad_gap_median": 1e-3,
                            "update_gap_median": 1e-3, "rpn_gap": 1e-3, "rpn_foreign": 0,
                            "rpn_missing": 0, "l1_flips": 0}
    tr["split"].update(images=8, sizes=[[64, 48], [48, 64], [61, 61], [64, 51]])
    tr["warm_epochs"] = 1
    r = harness.Run(workload="res101fpn.train.packed", seed=2 ** 31 + 11, seconds=1.0,
                    trace=False, config=c, traffic=tr, t0=time.perf_counter(), device="cpu",
                    workdir=str(tmp_path))
    out = fpn_train_loop.run(r)
    assert out["correct"], out["compared"]
    assert set(out["compared"]) == set(c["limits"]["train"])


def test_flop_count_of_the_cell():
    """1.48 TFLOP a train step an image at 800×1216 (512 rois, 81 classes),
    of which the neck and the RPN over the pyramid are 206 GFLOP forward."""
    from port_bench import counts_fpn

    parts = counts_fpn.fpn_parts(800, 1216)
    assert round(parts["neck"] / 1e9) == 110 and round(parts["rpn"] / 1e9) == 96
    assert abs(counts_fpn.fpn_train_step_flops(1, 800, 1216, 512, 81) / 1e12 - 1.482) < 1e-3
    ops, nbytes, _ = counts_fpn.roi_align_levels_work(
        [[2, 200, 304, 256], [2, 100, 152, 256], [2, 50, 76, 256], [2, 25, 38, 256],
         [1024, 5]], ["c10::BFloat16"] * 4 + ["float"])
    assert ops == 8.0 * 1024 * 49 * 256 and nbytes == 2 * (2 * 256 * (
        200 * 304 + 100 * 152 + 50 * 76 + 25 * 38) + 1024 * 49 * 256) + 4 * 5 * 1024


def test_annotation_reader_counts_launches_inside_a_span():
    from port_bench.annotations import annotation_device_s

    events = [
        {"cat": "user_annotation", "name": "model.fpn", "tid": 1, "ts": 100, "dur": 50},
        {"cat": "user_annotation", "name": "train.step", "tid": 1, "ts": 0, "dur": 1000},
        {"cat": "cuda_runtime", "tid": 1, "ts": 120, "dur": 2, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "tid": 1, "ts": 300, "dur": 2, "args": {"correlation": 8}},
        {"cat": "cuda_runtime", "tid": 2, "ts": 130, "dur": 2, "args": {"correlation": 9}},
        {"cat": "kernel", "ts": 500, "dur": 40, "args": {"correlation": 7}},
        {"cat": "kernel", "ts": 600, "dur": 10, "args": {"correlation": 8}},
        {"cat": "kernel", "ts": 700, "dur": 5, "args": {"correlation": 9}},
    ]
    got = annotation_device_s(events)
    assert got == {"model.fpn": 40e-6, "train.step": 50e-6}
