"""The FPN detector's training cell: the port's `train_epochs` driving
`make_train_step` (SGD with weight decay on every trained leaf, Detectron2's
groups, its linear warm-up) on `FPNFasterRCNN` (`--net res101_fpn`), over
`PackedRoiBatchLoader` on a synthetic COCO split written in set-up,
batches assembled on the traffic's worker threads.

The loop is `train_loop`'s: set-up builds the model, the optimizer, the
loader and one `train_epochs` call, warms a forward and backward at every
canvas the epochs' plans can give (no update), and lets that call run its
first `record_steps` steps, keeping their batches, proposals, losses, the
momentum after the first and the parameters after the last. The window
then opens on the same call and closes after `--seconds` at a step's end,
synchronised. With `--trace 1` a profiler covers `profile_steps` steps
from 40% into the window, its trace keeping the `user_annotation` ranges
of the program's spans (`port_bench/annotations.py`).

Correct: once the window has closed and the model is freed, the reference
(`reference/fpn.py`) assembles the same first batches from the JPEG files
and the plan's seeds and runs the same steps in float32 (TF32 off) from
the same weights, with the same sampling uniforms and the port's
proposals. Held: the batches (exact), each step's loss, the first gradient
as SGD takes it (d = g + wd·p) and the parameters' change after the
recorded steps, by the worst and the median leaf's gap of norms; and the
proposals on their own: the first step's RPN outputs against the
reference's, and each recorded step's proposals of each image against the
RPN outputs its proposal layer was given, level by level (each kept box a
level's top-N candidate's decoded box, in logit order, and no candidate
dropped that greedy NMS within its level keeps). The L1 losses' gradients
are signs, and where the reference's own residual lies within rounding of
0 (`reference/fpn.py::box_l1`) the port's may have the other sign: the
gaps are taken after `absorb_flips` has taken each such residual's
flipped share out of the two heads' last layers, and the residuals so
taken more than not are counted (`l1_flips`).
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np

from .. import annotations, harness, spans, weights, weights_fpn
from ..harness import WindowClosed
from ..reference import detector as ref_det
from ..reference import fpn as ref
from ..reference import loader as ref_loader
from ..traffic import gen
from ..window import StepWindow
from .train_loop import LOSS_KEYS, TimedLoader, _draws, _warm_shapes, loader_seed


def port_config(c: dict):
    """The port's config for configuration `c`, checked against it."""
    from rlobjectdetection_tpu_torch.engine.serve import build_config
    from rlobjectdetection_tpu_torch.models import fpn

    t, e = c["train"], c["test"]
    sets = ["DTYPE", c["dtype"], "TRAIN.SCALES", str(list(t["scales"])),
            "TRAIN.RPN_PRE_NMS_TOP_N", str(t["rpn_pre_nms_top_n"]),
            "TRAIN.RPN_POST_NMS_TOP_N", str(t["rpn_post_nms_top_n"]),
            "TRAIN.BATCH_SIZE", str(t["rois_per_image"]),
            "TEST.SCALES", str(list(e["scales"])),
            "TEST.RPN_PRE_NMS_TOP_N", str(e["rpn_pre_nms_top_n"]),
            "TEST.RPN_POST_NMS_TOP_N", str(e["rpn_post_nms_top_n"]),
            "TRAIN.LEARNING_RATE", str(t["lr"]), "TEST.MAX_DETS_PER_IMAGE",
            str(e["max_per_image"]), "MAX_NUM_GT_BOXES", str(c["max_num_gt_boxes"]),
            "STAGE_FUSED", str(c["stage_fused"])]
    cfg = build_config(c["dataset"], sets, net=c["net"])
    stated = {"TRAIN.RPN_PRE_NMS_TOP_N": t["rpn_pre_nms_top_n"],
              "TRAIN.RPN_POST_NMS_TOP_N": t["rpn_post_nms_top_n"],
              "TRAIN.RPN_NMS_THRESH": t["rpn_nms_thresh"],
              "TRAIN.RPN_BATCHSIZE": t["rpn_batchsize"],
              "TRAIN.RPN_FG_FRACTION": t["rpn_fg_fraction"],
              "TRAIN.RPN_POSITIVE_OVERLAP": t["rpn_positive_overlap"],
              "TRAIN.RPN_NEGATIVE_OVERLAP": t["rpn_negative_overlap"],
              "TRAIN.BATCH_SIZE": t["rois_per_image"], "TRAIN.FG_FRACTION": t["fg_fraction"],
              "TRAIN.FG_THRESH": t["fg_thresh"], "TRAIN.WEIGHT_DECAY": t["weight_decay"],
              "TRAIN.DOUBLE_BIAS": False, "TRAIN.BIAS_DECAY": True,
              "TRAIN.MOMENTUM": t["momentum"], "TRAIN.USE_FLIPPED": t["use_flipped"],
              "TRAIN.MAX_SIZE": t["max_size"],
              "TRAIN.BBOX_NORMALIZE_STDS": tuple(float(x) for x in t["bbox_normalize_stds"]),
              "TEST.RPN_PRE_NMS_TOP_N": e["rpn_pre_nms_top_n"],
              "TEST.RPN_POST_NMS_TOP_N": e["rpn_post_nms_top_n"],
              "TEST.RPN_NMS_THRESH": e["rpn_nms_thresh"], "TEST.NMS": e["nms"],
              "TEST.MAX_SIZE": e["max_size"],
              "ANCHOR_RATIOS": tuple(float(r) for r in c["anchor_ratios"]),
              "CONV1_FUSED": c["conv1_fused"], "LAYER1_FUSED": c["layer1_fused"],
              "RESNET.FIXED_BLOCKS": t["fixed_blocks"]}
    for key, want in stated.items():
        got = cfg
        for part in key.split("."):
            got = getattr(got, part)
        got = tuple(float(x) for x in got) if isinstance(got, tuple) else got
        if got != want:
            raise ValueError(f"the port's {key} is {got!r}, the configuration states {want!r}")
    module = {"fpn_out_channels": fpn.CHANNELS, "anchor_sizes": list(fpn.ANCHOR_SIZES),
              "anchor_strides": list(fpn.STRIDES), "box_head_fc_dim": fpn.HEAD_DIM,
              "score_thresh": fpn.TEST_SCORE_THRESH}
    for key, got in module.items():
        want = e[key] if key == "score_thresh" else c[key]
        if got != want:
            raise ValueError(f"the port's FPN {key} is {got!r}, the configuration states "
                             f"{want!r}")
    return cfg


def warmup_lr(t: dict, n: int) -> float:
    """The recipe's learning rate after n steps: WarmupMultiStepLR's linear
    warm-up from `warmup_factor`·lr over `warmup_iters` steps."""
    w = t["warmup_iters"]
    return t["lr"] * (t["warmup_factor"] + (1 - t["warmup_factor"]) * n / w if n < w else 1.0)


def run(r) -> dict:
    import torch

    c, tr = r.config, r.traffic
    dev = r.device
    root = os.path.join(r.workdir, "data")
    if not r.control:
        port_config(c)           # a program without the FPN net fails here, before any work
    records = gen.coco_split(root, r.seed, tr["split"])
    ref_roidb, ratios, order = ref_loader.train_roidb(records)
    jobs = ref_loader.plan(len(ref_roidb), ratios, order, tr["batch"], loader_seed(r.seed), 1)
    jobs = jobs[:tr["record_steps"]]
    w0 = weights_fpn.make(c, dev)
    r.log(f"data and weights made ({len(records)} images)")
    if r.control:
        readings = None
        result = {"correct": None, "attempted": 0, "failed": 0, "metrics": {},
                  "peak": torch.cuda.max_memory_allocated() if dev == "cuda" else 0}
    else:
        readings, result = _port_run(r, root, w0)
    numbers = _judge(r, c, ref_roidb, jobs, w0, readings)
    ok, shown = harness.judge(numbers, c["limits"]["train"])
    result["correct"] = ok and result["failed"] == 0
    result["compared"] = shown
    return result


def _port_run(r, root: str, w0: dict):
    import torch

    from rlobjectdetection_tpu_torch import engine
    from rlobjectdetection_tpu_torch.data.imdb import combined_roidb
    from rlobjectdetection_tpu_torch.data.packed import PackedRoiBatchLoader, pack_roidb
    from rlobjectdetection_tpu_torch.engine.trainval_net import train_epochs
    from rlobjectdetection_tpu_torch.models import build_detector
    from rlobjectdetection_tpu_torch.ops import nms as nms_mod

    c, tr, dev = r.config, r.traffic, r.device
    t = c["train"]
    cfg = port_config(c)
    os.environ["RLOD_DATA_DIR"] = root
    split = tr["split"]
    _, roidb, ratio_list, ratio_index = combined_roidb(
        f"coco_{split['year']}_{split['split']}", training=True, use_flipped=t["use_flipped"])
    pack = os.path.join(root, "pack")
    t_pack = time.perf_counter()
    pack_roidb(roidb, cfg.TRAIN.SCALES, pack, verbose=False)
    r.log(f"packed {len(roidb)} entries in {time.perf_counter() - t_pack:.1f} s")
    base = PackedRoiBatchLoader(roidb, ratio_list, ratio_index, tr["batch"], pack_root=pack,
                                scales=cfg.TRAIN.SCALES, max_num_gt=cfg.MAX_NUM_GT_BOXES,
                                seed=loader_seed(r.seed))
    loader = TimedLoader(base)

    model = build_detector(c["num_classes"], c["backbone"], cfg, device=dev, seed=3)
    model.load_state_dict(w0)
    opt, sched, _ = engine.build_optimizer(
        model, c["backbone"], t["lr"], momentum=t["momentum"],
        weight_decay=cfg.TRAIN.WEIGHT_DECAY, double_bias=cfg.TRAIN.DOUBLE_BIAS,
        bias_decay=cfg.TRAIN.BIAS_DECAY, fixed_blocks=t["fixed_blocks"],
        lr_schedule=lambda n: warmup_lr(t, n))
    step = engine.make_train_step(model, opt, sched)
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}

    shapes = _warm_shapes(base, tr["warm_epochs"])
    gen_w = torch.Generator(device=dev).manual_seed(0)
    for h, w in shapes:
        gt = torch.zeros((tr["batch"], cfg.MAX_NUM_GT_BOXES, 5), device=dev)
        gt[:, 0] = torch.tensor([w * 0.25, h * 0.25, w * 0.6, h * 0.6, 1.0], device=dev)
        out = model(torch.zeros((tr["batch"], h, w, 3), device=dev),
                    torch.tensor([[h, w, 1.0]] * tr["batch"], device=dev), gt,
                    train=True, generator=gen_w)
        sum(out[k] for k in ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls",
                             "rcnn_loss_bbox")).backward()
        opt.zero_grad(set_to_none=True)
    harness.sync(dev)
    r.log(f"warmed {len(shapes)} canvases: {shapes}")

    k = tr["record_steps"]
    rec = {"batches": [], "proposals": [], "rpn": [], "losses": []}
    propose = model._propose

    def recording(logits, deltas, hw, im_info, phase):
        out = propose(logits, deltas, hw, im_info, phase)
        rec["proposals"].append(tuple(x.detach().clone() for x in out))
        rec["rpn"].append((logits.detach().clone(), deltas.detach().clone(), list(hw),
                           im_info.detach().clone()))
        return out

    def before(i, batch):
        rec["batches"].append({n: batch[n].detach().cpu().clone()
                               for n in ("data", "im_info", "gt_boxes")})

    def after(i, batch, out):
        rec["losses"].append({n: float(out[n]) for n in ("loss",) + LOSS_KEYS})
        if i == 0:
            rec["d1"] = {n: opt.state[p]["momentum_buffer"].detach().clone()
                         if "momentum_buffer" in opt.state[p] else torch.zeros_like(p)
                         for n, p in trained.items()}
        if i == k - 1:
            rec["p"] = {n: p.detach().clone() for n, p in trained.items()}
            del model._propose

    model._propose = recording
    win = StepWindow(r, k, tr["batch"], tr["profile_steps"], lambda: harness.sync(dev),
                     busy=dev == "cuda")
    nms_calls = []
    try:
        with spans.timed(nms_mod, "nms_sorted_mask", nms_calls, on=r.trace,
                         sync=lambda: harness.sync(dev)), annotations.annotated_window():
            train_epochs(model, loader, win.wrap(step, before, after),
                         lambda g: _draws(r.seed, g, dev), start_epoch=1, epochs=10 ** 6,
                         num_workers=tr["workers"], on_step=win.on_step)
    except WindowClosed:
        pass
    span = win.close()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    r.log(f"window {span['window']:.3f} s: {span['steps']} steps, {span['images']} images "
          f"({span['images'] / span['window']:.3f} a second), {span['failed']} non-finite"
          + (f", card busy {span['busy_s']:.4f} s" if span["busy_s"] is not None else ""))
    metrics = {}
    if span["busy_s"] is not None:
        metrics["train_device_ms"] = {"value": span["busy_s"] * 1e3 / span["images"],
                                      "unit": "ms/image"}
    readings = {"losses": rec["losses"], "d1": {n: v.cpu() for n, v in rec["d1"].items()},
                "p": {n: v.cpu() for n, v in rec["p"].items()},
                "proposals": rec["proposals"], "rpn": rec["rpn"],
                "batches": rec["batches"], "names": sorted(trained)}
    span.update(loader_times=loader.times, nms_calls=nms_calls,
                flops=[_step_flops(c, s) for s in span["shapes"]])
    del step, opt, sched, model, trained, propose
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return readings, {"attempted": span["steps"], "failed": span["failed"], "metrics": metrics,
                      "peak": peak, "span": span, "setup_s": span["t_start"] - r.t0}


def _step_flops(c: dict, shape) -> float:
    from ..counts_fpn import fpn_train_step_flops

    return fpn_train_step_flops(shape[0], shape[1], shape[2], c["train"]["rois_per_image"],
                                c["num_classes"], c["train"]["fixed_blocks"])


def _judge(r, c, ref_roidb, jobs, w0: dict, readings) -> dict:
    """The compared numbers of the recorded steps."""
    import torch

    dev = r.device
    t0 = time.perf_counter()
    batches = [ref_loader.assemble(ref_roidb, j, c["train"]["scales"], c["max_num_gt_boxes"])
               for j in jobs]
    numbers = {}
    if readings is not None:
        gap = 0.0
        for got, want in zip(readings["batches"], batches):
            for n in ("data", "im_info", "gt_boxes"):
                a, b = got[n].numpy(), want[n]
                gap = max(gap, math.inf if a.shape != b.shape else float(np.abs(a - b).max()))
        numbers["batch_gap"] = gap if len(readings["batches"]) == len(batches) else math.inf
    dbatches = [{n: torch.from_numpy(v).to(dev) for n, v in b.items()} for b in batches]

    def uniforms():
        out = []
        for i in range(len(jobs)):
            g = _draws(r.seed, i, dev)[0]
            out.append(lambda shape, g=g: torch.rand(shape, generator=g, device=dev))
        return out

    given = ([(rois, valid) for rois, _, valid in readings["proposals"]]
             if readings is not None else [None] * len(jobs))
    if any(x is not None and x[0].shape[0] != len(j[0]) for x, j in zip(given, jobs)):
        r.log("the port's proposals do not cover its batches: no comparison")
        return dict(numbers, loss_gap=math.inf, grad_gap=math.inf, update_gap=math.inf,
                    grad_gap_median=math.inf, update_gap_median=math.inf)
    with weights.full_f32():
        if readings is None:
            # in the program's place: the reference in fp8 (control 1), or
            # on the first half of each batch, its mean over that half (2)
            half = [{n: v[:len(v) // 2] for n, v in b.items()} for b in dbatches]
            p = {n: v.clone() for n, v in w0.items()}
            hist, d1, names, given, _ = ref.train_steps(
                p, dbatches if r.control == 1 else half, given, uniforms(), c,
                ref_det.Precision(fp8=r.control == 1))
            if r.control == 2:
                given = [None] * len(jobs)
            readings = {"losses": hist, "d1": d1, "names": sorted(names),
                        "p": {n: p[n] for n in names}}
        p_ref = {n: v.clone() for n, v in w0.items()}
        hist, d1, names, _, bands = ref.train_steps(p_ref, dbatches, given, uniforms(), c)
    if sorted(names) != readings["names"]:
        raise RuntimeError("the port trains other leaves than the configuration states: "
                           f"{sorted(set(names) ^ set(readings['names']))[:5]}")
    numbers["loss_gap"] = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                              for g, w in zip(readings["losses"], hist))
    # the first step's gradient enters d1 once; step i's enters the update
    # p_K − p_0 as −Σ_{j ≥ i} lr_j μ^(j − i) of it
    d_got = {n: readings["d1"][n].to(dev) for n in names}
    diff = {n: d_got[n] - d1[n] for n in names}
    flips_first = ref.absorb_flips(diff, bands[:1], [1.0])
    d_got = {n: d1[n] + diff[n] for n in names}
    numbers["grad_gap"], leaf_g, numbers["grad_gap_median"], used, left = harness.norm_gap(
        d_got, d1, names)
    t = c["train"]
    lrs = [ref.lr_at(t, i) for i in range(len(bands))]
    coef = [-sum(lrs[j] * t["momentum"] ** (j - i) for j in range(i, len(lrs)))
            for i in range(len(lrs))]
    want = {n: p_ref[n] - w0[n] for n in names}
    diff = {n: readings["p"][n].to(dev) - w0[n] - want[n] for n in names}
    numbers["l1_flips"] = ref.absorb_flips(diff, bands, coef)
    moved = {n: want[n] + diff[n] for n in names}
    numbers["update_gap"], leaf_u, numbers["update_gap_median"], _, _ = harness.norm_gap(
        moved, want, names)
    if "rpn" in readings or r.control == 1:
        numbers.update(_proposal_numbers(c, w0, dbatches[0]["data"], readings.get("rpn"),
                                         readings.get("proposals")))
    r.log(f"reference: {len(jobs)} steps in {time.perf_counter() - t0:.1f} s; losses "
          f"{[round(g['loss'], 5) for g in readings['losses']]} vs "
          f"{[round(w['loss'], 5) for w in hist]}; worst leaves {leaf_g} (grad), {leaf_u} "
          f"(update); {used} leaves compared, {left} under 1e-3 of the median left out; "
          f"L1 residuals within rounding of 0: box head {[int(w['box_ties']) for w in hist]}, "
          f"RPN {[int(w['rpn_ties']) for w in hist]}; taken as flipped: "
          f"{flips_first} in the first gradient, {numbers['l1_flips']} in the update")
    return numbers


def _proposal_numbers(c, w0: dict, data0, port_rpn, proposals) -> dict:
    """`rpn_gap`: the first step's RPN outputs (logits, deltas) against the
    reference's from the same weights (the control's: its fp8 RPN's);
    `rpn_foreign` and `rpn_missing`: each recorded step's proposals of each
    image against the RPN outputs its proposal layer was given (the
    port's only)."""
    import torch

    t = c["train"]
    with weights.full_f32(), torch.no_grad():
        logits, deltas, _ = ref.rpn(w0, ref.neck(w0, ref.trunk(w0, data0)))
        want = (logits, deltas)
        if port_rpn is None:
            q = ref_det.Precision(fp8=True)
            got = ref.rpn(w0, ref.neck(w0, ref.trunk(w0, data0, q), q), q)
            return {"rpn_gap": ref_det.rpn_gap(got[:2], want)}
        out = {"rpn_gap": ref_det.rpn_gap(port_rpn[0][:2], want), "rpn_foreign": 0,
               "rpn_missing": 0}
        for (lg, dl, hw, info), (rois, scores, valid) in zip(port_rpn, proposals):
            for b in range(lg.shape[0]):
                foreign, missing = ref.proposal_faults(
                    lg[b], dl[b], hw, info[b], rois[b][valid[b]], scores[b][valid[b]], c,
                    t["rpn_pre_nms_top_n"], t["rpn_post_nms_top_n"], t["rpn_nms_thresh"])
                out["rpn_foreign"] += foreign
                out["rpn_missing"] += missing
    return out
