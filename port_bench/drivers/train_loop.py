"""Training cells: the port's `train_epochs` driving `make_train_step` (SGD
over the reference's groups) on the detector, over `RoiBatchLoader` or
`PackedRoiBatchLoader` on a synthetic COCO split written in set-up,
batches assembled on the traffic's worker threads.

Set-up builds the model, the optimizer, the loader and one `train_epochs`
call, warms a forward and backward at every canvas the epochs' plans can
give (no update), and lets that call run its first `record_steps` steps:
their batches, proposals, losses, the momentum after the first and the
parameters after the last are kept. The window then opens on the same
call and closes after `--seconds` at a step's end, synchronised; the loop
goes on across epoch boundaries. With `--trace 1` a profiler covers
`profile_steps` steps from 40% into the window.

Correct: once the window has closed and the model is freed, the reference
assembles the same first batches from the JPEG files and the plan's
seeds, and runs the same steps in float32 (TF32 off) from the same
weights, with the same sampling uniforms and the port's proposals. Held:
the batches (exact), each step's loss, the first gradient as SGD takes it
(d = g + wd·p, its momentum after one step) and the parameters' change
after the recorded steps, by the worst leaf's and the median leaf's gap
of norms. The proposals the reference takes are held on their own: the
first step's RPN outputs against the reference's, and each recorded
step's proposals against the RPN outputs the port's proposal layer was
given (each kept box a top-N candidate's decoded box, in score order, and
no candidate dropped that greedy NMS keeps).
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np

from .. import harness, spans, weights
from ..harness import WindowClosed
from ..reference import detector as ref_det
from ..reference import loader as ref_loader
from ..reference import train as ref_train
from ..traffic import gen
from ..window import StepWindow

LOSS_KEYS = ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box")


def port_config(c: dict):
    """The port's config for configuration `c`, checked against it."""
    from rlobjectdetection_tpu_torch.engine.serve import build_config

    t, e = c["train"], c["test"]
    sets = ["DTYPE", c["dtype"], "TRAIN.SCALES", str(list(t["scales"])),
            "TRAIN.RPN_PRE_NMS_TOP_N", str(t["rpn_pre_nms_top_n"]),
            "TRAIN.RPN_POST_NMS_TOP_N", str(t["rpn_post_nms_top_n"]),
            "TRAIN.BATCH_SIZE", str(t["rois_per_image"]),
            "TRAIN.WEIGHT_DECAY", str(t["weight_decay"]),
            "TRAIN.DOUBLE_BIAS", str(t["double_bias"]),
            "TRAIN.BG_THRESH_LO", str(t["bg_thresh_lo"]),
            "TEST.SCALES", str(list(e["scales"])),
            "TEST.RPN_PRE_NMS_TOP_N", str(e["rpn_pre_nms_top_n"]),
            "TEST.RPN_POST_NMS_TOP_N", str(e["rpn_post_nms_top_n"]),
            "TEST.MAX_DETS_PER_IMAGE", str(e["max_per_image"])]
    cfg = build_config(c["dataset"], sets, large_scale=True)
    stated = {"ANCHOR_SCALES": tuple(c["anchor_scales"]),
              "ANCHOR_RATIOS": tuple(float(r) for r in c["anchor_ratios"]),
              "MAX_NUM_GT_BOXES": c["max_num_gt_boxes"], "POOLING_MODE": c["pooling_mode"],
              "CONV1_FUSED": c["conv1_fused"], "LAYER1_FUSED": c["layer1_fused"],
              "STAGE_FUSED": c["stage_fused"], "TRAIN.USE_FLIPPED": t["use_flipped"],
              "TRAIN.RPN_NMS_THRESH": t["rpn_nms_thresh"], "TEST.NMS": e["nms"],
              "TEST.RPN_NMS_THRESH": e["rpn_nms_thresh"],
              "RESNET.FIXED_BLOCKS": t["fixed_blocks"],
              "TRAIN.WEIGHT_DECAY": t["weight_decay"], "TRAIN.DOUBLE_BIAS": t["double_bias"],
              "TRAIN.BG_THRESH_LO": t["bg_thresh_lo"], "TRAIN.FG_THRESH": t["fg_thresh"],
              "TRAIN.BG_THRESH_HI": t["bg_thresh_hi"]}
    for key, want in stated.items():
        got = cfg
        for part in key.split("."):
            got = getattr(got, part)
        got = tuple(float(x) for x in got) if key == "ANCHOR_RATIOS" else got
        if got != want:
            raise ValueError(f"the port's {key} is {got!r}, the configuration states {want!r}")
    return cfg


class TimedLoader:
    """A loader whose `assemble_job` is timed: (end time, ms, images) of
    each batch."""

    def __init__(self, loader):
        self.loader, self.times = loader, []

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def batch_plan(self):
        return self.loader.batch_plan()

    def assemble_job(self, job):
        t = time.perf_counter()
        batch = self.loader.assemble_job(job)
        end = time.perf_counter()
        self.times.append((end, (end - t) * 1e3, len(batch["data"])))
        return batch


def loader_seed(seed: int) -> int:
    """The loader's seed (its RandomState takes 32 bits)."""
    return harness.seed_ints(seed, 1)[0] % 2 ** 31


def _draws(seed: int, step: int, device: str):
    import torch

    s = harness.seed_ints(seed, 1000 + step, 2)
    return tuple(torch.Generator(device=device).manual_seed(x) for x in s)


def _warm_shapes(loader, epochs: int) -> list:
    """Every padded canvas the plans of epochs 1..epochs give."""
    shapes = set()
    for ep in range(1, epochs + 1):
        loader.set_epoch(ep)
        for idxs, ratio, seed in loader.batch_plan():
            shapes.add(loader.predict_train_canvas(idxs, ratio, seed))
    return sorted(shapes)


def run(r) -> dict:
    import torch

    c, tr = r.config, r.traffic
    t = c["train"]
    dev = r.device
    root = os.path.join(r.workdir, "data")
    records = gen.coco_split(root, r.seed, tr["split"])
    ref_roidb, ratios, order = ref_loader.train_roidb(records)
    jobs = ref_loader.plan(len(ref_roidb), ratios, order, tr["batch"], loader_seed(r.seed), 1)
    jobs = jobs[:tr["record_steps"]]
    w0 = weights.make(c, dev)
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
    from rlobjectdetection_tpu_torch.data.loader import RoiBatchLoader
    from rlobjectdetection_tpu_torch.data.packed import PackedRoiBatchLoader, pack_roidb
    from rlobjectdetection_tpu_torch.engine.trainval_net import train_epochs
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.ops import nms as nms_mod

    c, tr, dev = r.config, r.traffic, r.device
    t = c["train"]
    cfg = port_config(c)
    os.environ["RLOD_DATA_DIR"] = root
    split = tr["split"]
    _, roidb, ratio_list, ratio_index = combined_roidb(
        f"coco_{split['year']}_{split['split']}", training=True, use_flipped=t["use_flipped"])
    kw = dict(scales=cfg.TRAIN.SCALES, max_num_gt=cfg.MAX_NUM_GT_BOXES,
              seed=loader_seed(r.seed))
    if tr["input"] == "packed":
        pack = os.path.join(root, "pack")
        t_pack = time.perf_counter()
        pack_roidb(roidb, cfg.TRAIN.SCALES, pack, verbose=False)
        r.log(f"packed {len(roidb)} entries in {time.perf_counter() - t_pack:.1f} s")
        base = PackedRoiBatchLoader(roidb, ratio_list, ratio_index, tr["batch"], pack_root=pack,
                                    **kw)
    else:
        base = RoiBatchLoader(roidb, ratio_list, ratio_index, tr["batch"], **kw)
    loader = TimedLoader(base)

    model = FasterRCNN(c["num_classes"], c["backbone"], cfg, device=dev, seed=3)
    model.load_state_dict(w0)
    opt, sched, _ = engine.build_optimizer(
        model, c["backbone"], t["lr"], momentum=t["momentum"],
        weight_decay=cfg.TRAIN.WEIGHT_DECAY, double_bias=cfg.TRAIN.DOUBLE_BIAS,
        fixed_blocks=t["fixed_blocks"])
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
    rec = {"batches": [], "rois": [], "rpn": [], "losses": []}
    propose = model._propose

    def recording(*a, **kw_):
        out = propose(*a, **kw_)
        rec["rois"].append(out[0].detach().clone())
        rec["rpn"].append(tuple(x.detach().clone() for x in (a[0], a[1], a[2], out[2])))
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
                         sync=lambda: harness.sync(dev)):
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
                "p": {n: v.cpu() for n, v in rec["p"].items()}, "rois": rec["rois"],
                "rpn": rec["rpn"],
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
    from ..counts import train_step_flops

    return train_step_flops(shape[0], shape[1], shape[2], c["train"]["rois_per_image"],
                            c["num_classes"], c["train"]["fixed_blocks"])


def _judge(r, c, ref_roidb, jobs, w0: dict, readings) -> dict:
    """The compared numbers of the recorded steps."""
    import torch

    dev = r.device
    tr = r.traffic
    t0 = time.perf_counter()
    batches = [ref_loader.assemble(ref_roidb, j, c["train"]["scales"], c["max_num_gt_boxes"])
               for j in jobs]
    numbers = {}
    port_rpn = readings["rpn"] if readings is not None else None
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

    rois = readings["rois"] if readings is not None else [None] * len(jobs)
    if any(x is not None and x.shape[0] != len(j[0]) for x, j in zip(rois, jobs)):
        r.log("the port's proposals do not cover its batches: no comparison")
        return dict(numbers, loss_gap=math.inf, grad_gap=math.inf, update_gap=math.inf,
                    grad_gap_median=math.inf, update_gap_median=math.inf)
    with weights.full_f32():
        if readings is None:
            # in the program's place: the reference in fp8 (control 1), or
            # on the first half of each batch, its mean over that half (2)
            half = [{n: v[:len(v) // 2] for n, v in b.items()} for b in dbatches]
            p = {n: v.clone() for n, v in w0.items()}
            hist, d1, names, rois = ref_train.train_steps(
                p, dbatches if r.control == 1 else half, rois, uniforms(), c,
                ref_det.Precision(fp8=r.control == 1))
            if r.control == 2:
                rois = [None] * len(jobs)
            readings = {"losses": hist, "d1": d1, "names": sorted(names),
                        "p": {n: p[n] for n in names}}
        ref = {n: v.clone() for n, v in w0.items()}
        hist, d1, names, _ = ref_train.train_steps(ref, dbatches, rois, uniforms(), c)
    if sorted(names) != readings["names"]:
        raise RuntimeError("the port trains other leaves than the configuration states: "
                           f"{sorted(set(names) ^ set(readings['names']))[:5]}")
    numbers["loss_gap"] = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                              for g, w in zip(readings["losses"], hist))
    d_got = {n: readings["d1"][n].to(dev) for n in names}
    numbers["grad_gap"], leaf_g, numbers["grad_gap_median"], used, left = harness.norm_gap(
        d_got, d1, names)
    moved = {n: readings["p"][n].to(dev) - w0[n] for n in names}
    want = {n: ref[n] - w0[n] for n in names}
    numbers["update_gap"], leaf_u, numbers["update_gap_median"], _, _ = harness.norm_gap(
        moved, want, names)
    if port_rpn is not None or r.control == 1:
        numbers.update(_proposal_numbers(c, w0, dbatches[0]["data"], port_rpn,
                                         readings.get("rois")))
    r.log(f"reference: {len(jobs)} steps in {time.perf_counter() - t0:.1f} s; losses "
          f"{[round(g['loss'], 5) for g in readings['losses']]} vs "
          f"{[round(w['loss'], 5) for w in hist]}; worst leaves {leaf_g} (grad), {leaf_u} "
          f"(update); {used} leaves compared, {left} under 1e-3 of the median left out")
    return numbers


def _proposal_numbers(c, w0: dict, data0, port_rpn, rois) -> dict:
    """The proposals the reference takes, held on their own: `rpn_gap`, the
    first step's RPN outputs against the reference's from the same weights
    (the control's: its fp8 RPN's); `rpn_foreign` and `rpn_missing`, each
    recorded step's proposals against the RPN outputs its proposal layer
    was given (the port's only)."""
    import torch

    t = c["train"]
    with weights.full_f32(), torch.no_grad():
        want = ref_det.rpn(w0, ref_det.trunk(w0, data0))
        if port_rpn is None:
            q = ref_det.Precision(fp8=True)
            return {"rpn_gap": ref_det.rpn_gap(ref_det.rpn(w0, ref_det.trunk(w0, data0, q), q),
                                               want)}
        out = {"rpn_gap": ref_det.rpn_gap(port_rpn[0][:2], want), "rpn_foreign": 0,
               "rpn_missing": 0}
        for (cls, deltas, info, valid), step_rois in zip(port_rpn, rois):
            for b in range(cls.shape[0]):
                foreign, missing = ref_det.proposal_faults(
                    cls[b], deltas[b], info[b], step_rois[b][valid[b]], c,
                    t["rpn_pre_nms_top_n"], t["rpn_post_nms_top_n"], t["rpn_nms_thresh"])
                out["rpn_foreign"] += foreign
                out["rpn_missing"] += missing
    return out
