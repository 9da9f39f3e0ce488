"""RL training cells: the port's `train_epochs` driving `rl_train_step` on
`RLPolicyNet` (float32, TF32 off; the stem, layer1 and residual-stage
kernels in the frozen trunk), over `COCODataset` / `COCODataLoader` on a
synthetic COCO split and a synthetic detector's results written in
set-up: ΔIoU labels of every detection and action made on the host, the
transform and the collate on the traffic's worker threads, only the
arrays crossing to the card (`trainval_rl.train_arrays`), as the
`trainval_rl` CLI trains.

Set-up, window and trace as in `train_loop` (`port_bench/window.py`); the
first `record_steps` steps keep their batches, the first step's action
values and momentum, and the parameters after the last. Correct: once the
window has closed and the net is freed, the reference labels the
detections and assembles the same batches from the files and the plan's
seeds, then runs the same steps in float32 (TF32 off) from the same
weights. Held: the batches and labels (exact), the first action values
(the largest gap over the largest value), each step's loss, the first
gradient as SGD takes it and the parameters' change, by the worst leaf's
gap of norms.
"""

from __future__ import annotations

import gc
import json
import math
import os
import time

import numpy as np

from .. import harness, weights
from ..harness import WindowClosed
from ..reference import detector as ref_det
from ..reference import rl as ref_rl
from ..traffic import gen
from ..window import StepWindow
from .train_loop import TimedLoader

ARRAYS = ("data", "bboxes", "targets", "weights", "num_dts")


def rl_weights(c: dict, dev: str) -> dict:
    """The trunk and layer4 of the detector's weights (`weights.make`); fc8
    and fc lecun-normal from the configuration's `weights_seed`, zero
    biases."""
    import torch

    with open(os.path.join(harness.ROOT, "port_bench", "configs",
                           c["detector_config"] + ".json")) as f:
        det = weights.make(json.load(f), dev)
    p = {k: v for k, v in det.items() if k.startswith(("base.", "head."))}
    g = torch.Generator(device=dev).manual_seed(harness.seed_ints(c["weights_seed"], 3)[0])
    for name, shape in (("fc8", (4096, 2048)), ("fc", (c["num_acts"], 4096))):
        p[name + ".weight"] = torch.randn(shape, generator=g, device=dev) * math.sqrt(
            1.0 / shape[1])
        p[name + ".bias"] = torch.zeros(shape[0], device=dev)
    return p


def loader_seed(seed: int) -> int:
    return harness.seed_ints(seed, 4)[0] % 2 ** 31


def run(r) -> dict:
    import torch

    c, tr, dev = r.config, r.traffic, r.device
    root = os.path.join(r.workdir, "data")
    records = gen.coco_split(root, r.seed, tr["split"])
    split = tr["split"]["split"] + tr["split"]["year"]
    files = {"img_dir": os.path.join(root, "coco", "images", split),
             "ann": os.path.join(root, "coco", "annotations", f"instances_{split}.json"),
             "dt": os.path.join(root, "detections.json")}
    with open(files["dt"], "w") as f:
        json.dump(gen.detections(records, r.seed, tr["detections"]), f)
    w0 = rl_weights(c, dev)
    r.log(f"data ({len(records)} images, {tr['detections']['per_image']} detections an "
          f"image) and weights made")
    if r.control:
        readings = None
        result = {"attempted": 0, "failed": 0, "metrics": {},
                  "peak": torch.cuda.max_memory_allocated() if dev == "cuda" else 0}
    else:
        readings, result = _port_run(r, files, w0)
    numbers = _judge(r, files, w0, readings)
    ok, shown = harness.judge(numbers, c["limits"]["rl_train"])
    result["correct"] = ok and result["failed"] == 0
    result["compared"] = shown
    return result


def _port_run(r, files: dict, w0: dict):
    import torch

    from rlobjectdetection_tpu_torch.config import RLConfig
    from rlobjectdetection_tpu_torch.data.rl_coco import (COCODataLoader, COCODataset,
                                                          COCOTransform)
    from rlobjectdetection_tpu_torch.engine import rl as rl_engine
    from rlobjectdetection_tpu_torch.engine.trainval_net import train_epochs
    from rlobjectdetection_tpu_torch.engine.trainval_rl import train_arrays
    from rlobjectdetection_tpu_torch.models.rl.action import Action
    from rlobjectdetection_tpu_torch.models.rl.policy import RLPolicyNet

    c, tr, dev = r.config, r.traffic, r.device
    cfg = RLConfig()
    # the optimizer reads these from RLConfig; the rest is passed as stated
    stated = {"lr": cfg.learning_rate, "momentum": cfg.momentum,
              "weight_decay": cfg.weight_decay, "lr_decay": list(cfg.train_lr_decay)}
    for key, got in stated.items():
        if got != c[key]:
            raise ValueError(f"the port's RLConfig {key} is {got!r}, the configuration states "
                             f"{c[key]!r}")
    action = Action(c["act_delta"], alpha=1.0, iou_thres=c["act_iou_thres"],
                    wtrans=cfg.act_wtrans)
    t0 = time.perf_counter()
    dataset = COCODataset(files["img_dir"], files["ann"], files["dt"], action,
                          transform_fn=COCOTransform(c["img_short"], c["img_size"],
                                                     flip=c["flip"]),
                          normalize_mean=c["normalize_mean"], normalize_std=c["normalize_std"],
                          max_stat_dets=c["max_stat_dets"], stat_workers=c["stat_workers"])
    r.log(f"the dataset's weight statistic in {time.perf_counter() - t0:.2f} s")
    base = COCODataLoader(dataset, tr["batch"], shuffle=True, seed=loader_seed(r.seed))
    loader = TimedLoader(base)
    model = RLPolicyNet(c["num_acts"], c["layers"], torch.float32, conv1_fused=c["conv1_fused"],
                        layer1_fused=c["layer1_fused"], stages_fused=c["stages_fused"],
                        device=dev, seed=3)
    model.load_state_dict(w0)
    opt, sched = rl_engine.make_rl_optimizer(model, cfg, len(base))
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}

    shapes = set()
    for ep in range(tr["warm_epochs"]):
        base.set_epoch(ep)
        for job in base.batch_plan():
            pad_hw, slots, _ = base.predict_job(job)
            shapes.add((*pad_hw, slots))
    for h, w, slots in sorted(shapes):
        b = tr["batch"]
        boxes = torch.zeros((b, slots, 8), device=dev)
        boxes[..., 0] = torch.arange(b, device=dev)[:, None]
        boxes[..., 1:5] = torch.tensor([w * 0.25, h * 0.25, w * 0.6, h * 0.6], device=dev)
        z = torch.zeros((b, slots, c["num_acts"]), device=dev)
        _, loss, _ = model(torch.zeros((b, h, w, 3), device=dev), boxes, z, z + 1.0,
                           torch.full((b,), slots, device=dev))
        loss.backward()
        opt.zero_grad(set_to_none=True)
    harness.sync(dev)
    r.log(f"warmed {len(shapes)} (canvas, detection slots): {sorted(shapes)}")

    k = tr["record_steps"]
    rec = {"batches": [], "losses": []}
    forward = model.forward

    def recording(*a, **kw):
        out = forward(*a, **kw)
        if "pred" not in rec:
            rec["pred"] = out[0].detach().clone()
        return out

    def before(i, batch):
        rec["batches"].append({n: batch[n].detach().cpu().clone() for n in ARRAYS})

    def after(i, batch, out):
        rec["losses"].append({"loss": float(out["loss"])})
        if i == 0:
            rec["d1"] = {n: opt.state[p]["momentum_buffer"].detach().clone()
                         if "momentum_buffer" in opt.state[p] else torch.zeros_like(p)
                         for n, p in trained.items()}
        if i == k - 1:
            rec["p"] = {n: p.detach().clone() for n, p in trained.items()}
            del model.forward

    def step(batch, generator, dropout):
        loss, noweight = rl_engine.rl_train_step(model, opt, sched, batch["data"],
                                                 batch["bboxes"], batch["targets"],
                                                 batch["weights"], batch["num_dts"])
        return {"loss": loss, "noweight": noweight}

    model.forward = recording
    win = StepWindow(r, k, tr["batch"], tr["profile_steps"], lambda: harness.sync(dev),
                     lambda b: (*b["data"].shape, b["bboxes"].shape[1]))
    try:
        train_epochs(model, loader, win.wrap(step, before, after), lambda s: (None, None),
                     start_epoch=0, epochs=10 ** 6, num_workers=tr["workers"],
                     on_step=win.on_step, select=train_arrays)
    except WindowClosed:
        pass
    span = win.close()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    r.log(f"window {span['window']:.3f} s: {span['steps']} steps, {span['images']} images, "
          f"{span['failed']} non-finite")
    metrics = {"rl_train_images_per_s": {"value": span["images"] / span["window"],
                                         "unit": "images/s"}}
    readings = {"losses": rec["losses"], "pred": rec["pred"].cpu(),
                "d1": {n: v.cpu() for n, v in rec["d1"].items()},
                "p": {n: v.cpu() for n, v in rec["p"].items()},
                "batches": rec["batches"], "names": sorted(trained)}
    span.update(loader_times=loader.times, flops=[_step_flops(s) for s in span["shapes"]])
    del model, opt, sched, trained, forward, dataset, base
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return readings, {"attempted": span["steps"], "failed": span["failed"], "metrics": metrics,
                      "peak": peak, "span": span, "setup_s": span["t_start"] - r.t0}


def _step_flops(shape) -> float:
    """(batch, H, W, 3, detection slots) → FLOPs of the step."""
    from ..counts import rl_step_flops

    return rl_step_flops(shape[0], shape[1], shape[2], shape[0] * shape[4])


def _judge(r, files: dict, w0: dict, readings) -> dict:
    import torch

    c, tr, dev = r.config, r.traffic, r.device
    t0 = time.perf_counter()
    labels = ref_rl.Labels(files["ann"], files["dt"], c)
    jobs = ref_rl.plan(len(labels.img_ids), tr["batch"], loader_seed(r.seed), 0)
    jobs = jobs[:tr["record_steps"]]
    batches = [ref_rl.collate([labels.sample(files["img_dir"], i, loader_seed(r.seed), ep)
                               for i in idxs]) for ep, idxs in jobs]
    for b in batches:
        b["targets"], b["weights"] = b["labels"][..., 1], b["labels"][..., 2]
    numbers = {}
    if readings is not None:
        gap = 0.0 if len(readings["batches"]) == len(batches) else math.inf
        for got, want in zip(readings["batches"], batches):
            for n in ARRAYS:
                a, b = got[n].numpy(), want[n]
                gap = max(gap, math.inf if a.shape != b.shape else
                          float(np.abs(a.astype(np.float64) - b).max()))
        numbers["batch_gap"] = gap
    dbatches = [{n: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for n, v in b.items() if n != "im_info"} for b in batches]
    with weights.full_f32():
        if readings is None:
            # in the program's place: the reference in TF32 (control 1), or
            # on the first half of each batch, its mean over that half (2)
            tf32 = r.control == 1
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            p = {n: v.clone() for n, v in w0.items()}
            half = [{n: v[:len(v) // 2] for n, v in b.items()} for b in dbatches]
            hist, pred, d1, names = ref_rl.train_steps(p, dbatches if tf32 else half, c)
            readings = {"losses": hist, "pred": pred, "d1": d1, "names": sorted(names),
                        "p": {n: p[n] for n in names}}
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        ref = {n: v.clone() for n, v in w0.items()}
        hist, pred, d1, names = ref_rl.train_steps(ref, dbatches, c, ref_det.F32)
    if sorted(names) != readings["names"]:
        raise RuntimeError("the port trains other leaves than the configuration states: "
                           f"{sorted(set(names) ^ set(readings['names']))[:5]}")
    got = readings["pred"].to(dev)
    numbers["pred_gap"] = float((got - pred).abs().max() / pred.abs().max()) \
        if got.shape == pred.shape else math.inf
    numbers["loss_gap"] = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                              for g, w in zip(readings["losses"], hist))
    numbers["grad_gap"], leaf_g, _, used, left = harness.norm_gap(
        {n: readings["d1"][n].to(dev) for n in names}, d1, names)
    numbers["update_gap"], leaf_u, _, _, _ = harness.norm_gap(
        {n: readings["p"][n].to(dev) - w0[n] for n in names},
        {n: ref[n] - w0[n] for n in names}, names)
    r.log(f"reference: labels and {len(jobs)} steps in {time.perf_counter() - t0:.1f} s; "
          f"losses {[round(g['loss'], 6) for g in readings['losses']]} vs "
          f"{[round(w['loss'], 6) for w in hist]}; worst leaves {leaf_g} (grad), {leaf_u} "
          f"(update); {used} leaves compared, {left} under 1e-3 of the median left out")
    return numbers
