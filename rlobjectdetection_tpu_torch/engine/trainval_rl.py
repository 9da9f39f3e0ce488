"""RL refinement training and teacher-forced eval over a dataset (the
port's counterpart of the JAX package's `tools/trainval_rl.py`).

    python -m rlobjectdetection_tpu_torch.engine.trainval_rl \
        [--ann_file A --dt_file D --data_dir I] [--save_dir S] [--epochs E] \
        [--batch_size 2] [--lr LR] [--layers 101] [--img_short N] [--img_size M] \
        [--max_stat_dets 5000] [--stat_workers 8] [--pretrained F] [--resume C] \
        [-e --maxk K --wire bf16|f32] [--device cuda]

Builds the 56 actions of `RLConfig`, the ΔIoU-labelled `COCODataset` over
the gt json and the detections json (its weight statistic over
`--max_stat_dets` detections, 0 for all), the epoch-keyed
`COCODataLoader`, and `RLPolicyNet` in f32 with conv1..layer3 frozen on the
stem, layer1 and residual-stage kernels (their plain versions on the CPU).
`--pretrained` copies a detector's trunk and layer4 in
(`warm_start_from_detector`): a port checkpoint, a bare state dict, or a
JAX `save_net_npz` dump (`.npz`).

Training runs epochs `start..E-1` (0-based, as the JAX loop counts them)
through `trainval_net.train_epochs`: `set_epoch(epoch)`, assembly on
worker threads, the batch's arrays copied to the card ahead of the step,
`rl_train_step` (SGD over `make_rl_optimizer`'s groups, ×0.1 at each epoch
of `train_lr_decay`). It logs every 10 iterations in the JAX CLI's format
and each epoch's rates, and writes `<save_dir>/rl_epoch_<epoch+1>.pth`
(model, momentum, schedule count, step; `kind: rl`, layers, num_acts).
`--resume` restores all of them and goes on at the saved epoch.

`-e` evaluates (`engine/rl.py::rl_evaluate`): moves, precision@k, the
COCO json `<save_dir>/rl_results.json` and `cocoval`. The JAX CLI draws one
batch of epoch 0 to build its params before it evaluates, so its eval runs
on epoch 1's item draws; the port does the same.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..config import RLConfig
from ..data.rl_coco import COCODataLoader, COCODataset, COCOTransform
from ..device import resolve_device
from ..models.backbones.resnet import LAYER_SPECS
from ..models.rl import Action, RLPolicyNet, warm_start_from_detector
from ..utils.logging import AveMeter, init_log
from .checkpoint import (load_checkpoint, load_params, read_checkpoint, save_checkpoint,
                         state_dict_from_jax)
from .rl import make_rl_optimizer, rl_evaluate, rl_train_step
from .test_net import refuse_waiting_flags
from .trainval_net import rate_line, train_epochs

WAITING_FLAGS = {
    "--aot_cache": "it is the JAX package's executable cache, which has no counterpart "
                   "(ROADMAP §1)",
}
LOG_EVERY = 10


def parse_args(argv=None):
    p = argparse.ArgumentParser("RL bbox-refinement training")
    p.add_argument("-e", "--evaluate", action="store_true")
    p.add_argument("--resume", default=None, help="an rl_epoch_<k>.pth checkpoint")
    p.add_argument("--batch_size", default=2, type=int)
    p.add_argument("--epochs", default=None, type=int)
    p.add_argument("--maxk", default=1, type=int)
    p.add_argument("--pretrained", default=None,
                   help="detector weights for the trunk: a checkpoint, a state dict or an npz dump")
    p.add_argument("--ann_file", default=None)
    p.add_argument("--dt_file", default=None)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--img_short", default=None, type=int,
                   help="override the train/test short side")
    p.add_argument("--img_size", default=None, type=int, help="override the max size")
    p.add_argument("--max_stat_dets", default=5000, type=int,
                   help="detections in the pos/neg weight statistic (0: all)")
    p.add_argument("--stat_workers", default=8, type=int,
                   help="threads for the weight statistic")
    p.add_argument("--layers", default=101, type=int, choices=sorted(LAYER_SPECS),
                   help="policy-net ResNet depth")
    p.add_argument("--aot_cache", default=None, help="refused: JAX's executable cache")
    p.add_argument("--lr", default=None, type=float, help="override RLConfig.learning_rate")
    p.add_argument("--wire", default="bf16", choices=["bf16", "f32"],
                   help="eval image-blob dtype on the copy to the device")
    p.add_argument("--device", default="cuda")
    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_waiting_flags(p, argv, WAITING_FLAGS, "trainval_rl")
    return p.parse_args(argv)


def build_config(args) -> RLConfig:
    """`RLConfig` of the phase, then `--ann_file / --dt_file / --data_dir /
    --lr`."""
    phase = "test" if args.evaluate else "train"
    cfg = RLConfig(phase=phase)
    for flag, field in (("ann_file", f"{phase}_ann_file"), ("dt_file", f"{phase}_dt_file"),
                        ("data_dir", f"{phase}_data_dir")):
        if getattr(args, flag):
            object.__setattr__(cfg, field, getattr(args, flag))
    if args.lr is not None:
        object.__setattr__(cfg, "learning_rate", args.lr)
    return cfg


def build_dataset(args, cfg: RLConfig, action: Action) -> COCODataset:
    """The phase's transform (`--img_short` / `--img_size` over the config's
    sizes) and dataset."""
    train = cfg.phase == "train"
    img_short = [args.img_short] if args.img_short else list(
        cfg.train_img_short if train else cfg.test_img_short)
    img_size = args.img_size or (cfg.train_img_size if train else cfg.test_img_size)
    transform = COCOTransform(img_short, img_size, flip=cfg.train_flip if train else cfg.test_flip)
    return COCODataset(cfg.data_dir, cfg.ann_file, cfg.dt_file, action, transform_fn=transform,
                       normalize_mean=cfg.normalize_mean, normalize_std=cfg.normalize_std,
                       max_stat_dets=args.max_stat_dets or None, stat_workers=args.stat_workers)


def detector_state(path: str) -> dict:
    """Detector weights as a state dict: a JAX `save_net_npz` dump (`.npz`),
    a port checkpoint (its `model`), or a bare state dict."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return state_dict_from_jax({k: data[k] for k in data.files})
    sd = load_params(path)
    return sd["model"] if isinstance(sd.get("model"), dict) else sd


def build_model(args, num_acts: int, device, log=None) -> RLPolicyNet:
    """The f32 policy net of `--layers` with the stem, layer1 (where layer1
    has the three blocks its kernel takes) and layer2/layer3 kernels, its
    trunk and layer4 from `--pretrained` where given."""
    model = RLPolicyNet(num_acts, args.layers, torch.float32, conv1_fused=True,
                        layer1_fused=LAYER_SPECS[args.layers][0] == 3, stages_fused=23,
                        device=device, seed=3)
    if args.pretrained:
        model.load_state_dict(warm_start_from_detector(model.state_dict(),
                                                       detector_state(args.pretrained)))
        if log is not None:
            log.info(f"warm-started trunk from {args.pretrained}")
    return model


def rl_checkpoint(path: str) -> dict:
    """A `rl_epoch_<k>.pth` payload; exits where the file is not an RL
    checkpoint."""
    payload = read_checkpoint(path)
    if payload.get("kind") != "rl":
        raise SystemExit(f"trainval_rl: {path} is not an RL checkpoint")
    return payload


def train_arrays(batch: dict) -> dict:
    """What a train step reads of a collated batch (`im_info`, which holds
    file names, stays on the host)."""
    return {"data": batch["data"], "bboxes": batch["bboxes"],
            "targets": np.ascontiguousarray(batch["labels"][..., 1]),
            "weights": np.ascontiguousarray(batch["labels"][..., 2]),
            "num_dts": batch["num_dts"]}


def train_loop(model, loader, opt, sched, *, start_epoch: int, max_epoch: int,
               global_step: int = 0, num_workers: int = 0, log=None, on_epoch=None):
    """Epochs `start_epoch..max_epoch-1` (0-based) of `rl_train_step` over
    `loader` through `train_epochs`, logging every LOG_EVERY iterations as
    the JAX CLI does (loss and noweight of that step, read from the card
    only there; batch and data the host's seconds a step and waiting for a
    batch, averaged over the last 20). `on_epoch(epoch, global_step, stats)` runs after each epoch.
    Returns (global_step, [stats of each epoch], [(epoch, it, loss,
    noweight) of each logged step])."""
    log = log or init_log("rl")
    steps = len(loader)
    batch_time, data_time, losses = AveMeter(), AveMeter(), AveMeter()
    logged, mark = [], {}

    def step_fn(batch, generator, dropout):
        mark["start"] = time.perf_counter()
        loss, noweight = rl_train_step(model, opt, sched, batch["data"], batch["bboxes"],
                                       batch["targets"], batch["weights"], batch["num_dts"])
        return {"loss": loss, "noweight": noweight}

    def on_step(epoch, it, step, metrics):
        now = time.perf_counter()
        data_time.update(mark["start"] - mark["end"])
        batch_time.update(now - mark["end"])
        mark["end"] = now
        if it % LOG_EVERY == 0:
            loss, noweight = float(metrics["loss"]), float(metrics["noweight"])
            losses.update(loss)
            logged.append((epoch, it, loss, noweight))
            log.info(f"[{epoch}][{it}/{steps}] loss(sampled) {losses.avg:.4f} (noweight "
                     f"{noweight:.4f}) batch {batch_time.avg:.3f}s data {data_time.avg:.3f}s")

    def epoch_done(epoch, step, stats):
        if on_epoch is not None:
            on_epoch(epoch, step, stats)
        mark["end"] = time.perf_counter()

    mark["end"] = time.perf_counter()
    global_step, history = train_epochs(
        model, loader, step_fn, lambda step: (None, None), start_epoch=start_epoch,
        epochs=max_epoch - 1, global_step=global_step, num_workers=num_workers,
        on_step=on_step, on_epoch=epoch_done, select=train_arrays)
    return global_step, history, logged


def main(argv=None, num_workers: int | None = None) -> dict:
    """Train (returns {"step", "epochs": each epoch's `train_epochs` stats,
    "checkpoints", "logged": (epoch, it, loss, noweight) of each logged
    step}) or, with `-e`, evaluate (returns `rl_evaluate`'s dict).
    `num_workers` assembly threads (default `RLConfig.num_workers`)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    log = init_log("rl")
    cfg = build_config(args)
    save_dir = args.save_dir or cfg.save_dir
    os.makedirs(save_dir, exist_ok=True)
    workers = cfg.num_workers if num_workers is None else num_workers

    action = Action(list(cfg.act_delta), alpha=1.0, iou_thres=cfg.act_iou_thres,
                    wtrans=cfg.act_wtrans)
    log.info(f"{action.num_acts} actions")
    t0 = time.perf_counter()
    dataset = build_dataset(args, cfg, action)
    loader = COCODataLoader(dataset, args.batch_size, shuffle=cfg.phase == "train")
    log.info(f"dataset: {len(dataset)} images ({time.perf_counter() - t0:.3f}s with the weight "
             f"statistic)")

    model = build_model(args, action.num_acts, dev, log)
    log.info(f"RL policy net resnet{args.layers} on {dev}, f32, batch {args.batch_size}, "
             f"{len(loader)} steps an epoch")

    if args.evaluate:
        if args.resume:
            load_checkpoint(rl_checkpoint(args.resume), model)
            log.info(f"resumed from {args.resume}")
        # the JAX CLI draws epoch 0's first batch to build its params, so
        # its eval runs on epoch 1's item draws
        loader.set_epoch(1)
        return rl_evaluate(model, loader, action, args.maxk, wire=args.wire,
                           res_file=os.path.join(save_dir, "rl_results.json"),
                           ann_file=cfg.ann_file, num_workers=workers, log=log)

    opt, sched = make_rl_optimizer(model, cfg, len(loader))
    start_epoch, global_step = 0, 0
    if args.resume:
        meta = load_checkpoint(rl_checkpoint(args.resume), model, opt, sched)
        start_epoch, global_step = int(meta["epoch"]), int(meta["step"])
        log.info(f"resumed from {args.resume} at epoch {start_epoch}")
    max_epoch = args.epochs or cfg.train_max_epoch
    written = []

    def on_epoch(epoch, step, stats):
        path = os.path.join(save_dir, f"rl_epoch_{epoch + 1}.pth")
        t0 = time.perf_counter()
        save_checkpoint(path, model, opt, sched, epoch=epoch + 1, step=step,
                        extra={"kind": "rl", "layers": args.layers,
                               "num_acts": action.num_acts})
        stats["save_ms"] = (time.perf_counter() - t0) * 1e3
        written.append(path)
        log.info(rate_line(stats))
        log.info(f"saved {path} (save {stats['save_ms']:.1f} ms)")

    global_step, history, logged = train_loop(
        model, loader, opt, sched, start_epoch=start_epoch, max_epoch=max_epoch,
        global_step=global_step, num_workers=workers, log=log, on_epoch=on_epoch)
    return {"step": global_step, "epochs": history, "checkpoints": written, "logged": logged}


if __name__ == "__main__":
    main()
