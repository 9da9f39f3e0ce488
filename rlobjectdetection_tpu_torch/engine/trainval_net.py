"""Detector training over a dataset (the port's counterpart of the JAX
package's `tools/trainval_net.py`).

    python -m rlobjectdetection_tpu_torch.engine.trainval_net --dataset coco \
        [--net res101|res50|res152|vgg16|tiny] [--bs N] [--epochs E] [--lr LR] \
        [--lr_decay_step K] [--save_dir D] [--s S] [--r --checkepoch k] \
        [--pretrained F] [--nw W] [--device cuda] [--set KEY VALUE ...]

builds the train roidb (`$RLOD_DATA_DIR`, flipped copies with
TRAIN.USE_FLIPPED) and the aspect-grouped `RoiBatchLoader`, then trains:
each epoch pins the loader's plan to the epoch (`set_epoch`), assembles
batches on `--nw` worker threads (`AsyncLoader`; `--nw 0` assembles in the
loop) and copies them to the card ahead of the step (`device_prefetch`).
The step is `make_train_step` with SGD over the reference's groups, the
step-decay schedule (×gamma every `lr_decay_step` epochs) and, for VGG-16,
the global norm clipped at 10. Each step's sampling and dropout generators
are seeded from (RNG_SEED + 1, global step), so a resumed run replays the
draws of the run it continues. A checkpoint is written at the end of every
epoch, `<save_dir>/<net>/<dataset>/faster_rcnn_<s>_<epoch>.pth`; `--r
--checkepoch k` restores the model, momentum, schedule and step from
epoch k's and goes on at epoch k + 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..data.imdb import combined_roidb
from ..data.loader import RoiBatchLoader
from ..data.prefetch import AsyncLoader, device_prefetch, to_device
from ..device import resolve_device
from ..models import FasterRCNN
from ..utils.logging import (AveMeter, MetricsWriter, init_log, start_profiler_trace,
                             stop_profiler_trace)
from .checkpoint import checkpoint_path, load_checkpoint, load_params, save_checkpoint
from .convert_torch_weights import merge_pretrained
from .optim import build_optimizer, count_trainable, make_lr_schedule
from .serve import BACKBONES, build_config
from .test_net import refuse_waiting_flags
from .train import make_train_step

DATASET_MAP = {
    "pascal_voc": ("voc_2007_trainval", "voc_2007_test"),
    "pascal_voc_0712": ("voc_2007_trainval+voc_2012_trainval", "voc_2007_test"),
    "coco": ("coco_2014_train+coco_2014_valminusminival", "coco_2014_minival"),
    "imagenet": ("imagenet_train", "imagenet_val"),
    "vg": ("vg_1600-400-20_train", "vg_1600-400-20_val"),
}
_DIST = "it waits for ROADMAP §1 item 14 (torch.distributed)"
WAITING_FLAGS = {
    "--packed_input": "it waits for ROADMAP §1 item 17b (data/packed.py)",
    "--dist_coordinator": _DIST, "--dist_nprocs": _DIST, "--dist_rank": _DIST,
    "--aot_cache": "it is the JAX package's executable cache, which has no counterpart "
                   "(ROADMAP §1)",
}
LOSS_KEYS = ("loss", "rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a Faster R-CNN detector")
    p.add_argument("--dataset", default="pascal_voc")
    p.add_argument("--net", default="res101", choices=["vgg16", "res50", "res101", "res152",
                                                      "tiny"])
    p.add_argument("--start_epoch", default=1, type=int)
    p.add_argument("--epochs", default=20, type=int)
    p.add_argument("--disp_interval", default=100, type=int)
    p.add_argument("--save_dir", default="models")
    p.add_argument("--bs", dest="batch_size", default=1, type=int)
    p.add_argument("--ls", dest="large_scale", action="store_true")
    p.add_argument("--cag", dest="class_agnostic", action="store_true")
    p.add_argument("--o", dest="optimizer", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--lr_decay_step", default=5, type=int)
    p.add_argument("--lr_decay_gamma", default=0.1, type=float)
    p.add_argument("--s", dest="session", default=1, type=int)
    p.add_argument("--r", dest="resume", action="store_true")
    p.add_argument("--checkepoch", default=1, type=int)
    p.add_argument("--use_tfb", action="store_true")
    p.add_argument("--cfg", dest="cfg_file", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    p.add_argument("--pretrained", default=None,
                   help="converted weights (convert_torch_weights output) merged before training")
    p.add_argument("--pooling_mode", default=None)
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace of this run's first N steps to logs/trace")
    p.add_argument("--nw", dest="num_workers", default=4, type=int,
                   help="batch assembly threads; 0 assembles in the loop")
    p.add_argument("--skip_nonfinite", action="store_true",
                   help="skip optimizer updates whose gradients hold NaN or Inf")
    p.add_argument("--device", default="cuda")
    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_waiting_flags(p, argv, WAITING_FLAGS, "trainval_net")
    args = p.parse_args(argv)
    if args.optimizer == "adam":
        # the JAX trainer parses --o and trains SGD whatever it says
        p.exit(2, "trainval_net: --o adam is refused: the JAX trainer this follows trains "
                  "SGD whatever --o says (ROADMAP §3, noted); pass --o sgd\n")
    return args


def step_draws(seed: int, global_step: int, device) -> tuple[torch.Generator, torch.Generator]:
    """(sampling, dropout) generators of a step, on `device`, seeded from
    (seed + 1, global_step): the counterpart of `fold_in(PRNGKey(seed + 1),
    global_step)`."""
    seeds = np.random.SeedSequence((seed + 1, global_step)).generate_state(2, np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s)) for s in seeds)


class TimedJobs:
    """A loader's `batch_plan()` jobs whose result is (batch, host ms of its
    assembly)."""

    def __init__(self, loader):
        self.loader = loader

    def batch_plan(self):
        return self.loader.batch_plan()

    def assemble_job(self, job):
        t0 = time.perf_counter()
        batch = self.loader.assemble_job(job)
        return batch, (time.perf_counter() - t0) * 1e3


def train_epochs(model, loader, step_fn, draws_for_step, *, start_epoch: int = 1,
                 epochs: int = 1, global_step: int = 0, num_workers: int = 0,
                 on_step=None, on_epoch=None, select=None):
    """Epochs `start_epoch..epochs` of `step_fn(batch, generator, dropout)`
    over `loader` (a `RoiBatchLoader`, or any loader with `set_epoch`,
    `batch_plan` and `assemble_job`), with `draws_for_step(global_step)` →
    (generator, dropout). Each epoch: `loader.set_epoch(epoch)`, assembly on
    `num_workers` threads (0: in the loop), `device_prefetch` to the model's
    device of every array of the batch, or of the dict of arrays
    `select(batch)` returns. `on_step(epoch, it, global_step, metrics)`
    runs after each step, `on_epoch(epoch, global_step, stats)` after each
    epoch. Returns
    (global_step, [stats of each epoch]): images, steps, wall seconds, the
    steady seconds and images after the epoch's first step, the seconds the
    device waits between steps (CUDA events from a step's end to the next
    one's start; on the CPU the host clock), host assembly ms an image."""
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def put(job_out):
        batch, ms = job_out
        arrays = batch if select is None else select(batch)
        return {k: to_device(v, dev) for k, v in arrays.items()}, ms

    history = []
    for epoch in range(start_epoch, epochs + 1):
        sync()
        t0 = time.perf_counter()
        loader.set_epoch(epoch)
        jobs = TimedJobs(loader)
        source = (AsyncLoader(jobs, num_workers) if num_workers > 0
                  else (jobs.assemble_job(j) for j in jobs.batch_plan()))
        images = first_images = 0
        asm_ms, gaps, wait_s = [], [], 0.0
        last_end, t_first = None, None
        for it, (batch, ms) in enumerate(device_prefetch(source, put, device=dev)):
            n = batch["data"].shape[0]
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                if last_end is not None:
                    gaps.append((last_end, start))
            elif last_end is not None:
                wait_s += time.perf_counter() - last_end
            generator, dropout = draws_for_step(global_step)
            metrics = step_fn(batch, generator, dropout)
            global_step += 1
            images += n
            asm_ms.append(ms / n)
            if cuda:
                last_end = torch.cuda.Event(enable_timing=True)
                last_end.record()
            else:
                last_end = time.perf_counter()
            if it == 0:
                sync()
                t_first, first_images = time.perf_counter(), n
            if on_step is not None:
                on_step(epoch, it, global_step, metrics)
        sync()
        t_end = time.perf_counter()
        if cuda:
            wait_s = sum(a.elapsed_time(b) for a, b in gaps) / 1e3
        stats = dict(epoch=epoch, steps=len(asm_ms), images=images, wall_s=t_end - t0,
                     steady_s=t_end - t_first if t_first is not None else 0.0,
                     steady_images=images - first_images, wait_s=wait_s,
                     assembly_ms_per_image=float(np.mean(asm_ms)) if asm_ms else 0.0)
        history.append(stats)
        if on_epoch is not None:
            on_epoch(epoch, global_step, stats)
    return global_step, history


def rate_line(stats: dict) -> str:
    """One epoch's rates: images/s wall and steady, host assembly, device
    wait between steps."""
    wall, steady = stats["wall_s"], stats["steady_s"]
    return (f"train loop epoch {stats['epoch']}: {stats['images'] / max(wall, 1e-9):.3f} img/s "
            f"wall ({stats['images']} images, {stats['steps']} steps, {wall:.3f}s); steady "
            f"{stats['steady_images'] / max(steady, 1e-9):.3f} img/s over "
            f"{stats['steady_images']} images after the first step; host assembly "
            f"{stats['assembly_ms_per_image']:.3f} ms/img; {stats['wait_s']:.3f}s between "
            f"steps (device waiting)")


def main(argv=None) -> dict:
    """Returns {"step": the global step at the end, "epochs": each epoch's
    `train_epochs` stats, "checkpoints": the paths written}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    log = init_log("train")
    cfg = build_config(args.dataset, args.set_cfgs, large_scale=args.large_scale,
                       cfg_file=args.cfg_file, pooling_mode=args.pooling_mode)

    imdb_name = DATASET_MAP.get(args.dataset, (args.dataset, None))[0]
    imdb_obj, roidb, ratio_list, ratio_index = combined_roidb(
        imdb_name, training=True, use_flipped=cfg.TRAIN.USE_FLIPPED)
    log.info(f"{len(roidb)} roidb entries")
    loader = RoiBatchLoader(roidb, ratio_list, ratio_index, args.batch_size,
                            scales=cfg.TRAIN.SCALES, max_num_gt=cfg.MAX_NUM_GT_BOXES,
                            seed=cfg.RNG_SEED)
    iters_per_epoch = len(loader)

    backbone = BACKBONES[args.net]
    model = FasterRCNN(imdb_obj.num_classes, backbone, cfg, class_agnostic=args.class_agnostic,
                       device=dev, seed=cfg.RNG_SEED)
    if args.pretrained:
        model.load_state_dict(merge_pretrained(model.state_dict(), load_params(args.pretrained)))
    schedule = make_lr_schedule(args.lr, args.lr_decay_step * iters_per_epoch,
                                args.lr_decay_gamma)
    opt, sched, labels = build_optimizer(
        model, backbone, args.lr, momentum=cfg.TRAIN.MOMENTUM,
        weight_decay=cfg.TRAIN.WEIGHT_DECAY, double_bias=cfg.TRAIN.DOUBLE_BIAS,
        bias_decay=cfg.TRAIN.BIAS_DECAY, fixed_blocks=cfg.RESNET.FIXED_BLOCKS,
        lr_schedule=schedule, clip_norm=10.0 if backbone == "vgg16" else None)
    log.info(f"{args.net} on {dev}, compute {cfg.DTYPE}, tensors by label "
             f"{count_trainable(labels)}, {iters_per_epoch} steps an epoch at batch "
             f"{args.batch_size}")

    global_step = 0
    if args.resume:
        path = checkpoint_path(args.save_dir, args.net, args.dataset, args.session,
                               args.checkepoch)
        meta = load_checkpoint(path, model, opt, sched)
        args.start_epoch, global_step = int(meta["epoch"]) + 1, int(meta["step"])
        log.info(f"resumed from {path} at step {global_step}")

    step_fn = make_train_step(model, opt, sched, skip_nonfinite=args.skip_nonfinite)
    writer = MetricsWriter("logs") if args.use_tfb else None
    trace_steps = int(args.profile) if args.profile else 0
    trace = start_profiler_trace(os.path.join("logs", "trace")) if trace_steps else None
    meters = {k: AveMeter() for k in LOSS_KEYS}
    run_steps, written = 0, []

    def on_step(epoch, it, step, metrics):
        nonlocal run_steps, trace
        run_steps += 1       # the trace window counts this run's steps, not the global step
        if trace is not None and run_steps == trace_steps:
            log.info(f"profiler trace written to {stop_profiler_trace(trace)}")
            trace = None
        if it % args.disp_interval == 0:
            m = {k: float(v) for k, v in metrics.items()}
            for k in meters:
                meters[k].update(m[k])
            log.info(
                f"[session {args.session}][epoch {epoch:2d}][iter {it:4d}/{iters_per_epoch}] "
                f"loss: {meters['loss'].avg:.4f}, lr: {schedule(step):.2e} "
                f"fg/bg=({m['fg_cnt']:.0f}/{m['bg_cnt']:.0f}) "
                f"rpn_cls {m['rpn_cls']:.4f} rpn_box {m['rpn_box']:.4f} "
                f"rcnn_cls {m['rcnn_cls']:.4f} rcnn_box {m['rcnn_box']:.4f}")
            if writer:
                for k, v in m.items():
                    writer.scalar_summary(k, v, step)

    def on_epoch(epoch, step, stats):
        path = checkpoint_path(args.save_dir, args.net, args.dataset, args.session, epoch)
        t0 = time.perf_counter()
        save_checkpoint(path, model, opt, sched, session=args.session, epoch=epoch, step=step,
                        pooling_mode=cfg.POOLING_MODE, class_agnostic=args.class_agnostic,
                        extra={"classes": list(imdb_obj.classes)})
        stats["save_ms"] = (time.perf_counter() - t0) * 1e3
        written.append(path)
        log.info(rate_line(stats))
        log.info(f"save model: {path} (epoch time {stats['wall_s']:.1f}s, save "
                 f"{stats['save_ms']:.1f} ms)")

    try:
        global_step, history = train_epochs(
            model, loader, step_fn, lambda step: step_draws(cfg.RNG_SEED, step, dev),
            start_epoch=args.start_epoch, epochs=args.epochs, global_step=global_step,
            num_workers=args.num_workers, on_step=on_step, on_epoch=on_epoch)
    finally:
        if trace is not None:
            log.info(f"profiler trace written to {stop_profiler_trace(trace)}")
        if writer:
            writer.close()
    return {"step": global_step, "epochs": history, "checkpoints": written}


if __name__ == "__main__":
    main()
