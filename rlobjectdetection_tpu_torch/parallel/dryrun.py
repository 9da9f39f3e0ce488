"""A data-parallel dry run over N processes (counterpart of the JAX
package's `__graft_entry__.dryrun_multichip`).

    python -m rlobjectdetection_tpu_torch.parallel.dryrun N [--device cpu|cuda] \
        [--backend nccl|gloo]

spawns N ranks that run, over one process group: one train step of the
ResNet-101 detector (81 classes, f32, the stem and layer1 kernels on) at
two images a rank with uneven gt counts and the real 300 test proposals;
the eval forward and postprocess on each rank's images; and a checkpoint
that rank 0 writes. The launcher then runs the same step on the whole
batch in one process (while the ranks run), asserts that its loss
equals the ranks' (relative
1e-4: the two runs' convolutions see other batch sizes, so their sums may
run in other orders), and restores rank 0's checkpoint into a model
outside any group, whose every tensor must equal each rank's trained
replica. Under NCCL a rank takes a GPU, so with fewer GPUs than N the run
is on gloo over the GPU's tensors (printed).

`launch(n, spec)` and `run_spec(spec)` are its two halves, and the tests'
way to hold an N-rank step against the one-process step: a spec names the
net (a detector or the RL net), its weights, the global batch, the draws
(a replayed list of global arrays, or a generator seed) and the learning
rate; each rank writes its metrics and rank 0 its gradients and updated
parameters. The convolutions of a rank see fewer images than the one
process's, so a ReLU input within rounding of 0 may fall on the other side
of it and route a gradient otherwise: `record_ties` has the one-process
run note its ResNet gates (`models/backbones/resnet_ties.py`; VGG-16's
pool routes and gates, `vgg_ties.py`), and a spec that carries them as
`ties` has each rank take its rows of them. A rank that raises ends with a
non-zero code, and the launcher then stops its peers, so that none waits
in a collective.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import multiprocessing
import os
import socket
import tempfile
import time

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..config import Config, RLConfig, TestConfig, TrainConfig, net_of_backbone
from ..engine.checkpoint import load_checkpoint, save_checkpoint
from ..engine.detect import postprocess_detections
from ..engine.optim import build_optimizer
from ..engine.rl import make_rl_optimizer, rl_train_step
from ..engine.train import make_train_step
from ..models import build_detector
from ..models.backbones import resnet_ties, vgg_ties
from ..models.backbones.resnet import LAYER_SPECS
from ..models.backbones.vgg import VGGBase
from ..models.rl import RLPolicyNet
from ..ops.library import WRAPPERS
from .distributed import (GlobalBatch, fetch_scalar, initialize, shard_global_batch,
                          shard_local_batch)
from .mesh import replicate

LOSS_REL = 1e-4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Replay:
    """A uniform source handing out the given global draws in order."""

    def __init__(self, arrays, device):
        self.arrays = list(arrays)
        self.device = device

    def __call__(self, shape):
        a = np.asarray(self.arrays.pop(0), np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"replayed draw {a.shape} where {tuple(shape)} is asked for")
        return torch.from_numpy(a).to(self.device)


def _draws(spec, device):
    if spec.get("draws") is not None:
        return Replay(spec["draws"], device)
    return torch.Generator(device=device).manual_seed(int(spec.get("draw_seed", 7)))


def _model(spec, device):
    """The spec's net on `device`: made from its seed, or where the spec
    carries a state dict, built on the meta device and given that state
    (no initialiser runs)."""
    if spec["kind"] == "rl":
        make = lambda dev: RLPolicyNet(
            spec["num_acts"], spec["layers"], torch.float32, conv1_fused=True,
            layer1_fused=LAYER_SPECS[spec["layers"]][0] == 3, stages_fused=23, device=dev,
            seed=spec.get("seed", 3))
    else:
        make = lambda dev: build_detector(spec["num_classes"], spec["backbone"], spec["cfg"],
                                          device=dev, seed=spec.get("seed", 3))
    if spec.get("state") is None:
        return make(device)
    with torch.device("meta"):
        model = make("meta")
    model.load_state_dict(spec["state"], assign=True)
    return model.to(device)


def _build(spec, device):
    """(model, optimizer, scheduler) of a spec on `device`."""
    model = _model(spec, device)
    if spec["kind"] == "rl":
        opt, sched = make_rl_optimizer(
            model, dataclasses.replace(RLConfig(), learning_rate=spec["lr"]), 1)
        return model, opt, sched
    opt, sched, _ = build_optimizer(model, spec["backbone"], spec["lr"],
                                    clip_norm=net_of_backbone(spec["backbone"]).clip_norm)
    return model, opt, sched


def _step(spec, model, opt, sched, device, gb: GlobalBatch | None) -> dict:
    """One train step of the spec, on this rank's rows where `gb` is given;
    the metrics as floats."""
    from ..engine.trainval_rl import shard_rl_batch

    batch = spec["batch"]
    if spec["kind"] == "rl":
        arrays = batch if gb is None else shard_rl_batch(batch, gb.rank, gb.size)
        t = shard_local_batch(arrays, device)
        dp = {} if gb is None else {"global_batch": gb, "images": t["images"],
                                    "image_mask": t["image_mask"]}
        loss, noweight = rl_train_step(model, opt, sched, t["data"], t["bboxes"],
                                       t["targets"], t["weights"], t["num_dts"], **dp)
        return {"loss": float(loss), "noweight": float(noweight)}
    rows = (shard_local_batch if gb is None else shard_global_batch)(batch, device)
    step = make_train_step(model, opt, sched, global_batch=gb)
    metrics = step(rows, _draws(spec, device))
    return {k: float(v) for k, v in metrics.items()}


def _eval(spec, model, device, distributed: bool) -> int:
    """The eval forward and postprocess of this process's images (its rows
    where `distributed`; with the weights before the step); returns the
    detections kept."""
    batch = {k: spec["batch"][k] for k in ("data", "im_info")}
    batch = (shard_global_batch if distributed else shard_local_batch)(batch, device)
    c = spec["cfg"]
    with torch.no_grad():
        out = model(batch["data"], batch["im_info"])
        kept = 0
        for i in range(batch["data"].shape[0]):
            boxes, scores, _, valid = postprocess_detections(
                out["rois"][i], out["cls_prob"][i], out["bbox_pred"][i], batch["im_info"][i],
                out["roi_valid"][i], num_classes=spec["num_classes"], max_per_image=10,
                nms_thresh=c.TEST.NMS)
            if tuple(boxes.shape) != (10, 4) or not bool(torch.isfinite(scores).all()):
                raise AssertionError(f"eval postprocess gave {tuple(boxes.shape)} boxes or "
                                     f"non-finite scores")
            kept += int(valid.sum())
    return kept


def _rows(x: torch.Tensor, gb: GlobalBatch | None) -> torch.Tensor:
    """A rank's rows of a tensor that leads with the global batch (images,
    or rois image by image)."""
    if gb is None:
        return x
    n = x.shape[0] // gb.size
    return x[gb.rank * n:(gb.rank + 1) * n]


def digest(model) -> dict:
    """Every tensor of the state dict as the SHA-256 of its bytes."""
    return {k: hashlib.sha256(v.detach().cpu().contiguous().view(torch.uint8).numpy()
                              .tobytes()).hexdigest()
            for k, v in model.state_dict().items()}


def run_spec(spec: dict, world=None) -> dict:
    """One step of `spec` in this process: the one-process step (`world`
    None), or this rank's part of the N-rank step. Returns {metrics,
    launches (each kernel's over the step), kept (with spec["eval"]), and
    on rank 0 (or alone) grads and params: each trainable parameter's
    gradient and updated value on the CPU}."""
    device = torch.device(spec.get("device", "cpu")) if world is None else world.device
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model, opt, sched = _build(spec, device)
    out = {}
    gb = None if world is None else GlobalBatch()
    if spec.get("eval"):
        out["kept"] = _eval(spec, model, device, gb is not None)
    trained = model if world is None else replicate(model, device)
    gates = contextlib.nullcontext()
    vgg = isinstance(getattr(model, "base", None), VGGBase)
    tied, ties = (model.base, vgg_ties) if vgg else (model, resnet_ties)
    if spec.get("record_ties"):
        out["ties"] = {}
        gates = ties.record(tied, out["ties"])
    elif spec.get("ties") is not None:
        out["tie_counts"] = {}
        gates = ties.replay(tied, tree_map(lambda v: _rows(v, gb).to(device), spec["ties"]),
                            out["tie_counts"])
    for f in WRAPPERS.values():
        f.launches = 0
    with gates:
        out["metrics"] = _step(spec, trained, opt, sched, device, gb)
    out["launches"] = {k: f.launches for k, f in WRAPPERS.items()}
    # the ranks' mean of their loss: each holds the global one already
    out["loss_mean"] = fetch_scalar(out["metrics"]["loss"])
    if "ties" in out:
        out["ties"] = tree_map(lambda v: v.cpu(), out["ties"])
    if world is None or world.rank == 0:
        named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
        out["grads"] = {k: p.grad.detach().cpu() for k, p in named}
        out["params"] = {k: p.detach().cpu() for k, p in named}
    if spec.get("checkpoint"):
        if world is not None:
            torch.distributed.barrier()
        if world is None or world.rank == 0:
            save_checkpoint(spec["checkpoint"], model, opt, sched, epoch=1, step=1)
        if world is not None:
            torch.distributed.barrier()
        out["digest"] = digest(model)
    return out


def _rank_main(rank: int, size: int, coordinator: str, spec_path: str, out_dir: str,
               backend: str | None) -> None:
    spec = torch.load(spec_path, weights_only=False)
    world = initialize(coordinator, size, rank, device=spec.get("device", "cpu"),
                       backend=backend, timeout_s=600.0)
    try:
        out = run_spec(spec, world)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def launch(n: int, spec: dict, backend: str | None = None, timeout_s: float = 900.0,
           meanwhile=None):
    """Run `spec`'s step on `n` spawned ranks; returns each rank's
    `run_spec` result, or (those, `meanwhile()`) where a callable is given
    to run in this process while the ranks run (the one-process run). A
    rank that fails (or the timeout) stops every other and raises
    RuntimeError."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="rlod_dp_") as td:
        spec_path = os.path.join(td, "spec.pt")
        torch.save(spec, spec_path)
        coordinator = f"localhost:{free_port()}"
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, coordinator, spec_path, td, backend))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            local = None if meanwhile is None else meanwhile()
            while True:
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad:
                    raise RuntimeError(f"rank(s) {bad} exited with "
                                       f"{[procs[r].exitcode for r in bad]}")
                if not any(p.is_alive() for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the ranks did not finish in {timeout_s:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        ranks = [torch.load(os.path.join(td, f"rank{r}.pt"), weights_only=False)
                 for r in range(n)]
    return ranks if meanwhile is None else (ranks, local)


def dryrun_spec(n: int, device: str, checkpoint: str) -> dict:
    """The dry run's spec: ResNet-101, 81 classes, f32 at 128×160, two
    images a rank (2..6 gt boxes each), TRAIN 512 / 300 proposals and 128
    rois an image, TEST 256 / 300, seed 3."""
    cfg = Config(TRAIN=TrainConfig(RPN_PRE_NMS_TOP_N=512, RPN_POST_NMS_TOP_N=300,
                                   BATCH_SIZE=128),
                 TEST=TestConfig(RPN_PRE_NMS_TOP_N=256, RPN_POST_NMS_TOP_N=300),
                 DTYPE="float32", NMS_TILE=64, CONV1_FUSED=True, LAYER1_FUSED=True)
    b, h, w, g = 2 * n, 128, 160, 20
    rng = np.random.RandomState(3)
    batch = {"data": rng.randn(b, h, w, 3).astype(np.float32) * 10,
             "im_info": np.array([[h, w, 1.0]] * b, dtype=np.float32),
             "gt_boxes": np.zeros((b, g, 5), dtype=np.float32),
             "num_boxes": np.asarray([2 + i % 5 for i in range(b)], dtype=np.int32)}
    for i in range(b):
        for j in range(int(batch["num_boxes"][i])):
            x1, y1 = rng.randint(0, w - 50), rng.randint(0, h - 50)
            batch["gt_boxes"][i, j] = [x1, y1, x1 + rng.randint(20, 45),
                                       y1 + rng.randint(20, 45), 1 + rng.randint(80)]
    return dict(kind="detector", backbone="resnet101", num_classes=81, cfg=cfg, seed=3,
                batch=batch, draw_seed=7, lr=0.01, device=device, eval=True,
                checkpoint=checkpoint)


def dryrun(n: int, device: str = "cpu", backend: str | None = None) -> dict:
    """The dry run; raises AssertionError where the N-rank run departs from
    the one-process run. Returns {loss, single_loss, kept, backend}."""
    if device == "cuda" and backend is None:
        backend = "nccl" if n <= torch.cuda.device_count() else "gloo"
    backend = backend or "gloo"
    if device == "cpu":
        # this process runs the one-process step beside the ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // (n + 1)))
    with tempfile.TemporaryDirectory(prefix="rlod_dryrun_") as td:
        spec = dryrun_spec(n, device, os.path.join(td, "state.pth"))
        # the seeded weights made once, here, and handed to every process
        spec["state"] = _model(spec, torch.device("cpu")).state_dict()
        ranks, one = launch(n, spec, backend, meanwhile=lambda: run_spec(
            {**spec, "eval": False, "checkpoint": None}))
        loss = ranks[0]["metrics"]["loss"]
        if not np.isfinite(loss) or any(r["metrics"]["loss"] != loss or r["loss_mean"] != loss
                                        for r in ranks):
            raise AssertionError(f"rank losses {[r['metrics']['loss'] for r in ranks]}, their "
                                 f"mean {ranks[0]['loss_mean']}")
        print(f"dryrun({n}, {device}, {backend}): train loss={loss:.6f} OK; each rank's "
              f"kernel launches {json.dumps([r['launches'] for r in ranks])}")
        kept = sum(r["kept"] for r in ranks)
        if kept == 0:
            raise AssertionError("the eval postprocess kept zero detections")
        print(f"dryrun({n}): eval + postprocess OK ({kept} detections kept)")
        single = one["metrics"]["loss"]
        if abs(single - loss) > LOSS_REL * abs(single):
            raise AssertionError(f"{n}-rank loss {loss} against one process's {single}")
        print(f"dryrun({n}): loss {loss:.6f} == one process's {single:.6f} "
              f"(rel {abs(single - loss) / abs(single):.2e})")
        restored = _model(spec, torch.device(device))   # the state, then the file's
        load_checkpoint(spec["checkpoint"], restored)
        want = digest(restored)
        for r, out in enumerate(ranks):
            if out["digest"] != want:
                bad = [k for k in want if out["digest"][k] != want[k]][:3]
                raise AssertionError(f"rank {r}'s replica differs from the checkpoint "
                                     f"restored in one process at {bad}")
        print(f"dryrun({n}): rank 0's checkpoint restores into one process, equal to "
              f"every rank's replica OK")
    return {"loss": loss, "single_loss": single, "kept": kept, "backend": backend,
            "launches": [r["launches"] for r in ranks]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Data-parallel dry run over N processes")
    p.add_argument("n", type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    args = p.parse_args(argv)
    dryrun(args.n, args.device, args.backend)


if __name__ == "__main__":
    main()
