"""Resume equality through the RL trainer CLI (counterpart of the JAX
package's `tools/rl_resume_validate.py`).

    python -m rlobjectdetection_tpu_torch.engine.rl_resume_validate \
        [--epochs 2] [--layers 18] [--batch_size 2] [--img_short 96] \
        [--img_size 160] [--images 6] [--device cuda] [--pretrained F] \
        [--ann_file A --dt_file D --data_dir I] [--work_dir W]

Run A trains `--epochs` E epochs of `engine/trainval_rl.py` in one process;
run B trains one epoch (beside A), then `--resume`s from `rl_epoch_1.pth`
to E in a fresh process. Every tensor of the two final checkpoints (parameters,
frozen-BN statistics, momentum buffers) and their step and schedule counts
are compared. What makes them equal: the loader's order keyed on (seed,
epoch) and each item's draws on (seed, epoch, index), and the checkpoint
restoring the model, momentum, schedule and step exactly.

Each run is `python -c` of `trainval_rl.main` under
`torch.use_deterministic_algorithms(True)` with
`CUBLAS_WORKSPACE_CONFIG=:4096:8`: an op without a deterministic algorithm
raises and names itself. Without `--ann_file` the data is a synthetic COCO
split of `--images` images made under the work dir, its detections the gt
jittered by N(0, 2) px from seed 0. Prints one JSON line {"metric":
"rl_resume_bitwise_equality", ...}; exits 1 where the runs differ in any
bit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .checkpoint import read_checkpoint
from .resume_validate import REPO, tensors

CHILD = ("import sys, torch; torch.use_deterministic_algorithms(True); "
         "from rlobjectdetection_tpu_torch.engine.trainval_rl import main; main(sys.argv[1:])")


def make_data(work: str, images: int) -> tuple[str, str, str]:
    """(gt json, detections json, image dir) of a synthetic COCO val split
    whose detections are its gt boxes jittered in x and y."""
    from ..data.synthetic import make_coco_dataset

    ann = make_coco_dataset(work, num_images=images, split="val", year="2014")
    with open(ann) as f:
        gt = json.load(f)
    rng = np.random.RandomState(0)
    dets = []
    for a in gt["annotations"]:
        b = list(a["bbox"])
        b[0] += rng.randn() * 2
        b[1] += rng.randn() * 2
        dets.append({"image_id": a["image_id"], "category_id": a["category_id"],
                     "bbox": [float(x) for x in b], "score": 0.8})
    dt_file = os.path.join(work, "dets.json")
    with open(dt_file, "w") as f:
        json.dump(dets, f)
    return ann, dt_file, os.path.join(work, "coco", "images", "val2014")


def start(save_dir: str, args, data, epochs: int, resume=None) -> subprocess.Popen:
    """One trainer process, started."""
    ann, dt_file, img_dir = data
    argv = ["--ann_file", ann, "--dt_file", dt_file, "--data_dir", img_dir,
            "--save_dir", save_dir, "--batch_size", str(args.batch_size),
            "--epochs", str(epochs), "--layers", str(args.layers),
            "--img_short", str(args.img_short), "--img_size", str(args.img_size),
            "--max_stat_dets", "64", "--stat_workers", "1", "--device", args.device]
    if args.pretrained:
        argv += ["--pretrained", args.pretrained]
    if resume is not None:
        argv += ["--resume", resume]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    return subprocess.Popen([sys.executable, "-c", CHILD, *argv], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait(*procs: subprocess.Popen) -> None:
    """Wait for trainer processes (each killed if it outlives the wait);
    raise with the stderr of one that failed."""
    try:
        errs = [proc.communicate(timeout=1800)[1] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, err in zip(procs, errs):
        if proc.returncode != 0:
            raise SystemExit(f"RL trainer failed (exit {proc.returncode}):\n{err[-4000:]}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Resume equality through trainval_rl")
    p.add_argument("--epochs", default=2, type=int)
    p.add_argument("--layers", default=18, type=int)
    p.add_argument("--batch_size", default=2, type=int)
    p.add_argument("--img_short", default=96, type=int)
    p.add_argument("--img_size", default=160, type=int)
    p.add_argument("--images", default=6, type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--pretrained", default=None, help="trainval_rl's --pretrained, both runs")
    p.add_argument("--ann_file", default=None)
    p.add_argument("--dt_file", default=None)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--work_dir", default=None)
    args = p.parse_args(argv)
    if args.epochs < 2:
        p.error("--epochs must be at least 2: one epoch on each side of the cut")

    work = args.work_dir or tempfile.mkdtemp(prefix="rl_resume_val_")
    try:
        data = ((args.ann_file, args.dt_file, args.data_dir) if args.ann_file
                else make_data(os.path.join(work, "data"), args.images))
        dir_a, dir_b = os.path.join(work, "uninterrupted"), os.path.join(work, "resumed")
        # A and B's first epoch are independent: run them side by side
        wait(start(dir_a, args, data, args.epochs), start(dir_b, args, data, 1))
        wait(start(dir_b, args, data, args.epochs,
                   resume=os.path.join(dir_b, "rl_epoch_1.pth")))
        final = f"rl_epoch_{args.epochs}.pth"
        a = tensors(os.path.join(dir_a, final))
        b = tensors(os.path.join(dir_b, final))
        if a.keys() != b.keys():
            raise SystemExit("the two final checkpoints hold other tensors")
        delta = max(float((a[k].double() - b[k].double()).abs().max()) if a[k].numel() else 0.0
                    for k in a)
        ok = all(torch.equal(a[k], b[k]) for k in a)
        epoch = read_checkpoint(os.path.join(dir_b, final))["epoch"]
        device = (torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda"
                  else "cpu")
        result = {"metric": "rl_resume_bitwise_equality", "layers": args.layers,
                  "epochs": args.epochs, "device": device, "n_leaves": len(a),
                  "max_abs_delta": delta, "ok": ok and epoch == args.epochs}
        print(json.dumps(result), flush=True)
    finally:
        if args.work_dir is None:
            shutil.rmtree(work, ignore_errors=True)
    if not result["ok"]:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
