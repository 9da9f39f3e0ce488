"""Resume equality through the trainer CLI (counterpart of the JAX
package's `tools/resume_validate.py`).

    python -m rlobjectdetection_tpu_torch.engine.resume_validate \
        [--net tiny|res50|res101] [--dataset pascal_voc|coco] [--epochs 2] \
        [--bs 2] [--images 8] [--image_size H W] [--device cuda] \
        [--pretrained F] [--work_dir W] [--set KEY VALUE ...]

Run A trains `--epochs` E epochs in one process; run B trains one epoch,
then resumes with `--r --checkepoch 1` in a fresh process up to E. Every
tensor of the two final checkpoints (parameters, frozen-BN statistics,
momentum buffers) and their step and schedule counts are compared. What
makes them equal: the loader's plan keyed on (seed, epoch), each step's
draws keyed on (seed, global step), and the checkpoint restoring the
model, momentum, schedule and step exactly.

Each run is `python -c` of `trainval_net.main` under
`torch.use_deterministic_algorithms(True)` with
`CUBLAS_WORKSPACE_CONFIG=:4096:8`: cuDNN and cuBLAS pick deterministic
algorithms, and an op that has none raises and names itself. The hand
kernels are outside torch's checker: the stem, layer1 and RoIAlignAvg
forward compute each output once, the RoIAlignAvg backward sums in a fixed
order. The dataset is synthetic, made under the work dir from seed 3.
Prints one JSON line {"metric": "resume_bitwise_equality", ...}; exits 1
where the two runs differ in any bit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from .checkpoint import checkpoint_path, read_checkpoint

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
TINY_SET = [
    "TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N", "64",
    "TRAIN.BATCH_SIZE", "32", "TRAIN.SCALES", "[128]", "TRAIN.USE_FLIPPED", "False",
    "ANCHOR_SCALES", "(2,3,5)", "DTYPE", "float32", "NMS_TILE", "64",
]
CHILD = ("import sys, torch; torch.use_deterministic_algorithms(True); "
         "from rlobjectdetection_tpu_torch.engine.trainval_net import main; main(sys.argv[1:])")


def make_dataset(root: str, dataset: str, images: int, image_size) -> None:
    """pascal_voc: a VOC 2007 trainval split; coco: `images` split between
    the train and valminusminival splits that `DATASET_MAP["coco"]` joins."""
    from ..data.synthetic import make_coco_dataset, make_voc_devkit

    if dataset == "pascal_voc":
        make_voc_devkit(root, num_images=images, image_size=image_size,
                        classes=("aeroplane", "bicycle", "bird"))
    elif dataset == "coco":
        classes = tuple(f"category{i:02d}" for i in range(1, 81))
        make_coco_dataset(root, num_images=images // 2, split="train", image_size=image_size,
                          classes=classes, seed=3)
        make_coco_dataset(root, num_images=images - images // 2, split="valminusminival",
                          image_size=image_size, classes=classes, seed=4, first_id=2000)
    else:
        raise ValueError(f"no synthetic {dataset!r}")


def train(save_dir: str, args, data_dir: str, epochs: int, resume_epoch=None) -> None:
    """One trainer process."""
    argv = ["--dataset", args.dataset, "--net", args.net, "--epochs", str(epochs),
            "--bs", str(args.bs), "--lr", "0.002", "--disp_interval", "1",
            "--save_dir", save_dir, "--device", args.device]
    if resume_epoch is not None:
        argv += ["--r", "--checkepoch", str(resume_epoch)]
    if args.pretrained:
        argv += ["--pretrained", args.pretrained]
    argv += ["--set"] + (args.set_cfgs or TINY_SET)
    env = dict(os.environ, RLOD_DATA_DIR=data_dir, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    r = subprocess.run([sys.executable, "-c", CHILD, *argv], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        raise SystemExit(f"trainer failed (exit {r.returncode}):\n{r.stderr[-4000:]}")


def tensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor and count of a checkpoint, by name."""
    ck = read_checkpoint(path)
    out = {f"model/{k}": v for k, v in ck["model"].items()}
    for idx, state in ck["optimizer"]["state"].items():
        for k, v in state.items():
            out[f"optimizer/{idx}/{k}"] = torch.as_tensor(v)
    out["step"] = torch.tensor(ck["step"])
    out["scheduler/last_epoch"] = torch.tensor(ck["scheduler"]["last_epoch"])
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Resume equality through trainval_net")
    p.add_argument("--net", default="tiny")
    p.add_argument("--dataset", default="pascal_voc", choices=["pascal_voc", "coco"])
    p.add_argument("--epochs", default=2, type=int)
    p.add_argument("--bs", default=2, type=int)
    p.add_argument("--images", default=8, type=int)
    p.add_argument("--image_size", nargs=2, type=int, default=(128, 160), metavar=("H", "W"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--pretrained", default=None, help="trainval_net's --pretrained, both runs")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)
    if args.epochs < 2:
        p.error("--epochs must be at least 2: one epoch on each side of the cut")

    work = args.work_dir or tempfile.mkdtemp(prefix="resume_val_")
    try:
        data_dir = os.path.join(work, "data")
        if not os.path.isdir(data_dir):
            make_dataset(data_dir, args.dataset, args.images, tuple(args.image_size))
        dir_a, dir_b = os.path.join(work, "uninterrupted"), os.path.join(work, "resumed")
        train(dir_a, args, data_dir, args.epochs)
        train(dir_b, args, data_dir, 1)
        train(dir_b, args, data_dir, args.epochs, resume_epoch=1)
        a = tensors(checkpoint_path(dir_a, args.net, args.dataset, 1, args.epochs))
        b = tensors(checkpoint_path(dir_b, args.net, args.dataset, 1, args.epochs))
        if a.keys() != b.keys():
            raise SystemExit("the two final checkpoints hold other tensors")
        delta = max(float((a[k].double() - b[k].double()).abs().max()) if a[k].numel() else 0.0
                    for k in a)
        ok = all(torch.equal(a[k], b[k]) for k in a)
        device = (torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda"
                  else "cpu")
        result = {"metric": "resume_bitwise_equality", "net": args.net, "epochs": args.epochs,
                  "device": device, "n_leaves": len(a), "max_abs_delta": delta, "ok": ok}
        print(json.dumps(result), flush=True)
    finally:
        if args.work_dir is None:
            shutil.rmtree(work, ignore_errors=True)
    if not ok:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
