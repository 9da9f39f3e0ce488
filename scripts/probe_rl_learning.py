"""Does the RL CLI's ResNet-101 net learn the smoke's detector shift? On an
H100, about 1.5 min with the kernels' build.

    python scripts/probe_rl_learning.py [--epochs 12] [--lr 0.01 0.001]

The fixture and weights of `chip_smoke.py`'s "rl cli" phase: 8 synthetic
COCO images of 480×640 whose detections are the gt shifted by (7, -5)
(`engine/rl_hw_validate.py::build_fixture`), the seeded random flagship
with frozen-BN statistics from one of the CLI's batches
(`chip_smoke.calibrated_state`). For each learning rate it trains
`engine/trainval_rl.py` at its defaults (ResNet-101, 800 / 1200, batch 2,
f32) for `--epochs` epochs, prints the loss logged each epoch, and
evaluates epochs 2, half way and the last (`-e --resume`, top-1
teacher-forced moves): precision@1 and the mAP of the moved boxes (the
unmoved ones score the epoch-0 value). Prints the card's name and power
limit first. Needs a CUDA device and nvcc.
"""

import argparse
import contextlib
import io
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from rlobjectdetection_tpu_torch.config import RLConfig
    from rlobjectdetection_tpu_torch.data.rl_coco import (COCODataLoader, COCODataset,
                                                          COCOTransform)
    from rlobjectdetection_tpu_torch.engine import rl_hw_validate, trainval_rl
    from rlobjectdetection_tpu_torch.engine.checkpoint import save_params
    from rlobjectdetection_tpu_torch.engine.serve import build_config
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.models.rl import Action
    from rlobjectdetection_tpu_torch.ops import _build

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", default=12, type=int)
    p.add_argument("--lr", nargs="+", default=["0.01", "0.001"])
    args = p.parse_args()
    cs.check(torch.cuda.is_available(), "the probe needs a GPU")
    print(cs.nvidia_smi_line(), flush=True)
    _build.build()

    model = FasterRCNN(cs.NUM_CLASSES, "resnet101",
                       build_config("coco", ["TEST.SCALES", "[800]", "DTYPE", "bfloat16"]),
                       device="cuda", seed=3)
    cs.randomize_frozen_bn(model, seed=3)
    det_state = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    os.makedirs(os.path.join(REPO, "output"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="rl_learning_", dir=os.path.join(REPO, "output"))
    try:
        classes = tuple(f"category{i:02d}" for i in range(1, cs.NUM_CLASSES))
        ann, dt_file, img_dir = rl_hw_validate.build_fixture(
            root, cs.RL_CLI_IMAGES, cs.RL_CLI_IMAGE_SIZE, classes=classes)
        cfg = RLConfig()
        dataset = COCODataset(img_dir, ann, dt_file, Action(list(cfg.act_delta),
                                                            wtrans=cfg.act_wtrans),
                              transform_fn=COCOTransform(cs.RL_CLI_SHORT, cs.RL_CLI_MAX_SIZE),
                              normalize_mean=cfg.normalize_mean, normalize_std=cfg.normalize_std)
        loader = COCODataLoader(dataset, 2)
        loader.set_epoch(0)
        batch = loader.assemble_job(loader.batch_plan()[0])
        info = torch.tensor([[*cs.RL_CLI_BLOB[1:3], 1.0]] * 2, device="cuda")
        pretrained = save_params(os.path.join(root, "pretrained.pth"), cs.calibrated_state(
            det_state, build_config("coco", cs.TRAINVAL_SET), "resnet101",
            {"data": torch.from_numpy(batch["data"]).cuda(), "im_info": info}))
        print(f"unmoved detections: mAP {rl_hw_validate.score(ann, dt_file)[0]:.4f}", flush=True)
        common = ["--ann_file", ann, "--dt_file", dt_file, "--data_dir", img_dir,
                  "--save_dir", os.path.join(root, "models")]
        for lr in args.lr:
            with contextlib.redirect_stdout(io.StringIO()):
                run = trainval_rl.main(["--epochs", str(args.epochs), "--pretrained",
                                        pretrained, "--lr", lr] + common,
                                       num_workers=cs.RL_CLI_WORKERS)
            print(f"lr {lr}: logged (epoch, loss, noweight) "
                  f"{[(e, round(l, 4), round(n, 4)) for e, _, l, n in run['logged']]}",
                  flush=True)
            for k in sorted({2, args.epochs // 2, args.epochs}):
                with contextlib.redirect_stdout(io.StringIO()):
                    ev = trainval_rl.main(["-e", "--resume", os.path.join(
                        root, "models", f"rl_epoch_{k}.pth")] + common,
                        num_workers=cs.RL_CLI_WORKERS)
                print(f"lr {lr} epoch {k}: Preck {ev['preck']:.2f}%, mAP {ev['stats'][0]:.4f}",
                      flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
