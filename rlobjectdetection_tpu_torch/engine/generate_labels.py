"""Offline ΔIoU labels of a detections json (the port's counterpart of the
JAX package's `tools/generate_labels.py`).

    python -m rlobjectdetection_tpu_torch.engine.generate_labels \
        --ann_file GT.json --dt_file DETS.json --out OUT.json \
        [--delta 0.5 0.25 ...] [--alpha 1.0]

Each detection of DETS.json is written to OUT.json with three more fields:
`iou` (its best IoU against the same-category gt of its image), `dious`
(the ΔIoU of each action, `data/rl_coco.py::action_dious`) and `act` (the
first action of largest ΔIoU). numpy only; no device.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np

from ..data.coco_api import COCO
from ..data.rl_coco import action_dious
from ..models.rl import Action


def parse_args(argv=None):
    p = argparse.ArgumentParser("offline ΔIoU label generation")
    p.add_argument("--ann_file", required=True, help="COCO gt annotations json")
    p.add_argument("--dt_file", required=True, help="detections results json")
    p.add_argument("--out", required=True, help="enriched output json")
    p.add_argument("--delta", type=float, nargs="+",
                   default=[0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625, 0.008])
    p.add_argument("--alpha", type=float, default=1.0)
    return p.parse_args(argv)


def label_detections(action: Action, gt: COCO, dts: list) -> list[dict]:
    """Each detection with its `iou`, `dious` and `act`."""
    gt_by_key = defaultdict(list)
    for ann in gt.dataset.get("annotations", []):
        gt_by_key[ann["image_id"], ann["category_id"]].append(ann)
    out = []
    for dt in dts:
        origin, dious = action_dious(action, dt["bbox"],
                                     gt_by_key.get((dt["image_id"], dt["category_id"]), []))
        dious = dious.tolist()
        out.append(dict(dt, iou=float(origin), dious=[float(x) for x in dious],
                        act=int(np.argmax(dious))))
    return out


def main(argv=None) -> str:
    """Writes `--out`; returns its path."""
    args = parse_args(argv)
    action = Action(args.delta, alpha=args.alpha)
    with open(args.dt_file) as f:
        dts = json.load(f)
    out = label_detections(action, COCO(args.ann_file), dts)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"wrote {args.out} ({len(out)} detections × {action.num_acts} actions)")
    return args.out


if __name__ == "__main__":
    main()
