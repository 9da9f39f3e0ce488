"""Torch checkpoints of the reference (caffe-pretrained backbones, trained
detectors, the RL policy) → the port's state dict (counterpart of the JAX
package's `tools/convert_torch_weights.py`).

    python -m rlobjectdetection_tpu_torch.engine.convert_torch_weights \
        --src resnet101_caffe.pth --net res101 --out res101.pth

The port keeps torch's layouts (conv OIHW, linear `[out, in]`), so this is
a renaming of keys: torchvision's `features.{i}` / `classifier.{i}` (VGG-16)
and `conv1`, `bn1`, `layer{n}.{b}.conv{k}`, `downsample.{0,1}` (ResNet),
BatchNorm's `weight`, `bias`, `running_mean`, `running_var` →
`scale`, `bias`, `mean`, `var`; the detector's `RCNN_base`, `RCNN_top`,
`RCNN_rpn`, `RCNN_cls_score` and `RCNN_bbox_pred` → `base`, `head`, `rpn`
and the two classifiers. Values come out as f32 CPU tensors. `--pretrained`
of `trainval_net` and `--weights` of `test_net` read the result with
`merge_pretrained`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .checkpoint import save_params

VGG_CONVS = dict(zip(
    (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
    ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3",
     "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2", "conv5_3")))
RESNET_SPECS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BN_LEAVES = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
             ("running_var", "var"))


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(v), dtype=np.float32, order="C"))


def _copy(out: dict, sd: dict, src: str, dst: str) -> None:
    """`src.weight` → `dst.weight`, and the bias where `sd` has one."""
    out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])


def _bn(out: dict, sd: dict, src: str, dst: str) -> None:
    for a, b in BN_LEAVES:
        out[f"{dst}.{b}"] = _t(sd[f"{src}.{a}"])


def convert_vgg16(sd) -> dict[str, torch.Tensor]:
    """torchvision VGG-16 → `base.conv1_1` … `base.conv5_3`, `head.fc6`,
    `head.fc7`."""
    out = {}
    for idx, name in VGG_CONVS.items():
        _copy(out, sd, f"features.{idx}", f"base.{name}")
    _copy(out, sd, "classifier.0", "head.fc6")
    _copy(out, sd, "classifier.3", "head.fc7")
    return out


def convert_resnet(sd, num_layers: int = 101) -> dict[str, torch.Tensor]:
    """torch ResNet → `base` (conv1, bn1, layer1-3) and, where `sd` has
    layer4, `head.layer4`."""
    specs = RESNET_SPECS[num_layers]
    out = {"base.conv1.weight": _t(sd["conv1.weight"])}
    _bn(out, sd, "bn1", "base.bn1")
    for n, blocks in enumerate(specs, start=1):
        if n == 4 and "layer4.0.conv1.weight" not in sd:   # a base-only dump has no head
            break
        dst = f"head.layer{n}" if n == 4 else f"base.layer{n}"
        for b in range(blocks):
            src, blk = f"layer{n}.{b}", f"{dst}.block{b}"
            for k in (1, 2, 3):
                out[f"{blk}.conv{k}.weight"] = _t(sd[f"{src}.conv{k}.weight"])
                _bn(out, sd, f"{src}.bn{k}", f"{blk}.bn{k}")
            if f"{src}.downsample.0.weight" in sd:
                out[f"{blk}.downsample_conv.weight"] = _t(sd[f"{src}.downsample.0.weight"])
                _bn(out, sd, f"{src}.downsample.1", f"{blk}.downsample_bn")
    return out


def convert_rpn(sd, prefix: str = "RCNN_rpn.") -> dict[str, torch.Tensor]:
    """The RPN's three convs; the channel orders carry over (the 2A class
    channels [A bg, A fg], the 4A deltas A groups of (dx, dy, dw, dh))."""
    out = {}
    for name in ("RPN_Conv", "RPN_cls_score", "RPN_bbox_pred"):
        _copy(out, sd, prefix + name, f"rpn.{name}")
    return out


def _unwrap(sd) -> dict:
    return {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}


def convert_detector(sd, net: str = "res101") -> dict[str, torch.Tensor]:
    """A whole reference detector (`RCNN_base`, `RCNN_top`, `RCNN_rpn`, the
    classifiers) → the port's `FasterRCNN` state dict."""
    sd = _unwrap(sd)
    if net == "vgg16":
        remapped = {}
        for k, v in sd.items():
            if k.startswith("RCNN_base."):
                remapped["features." + k[len("RCNN_base."):]] = v
            elif k.startswith("RCNN_top."):
                remapped["classifier." + k[len("RCNN_top."):]] = v
        out = convert_vgg16(remapped)
    else:
        seq = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3"}
        remapped = {}
        for k, v in sd.items():
            if k.startswith("RCNN_base."):
                idx, rest = k[len("RCNN_base."):].split(".", 1)
                remapped[f"{seq[idx]}.{rest}"] = v
            elif k.startswith("RCNN_top.0."):
                remapped["layer4." + k[len("RCNN_top.0."):]] = v
        out = convert_resnet(remapped, {"res50": 50, "res101": 101, "res152": 152}[net])
    out.update(convert_rpn(sd))
    if "RCNN_cls_score.weight" in sd:
        _copy(out, sd, "RCNN_cls_score", "RCNN_cls_score")
        _copy(out, sd, "RCNN_bbox_pred", "RCNN_bbox_pred")
    return out


def convert_rl(sd) -> dict[str, torch.Tensor]:
    """The reference RL policy (a ResNet with fc8 and fc) → `RLPolicyNet`'s
    state dict: conv1..layer3 `base`, layer4 `head`, then fc8 and fc."""
    sd = _unwrap(sd)
    out = convert_resnet(sd, 101 if "layer3.22.conv1.weight" in sd else 50)
    _copy(out, sd, "fc8", "fc8")
    _copy(out, sd, "fc", "fc")
    return out


def merge_pretrained(state_dict: dict, pretrained: dict) -> dict:
    """`state_dict` with every key of `pretrained` that it has at the same
    shape replaced (cast to its dtype); a key it lacks or a shape that
    differs is skipped with a line saying so, every other key left as it
    is (the reference's strict=False load)."""
    out = dict(state_dict)
    for k, v in pretrained.items():
        if k not in out:
            print(f"skip (missing): {k}")
        elif tuple(out[k].shape) != tuple(np.shape(v)):
            print(f"skip (shape): {k} {tuple(out[k].shape)} vs {tuple(np.shape(v))}")
        else:
            out[k] = torch.as_tensor(np.asarray(v)).to(out[k].dtype)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Convert reference torch weights to the port's")
    p.add_argument("--src", required=True, help=".pth state dict")
    p.add_argument("--net", required=True, choices=["vgg16", "res50", "res101", "res152", "rl"])
    p.add_argument("--out", required=True, help="output .pth (save_params)")
    args = p.parse_args(argv)

    sd = torch.load(args.src, map_location="cpu", weights_only=True)
    for wrap in ("model", "state_dict"):        # a whole detector's or the RL net's payload
        if wrap in sd:
            sd = sd[wrap]
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    if args.net == "rl":
        out = convert_rl(sd)
    elif any(k.startswith(("RCNN_base.", "module.RCNN_base.")) for k in sd):
        out = convert_detector(sd, args.net)
    elif args.net == "vgg16":
        out = convert_vgg16(sd)
    else:
        out = convert_resnet(sd, {"res50": 50, "res101": 101, "res152": 152}[args.net])
    save_params(args.out, out)
    print(f"wrote {args.out} ({len(out)} tensors)")


if __name__ == "__main__":
    main()
