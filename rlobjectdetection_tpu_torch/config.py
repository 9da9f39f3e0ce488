"""Config system of the PyTorch port.

A copy of `rlobjectdetection_tpu/config.py` (the port imports nothing of the
JAX package): the frozen-dataclass rebuild of the reference's three-tier
config (code defaults ← YAML `cfg_from_file` ← CLI `cfg_from_list`) with the
same key names, so `--set TRAIN.SCALES ...` overrides and config files mean
the same thing to both packages. `NETS` is the one table of the detector
`--net` names, and `build_config` the config of every entry point.

In the port, `CONV1_FUSED` / `LAYER1_FUSED` / `STAGE_FUSED` select the
hand-written CUDA stem, layer1 and layer2/layer3 kernels (their plain PyTorch
versions on CPU tensors); `STEM_INTERPRET` has no meaning here. `ALIGN_IMPL` is kept for the training
slice: every value computes the same RoIAlignAvg forward.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Tuple


@dataclass(frozen=True)
class TrainConfig:
    # mirrors __C.TRAIN (utils/config.py:19-159)
    LEARNING_RATE: float = 0.001
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 0.0005
    GAMMA: float = 0.1
    STEPSIZE: Tuple[int, ...] = (30000,)
    DISPLAY: int = 10
    DOUBLE_BIAS: bool = True
    TRUNCATED: bool = False
    BIAS_DECAY: bool = False
    USE_GT: bool = False
    ASPECT_GROUPING: bool = False
    SNAPSHOT_KEPT: int = 3
    SUMMARY_INTERVAL: int = 180
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    TRIM_HEIGHT: int = 600
    TRIM_WIDTH: int = 600
    IMS_PER_BATCH: int = 1
    BATCH_SIZE: int = 128            # rois per image
    FG_FRACTION: float = 0.25
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.1
    USE_FLIPPED: bool = True
    BBOX_REG: bool = True
    BBOX_THRESH: float = 0.5
    SNAPSHOT_ITERS: int = 5000
    SNAPSHOT_PREFIX: str = "res101_faster_rcnn"
    BBOX_NORMALIZE_TARGETS: bool = True
    BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    BBOX_NORMALIZE_TARGETS_PRECOMPUTED: bool = True
    BBOX_NORMALIZE_MEANS: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    BBOX_NORMALIZE_STDS: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    PROPOSAL_METHOD: str = "gt"
    HAS_RPN: bool = True
    RPN_POSITIVE_OVERLAP: float = 0.7
    RPN_NEGATIVE_OVERLAP: float = 0.3
    RPN_CLOBBER_POSITIVES: bool = False
    RPN_FG_FRACTION: float = 0.5
    RPN_BATCHSIZE: int = 256
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 12000
    RPN_POST_NMS_TOP_N: int = 2000
    RPN_MIN_SIZE: int = 8
    RPN_BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    RPN_POSITIVE_WEIGHT: float = -1.0
    USE_ALL_GT: bool = True
    BN_TRAIN: bool = False


@dataclass(frozen=True)
class TestConfig:
    # mirrors __C.TEST (utils/config.py:164-206)
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    NMS: float = 0.3
    SVM: bool = False
    BBOX_REG: bool = True
    HAS_RPN: bool = False
    PROPOSAL_METHOD: str = "gt"
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 6000
    RPN_POST_NMS_TOP_N: int = 300
    RPN_MIN_SIZE: int = 16
    MODE: str = "nms"
    RPN_TOP_N: int = 5000
    MAX_DETS_PER_IMAGE: int = 100    # test_net.py:97 max_per_image


@dataclass(frozen=True)
class ResNetConfig:
    MAX_POOL: bool = False
    FIXED_BLOCKS: int = 1


@dataclass(frozen=True)
class Config:
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    RESNET: ResNetConfig = field(default_factory=ResNetConfig)
    # MISC (utils/config.py:244-302)
    DEDUP_BOXES: float = 1.0 / 16.0
    PIXEL_MEANS: Tuple[float, ...] = (102.9801, 115.9465, 122.7717)  # BGR
    RNG_SEED: int = 3
    EPS: float = 1e-14
    POOLING_MODE: str = "align"      # reference default 'crop'; 'align' is the bench path
    POOLING_SIZE: int = 7
    MAX_NUM_GT_BOXES: int = 20
    ANCHOR_SCALES: Tuple[int, ...] = (8, 16, 32)
    ANCHOR_RATIOS: Tuple[float, ...] = (0.5, 1, 2)
    FEAT_STRIDE: Tuple[int, ...] = (16,)
    CROP_RESIZE_WITH_MAX_POOL: bool = True
    EXP_DIR: str = "default"
    DATA_DIR: str = "data"
    MATLAB: str = "matlab"           # accepted for YAML compat; MATLAB eval is dropped
    # TPU-specific knobs (no reference counterpart)
    DTYPE: str = "bfloat16"          # compute dtype for the backbone/heads
    NMS_TILE: int = 256
    REMAT: bool = False              # rematerialize backbone stages (memory ↓, FLOPs ↑)
    ALIGN_IMPL: str = "autodiff"     # autodiff | cvjp (sorted-scatter backward; compiles faster)
    CONV1_S2D: bool = False          # space-to-depth stem (identical numerics; measured slower on v5e)
    CONV1_FUSED: bool = False        # Pallas fused stem (conv1+bn+relu+maxpool); TPU backend (any device count)
    LAYER1_FUSED: bool = False       # Pallas fused layer1 (3 bottlenecks); needs CONV1_FUSED + FIXED_BLOCKS>=1
    STEM_INTERPRET: bool = False     # run the fused Pallas kernels in interpret mode (CPU tests/dryruns)
    STAGE_FUSED: int = 0             # Pallas fused frozen stages, digit-coded: 2 = layer2, 3 = layer3,
                                     # 23 = both (forward-only: needs FIXED_BLOCKS >= stage in training;
                                     # eval fuses regardless)


def _coerce(old: Any, new: Any, key: str) -> Any:
    """Type-checked coercion matching _merge_a_into_b (utils/config.py:337-367)."""
    if isinstance(old, tuple):
        if not isinstance(new, (list, tuple)):
            raise ValueError(f"Type mismatch ({type(old)} vs {type(new)}) for config key: {key}")
        return tuple(new)
    if isinstance(old, bool):
        if not isinstance(new, bool):
            raise ValueError(f"Type mismatch (bool vs {type(new)}) for config key: {key}")
        return new
    if isinstance(old, float) and isinstance(new, (int, float)):
        return float(new)
    if type(old) is not type(new):
        raise ValueError(f"Type mismatch ({type(old)} vs {type(new)}) for config key: {key}")
    return new


def cfg_update(cfg: Config, updates: dict) -> Config:
    """Merge a (possibly nested) dict of overrides into a Config."""
    kw = {}
    for k, v in updates.items():
        if not hasattr(cfg, k):
            raise KeyError(f"{k} is not a valid config key")
        cur = getattr(cfg, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kw[k] = cfg_update(cur, v)
        else:
            kw[k] = _coerce(cur, v, k)
    return replace(cfg, **kw)


def cfg_from_file(cfg: Config, filename: str) -> Config:
    """YAML override, mirroring cfg_from_file (utils/config.py:370-376)."""
    import yaml

    with open(filename) as f:
        y = yaml.safe_load(f)
    return cfg_update(cfg, y or {})


def cfg_from_list(cfg: Config, cfg_list) -> Config:
    """Dotted-key CLI override, mirroring cfg_from_list (utils/config.py:379-399).

    e.g. ["TRAIN.SCALES", "[800]", "POOLING_MODE", "align"]
    """
    from ast import literal_eval

    assert len(cfg_list) % 2 == 0
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        d: dict = {}
        node = d
        parts = k.split(".")
        for p in parts[:-1]:
            node[p] = {}
            node = node[p]
        node[parts[-1]] = value
        cfg = cfg_update(cfg, d)
    return cfg


def get_output_dir(cfg: Config, imdb_name: str, weights_filename: str | None = None) -> str:
    """Experiment artifact directory (utils/config.py:305-318):
    output/<EXP_DIR>/<imdb name>/<weights or 'default'>, created on demand."""
    import os

    outdir = os.path.abspath(
        os.path.join("output", cfg.EXP_DIR, imdb_name, weights_filename or "default")
    )
    os.makedirs(outdir, exist_ok=True)
    return outdir


# Dataset-specific override lists mirroring RCNN_bases/trainval_net.py:160-181.
DATASET_OVERRIDES = {
    "pascal_voc": {
        "ANCHOR_SCALES": (8, 16, 32), "ANCHOR_RATIOS": (0.5, 1, 2),
        "MAX_NUM_GT_BOXES": 20,
    },
    "pascal_voc_0712": {
        "ANCHOR_SCALES": (8, 16, 32), "ANCHOR_RATIOS": (0.5, 1, 2),
        "MAX_NUM_GT_BOXES": 20,
    },
    "coco": {
        "ANCHOR_SCALES": (4, 8, 16, 32), "ANCHOR_RATIOS": (0.5, 1, 2),
        "MAX_NUM_GT_BOXES": 50,
    },
    "imagenet": {
        "ANCHOR_SCALES": (8, 16, 32), "ANCHOR_RATIOS": (0.5, 1, 2),
        "MAX_NUM_GT_BOXES": 30,
    },
    "vg": {
        "ANCHOR_SCALES": (4, 8, 16, 32), "ANCHOR_RATIOS": (0.5, 1, 2),
        "MAX_NUM_GT_BOXES": 50,
    },
}

# Large-scale variants (`--ls`, README.md:82): scale 800, max 1200.
LS_OVERRIDES = {"TRAIN": {"SCALES": (800,), "MAX_SIZE": 1200},
                "TEST": {"SCALES": (800,), "MAX_SIZE": 1200}}


@dataclass(frozen=True)
class Net:
    """A detector `--net`: the backbone `models.build_detector` takes, the
    net's recipe (overrides that `build_config` applies after `--ls`) and
    the global-norm clip of its SGD (None: unclipped)."""

    backbone: str
    recipe: dict = field(default_factory=dict)
    clip_norm: float | None = None


# Every detector `--net` of the entry points (trainval_net, test_net, serve,
# demo, export_model). VGG-16 clips at 10 as the JAX trainer does; `tiny` is
# the test backbone. `res101_fpn` is the FPN detector (models/fpn.py) with
# Detectron2's COCO-Detection/faster_rcnn_R_101_FPN_3x recipe: its RPN top-N
# are a level's before NMS and an image's after it; 512 rois an image;
# weight decay on the biases too.
NETS = {
    "vgg16": Net("vgg16", clip_norm=10.0),
    "res50": Net("resnet50"),
    "res101": Net("resnet101"),
    "res152": Net("resnet152"),
    "res101_fpn": Net("resnet101_fpn", {
        "TRAIN": {"RPN_PRE_NMS_TOP_N": 2000, "RPN_POST_NMS_TOP_N": 1000, "BATCH_SIZE": 512,
                  "BG_THRESH_LO": 0.0, "WEIGHT_DECAY": 0.0001, "DOUBLE_BIAS": False,
                  "BIAS_DECAY": True, "LEARNING_RATE": 0.02, "SCALES": (800,),
                  "MAX_SIZE": 1333},
        "TEST": {"RPN_PRE_NMS_TOP_N": 1000, "RPN_POST_NMS_TOP_N": 1000, "NMS": 0.5,
                 "SCALES": (800,), "MAX_SIZE": 1333},
    }),
    "tiny": Net("tiny"),
}


def net_of_backbone(backbone: str) -> Net:
    """The `NETS` entry that builds `backbone` (KeyError for none)."""
    return {n.backbone: n for n in NETS.values()}[backbone]


def build_config(dataset: str | None = None, set_cfgs=None, *, large_scale: bool = False,
                 cfg_file: str | None = None, pooling_mode: str | None = None,
                 net: str | None = None) -> Config:
    """The config of every entry point: Config() with the fused stem and
    layer1 kernels on, then in the JAX trainer's order the dataset's
    overrides (none for a name without any, such as an imdb name), `--ls`,
    the `--net`'s recipe (`NETS`), `--cfg`, `--set` and `--pooling_mode`.
    Layer1's kernel stays on only with the stem's and where
    RESNET.FIXED_BLOCKS >= 1: it reads the stem kernel's output and is
    forward-only. VGG-16 reads CONV1_FUSED (its block-1 kernel) and ignores
    LAYER1_FUSED."""
    cfg = Config(CONV1_FUSED=True, LAYER1_FUSED=True)
    if dataset in DATASET_OVERRIDES:
        cfg = cfg_update(cfg, DATASET_OVERRIDES[dataset])
    if large_scale:
        cfg = cfg_update(cfg, LS_OVERRIDES)
    if net is not None:
        cfg = cfg_update(cfg, NETS[net].recipe)
    if cfg_file:
        cfg = cfg_from_file(cfg, cfg_file)
    if set_cfgs:
        cfg = cfg_from_list(cfg, set_cfgs)
    if pooling_mode:
        cfg = cfg_update(cfg, {"POOLING_MODE": pooling_mode})
    if cfg.LAYER1_FUSED and not (cfg.CONV1_FUSED and cfg.RESNET.FIXED_BLOCKS >= 1):
        cfg = cfg_update(cfg, {"LAYER1_FUSED": False})
    return cfg


def checkpoint_config(cfg: Config, payload: dict | None,
                      class_agnostic: bool) -> tuple[Config, bool]:
    """A `trainval_net` checkpoint's settings over an entry point's config
    and its `--cag`: (cfg with the payload's POOLING_MODE, the
    class_agnostic to build the detector with: `--cag` or the payload's).
    Without a payload, both as given."""
    if payload is None:
        return cfg, class_agnostic
    if payload.get("pooling_mode"):
        cfg = cfg_update(cfg, {"POOLING_MODE": payload["pooling_mode"]})
    return cfg, class_agnostic or bool(payload.get("class_agnostic"))


@dataclass(frozen=True)
class RLConfig:
    """RL refinement workload config (/root/reference/config.py)."""

    pretrained_model: str = "data/RL_model_dump/pretrained/faster_rcnn_new.pth"
    save_dir: str = "data/RL_model_dump/RL_tpu/"

    train_img_short: Tuple[int, ...] = (800,)
    train_img_size: int = 1200
    train_flip: bool = False
    train_max_epoch: int = 15
    train_lr_decay: Tuple[int, ...] = (8, 12)
    train_data_dir: str = "data/coco/images/train2014"
    train_ann_file: str = "data/coco/annotations/instances_train2014.json"
    train_dt_file: str = "data/output/detections_train2014_results.json"

    # RGB normalize (config.py:23-24)
    normalize_mean: Tuple[float, ...] = (0.4485295, 0.4249905, 0.39198247)
    normalize_std: Tuple[float, ...] = (0.12032582, 0.12394787, 0.14252729)

    test_img_short: Tuple[int, ...] = (800,)
    test_img_size: int = 1200
    test_flip: bool = False
    test_data_dir: str = "data/coco/images/val2014"
    test_ann_file: str = "data/coco/annotations/instances_minival2014.json"
    test_dt_file: str = "data/output/detections_minival2014_results.json"

    momentum: float = 0.9
    weight_decay: float = 0.0001
    learning_rate: float = 0.01

    num_workers: int = 6
    data_shuffle: bool = True

    act_delta: Tuple[float, ...] = (0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625, 0.008)
    act_iou_thres: float = 0.0

    phase: str = "train"

    @property
    def data_dir(self):
        return self.train_data_dir if self.phase == "train" else self.test_data_dir

    @property
    def ann_file(self):
        return self.train_ann_file if self.phase == "train" else self.test_ann_file

    @property
    def dt_file(self):
        return self.train_dt_file if self.phase == "train" else self.test_dt_file

    @staticmethod
    def act_wtrans(x):
        """exp(|x|) ΔIoU weight transform (config.py:48-51)."""
        import numpy as np

        return np.exp(np.abs(x))
