"""The one table of detector `--net` names (`config.NETS`) and the config
builders beside it, through the entry points on the CPU:

- every detector CLI offers exactly the table's names;
- `demo` and `export_model` with `--net res101_fpn` build the FPN detector
  with the net's recipe (Detectron2's 1000/1000 RPN top-N, NMS 0.5, scale
  800, max 1333), not C4's test values;
- a checkpoint written with `--cag` restores into the detector that
  `checkpoint_config` builds without `--cag`, in the checkpoint's pooling
  mode.
"""

import argparse
import dataclasses
import importlib

import pytest

from rlobjectdetection_tpu_torch import models
from rlobjectdetection_tpu_torch.config import NETS, build_config, checkpoint_config
from rlobjectdetection_tpu_torch.engine import build_optimizer
from rlobjectdetection_tpu_torch.engine.checkpoint import (checkpoint_path, load_checkpoint,
                                                           read_checkpoint, save_checkpoint)
import torch_threads  # noqa: F401  (xdist workers share the cores)

CLIS = ("trainval_net", "test_net", "serve", "demo", "export_model")
SET = ["DTYPE", "float32", "NMS_TILE", "64"]


def _cli(name: str):
    return importlib.import_module(f"rlobjectdetection_tpu_torch.engine.{name}")


def _parse(name: str):
    """The function of CLI `name` that parses its argv."""
    mod = _cli(name)
    return mod.main if name == "serve" else mod.parse_args


class _Parsed(Exception):
    pass


def test_every_detector_cli_offers_the_table(monkeypatch):
    def grab(parser, *args, **kwargs):
        raise _Parsed(parser)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    for name in CLIS:
        with pytest.raises(_Parsed) as e:
            _parse(name)([])
        assert list(e.value.args[0]._option_string_actions["--net"].choices) == sorted(NETS), \
            name


class _Built(Exception):
    pass


@pytest.mark.parametrize("cli", ["demo", "export_model"])
def test_fpn_net_builds_its_recipe(cli, monkeypatch, tmp_path):
    """Stopped at `build_detector`: the backbone and config it was given."""
    got = {}

    def record(num_classes, backbone, cfg, **kw):
        got.update(backbone=backbone, cfg=cfg)
        raise _Built

    mod = _cli(cli)
    monkeypatch.setattr(models, "build_detector", record)
    if hasattr(mod, "build_detector"):
        monkeypatch.setattr(mod, "build_detector", record)
    where = ["--image_dir", str(tmp_path)] if cli == "demo" else ["--out", str(tmp_path / "m.pt2")]
    with pytest.raises(_Built):
        mod.main(["--net", "res101_fpn", "--device", "cpu", *where, "--set", *SET])
    want = build_config(None, SET, net="res101_fpn")
    assert got["backbone"] == "resnet101_fpn"
    assert got["cfg"] == want
    t = want.TEST
    assert (t.RPN_PRE_NMS_TOP_N, t.RPN_POST_NMS_TOP_N, t.NMS, t.SCALES, t.MAX_SIZE) == (
        1000, 1000, 0.5, (800,), 1333)


def test_cag_checkpoint_builds_a_class_agnostic_detector(tmp_path):
    """The strict load would raise on the 4·C-wide box regressor that the
    flag alone would build."""
    cfg = build_config(None, SET, net="tiny")
    trained = models.build_detector(4, "tiny", cfg, class_agnostic=True, device="cpu")
    opt, sched, _ = build_optimizer(trained, "tiny", 0.01)
    path = checkpoint_path(str(tmp_path), "tiny", "pascal_voc", 1, 1)
    save_checkpoint(path, trained, opt, sched, pooling_mode="crop", class_agnostic=True)

    assert checkpoint_config(cfg, None, False) == (cfg, False)
    payload = read_checkpoint(path)
    got, class_agnostic = checkpoint_config(cfg, payload, False)
    assert class_agnostic and got == dataclasses.replace(cfg, POOLING_MODE="crop")
    model = models.build_detector(4, NETS["tiny"].backbone, got, class_agnostic=class_agnostic,
                                  device="cpu")
    load_checkpoint(payload, model)
    assert model.RCNN_bbox_pred.out_features == 4
