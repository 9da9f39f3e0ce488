"""The port's serving export (`engine/export_model.py`), the counterparts of
`tests/test_export.py`, on the CPU in f32 (the kernels' plain versions run
as the `rlod::` ops' CPU implementations there):

- an artifact's replay, from the file alone, equal to the live serving
  function to the bit: `tiny`, and ResNet-50 with the stem, layer1 and
  residual-stage kernels (their ops and pinned operands in the artifact);
- a `--batch 2` artifact equal to its live function to the bit, and to
  the one-image artifact image by image within `tests/test_export.py`'s
  1e-5 (oneDNN convolves a batch of two in another order than one image);
- the port's artifact against the JAX package's `jax.export` artifact on
  the same weights and blob: classes and validity equal, boxes and scores
  within 1e-4 of the largest (`tests/test_torch_model.py`'s eval bound);
- the `.pt2` file loaded and run in a fresh process that imports
  `rlobjectdetection_tpu_torch.ops.library` and no model code.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax import export as jexport

from rlobjectdetection_tpu.config import Config as JaxConfig
from rlobjectdetection_tpu.config import TestConfig as JaxTestConfig
from rlobjectdetection_tpu.models import FasterRCNN as JaxFasterRCNN
from rlobjectdetection_tpu_torch.config import Config, TestConfig
from rlobjectdetection_tpu_torch.engine import export_model
from rlobjectdetection_tpu_torch.engine.checkpoint import state_dict_from_jax
from rlobjectdetection_tpu_torch.models import FasterRCNN
from tools.export_model import build_serving_fn as jax_build_serving_fn
import torch_threads  # noqa: F401  (xdist workers share the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, CLASSES, MAX_DETS = 64, 96, 4, 10
CFG_KW = dict(DTYPE="float32", ANCHOR_SCALES=(2, 3, 5), NMS_TILE=64)
TEST_KW = dict(RPN_PRE_NMS_TOP_N=128, RPN_POST_NMS_TOP_N=32)
REL = 1e-4


def _cfg(**kw):
    return Config(TEST=TestConfig(**TEST_KW), **CFG_KW, **kw)


def _serving(backbone="tiny", batch=1, state=None, **cfg_kw):
    cfg = _cfg(**cfg_kw)
    model = FasterRCNN(CLASSES, backbone, cfg, device="cpu", seed=3)
    if state is not None:
        model.load_state_dict(state)
    return export_model.build_serving_fn(model, max_per_image=MAX_DETS, nms_thresh=cfg.TEST.NMS,
                                         batch=batch, cfg=cfg)


def _frame(batch=1):
    return export_model.synthetic_frame(batch, H, W, "cpu")


def _export(serving, batch, path):
    info = export_model.export_serving(serving, _frame(batch), str(path))
    assert info["bytes"] > 0
    return torch.export.load(str(path)).module()


def _assert_equal(got, want):
    for k in export_model.OUTPUT_KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("backbone,cfg_kw,ops", [
    ("tiny", {}, {"roi_align_avg", "nms_sorted_mask"}),
    ("resnet50", dict(CONV1_FUSED=True, LAYER1_FUSED=True, STAGE_FUSED=23),
     {"stem", "layer1", "res_stage", "roi_align_avg", "nms_sorted_mask", "frozen_bn_act"}),
])
def test_replay_equals_the_live_serving_function(backbone, cfg_kw, ops, tmp_path):
    serving = _serving(backbone, **cfg_kw)
    path = tmp_path / "m.pt2"
    replay = _export(serving, 1, path)
    data, info = _frame()
    with torch.no_grad():
        live = serving(data, info)
        _assert_equal(replay(data, info), live)
    assert tuple(live["boxes"].shape) == (MAX_DETS, 4) and bool(live["valid"].any())
    program = torch.export.load(str(path))
    used = {str(n.target).split(".")[1] for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("rlod.")}
    assert used == ops
    # the kernels' operands are pinned in the artifact, not packed by the replay
    assert not any("pack" in str(n.target) for n in program.graph.nodes)


def test_batched_artifact_equals_the_one_image_artifact(tmp_path):
    one = _export(_serving(), 1, tmp_path / "one.pt2")
    serving = _serving(batch=2)
    two = _export(serving, 2, tmp_path / "two.pt2")
    data, info = _frame(2)
    with torch.no_grad():
        batched = two(data, info)
        _assert_equal(batched, serving(data, info))
        for i in range(2):
            want = one(data[i:i + 1], info[i:i + 1])
            for k in ("classes", "valid"):
                assert torch.equal(batched[k][i], want[k]), (k, i)
            for k in ("boxes", "scores"):
                torch.testing.assert_close(batched[k][i], want[k], rtol=1e-5, atol=1e-5)


def test_artifact_matches_the_jax_artifact(tmp_path):
    cfg = JaxConfig(TEST=JaxTestConfig(**TEST_KW), **CFG_KW)
    jmodel = JaxFasterRCNN(num_classes=CLASSES, backbone="tiny", cfg=cfg)
    key = jax.random.PRNGKey(3)
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": key, "sampling": key, "dropout": key}, jnp.zeros((1, H, W, 3), jnp.float32),
        jnp.asarray([[float(H), float(W), 1.0]]), train=False)["params"]
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}
    # trained-like RPN outputs: the random net's logits saturate and tie
    flat["rpn/RPN_cls_score/kernel"] = flat["rpn/RPN_cls_score/kernel"] * 0.3
    flat["rpn/RPN_bbox_pred/kernel"] = flat["rpn/RPN_bbox_pred/kernel"] * 0.02
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    serve = jax_build_serving_fn(jmodel, params, CLASSES, False, MAX_DETS, cfg.TEST.NMS)
    exported = jexport.export(serve)(jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32),
                                     jax.ShapeDtypeStruct((1, 3), jnp.float32))
    restored = jexport.deserialize(bytearray(exported.serialize()))

    model = FasterRCNN(CLASSES, "tiny", _cfg(), device="cpu")
    replay = _export(_serving(state=state_dict_from_jax(flat, model)), 1, tmp_path / "m.pt2")
    data, info = _frame()
    want = {k: np.asarray(v) for k, v in
            restored.call(jnp.asarray(data.numpy()), jnp.asarray(info.numpy())).items()}
    with torch.no_grad():
        got = {k: v.numpy() for k, v in replay(data, info).items()}
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].any()
    for k in ("boxes", "scores"):
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= REL, (k, err)


def test_artifact_runs_in_a_fresh_process_without_model_code(tmp_path):
    serving = _serving()
    path = tmp_path / "m.pt2"
    _export(serving, 1, path)
    with torch.no_grad():
        live = serving(*_frame())
    torch.save(live, tmp_path / "live.pt")
    code = (
        "import sys, torch\n"
        "from rlobjectdetection_tpu_torch.engine.export_model import replay_artifact\n"
        f"out = replay_artifact({str(path)!r}, {H}, {W}, device='cpu')\n"
        f"live = torch.load({str(tmp_path / 'live.pt')!r})\n"
        "assert all((out[k] == live[k].numpy()).all() for k in live), 'outputs differ'\n"
        "models = [m for m in sys.modules if m.startswith('rlobjectdetection_tpu_torch.models')]\n"
        "assert not models, models\n"
        "print('fresh replay ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and "fresh replay ok" in out.stdout, out.stdout + out.stderr
