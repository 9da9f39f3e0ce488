"""The port's model, weight bridge and post-processing against the JAX
package, on the CPU in f32 (the kernels' plain versions run there).

One JAX `FasterRCNN("resnet50", 21 classes)` is built per module, its frozen
BN statistics moved away from the identity so the folds matter, and its
params carried into the port through `state_dict_from_jax`. Both then see
the same numpy inputs. Tolerances: max |port - jax| / max |jax| <= 1e-4 for
dense results (same f32 formulas, different summation order in the convs).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from rlobjectdetection_tpu.config import Config as JaxConfig
from rlobjectdetection_tpu.config import TestConfig as JaxTestConfig
from rlobjectdetection_tpu.engine.detect import detections_to_all_boxes as jax_all_boxes
from rlobjectdetection_tpu.engine.detect import postprocess_detections as jax_postprocess
from rlobjectdetection_tpu.models import FasterRCNN as JaxFasterRCNN
from rlobjectdetection_tpu.models.backbones.resnet import ResNetBase as JaxResNetBase
from rlobjectdetection_tpu_torch.config import Config
from rlobjectdetection_tpu_torch.config import TestConfig as PortTestConfig
from rlobjectdetection_tpu_torch.engine.checkpoint import load_net_npz, state_dict_from_jax
from rlobjectdetection_tpu_torch.engine.detect import (detections_to_all_boxes,
                                                      postprocess_detections)
from rlobjectdetection_tpu_torch.models import FasterRCNN
from rlobjectdetection_tpu_torch.models.backbones.resnet import ResNetBase

REL = 1e-4
NUM_CLASSES = 21
TEST_KW = dict(RPN_PRE_NMS_TOP_N=256, RPN_POST_NMS_TOP_N=32, MAX_DETS_PER_IMAGE=20)
CFG_KW = dict(DTYPE="float32", NMS_TILE=64, ANCHOR_SCALES=(4, 8, 16, 32))


def max_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _perturbed(params, rng):
    """Flat params with frozen-BN statistics away from the identity, and the
    RPN outputs scaled to what a trained net gives: the random backbone's
    features are large, so unscaled class logits saturate the sigmoid
    (exact ties at 1.0) and unscaled deltas reach exp(15)."""
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[1]
        if "bn" in k and leaf in ("scale", "var"):
            flat[k] = (0.7 + 0.3 * rng.rand(*v.shape)).astype(np.float32)
        elif "bn" in k and leaf in ("bias", "mean"):
            flat[k] = (0.05 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "rpn/RPN_cls_score/kernel":
            flat[k] = (v * 0.3).astype(np.float32)
        elif k == "rpn/RPN_bbox_pred/kernel":
            flat[k] = (v * 0.02).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, flat params) sharing weights."""
    jcfg = JaxConfig(TEST=JaxTestConfig(**TEST_KW), **CFG_KW)
    jmodel = JaxFasterRCNN(num_classes=NUM_CLASSES, backbone="resnet50", cfg=jcfg)
    x = jnp.zeros((1, 96, 128, 3), jnp.float32)
    info = jnp.asarray([[96.0, 128.0, 1.0]])
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(0)}, x, info, train=False)
    flat = _perturbed(variables["params"], np.random.RandomState(7))
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                                          sep="/")
    cfg = Config(TEST=PortTestConfig(**TEST_KW), **CFG_KW, CONV1_FUSED=True, LAYER1_FUSED=True)
    model = FasterRCNN(NUM_CLASSES, "resnet50", cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(flat, model))
    return jmodel, params, model, flat


@pytest.fixture(scope="module")
def jax_forward(models):
    """The JAX eval forward at 96×128 (B=2) with its base and RPN outputs."""
    jmodel, params, _, _ = models
    rng = np.random.RandomState(11)
    data = (rng.randn(2, 96, 128, 3) * 40).astype(np.float32)
    info = np.asarray([[96.0, 128.0, 1.0], [90.0, 120.0, 1.0]], np.float32)

    @jax.jit
    def run(p, d, i):
        return jmodel.apply({"params": p}, d, i, train=False,
                            capture_intermediates=True, mutable=["intermediates"])

    out, state = run(params, jnp.asarray(data), jnp.asarray(info))
    inter = state["intermediates"]
    base_feat = inter["base"]["__call__"][0]
    rpn_cls, rpn_delta = inter["rpn"]["__call__"][0]
    return data, info, jax.device_get(out), jax.device_get(
        dict(base_feat=base_feat, rpn_cls=rpn_cls, rpn_delta=rpn_delta))


def test_state_dict_from_jax_round_trips_every_key(models):
    _, _, model, flat = models
    sd = model.state_dict()
    assert len(sd) == len(flat)
    for key, arr in flat.items():
        t = sd[key.replace("/kernel", "/weight").replace("/", ".")].numpy()
        back = {4: lambda a: a.transpose(2, 3, 1, 0), 2: lambda a: a.T}.get(
            t.ndim, lambda a: a)(t)
        np.testing.assert_array_equal(back, arr, err_msg=key)


def test_state_dict_from_jax_raises_on_missing_or_extra_key(models):
    _, _, model, flat = models
    missing = dict(flat)
    missing.pop("head/layer4/block0/bn3/var")
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax(missing, model)
    extra = dict(flat, **{"rpn/RPN_Extra/kernel": np.zeros((1, 1, 2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        state_dict_from_jax(extra, model)


def test_load_net_npz_reads_a_save_net_npz_dump(models, tmp_path):
    from rlobjectdetection_tpu.engine.checkpoint import save_net_npz

    _, params, model, _ = models
    path = str(tmp_path / "net.npz")
    save_net_npz(path, params)
    cfg = Config(TEST=PortTestConfig(**TEST_KW), **CFG_KW)
    fresh = load_net_npz(path, FasterRCNN(NUM_CLASSES, "resnet50", cfg, device="cpu",
                                          seed=99))
    for (k, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), k


def test_resnet_base_fused_matches_jax(models):
    """The port's ResNetBase with the fused flags (the stem and layer1
    kernels' plain versions on the CPU) against the JAX ResNetBase with the
    Pallas kernels off, f32, 64×96."""
    _, params, model, _ = models
    x = (np.random.RandomState(5).randn(2, 64, 96, 3) * 40).astype(np.float32)
    want = jax.jit(JaxResNetBase(num_layers=50, dtype=jnp.float32).apply)(
        {"params": params["base"]}, jnp.asarray(x))
    base = ResNetBase(50, torch.float32, conv1_fused=True, layer1_fused=True)
    base.load_state_dict(model.base.state_dict())
    with torch.no_grad():
        got = base(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 4, 6, 1024)
    assert max_rel(got.numpy(), want) < REL


def test_faster_rcnn_eval_matches_jax(models, jax_forward):
    _, _, model, _ = models
    data, info, jout, jinter = jax_forward
    with torch.no_grad():
        base_feat = model.base(torch.from_numpy(data))
        rpn_cls, rpn_delta = model.rpn(base_feat)
        out = model(torch.from_numpy(data), torch.from_numpy(info))
        # the head fed the JAX rois: same pooling, layer4 and classifiers
        jrois = torch.from_numpy(np.array(jout["rois"]))
        cls_prob, bbox_pred = model.detect_head(base_feat, jrois)
    assert tuple(base_feat.shape) == (2, 6, 8, 1024)
    assert max_rel(base_feat.numpy(), jinter["base_feat"]) < REL
    assert max_rel(rpn_cls.numpy(), jinter["rpn_cls"]) < REL
    assert max_rel(rpn_delta.numpy(), jinter["rpn_delta"]) < REL
    assert max_rel(cls_prob.numpy(), jout["cls_prob"]) < REL
    assert max_rel(bbox_pred.numpy(), jout["bbox_pred"]) < REL
    assert set(out) == {"rois", "roi_valid", "cls_prob", "bbox_pred"}
    # End to end, the proposals come out of top-k and NMS on scores that
    # differ from the JAX ones in the last f32 bits. Two proposals whose
    # scores are that close may swap places, and a swap can flip which of
    # an overlapping pair survives, so one row in 50 may differ.
    rois, want = out["rois"].numpy(), np.asarray(jout["rois"])
    assert rois.shape == want.shape == (2, 32, 5)
    rows_equal = (np.abs(rois - want) <= 1e-3).all(-1)
    assert rows_equal.mean() >= 0.98, rows_equal.mean()
    np.testing.assert_array_equal(out["roi_valid"].numpy(), np.asarray(jout["roi_valid"]))


@pytest.mark.parametrize("agnostic,max_per_image", [(False, 20), (True, 20), (False, 200)])
def test_postprocess_detections_matches_jax(agnostic, max_per_image):
    """Exact classes and validity, 1e-4 on boxes and scores; at 200 per
    image fewer detections survive than there are slots (the -1 sentinel)."""
    rng = np.random.RandomState(21 + agnostic)
    r, c = 64, 6
    xy = rng.rand(r, 2) * 150
    rois = np.concatenate([np.zeros((r, 1)), xy, xy + rng.rand(r, 2) * 80 + 4], 1)
    rois = rois.astype(np.float32)
    logits = rng.randn(r, c).astype(np.float32) * 2
    cls_prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cls_prob[:5] = cls_prob[5]                        # ties across rois
    bbox_pred = (rng.randn(r, 4 if agnostic else 4 * c) * 0.3).astype(np.float32)
    im_info = np.asarray([180.0, 210.0, 1.6], np.float32)
    roi_valid = rng.rand(r) > 0.1
    kw = dict(num_classes=c, class_agnostic=agnostic, max_per_image=max_per_image,
              nms_thresh=0.3)
    want = jax_postprocess(*(jnp.asarray(a) for a in
                             (rois, cls_prob, bbox_pred, im_info, roi_valid)), **kw)
    got = postprocess_detections(*(torch.from_numpy(a) for a in
                                   (rois, cls_prob, bbox_pred, im_info, roi_valid)), **kw)
    (gb, gs, gc, gv), (wb, ws, wc, wv) = got, [np.asarray(a) for a in want]
    np.testing.assert_array_equal(gc.numpy(), wc)
    np.testing.assert_array_equal(gv.numpy(), wv)
    assert gc.dtype == torch.int32 and 0 < int(gv.sum()) <= max_per_image
    assert max_per_image == 20 or not gv.numpy().all()
    np.testing.assert_allclose(gb.numpy(), wb, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-4, atol=1e-4)
    got_all = detections_to_all_boxes([tuple(t.numpy() for t in got)], c)
    want_all = jax_all_boxes([want], c)
    for j in range(c):
        np.testing.assert_allclose(got_all[j][0], want_all[j][0], rtol=1e-4, atol=1e-4)


def test_detector_serves_on_the_cpu(models):
    from rlobjectdetection_tpu_torch.engine.serve import Detector

    _, _, model, _ = models
    im = np.random.RandomState(4).randint(0, 256, (70, 90, 3)).astype(np.float32)
    cfg = dataclasses.replace(model.cfg, TEST=dataclasses.replace(model.cfg.TEST,
                                                                  SCALES=(96,)))
    boxes, scores, classes, valid = Detector(model, cfg, "cpu").detect(im)
    assert boxes.shape == (20, 4) and scores.shape == classes.shape == valid.shape == (20,)
    assert np.isfinite(boxes).all() and np.isfinite(scores).all()
    assert (boxes[valid] >= 0).all() and (boxes[valid][:, 2] <= 89).all()


def test_port_imports_no_jax():
    """Importing the whole port leaves JAX and the JAX package unloaded."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import rlobjectdetection_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'flax',"
        " 'optax', 'rlobjectdetection_tpu.')) or k == 'rlobjectdetection_tpu')\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    repo = os.path.join(os.path.dirname(__file__), "..")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    from rlobjectdetection_tpu_torch.engine.serve import Detector, main
    from rlobjectdetection_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FasterRCNN(NUM_CLASSES, "resnet50", Config(DTYPE="float32"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector(torch.nn.Identity(), Config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--image_dir", os.path.dirname(__file__), "--net", "res50"])


def test_resnet_train_forward_returns_the_four_losses(models, jax_forward):
    """The ResNet train forward (sampling from a torch.Generator): four
    finite scalar losses, a gradient to the trainable parameters only, and
    the sampled rois with their labels; the eval forward takes no gradient."""
    _, _, model, _ = models
    data, info, _, _ = jax_forward
    gt = torch.zeros(2, 5, 5)
    gt[:, :2] = torch.tensor([[10.0, 12.0, 60.0, 70.0, 3.0], [40.0, 20.0, 100.0, 80.0, 7.0]])
    out = model(torch.from_numpy(data), torch.from_numpy(info), gt, train=True,
                generator=torch.Generator().manual_seed(0))
    names = ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls", "rcnn_loss_bbox")
    for k in names:
        assert out[k].shape == () and bool(torch.isfinite(out[k])) and out[k].requires_grad, k
    r = model.cfg.TRAIN.BATCH_SIZE
    assert tuple(out["rois"].shape) == (2, r, 5) and tuple(out["rois_label"].shape) == (2, r)
    assert tuple(out["bbox_pred"].shape) == (2, r, 4) and out["rois_label"].max() > 0
    sum(out[k] for k in names).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads["RCNN_cls_score.weight"] is not None
    assert grads["base.layer2.block0.conv1.weight"] is not None
    assert grads["base.conv1.weight"] is None and grads["base.layer1.block0.conv1.weight"] is None
    model.zero_grad(set_to_none=True)
    assert not model(torch.from_numpy(data), torch.from_numpy(info))["cls_prob"].requires_grad


def test_unported_modes_raise_with_a_roadmap_pointer(models):
    # VGG-16 serves but does not train yet (a small pooled size keeps fc6
    # small)
    vgg = FasterRCNN(NUM_CLASSES, "vgg16", Config(DTYPE="float32", POOLING_SIZE=2),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vgg(torch.zeros(1, 64, 64, 3), torch.tensor([[64.0, 64.0, 1.0]]), train=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FasterRCNN(NUM_CLASSES, "resnet50", Config(POOLING_MODE="crop"), device="cpu")
