"""The port's RL refinement net, its steps and data against the JAX package,
on the CPU in f32 (the kernels' plain versions run there).

One JAX `RLPolicyNet(56 actions, resnet50)` is built per module, its frozen
BN statistics moved away from the identity, dumped with `save_net_npz` and
loaded into the port's net (stem, layer1 and both stage kernels on, so their
plain versions run) with `load_net_npz`. Both then see the same numpy batch:
2 images of 64×64 with 11 and 7 boxes, padded to 16 by the collate.
Tolerances: max |port - jax| / max |jax| <= 1e-4 for dense results (same f32
formulas, other summation orders in the convs and GEMMs)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from rlobjectdetection_tpu.config import RLConfig as JaxRLConfig
from rlobjectdetection_tpu.engine.checkpoint import save_net_npz
from rlobjectdetection_tpu.models.losses import weighted_mse_loss as jax_weighted_mse_loss
from rlobjectdetection_tpu.models.rl import Action as JaxAction
from rlobjectdetection_tpu.models.rl import RLPolicyNet as JaxRLPolicyNet
from rlobjectdetection_tpu.models.rl import warm_start_from_detector as jax_warm_start
from rlobjectdetection_tpu_torch.config import Config, RLConfig
from rlobjectdetection_tpu_torch.data.rl_coco import collate, normalize_image
from rlobjectdetection_tpu_torch.engine.checkpoint import load_net_npz, state_dict_from_jax
from rlobjectdetection_tpu_torch.engine.rl import (Refiner, make_rl_optimizer, rl_eval_step,
                                                   rl_train_step)
from rlobjectdetection_tpu_torch.models import FasterRCNN
from rlobjectdetection_tpu_torch.models.backbones import resnet as port_resnet
from rlobjectdetection_tpu_torch.models.losses import weighted_mse_loss
from rlobjectdetection_tpu_torch.models.rl import Action, RLPolicyNet, warm_start_from_detector
from rlobjectdetection_tpu_torch.ops import res_stage_kernel
import torch_threads  # noqa: F401  (xdist workers share the cores)

REL = 1e-4
# Momentum buffers hold gradients, which sum layer4's 32 rois x 49 positions
# through ReLU gates: a pre-activation within rounding of 0 may open on one
# side and not the other, and moves that sum by one term. Measured up to
# 9.3e-4 (layer4 block2 bn3 bias); the bound is 2e-3.
GRAD_REL = 2e-3
A = 56


def max_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _samples(rng, sizes=((64, 64), (52, 60)), counts=(11, 7), scale=1.5):
    """(image, bboxes [n, 7], labels [n, A, 3], im_info) as the JAX dataset
    yields them after its resize: normalised RGB, xyxy boxes inside the image."""
    cfg = RLConfig()
    out = []
    for i, ((h, w), n) in enumerate(zip(sizes, counts)):
        img = normalize_image(rng.randint(0, 256, (h, w, 3)), cfg.normalize_mean,
                              cfg.normalize_std)
        xy = rng.rand(n, 2) * [w * 0.5, h * 0.5]
        wh = rng.rand(n, 2) * [w * 0.4, h * 0.4] + 6
        boxes = np.concatenate([xy, xy + wh, np.full((n, 1), 0.9),
                                rng.randint(1, 4, (n, 1)), np.full((n, 1), 100 + i)], 1)
        labels = np.stack(np.broadcast_arrays(
            np.arange(A)[None, :], rng.choice([-1.0, 1.0], (n, A)), rng.rand(n, A) + 0.5), -1)
        out.append((img, boxes.astype(np.float32), labels.astype(np.float32),
                    [h, w, scale, round(h / scale), round(w / scale), f"im{i}.jpg"]))
    return out


def _flat_params(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


@pytest.fixture(scope="module")
def rl(tmp_path_factory):
    """(jax net, jax params, port net, flat params, batch)."""
    batch = collate(_samples(np.random.RandomState(0)), A)
    jnet = JaxRLPolicyNet(num_acts=A, num_layers=50)
    params = jax.jit(jnet.init)(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(batch["data"]),
        jnp.asarray(batch["bboxes"]), jnp.asarray(batch["labels"][..., 1]),
        jnp.asarray(batch["labels"][..., 2]))["params"]
    rng = np.random.RandomState(7)
    flat = _flat_params(params)
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[1]
        if "bn" in k and leaf in ("scale", "var"):
            flat[k] = (0.7 + 0.3 * rng.rand(*v.shape)).astype(np.float32)
        elif "bn" in k and leaf in ("bias", "mean"):
            flat[k] = (0.05 * rng.randn(*v.shape)).astype(np.float32)
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    path = str(tmp_path_factory.mktemp("rl") / "rl.npz")
    save_net_npz(path, params)
    model = RLPolicyNet(A, 50, torch.float32, conv1_fused=True, layer1_fused=True,
                        stages_fused=23, device="cpu", seed=99)
    load_net_npz(path, model)
    return jnet, params, model, flat, batch


def _jax_inputs(batch):
    return (jnp.asarray(batch["data"]), jnp.asarray(batch["bboxes"]),
            jnp.asarray(batch["labels"][..., 1]), jnp.asarray(batch["labels"][..., 2]),
            jnp.asarray(batch["num_dts"]))


def _port_inputs(batch):
    return (torch.from_numpy(batch["data"]), torch.from_numpy(batch["bboxes"]),
            torch.from_numpy(np.ascontiguousarray(batch["labels"][..., 1])),
            torch.from_numpy(np.ascontiguousarray(batch["labels"][..., 2])),
            torch.from_numpy(batch["num_dts"]))


def test_load_net_npz_reads_an_rl_dump(rl):
    """Every key exactly, dense kernels transposed, layer4's BN affine as
    trainable parameters and its statistics as buffers, the trunk frozen."""
    _, _, model, flat, _ = rl
    sd = model.state_dict()
    assert len(sd) == len(flat)
    np.testing.assert_array_equal(sd["fc8.weight"].numpy(), flat["fc8/kernel"].T)
    np.testing.assert_array_equal(sd["fc.bias"].numpy(), flat["fc/bias"])
    bn = model.head.layer4.block1.bn2
    assert isinstance(bn.scale, torch.nn.Parameter) and bn.scale.requires_grad
    assert isinstance(bn.bias, torch.nn.Parameter) and "mean" in dict(bn.named_buffers())
    np.testing.assert_array_equal(bn.var.numpy(), flat["head/layer4/block1/bn2/var"])
    assert not any(p.requires_grad for p in model.base.parameters())
    missing = {k: v for k, v in flat.items() if k != "fc/bias"}
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax(missing, model)


@pytest.mark.parametrize("with_num_dts", [True, False])
def test_rl_policy_net_matches_jax(rl, with_num_dts):
    jnet, params, model, _, batch = rl
    jin, pin = list(_jax_inputs(batch)), list(_port_inputs(batch))
    if not with_num_dts:
        jin, pin = jin[:4], pin[:4]
    pred, loss, noweight = jax.jit(jnet.apply)({"params": params}, *jin)
    with torch.no_grad():
        got = model(*pin)
    assert tuple(got[0].shape) == pred.shape == (2 * 16, A)
    assert max_rel(got[0].numpy(), pred) < REL
    np.testing.assert_allclose(float(got[1]), float(loss), rtol=REL)
    np.testing.assert_allclose(float(got[2]), float(noweight), rtol=REL)
    # without targets only the action values come back
    with torch.no_grad():
        pred_only, zero, _ = model(*pin[:2])
    assert float(zero) == 0.0 and torch.equal(pred_only, got[0])


def _optax_chain(params, cfg, steps_per_epoch):
    """The optimizer of tools/trainval_rl.py:137-173, rebuilt here."""
    def lab(path, _):
        keys = tuple(p.key for p in path)
        if keys[0] == "base" or keys[-1] in ("mean", "var"):
            return "frozen"
        return "bias" if keys[-1] == "bias" else "weight"

    def lr_sched(count):
        epoch = count // steps_per_epoch
        mult = 1.0
        for e in cfg.train_lr_decay:
            mult = jnp.where(epoch >= e, mult * 0.1, mult)
        return cfg.learning_rate * mult

    def sgd(lr_mult, wd):
        return optax.chain(optax.add_decayed_weights(wd), optax.trace(decay=cfg.momentum),
                           optax.scale_by_schedule(lambda c: -lr_sched(c) * lr_mult))

    tx = optax.multi_transform(
        {"weight": sgd(1.0, cfg.weight_decay), "bias": sgd(2.0, 0.0),
         "frozen": optax.set_to_zero()},
        jax.tree_util.tree_map_with_path(lab, params))
    return tx, lr_sched


def _momentum(opt_state):
    """{param path: trace} over the weight and bias groups."""
    out = {}
    for group in ("weight", "bias"):
        trace = opt_state.inner_states[group].inner_state[1].trace
        out.update({k: v for k, v in _flat_params(trace).items() if v.size})   # not MaskedNode
    return out


def test_rl_train_steps_match_optax(rl):
    """One, then two steps from the same params: the trained params (to
    1e-5) and the momentum buffers (to GRAD_REL) match the optax chain, the
    trunk and the BN statistics stay bit-identical."""
    jnet, params, model, _, batch = rl
    jcfg = JaxRLConfig()
    tx, _ = _optax_chain(params, jcfg, steps_per_epoch=4)

    @jax.jit
    def step(p, s, *inputs):
        def loss_fn(q):
            _, loss, noweight = jnet.apply({"params": q}, *inputs)
            return loss, noweight

        (loss, noweight), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, s2 = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s2, loss, noweight

    model = copy.deepcopy(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = make_rl_optimizer(model, RLConfig(), steps_per_epoch=4)
    names = {p: n for n, p in model.named_parameters()}
    jp, js = params, tx.init(params)
    for _ in range(2):
        jp, js, jloss, jnoweight = step(jp, js, *_jax_inputs(batch))
        loss, noweight = rl_train_step(model, opt, sched, *_port_inputs(batch))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=REL)
        np.testing.assert_allclose(float(noweight), float(jnoweight), rtol=REL)
        want = state_dict_from_jax(_flat_params(jp))
        sd = model.state_dict()
        for k, v in sd.items():
            if k.startswith("base.") or k.endswith((".mean", ".var")):
                assert torch.equal(v, before[k]), k
            else:
                assert not torch.equal(v, before[k]), k
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=k)
        want_m = state_dict_from_jax(_momentum(js))
        got_m = {names[p]: s["momentum_buffer"] for p, s in opt.state.items()}
        assert set(got_m) == set(want_m)
        for k, v in got_m.items():
            assert max_rel(v.numpy(), want_m[k].numpy()) < GRAD_REL, k


def test_rl_lr_schedule_crosses_the_decay_epochs():
    """×0.1 from the first step of epoch 8, ×0.01 from epoch 12; biases at
    twice the rate throughout."""
    cfg = RLConfig()
    _, lr_sched = _optax_chain({"fc": {"kernel": jnp.zeros(1)}}, JaxRLConfig(),
                               steps_per_epoch=3)
    model = torch.nn.Module()
    model.fc = torch.nn.Linear(2, 2)
    opt, sched = make_rl_optimizer(model, cfg, steps_per_epoch=3)
    seen = set()
    for count in range(3 * 14):
        want = float(lr_sched(count))
        weight_lr, bias_lr = (g["lr"] for g in opt.param_groups)
        np.testing.assert_allclose(weight_lr, want, rtol=1e-6, err_msg=str(count))
        np.testing.assert_allclose(bias_lr, 2 * want, rtol=1e-6, err_msg=str(count))
        seen.add(round(weight_lr, 8))
        opt.step()
        sched.step()
    assert seen == {0.01, 0.001, 0.0001}


def test_warm_start_copies_what_the_jax_one_copies(rl):
    """The detector's base and head go into the RL net where the shapes
    match; fc8 and fc stay the RL net's own."""
    from rlobjectdetection_tpu.config import Config as JaxConfig
    from rlobjectdetection_tpu.config import TestConfig
    from rlobjectdetection_tpu.models import FasterRCNN as JaxFasterRCNN

    _, params, _, flat, _ = rl
    det = JaxFasterRCNN(num_classes=4, backbone="resnet50",
                        cfg=JaxConfig(TEST=TestConfig(RPN_PRE_NMS_TOP_N=64, RPN_POST_NMS_TOP_N=16),
                                      DTYPE="float32", NMS_TILE=64))
    det_params = jax.jit(det.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 64, 64, 3)),
        jnp.asarray([[64.0, 64.0, 1.0]]), train=False)["params"]
    want = state_dict_from_jax(_flat_params(jax_warm_start(params, det_params)))
    det_sd = state_dict_from_jax(_flat_params(det_params))
    got = warm_start_from_detector(state_dict_from_jax(flat), det_sd)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert torch.equal(got["head.layer4.block0.conv1.weight"],
                       det_sd["head.layer4.block0.conv1.weight"])
    np.testing.assert_array_equal(got["fc8.weight"].numpy(), flat["fc8/kernel"].T)


@pytest.mark.parametrize("scores", ["random", "tie-free", "tied"])
def test_action_matches_jax(scores):
    rng = np.random.RandomState(len(scores))
    cfg = RLConfig()
    port, ref = Action(cfg.act_delta), JaxAction(list(cfg.act_delta))
    np.testing.assert_array_equal(port.actDeltas, ref.actDeltas)
    b, n = 3, 12
    if scores == "random":
        preds = rng.randn(b, n, A).astype(np.float32)
    elif scores == "tie-free":
        preds = rng.permutation(b * n * A).reshape(b, n, A).astype(np.float32)
    else:       # a few levels: ties within a box and across boxes
        preds = rng.randint(0, 3, (b, n, A)).astype(np.float32)
    targets = rng.choice([-1.0, 1.0], (b, n, A)).astype(np.float32)
    boxes = np.concatenate([rng.rand(b, n, 2) * 100, rng.rand(b, n, 2) * 50 + 5], -1)
    for maxk in (1, 5):
        got, got_prec = port.move_from_act(boxes.copy(), preds, targets, maxk)
        want, want_prec = ref.move_from_act(boxes.copy(), preds, targets, maxk)
        np.testing.assert_array_equal(got, want)
        assert got_prec == want_prec
        np.testing.assert_array_equal(port.move_predicted(boxes, preds, maxk),
                                      ref.move_predicted(boxes, preds, maxk))


@pytest.mark.parametrize("masked", [False, True])
def test_weighted_mse_loss_matches_jax(masked):
    rng = np.random.RandomState(2)
    pred, t, w = (rng.randn(32, A).astype(np.float32) for _ in range(3))
    kw_j, kw_p = {}, {}
    if masked:
        mask = np.arange(32) % 16 < 11
        kw_j = dict(denom=jnp.int32(2 * A * 11), row_mask=jnp.asarray(mask))
        kw_p = dict(denom=torch.tensor(2 * A * 11), row_mask=torch.from_numpy(mask))
    want = jax_weighted_mse_loss(jnp.asarray(pred), jnp.asarray(t), jnp.asarray(w), **kw_j)
    got = weighted_mse_loss(*(torch.from_numpy(a) for a in (pred, t, w)), **kw_p)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(float(g), float(wv), rtol=1e-5)   # summation order


def test_collate_and_normalization_match_jax_loader(tmp_path):
    """Images read and normalised by the JAX COCODataset (no resize) and by
    `normalize_image`, then batched by `COCODataLoader.collate` and by
    `collate`: every array equal."""
    from PIL import Image

    from rlobjectdetection_tpu.data.rl_coco import COCODataLoader, COCODataset
    from rlobjectdetection_tpu.data.synthetic import make_coco_dataset

    ann = make_coco_dataset(str(tmp_path), num_images=3, split="val", year="2014",
                            image_size=(70, 90))
    with open(ann) as f:
        gt = json.load(f)
    dets = [{"image_id": a["image_id"], "category_id": a["category_id"],
             "bbox": [float(v) + 1.5 for v in a["bbox"]], "score": 0.8}
            for a in gt["annotations"]]
    dt_file = str(tmp_path / "dets.json")
    with open(dt_file, "w") as f:
        json.dump(dets, f)
    cfg = JaxRLConfig()
    ds = COCODataset(os.path.join(str(tmp_path), "coco", "images", "val2014"), ann, dt_file,
                     JaxAction(list(cfg.act_delta)), normalize_mean=cfg.normalize_mean,
                     normalize_std=cfg.normalize_std)
    samples = [ds[i] for i in range(3)]
    want = COCODataLoader(ds, batch_size=3, shuffle=False).collate(samples)
    port_samples = []
    for img, boxes, labels, info in samples:
        rgb = np.asarray(Image.open(info[5]).convert("RGB"))
        port_samples.append((normalize_image(rgb, cfg.normalize_mean, cfg.normalize_std),
                             boxes, labels, info))
    got = collate(port_samples, A)
    assert want["bboxes"].shape[1] % 16 == 0 and want["data"].shape[1] % 32 == 0
    for k in ("data", "bboxes", "labels", "num_dts"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["im_info"] == want["im_info"]


def test_refiner_matches_the_jax_evaluate_step(rl):
    """`Refiner` against the per-batch part of trainval_rl.evaluate fed the
    JAX action values: teacher-forced moves, precision@k, boxes ÷ scale;
    without labels, `move_predicted`."""
    jnet, params, model, _, batch = rl
    pred = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(batch["data"]),
                                          jnp.asarray(batch["bboxes"]))[0]).reshape(2, 16, A)
    action = Action(RLConfig().act_delta)
    got_pred, moved, prec = Refiner(model, action, maxk=2)(batch)
    assert max_rel(got_pred, pred) < REL
    bboxes = batch["bboxes"]
    xywh = bboxes[..., 1:5].copy()
    xywh[..., 2] -= xywh[..., 0]
    xywh[..., 3] -= xywh[..., 1]
    want_all, want_prec = JaxAction(list(RLConfig().act_delta)).move_from_act(
        xywh.copy(), pred, batch["labels"][..., 1], 2)
    assert prec == want_prec
    for i in range(2):
        n = int(batch["num_dts"][i])
        np.testing.assert_allclose(moved[i], want_all[i, :n] / float(batch["im_info"][i][2]),
                                   rtol=1e-6)
    _, free, none = Refiner(model, action, maxk=2)(dict(batch, labels=None))
    assert none is None
    want_free = action.move_predicted(xywh, got_pred, 2)
    np.testing.assert_allclose(free[1], want_free[1, :7] / 1.5, rtol=1e-6)
    with torch.no_grad():
        eager = model(*_port_inputs(batch)[:2])[0]
    assert torch.equal(rl_eval_step(model, *_port_inputs(batch)[:2]), eager)


def test_detector_stage_fused_eval_matches_unfused(monkeypatch):
    """The port's FasterRCNN honours STAGE_FUSED on its eval forward (as the
    JAX model does, whatever FIXED_BLOCKS says): 23 runs both stages through
    `fused_res_stage` and gives the STAGE_FUSED=0 results."""
    calls = []

    def spy(x, layer, **kw):
        calls.append(kw["width"])
        return res_stage_kernel.fused_res_stage(x, layer, **kw)

    monkeypatch.setattr(port_resnet, "fused_res_stage", spy)
    from rlobjectdetection_tpu_torch.config import TestConfig

    kw = dict(TEST=TestConfig(RPN_PRE_NMS_TOP_N=256, RPN_POST_NMS_TOP_N=32,
                              MAX_DETS_PER_IMAGE=20),
              DTYPE="float32", NMS_TILE=64, CONV1_FUSED=True, LAYER1_FUSED=True)
    plain = FasterRCNN(21, "resnet50", Config(**kw), device="cpu", seed=5)
    rng = np.random.RandomState(8)
    with torch.no_grad():
        for name, buf in plain.named_buffers():
            leaf = name.rsplit(".", 1)[1]
            buf.copy_(torch.from_numpy((0.7 + 0.3 * rng.rand(*buf.shape)) if leaf in
                                       ("scale", "var") else 0.05 * rng.randn(*buf.shape)))
        plain.rpn.RPN_cls_score.weight.mul_(0.3)
        plain.rpn.RPN_bbox_pred.weight.mul_(0.02)
    fused = FasterRCNN(21, "resnet50", Config(**kw, STAGE_FUSED=23), device="cpu")
    fused.load_state_dict(plain.state_dict())
    data = torch.from_numpy((rng.randn(1, 96, 128, 3) * 40).astype(np.float32))
    info = torch.tensor([[96.0, 128.0, 1.0]])
    with torch.no_grad():
        want = plain(data, info)
        assert calls == []
        got = fused(data, info)
        assert calls == [128, 256]
        # the heads fed the same rois, so NMS order cannot differ
        feat_p, feat_f = plain.base(data, fwd_only=True), fused.base(data, fwd_only=True)
        assert max_rel(feat_f.numpy(), feat_p.numpy()) < REL
        head_p = plain.detect_head(feat_p, want["rois"])
        head_f = fused.detect_head(feat_f, want["rois"])
    for g, w in zip(head_f, head_p):
        assert max_rel(g.numpy(), w.numpy()) < REL
    rows_equal = (torch.abs(got["rois"] - want["rois"]) <= 1e-3).all(-1)
    assert rows_equal.float().mean() >= 0.98


def test_rl_net_needs_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RLPolicyNet(A, 50)
