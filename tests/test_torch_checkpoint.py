"""The port's torch checkpoints (`engine/checkpoint.py`) and weight
converter (`engine/convert_torch_weights.py`), on the CPU.

- a checkpoint saved after two train steps and loaded into fresh objects
  gives back every parameter and buffer, every momentum buffer, the
  schedule's count and LRs, the step and the meta entries, bit for bit;
  a step after the load equals the uninterrupted run's step, across an LR
  decay; the wrong backbone, class count or frozen prefix raises; the
  write is atomic; a load after a kernel call packs again and gives the
  loaded weights' output;
- the converter against the JAX package's `tools/convert_torch_weights.py`
  on synthetic torchvision-layout state dicts made with numpy (ResNet-50,
  -101 and -152 with and without layer4, VGG-16, a reference detector of
  each backbone, the RL policy): JAX's tree through `state_dict_from_jax`
  equals the port's output exactly, and so does `merge_pretrained` (with a
  key the target lacks and a shape that differs); the CLI writes what
  `load_params` reads back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import tools.convert_torch_weights as jax_conv
from rlobjectdetection_tpu_torch.config import Config, TrainConfig
from rlobjectdetection_tpu_torch.engine import (build_optimizer, make_lr_schedule,
                                                make_train_step)
from rlobjectdetection_tpu_torch.engine import checkpoint, convert_torch_weights as conv
from rlobjectdetection_tpu_torch.engine.trainval_net import step_draws
from rlobjectdetection_tpu_torch.models import FasterRCNN
from rlobjectdetection_tpu_torch.ops.stem_kernel import packed_stem
from rlobjectdetection_tpu_torch.utils import tracing
from test_torch_train import _gt_boxes
import torch_threads  # noqa: F401  (xdist workers share the cores)


def pack_misses() -> int:
    return tracing.totals().get("pack.misses", 0)


TINY_CFG = Config(TRAIN=TrainConfig(RPN_PRE_NMS_TOP_N=256, RPN_POST_NMS_TOP_N=64,
                                    BATCH_SIZE=32),
                  DTYPE="float32", NMS_TILE=64, ANCHOR_SCALES=(4, 8, 16, 32))


def _batch(seed=5):
    rng = np.random.RandomState(seed)
    b = dict(data=(rng.randn(2, 96, 128, 3) * 40).astype(np.float32),
             im_info=np.asarray([[96.0, 128.0, 1.0]] * 2, np.float32),
             gt_boxes=_gt_boxes(rng, 2, 8, (4, 3), 96, 128),
             num_boxes=np.asarray([4, 3], np.int32))
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _trainer(seed=3, lr_decay_iters=2, backbone="tiny", cfg=TINY_CFG, fixed_blocks=1):
    model = FasterRCNN(21, backbone, cfg, device="cpu", seed=seed)
    opt, sched, _ = build_optimizer(model, backbone, 0.01, fixed_blocks=fixed_blocks,
                                    lr_schedule=make_lr_schedule(0.01, lr_decay_iters))
    return model, opt, sched, make_train_step(model, opt, sched)


def _run(step, steps, start=0):
    for s in range(start, start + steps):
        step(_batch(s), *step_draws(3, s, "cpu"))


def _momentum(opt):
    return [opt.state[p]["momentum_buffer"] for g in opt.param_groups for p in g["params"]]


def test_round_trip_restores_everything_bit_for_bit(tmp_path):
    model, opt, sched, step = _trainer()
    _run(step, 2)
    path = checkpoint.checkpoint_path(str(tmp_path), "tiny", "pascal_voc", 4, 2)
    checkpoint.save_checkpoint(path, model, opt, sched, session=4, epoch=2, step=2,
                               pooling_mode="crop", class_agnostic=True,
                               extra={"classes": ["__background__", "a"]})
    assert path.endswith("tiny/pascal_voc/faster_rcnn_4_2.pth")
    fresh, fopt, fsched, _ = _trainer(seed=9)
    assert not torch.equal(fresh.RCNN_cls_score.weight, model.RCNN_cls_score.weight)
    meta = checkpoint.load_checkpoint(path, fresh, fopt, fsched)
    assert meta == {"session": 4, "epoch": 2, "step": 2, "pooling_mode": "crop",
                    "class_agnostic": True, "classes": ["__background__", "a"]}
    want, got = model.state_dict(), fresh.state_dict()
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    assert all(torch.equal(a, b) for a, b in zip(_momentum(opt), _momentum(fopt)))
    assert fsched.last_epoch == sched.last_epoch == 2
    assert [g["lr"] for g in fopt.param_groups] == [g["lr"] for g in opt.param_groups]
    assert fopt.param_groups[0]["lr"] == pytest.approx(0.001)      # decayed after 2 steps
    payload = checkpoint.read_checkpoint(path)
    assert all(not t.is_cuda for t in payload["model"].values())


def test_a_step_after_the_load_is_the_uninterrupted_step(tmp_path):
    """Three steps in one run against two, a save, a load into fresh
    objects and the third: the LR decays at step 2, so the resumed step's
    LR is the decayed one."""
    model, _, _, step = _trainer()
    _run(step, 3)
    model2, opt2, sched2, step2 = _trainer()
    _run(step2, 2)
    path = str(tmp_path / "c.pth")
    checkpoint.save_checkpoint(path, model2, opt2, sched2, epoch=1, step=2)
    model3, opt3, sched3, step3 = _trainer(seed=11)
    checkpoint.load_checkpoint(path, model3, opt3, sched3)
    _run(step3, 1, start=2)
    want, got = model.state_dict(), model3.state_dict()
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_the_wrong_model_or_optimizer_raises(tmp_path):
    """Another backbone (KeyError), another class count (ValueError), another
    frozen prefix (the optimizer's groups, ValueError)."""
    res_cfg = Config(DTYPE="float32")
    model = FasterRCNN(21, "resnet50", res_cfg, device="cpu")
    opt, sched, _ = build_optimizer(model, "resnet50", 0.01)
    path = str(tmp_path / "r.pth")
    checkpoint.save_checkpoint(path, model, opt, sched)
    with pytest.raises(KeyError):
        checkpoint.load_checkpoint(path, FasterRCNN(21, "tiny", TINY_CFG, device="cpu"))
    with pytest.raises(ValueError, match="RCNN_cls_score"):
        checkpoint.load_checkpoint(path, FasterRCNN(81, "resnet50", res_cfg, device="cpu"))
    other = FasterRCNN(21, "resnet50", res_cfg, device="cpu")
    opt2, sched2, _ = build_optimizer(other, "resnet50", 0.01, fixed_blocks=2)
    with pytest.raises(ValueError, match="FIXED_BLOCKS"):
        checkpoint.load_checkpoint(path, other, opt2, sched2)


def test_the_write_is_atomic(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the earlier file whole and no
    temporary file behind."""
    model, opt, sched, _ = _trainer()
    path = str(tmp_path / "c.pth")
    checkpoint.save_checkpoint(path, model, opt, sched, epoch=1)
    before = open(path, "rb").read()

    def dies(obj, f):
        open(f, "wb").write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(OSError):
        checkpoint.save_checkpoint(path, model, opt, sched, epoch=2)
    assert open(path, "rb").read() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.pth"]


def test_a_load_after_a_kernel_call_packs_again(tmp_path):
    """The fused layer1 packs its weights on the CPU too (its plain version
    reads the packed operands): after a load the next forward packs again
    and gives the loaded weights' output; the stem's packed operands are
    those of the loaded weights."""
    cfg = Config(DTYPE="float32", CONV1_FUSED=True, LAYER1_FUSED=True)
    src = FasterRCNN(21, "resnet50", cfg, device="cpu", seed=9)
    rng = np.random.RandomState(2)
    with torch.no_grad():
        for name, buf in src.named_buffers():
            buf.copy_(torch.from_numpy((0.7 + 0.3 * rng.rand(*buf.shape)).astype(np.float32)))
    path = str(tmp_path / "w.pth")
    checkpoint.save_checkpoint(path, src)
    model = FasterRCNN(21, "resnet50", cfg, device="cpu", seed=3)
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 64, 96, 3).astype(np.float32) * 30)
    bn = model.base.bn1
    with torch.no_grad():
        model.base(x)
        stem_ops = packed_stem(model.base.conv1.weight, bn.scale, bn.bias, bn.mean, bn.var,
                               torch.float32, torch.device("cpu"))
        packs = pack_misses()
        checkpoint.load_checkpoint(path, model)
        got = model.base(x)
        assert pack_misses() > packs
        assert torch.equal(got, src.base(x))
        again = packed_stem(model.base.conv1.weight, bn.scale, bn.bias, bn.mean, bn.var,
                            torch.float32, torch.device("cpu"))
        sbn = src.base.bn1
        want = packed_stem(src.base.conv1.weight, sbn.scale, sbn.bias, sbn.mean, sbn.var,
                           torch.float32, torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(again, want))
    assert not all(torch.equal(a, b) for a, b in zip(again, stem_ops))


def test_save_params_round_trip(tmp_path):
    sd = {"a.weight": torch.randn(3, 4), "b.bias": np.arange(5, dtype=np.float32)}
    path = checkpoint.save_params(str(tmp_path / "p.pth"), sd)
    got = checkpoint.load_params(path)
    assert torch.equal(got["a.weight"], sd["a.weight"])
    assert torch.equal(got["b.bias"], torch.arange(5, dtype=torch.float32))


# -- the weight converter against the JAX package --------------------------------

RESNET_SPECS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _bn(sd, prefix, c, rng):
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        sd[f"{prefix}.{leaf}"] = rng.randn(c).astype(np.float32)
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0)


def torchvision_resnet(num_layers, rng, width=4, head=True, fc=True):
    """A torchvision ResNet's keys at 1/16 of its widths (the converter only
    renames)."""
    sd = {"conv1.weight": rng.randn(width, 3, 7, 7).astype(np.float32)}
    _bn(sd, "bn1", width, rng)
    inplanes = width
    for n, blocks in enumerate(RESNET_SPECS[num_layers], start=1):
        if n == 4 and not head:
            break
        planes = width * 2 ** (n - 1)
        for b in range(blocks):
            p = f"layer{n}.{b}"
            cin = inplanes if b == 0 else planes * 4
            for k, shape in ((1, (planes, cin, 1, 1)), (2, (planes, planes, 3, 3)),
                             (3, (planes * 4, planes, 1, 1))):
                sd[f"{p}.conv{k}.weight"] = rng.randn(*shape).astype(np.float32)
                _bn(sd, f"{p}.bn{k}", shape[0], rng)
            if b == 0:
                sd[f"{p}.downsample.0.weight"] = rng.randn(planes * 4, cin, 1, 1).astype(
                    np.float32)
                _bn(sd, f"{p}.downsample.1", planes * 4, rng)
        inplanes = planes * 4
    if fc:
        sd["fc.weight"] = rng.randn(10, inplanes).astype(np.float32)
        sd["fc.bias"] = rng.randn(10).astype(np.float32)
    return sd


def torchvision_vgg16(rng):
    sd, cin = {}, 3
    for idx, name in conv.VGG_CONVS.items():
        cout = 8 if name.startswith(("conv1", "conv2")) else 16
        sd[f"features.{idx}.weight"] = rng.randn(cout, cin, 3, 3).astype(np.float32)
        sd[f"features.{idx}.bias"] = rng.randn(cout).astype(np.float32)
        cin = cout
    for i, (o, n) in {0: (32, 16 * 49), 3: (32, 32), 6: (10, 32)}.items():
        sd[f"classifier.{i}.weight"] = rng.randn(o, n).astype(np.float32)
        sd[f"classifier.{i}.bias"] = rng.randn(o).astype(np.float32)
    return sd


def reference_detector(net, rng, num_classes=5, module=False):
    """A reference detector's state dict: RCNN_base / RCNN_top, RCNN_rpn,
    the classifiers (`module.` prefixed, as a DataParallel save is)."""
    if net == "vgg16":
        bb = torchvision_vgg16(rng)
        sd = {("RCNN_base." + k[len("features."):] if k.startswith("features.")
               else "RCNN_top." + k[len("classifier."):]): v for k, v in bb.items()
              if not k.startswith("classifier.6")}
        feat, head = 16, 32
    else:
        bb = torchvision_resnet({"res50": 50, "res101": 101, "res152": 152}[net], rng, fc=False)
        seq = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6"}
        sd = {}
        for k, v in bb.items():
            top, rest = k.split(".", 1)
            sd[f"RCNN_top.0.{rest}" if top == "layer4" else f"RCNN_base.{seq[top]}.{rest}"] = v
        feat, head = 4 * 4 * 4, 4 * 8 * 4
    a = 12
    for name, o, i, k in (("RPN_Conv", 8, feat, 3), ("RPN_cls_score", 2 * a, 8, 1),
                          ("RPN_bbox_pred", 4 * a, 8, 1)):
        sd[f"RCNN_rpn.{name}.weight"] = rng.randn(o, i, k, k).astype(np.float32)
        sd[f"RCNN_rpn.{name}.bias"] = rng.randn(o).astype(np.float32)
    sd["RCNN_cls_score.weight"] = rng.randn(num_classes, head).astype(np.float32)
    sd["RCNN_cls_score.bias"] = rng.randn(num_classes).astype(np.float32)
    sd["RCNN_bbox_pred.weight"] = rng.randn(4 * num_classes, head).astype(np.float32)
    sd["RCNN_bbox_pred.bias"] = rng.randn(4 * num_classes).astype(np.float32)
    return {("module." + k if module else k): v for k, v in sd.items()}


def _via_jax(tree):
    """A JAX converter's tree as the port's state dict."""
    flat = traverse_util.flatten_dict(tree, sep="/")
    return checkpoint.state_dict_from_jax({k: np.asarray(v) for k, v in flat.items()})


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert got[k].is_contiguous() and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("layers,head", [(50, True), (101, True), (101, False), (152, True)])
def test_convert_resnet_matches_jax(layers, head):
    sd = torchvision_resnet(layers, np.random.RandomState(layers), head=head)
    got = conv.convert_resnet(sd, layers)
    _assert_same(got, _via_jax(jax_conv.convert_resnet(sd, layers)))
    assert any(k.startswith("head.layer4.") for k in got) == head
    assert "base.layer3.block0.downsample_bn.var" in got


def test_convert_vgg16_matches_jax():
    sd = torchvision_vgg16(np.random.RandomState(1))
    got = conv.convert_vgg16(sd)
    _assert_same(got, _via_jax(jax_conv.convert_vgg16(sd)))
    assert len(got) == 30 and "head.fc7.bias" in got


@pytest.mark.parametrize("net,module", [("vgg16", False), ("res50", True), ("res101", False)])
def test_convert_detector_matches_jax(net, module):
    sd = reference_detector(net, np.random.RandomState(2), module=module)
    got = conv.convert_detector(sd, net)
    _assert_same(got, _via_jax(jax_conv.convert_detector(sd, net)))
    assert {"rpn.RPN_cls_score.weight", "RCNN_bbox_pred.bias"} <= set(got)


def test_convert_rl_matches_jax():
    rng = np.random.RandomState(3)
    sd = torchvision_resnet(101, rng, fc=False)
    sd.update({"fc8.weight": rng.randn(16, 128).astype(np.float32),
               "fc8.bias": rng.randn(16).astype(np.float32),
               "fc.weight": rng.randn(7, 16).astype(np.float32),
               "fc.bias": rng.randn(7).astype(np.float32)})
    sd = {"module." + k: v for k, v in sd.items()}
    _assert_same(conv.convert_rl(sd), _via_jax(jax_conv.convert_rl(sd)))


def test_merge_pretrained_matches_jax(capsys):
    """Keys both have at one shape come from the pretrained dict; a key the
    target lacks and a shape that differs are skipped; the rest stays."""
    rng = np.random.RandomState(4)
    target = conv.convert_detector(reference_detector("res50", rng, num_classes=21), "res50")
    pre = conv.convert_resnet(torchvision_resnet(50, rng), 50)          # backbone only
    pre.update(conv.convert_detector(reference_detector("res50", rng, num_classes=81),
                                     "res50"))
    pre["base.extra.weight"] = torch.zeros(3)
    del pre["base.layer1.block0.conv1.weight"]
    got = conv.merge_pretrained(target, pre)
    printed = capsys.readouterr().out

    def tree(sd):
        return traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in _jax_flat(sd).items()}, sep="/")

    want = jax_conv.merge_pretrained(tree(target), tree(pre))
    _assert_same(got, _via_jax(want))
    capsys.readouterr()
    assert "skip (missing): base.extra.weight" in printed
    assert "skip (shape): RCNN_cls_score.weight (21, 2048)" not in printed
    assert "skip (shape): RCNN_cls_score.weight" in printed
    assert torch.equal(got["base.layer1.block0.conv1.weight"],
                       target["base.layer1.block0.conv1.weight"])
    assert torch.equal(got["base.layer2.block0.conv2.weight"],
                       pre["base.layer2.block0.conv2.weight"])
    assert torch.equal(got["RCNN_cls_score.weight"], target["RCNN_cls_score.weight"])


def _jax_flat(sd):
    """The port's state dict as a JAX flat param dict (the inverse of
    `state_dict_from_jax`)."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        v = np.asarray(v)
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
        out["/".join(parts)] = np.ascontiguousarray(v)
    return out


def test_converter_cli_writes_what_load_params_reads(tmp_path):
    sd = reference_detector("vgg16", np.random.RandomState(5))
    src = str(tmp_path / "ref.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 3}, src)
    out = str(tmp_path / "port.pth")
    conv.main(["--src", src, "--net", "vgg16", "--out", out])
    _assert_same(checkpoint.load_params(out), conv.convert_detector(sd, "vgg16"))
