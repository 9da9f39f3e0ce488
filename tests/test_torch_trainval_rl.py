"""The port's RL CLI (`engine/trainval_rl.py`), its eval loop and its train
loop against the JAX package's `tools/trainval_rl.py`, on the CPU in f32
(the kernels' plain versions run there).

The data is a synthetic COCO split of 6 images of 72×96, each gt box
jittered by N(0, 2) px as a detection. Tolerances: the eval's json rows
and Preck line equal (the same action values feed both); two epochs of the
train loop (ResNet-50 at 64 px, 6 steps, the rate ×0.1 from epoch 1) hold
each step's losses to 1e-4 and each trained tensor's update to 1e-3 of its
largest, as the detector's steps are held; resume is bitwise."""

import json
import logging
import os
import subprocess
import sys
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from rlobjectdetection_tpu.config import RLConfig as JaxRLConfig
from rlobjectdetection_tpu.data import rl_coco as jax_rl
from rlobjectdetection_tpu.engine.checkpoint import save_net_npz
from rlobjectdetection_tpu.models.rl import Action as JaxAction
from rlobjectdetection_tpu.models.rl import RLPolicyNet as JaxRLPolicyNet
from rlobjectdetection_tpu_torch.config import Config, RLConfig, TestConfig
from rlobjectdetection_tpu_torch.data import rl_coco
from rlobjectdetection_tpu_torch.data.synthetic import make_coco_dataset
from rlobjectdetection_tpu_torch.engine import rl_resume_validate, trainval_rl
from rlobjectdetection_tpu_torch.engine.checkpoint import (load_net_npz, read_checkpoint,
                                                           save_checkpoint)
from rlobjectdetection_tpu_torch.engine.rl import make_rl_optimizer, rl_evaluate, rl_train_step
from rlobjectdetection_tpu_torch.models import FasterRCNN
from rlobjectdetection_tpu_torch.models.backbones import resnet_ties
from rlobjectdetection_tpu_torch.models.backbones.resnet import LAYER_SPECS
from rlobjectdetection_tpu_torch.models.rl import Action, warm_start_from_detector

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
A = 56
LOSS_REL, UPDATE_REL = 1e-4, 1e-3
# a replayed gate's input, relative to its gate's largest: a rounding tie
TIE_SIZE_TOL = 1e-5
SHORT, MAX_SIZE = 64, 96
LOOP_LAYERS = 50        # layer1 has the three blocks its kernel takes, as in ResNet-101


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(gt json, detections json, image dir)."""
    root = str(tmp_path_factory.mktemp("rl_cli"))
    ann = make_coco_dataset(root, num_images=6, split="val", year="2014", image_size=(72, 96))
    with open(ann) as f:
        gt = json.load(f)
    rng = np.random.RandomState(0)
    dets = []
    for a in gt["annotations"]:
        b = np.asarray(a["bbox"]) + np.r_[rng.randn(2) * 2, 0.0, 0.0]
        dets.append({"image_id": a["image_id"], "category_id": a["category_id"],
                     "bbox": [float(v) for v in b], "score": 0.8})
    dt_file = os.path.join(root, "dets.json")
    with open(dt_file, "w") as f:
        json.dump(dets, f)
    return ann, dt_file, os.path.join(root, "coco", "images", "val2014")


def loaders(data, sizes, flip: bool, shuffle: bool):
    """(port loader, JAX loader) at batch 2 over the same files."""
    ann, dt_file, img_dir = data
    cfg = RLConfig()
    norm = dict(normalize_mean=cfg.normalize_mean, normalize_std=cfg.normalize_std)
    port = rl_coco.COCODataset(
        img_dir, ann, dt_file, Action(list(cfg.act_delta), wtrans=cfg.act_wtrans),
        transform_fn=rl_coco.COCOTransform(sizes, MAX_SIZE, flip=flip), **norm)
    ref = jax_rl.COCODataset(
        img_dir, ann, dt_file, JaxAction(list(cfg.act_delta), wtrans=JaxRLConfig.act_wtrans),
        transform_fn=jax_rl.COCOTransform(sizes, MAX_SIZE, flip=flip), **norm)
    return (rl_coco.COCODataLoader(port, 2, shuffle=shuffle),
            jax_rl.COCODataLoader(ref, 2, shuffle=shuffle))


class BoxScorer(torch.nn.Module):
    """Action values from each roi's box and its image's mean pixel (so the
    wire's rounding reaches them): `model(data, bboxes)[0]` as
    `RLPolicyNet` returns it."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(7, A, generator=gen))

    def forward(self, data, bboxes):
        b, n = bboxes.shape[:2]
        mean = data.float().mean(dim=(1, 2))[:, None, :].expand(b, n, 3)
        feat = torch.cat([bboxes[..., 1:5].float() / 50.0, mean], -1).reshape(b * n, 7)
        zero = torch.zeros(())
        return feat @ self.w, zero, zero


class Lines:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


@pytest.mark.parametrize("wire,maxk", [("bf16", 1), ("f32", 2)])
def test_eval_rows_and_preck_match_jax_evaluate(data, tmp_path, wire, maxk):
    """`rl_evaluate` and the JAX CLI's `evaluate` fed the same action values
    (its `eval_step` runs the port's model on the pixels it was shipped),
    on epoch 1's draws (a short-side range, flips): equal json rows and
    Preck line, both wires; the wire and the rows reach the log."""
    sys.path.insert(0, REPO)
    from tools import trainval_rl as jax_cli

    model = BoxScorer()
    port_loader, jax_loader = loaders(data, (48, 80), flip=True, shuffle=False)
    port_loader.set_epoch(1)
    jax_loader.set_epoch(1)

    def eval_step(params, x, bboxes):
        x = torch.from_numpy(np.asarray(x).astype(np.float32))
        with torch.no_grad():
            return model(x, torch.from_numpy(np.array(bboxes)))[0].numpy()

    ann = data[0]
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    jax_log = Lines()
    cfg = SimpleNamespace(save_dir=str(jax_dir), ann_file=ann)
    jax_cli.evaluate(SimpleNamespace(wire=wire, maxk=maxk, save_dir=str(jax_dir)), cfg, None,
                     jax_loader, eval_step, None,
                     JaxAction(list(JaxRLConfig().act_delta)), jax_log)
    port_log = Lines()
    out = rl_evaluate(model, port_loader, Action(RLConfig().act_delta), maxk, wire=wire,
                      res_file=str(tmp_path / "port.json"), ann_file=ann, log=port_log)
    with open(jax_dir / "rl_results.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    assert got == want == out["rows"] and len(got) > 6
    preck = [line for line in jax_log.lines if line.startswith("Preck")]
    assert preck == [line for line in port_log.lines if line.startswith("Preck")]
    assert f"wire {wire}" in port_log.lines[0] and out["images"] == 6
    assert len(out["stats"]) == 12 and out["stats"][1] > 0


def _jax_train_step(model, tx):
    @jax.jit
    def step(params, opt_state, data, bboxes, targets, weights, num_dts):
        def loss_fn(p):
            _, loss, noweight = model.apply({"params": p}, data, bboxes, targets, weights,
                                            num_dts)
            return loss, noweight

        (loss, noweight), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state2 = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, loss, noweight

    return step


def _optax_chain(params, cfg, steps_per_epoch):
    """The optimizer of tools/trainval_rl.py:137-172."""
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

    return optax.multi_transform(
        {"weight": sgd(1.0, cfg.weight_decay), "bias": sgd(2.0, 0.0),
         "frozen": optax.set_to_zero()},
        jax.tree_util.tree_map_with_path(lab, params))


def _flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


def _jax_gates(capture, params, batch, blocks: int) -> dict:
    """The JAX forward's ReLU gates of layer4 and fc8 on `batch`, in the
    port's layouts: {("head.layer4.block<i>", 0|1|2): input > 0 NCHW,
    "fc8": input > 0}, from the modules' outputs (`capture(params, data,
    bboxes)` runs the net with `capture_intermediates`); the last gate's
    input is bn3's output plus the shortcut's."""
    _, state = capture(params, *(jnp.asarray(batch[k]) for k in ("data", "bboxes")))
    inter = state["intermediates"]
    layer4 = inter["head"]["layer4"]
    out = lambda tree: np.asarray(tree["__call__"][0])
    nchw = lambda x: torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)) > 0)
    gates = {"fc8": torch.from_numpy(out(inter["fc8"]) > 0)}
    for i in range(blocks):
        blk = layer4[f"block{i}"]
        shortcut = out(blk["downsample_bn"]) if i == 0 else out(layer4[f"block{i - 1}"])
        name = f"head.layer4.block{i}"
        gates[name, 0] = nchw(out(blk["bn1"]))
        gates[name, 1] = nchw(out(blk["bn2"]))
        gates[name, 2] = nchw(out(blk["bn3"]) + shortcut)
    return gates


class StepGates:
    """`resnet_ties.replay`'s ties for a run of steps: the gates of the step
    whose forward runs (a pre-hook on the model moves to the next)."""

    def __init__(self, steps: list):
        self.steps, self.at = steps, -1

    def __getitem__(self, key):
        return self.steps[self.at][key]

    def advance(self, *_):
        self.at += 1


def test_train_loop_matches_jax_optax_chain(data, tmp_path, monkeypatch):
    """Two epochs (3 steps each, batch 2, ResNet-50, f32) of the port's
    `train_loop` on its loader, from JAX params carried over by npz,
    against the JAX CLI's loop (set_epoch, the jitted step, the optax
    chain) on the JAX loader, with `train_lr_decay` (1,) so the rate drops
    at the second epoch: every step's loss and noweight to 1e-4, each
    trained tensor's update over the run to 1e-3 of its largest, the trunk
    and BN statistics untouched.

    A ReLU input within rounding of 0 is decided by its last bit, and one
    such gate moves a bias's update by ~1e-3 (a sum over 32 rois × 49
    positions). So the port's run takes the JAX run's gates in layer4 and
    fc8 (`resnet_ties.replay`), and each input it flips must be a tie:
    within 1e-5 of its gate's largest."""
    port_loader, jax_loader = loaders(data, (SHORT,), flip=False, shuffle=True)
    jcfg = replace(JaxRLConfig(), train_lr_decay=(1,))
    cfg = replace(RLConfig(), train_lr_decay=(1,))
    jnet = JaxRLPolicyNet(num_acts=A, num_layers=LOOP_LAYERS)
    jax_loader.set_epoch(0)
    sample = next(iter(jax_loader))
    params = jax.jit(jnet.init)(
        {"params": jax.random.PRNGKey(3)}, jnp.asarray(sample["data"]),
        jnp.asarray(sample["bboxes"]), jnp.asarray(sample["labels"][..., 1]),
        jnp.asarray(sample["labels"][..., 2]))["params"]
    rng = np.random.RandomState(7)
    flat = _flat(params)
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[1]
        if "bn" in k and leaf in ("scale", "var"):
            flat[k] = (0.7 + 0.3 * rng.rand(*v.shape)).astype(np.float32)
        elif "bn" in k and leaf in ("bias", "mean"):
            flat[k] = (0.05 * rng.randn(*v.shape)).astype(np.float32)
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    npz = str(tmp_path / "rl.npz")
    save_net_npz(npz, params)

    tx = _optax_chain(params, jcfg, len(jax_loader))
    jax_step = _jax_train_step(jnet, tx)
    capture = jax.jit(lambda p, d, b: jnet.apply({"params": p}, d, b, capture_intermediates=True,
                                                 mutable=["intermediates"]))
    jp, js, want, gates = params, tx.init(params), [], []
    for epoch in range(2):
        jax_loader.set_epoch(epoch)
        for batch in jax_loader:
            gates.append(_jax_gates(capture, jp, batch, LAYER_SPECS[LOOP_LAYERS][3]))
            jp, js, loss, noweight = jax_step(
                jp, js, jnp.asarray(batch["data"]), jnp.asarray(batch["bboxes"]),
                jnp.asarray(batch["labels"][..., 1]), jnp.asarray(batch["labels"][..., 2]),
                jnp.asarray(batch["num_dts"]))
            want.append((float(loss), float(noweight)))

    args = trainval_rl.parse_args(["--layers", str(LOOP_LAYERS), "--device", "cpu"])
    model = load_net_npz(npz, trainval_rl.build_model(args, A, "cpu"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = make_rl_optimizer(model, cfg, len(port_loader))
    ties, counts = StepGates(gates), {}
    fc8_flips = []

    def fc8_gate(module, inputs, out):
        flip = (out > 0) != ties["fc8"]
        size = out.detach().abs()
        fc8_flips.append(float(torch.where(flip, size, 0).max() / size.max()))
        return out + torch.where(flip, -2 * out, 0).detach()

    hooks = [model.register_forward_pre_hook(ties.advance),
             model.fc8.register_forward_hook(fc8_gate)]
    losses = []

    def recorded_step(*args):
        out = rl_train_step(*args)
        losses.append(tuple(float(v) for v in out))
        return out

    monkeypatch.setattr(trainval_rl, "rl_train_step", recorded_step)
    with resnet_ties.replay(model, ties, counts):
        step, history, logged = trainval_rl.train_loop(
            model, port_loader, opt, sched, start_epoch=0, max_epoch=2, num_workers=2,
            log=logging.getLogger("rl_test"))
    for h in hooks:
        h.remove()
    assert step == 6 and [h["epoch"] for h in history] == [0, 1] and ties.at == 5
    assert counts["flipped_max"] <= TIE_SIZE_TOL and max(fc8_flips) <= TIE_SIZE_TOL
    assert [l[:2] for l in logged] == [(0, 0), (1, 0)]           # every 10th step, per epoch
    assert [l[2:] for l in logged] == [losses[0], losses[3]]
    np.testing.assert_allclose(losses, want, rtol=LOSS_REL)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.1 * cfg.learning_rate)

    after_jax = {k.replace("/", ".").replace("kernel", "weight"): v
                 for k, v in _flat(jp).items()}
    sd = model.state_dict()
    trained = 0
    for k, v in sd.items():
        if k.startswith("base.") or k.endswith((".mean", ".var")):
            assert torch.equal(v, before[k]), k
            continue
        got = (v - before[k]).numpy()
        w = after_jax[k]
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else (w.T if w.ndim == 2 else w)
        want_upd = w - before[k].numpy()
        scale = np.abs(want_upd).max()
        assert scale > 0, k
        assert np.abs(got - want_upd).max() <= UPDATE_REL * scale, k
        trained += 1
    assert trained == sum(p.requires_grad for p in model.parameters())


def _cli(args, timeout=300):
    return subprocess.run([sys.executable, "-m", "rlobjectdetection_tpu_torch.engine.trainval_rl",
                           *args], cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_cli_trains_then_evaluates_on_the_cpu(data, tmp_path):
    """`--device cpu`: one epoch (a checkpoint with kind rl, epoch 1, step
    3), then `-e --resume`: exit 0, the log holds the loss line, Preck,
    the wire and COCOeval's table."""
    ann, dt_file, img_dir = data
    save = str(tmp_path / "m")
    common = ["--ann_file", ann, "--dt_file", dt_file, "--data_dir", img_dir,
              "--save_dir", save, "--img_short", str(SHORT), "--img_size", str(MAX_SIZE),
              "--layers", "18", "--device", "cpu"]
    r = _cli(["--epochs", "1"] + common)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[0][0/3] loss(sampled)" in r.stderr and "train loop epoch 0" in r.stderr
    ck = read_checkpoint(os.path.join(save, "rl_epoch_1.pth"))
    assert (ck["kind"], ck["epoch"], ck["step"], ck["layers"], ck["num_acts"]) == (
        "rl", 1, 3, 18, A)
    assert ck["scheduler"]["last_epoch"] == 3 and ck["optimizer"]["state"]
    r2 = _cli(["-e", "--resume", os.path.join(save, "rl_epoch_1.pth"), "--maxk", "1"] + common)
    assert r2.returncode == 0, r2.stderr[-3000:]
    log = r2.stdout + r2.stderr
    assert "Preck precision@1" in log and "Average Precision" in log and "wire bf16" in log
    with open(os.path.join(save, "rl_results.json")) as f, open(dt_file) as g:
        assert len(json.load(f)) == len(json.load(g))     # one row a detection


def test_cli_refuses_aot_cache_and_has_the_jax_flags(monkeypatch, capsys):
    """`--aot_cache` exits with code 2 and names JAX's executable cache; the
    flag set and every default are the JAX CLI's, plus `--device` (cuda)."""
    with pytest.raises(SystemExit) as e:
        trainval_rl.parse_args(["--epochs", "1", "--aot_cache", "/tmp/x"])
    assert e.value.code == 2 and "executable cache" in capsys.readouterr().err
    sys.path.insert(0, REPO)
    from tools import trainval_rl as jax_cli

    for argv in ([], ["-e", "--wire", "f32", "--max_stat_dets", "0", "--layers", "50"]):
        monkeypatch.setattr(sys, "argv", ["trainval_rl.py", *argv])
        want = vars(jax_cli.parse_args())
        got = vars(trainval_rl.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want


def test_rl_resume_validate_is_bitwise_on_the_cpu(tmp_path):
    """Two epochs in one process against one epoch and a `--resume` in a
    fresh process: every tensor equal (fresh processes under
    deterministic algorithms)."""
    res = rl_resume_validate.main(
        ["--device", "cpu", "--layers", "18", "--images", "2", "--img_short", "64",
         "--img_size", "96", "--work_dir", str(tmp_path)])
    assert res["ok"] and res["max_abs_delta"] == 0.0 and res["n_leaves"] > 100


def _jax_dump(state: dict, path: str) -> None:
    """A `save_net_npz` dump of a port state dict: JAX param paths, HWIO
    conv kernels and [in, out] dense kernels."""
    flat = {}
    for k, v in state.items():
        parts = k.split(".")
        v = v.numpy()
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
        flat["/".join(parts)] = jnp.asarray(v)
    save_net_npz(path, traverse_util.unflatten_dict(flat, sep="/"))


def test_pretrained_from_a_checkpoint_and_an_npz_dump(tmp_path):
    """`--pretrained` with a port detector checkpoint, and with the same
    weights as a JAX npz dump: the net `warm_start_from_detector` gives
    (trunk and layer4 the detector's, fc8 and fc the RL net's own). The
    detector checkpoint is refused as a `--resume` point."""
    det = FasterRCNN(4, "resnet50", Config(TEST=TestConfig(RPN_PRE_NMS_TOP_N=64,
                                                           RPN_POST_NMS_TOP_N=16),
                                           DTYPE="float32", NMS_TILE=64),
                     device="cpu", seed=5)
    det_sd = det.state_dict()
    ckpt = save_checkpoint(str(tmp_path / "det.pth"), det, epoch=1)
    npz = str(tmp_path / "det.npz")
    _jax_dump(det_sd, npz)
    fresh = trainval_rl.build_model(trainval_rl.parse_args(["--layers", "50"]), A, "cpu")
    want = warm_start_from_detector(fresh.state_dict(), det_sd)
    copied = [k for k in det_sd if k.startswith(("base.", "head."))]
    assert len(copied) > 200
    for path in (ckpt, npz):
        args = trainval_rl.parse_args(["--layers", "50", "--pretrained", path])
        got = trainval_rl.build_model(args, A, "cpu").state_dict()
        assert set(got) == set(want)
        for k in got:
            assert torch.equal(got[k], want[k]), (path, k)
        assert all(torch.equal(got[k], det_sd[k]) for k in copied)
        assert torch.equal(got["fc8.weight"], fresh.state_dict()["fc8.weight"])
    # a detector checkpoint is no --resume point for the RL net
    with pytest.raises(SystemExit, match="not an RL checkpoint"):
        trainval_rl.rl_checkpoint(ckpt)
