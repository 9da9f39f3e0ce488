"""The port's training entry point (`engine/trainval_net.py`) against the
JAX package, on the CPU in f32 (the kernels' plain versions run there).

- the `tiny` test backbone: its parameter labels and `count_trainable`
  leaf by leaf, its train forward and one train step under the JAX step's
  sampling draws replayed (`test_torch_train.Replay`): losses 1e-4
  relative, each tensor's update 1e-3 of its largest;
- the loop: two steps of the JAX trainer's loop (`RoiBatchLoader.set_epoch`,
  `fold_in(PRNGKey(seed + 1), global_step)`, the step-decay schedule) and of
  the port's `train_epochs`, ResNet-50 with the stem and layer1 kernels on
  (their plain versions here) at 96×128, the same weights through the npz
  bridge. Each package's loader reads its own copy of one synthetic VOC
  devkit and gives the same batches, bit for bit (so does the port's
  packed loader, `--packed_input`'s); the anchor and proposal
  keys the JAX steps drew are recorded (`jax.debug.callback`) and their
  uniforms replayed into the port's steps. Each step's losses 1e-4
  relative; the final parameters 1e-3 of each tensor's largest update
  over both steps (momentum and the schedule's decay after step 1
  included), beyond one f32 spacing of the weight;
- the config order (`DATASET_OVERRIDES`, `--ls`, `--cfg`, `--set`,
  `--pooling_mode`, then the fused defaults) against the JAX trainer's;
- the step draws keyed on (seed, global step), and the flags whose
  counterparts wait, each exiting 2 with what it waits for.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import rlobjectdetection_tpu.models.faster_rcnn as jax_frcnn
from rlobjectdetection_tpu.config import DATASET_OVERRIDES as JAX_DATASET_OVERRIDES
from rlobjectdetection_tpu.config import LS_OVERRIDES as JAX_LS_OVERRIDES
from rlobjectdetection_tpu.config import Config as JaxConfig
from rlobjectdetection_tpu.config import TrainConfig as JaxTrainConfig
from rlobjectdetection_tpu.config import cfg_from_list as jax_cfg_from_list
from rlobjectdetection_tpu.config import cfg_update as jax_cfg_update
from rlobjectdetection_tpu.data import synthetic as jax_synthetic
from rlobjectdetection_tpu.data.imdb import combined_roidb as jax_combined_roidb
from rlobjectdetection_tpu.data.loader import RoiBatchLoader as JaxRoiBatchLoader
from rlobjectdetection_tpu.engine.checkpoint import save_net_npz
from rlobjectdetection_tpu.engine.optim import build_optimizer as jax_build_optimizer
from rlobjectdetection_tpu.engine.optim import count_trainable as jax_count_trainable
from rlobjectdetection_tpu.engine.optim import make_lr_schedule as jax_make_lr_schedule
from rlobjectdetection_tpu.engine.optim import param_labels as jax_param_labels
from rlobjectdetection_tpu.engine.train import TrainState
from rlobjectdetection_tpu.engine.train import make_train_step as jax_make_train_step
from rlobjectdetection_tpu.models import FasterRCNN as JaxFasterRCNN
from rlobjectdetection_tpu_torch.config import Config, TrainConfig
from rlobjectdetection_tpu_torch.data import synthetic
from rlobjectdetection_tpu_torch.data.imdb import combined_roidb
from rlobjectdetection_tpu_torch.data.loader import RoiBatchLoader
from rlobjectdetection_tpu_torch.data.packed import PackedRoiBatchLoader, pack_roidb
from rlobjectdetection_tpu_torch.engine import (build_optimizer, count_trainable,
                                                make_lr_schedule, make_train_step,
                                                trainval_net)
from rlobjectdetection_tpu_torch.engine.checkpoint import (load_net_npz, state_dict_from_jax,
                                                            torch_key)
from rlobjectdetection_tpu_torch.engine.optim import param_labels
from rlobjectdetection_tpu_torch.models import FasterRCNN
from test_torch_data import VOC_CLASSES, data_dir
from test_torch_train import Replay, _gt_boxes, _t, anchor_draws, proposal_draws
import torch_threads  # noqa: F401  (xdist workers share the cores)

LOSS_REL, UPDATE_REL = 1e-4, 1e-3
LOSSES = ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box")
TRAIN_KW = dict(RPN_PRE_NMS_TOP_N=256, RPN_POST_NMS_TOP_N=64, BATCH_SIZE=32)
CFG_KW = dict(DTYPE="float32", NMS_TILE=64, ANCHOR_SCALES=(4, 8, 16, 32))
AT_KEY, PT_KEY = jax.random.PRNGKey(11), jax.random.PRNGKey(22)
NUM_CLASSES = 21


def _flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


def _assert_losses(got, want):
    for k in LOSSES + ("loss",):
        g, w = float(got[k]), float(want[k])
        assert np.isfinite(w) and abs(g - w) <= LOSS_REL * abs(w), (k, g, w)
    assert int(got["fg_cnt"]) == int(want["fg_cnt"]) > 0
    assert int(got["bg_cnt"]) == int(want["bg_cnt"]) > 0


def _assert_updates(model, before, want_flat, labels):
    """Each trainable tensor's update within UPDATE_REL of its largest JAX
    update, beyond one f32 spacing of the weight (the rounding of storing
    p - update, which either side may round the other way); everything
    else unchanged."""
    after = model.state_dict()
    want = state_dict_from_jax(want_flat, model)
    for k in after:
        if labels.get(k, "frozen") == "frozen":
            assert torch.equal(after[k], before[k]), k
            continue
        want_up, got_up = (want[k] - before[k]).numpy(), (after[k] - before[k]).numpy()
        gap = np.abs(got_up - want_up) - np.spacing(np.abs(before[k].numpy()))
        assert np.abs(want_up).max() > 0, k
        assert gap.max() <= UPDATE_REL * np.abs(want_up).max(), k


# -- tiny ---------------------------------------------------------------------


def _tiny_batch():
    rng = np.random.RandomState(5)
    return dict(data=(rng.randn(2, 96, 128, 3) * 40).astype(np.float32),
                im_info=np.asarray([[96.0, 128.0, 1.0], [90.0, 120.0, 1.0]], np.float32),
                gt_boxes=_gt_boxes(rng, 2, 8, (4, 3), 96, 128),
                num_boxes=np.asarray([4, 3], np.int32))


def _tiny_draws():
    """The tiny step's draws: a 6×8 map of 12 anchors, 64 proposals + 8 gt
    rows an image, 32 rois an image."""
    return Replay(anchor_draws(AT_KEY, 2, 6 * 8 * 12)
                  + proposal_draws(PT_KEY, 2, TRAIN_KW["RPN_POST_NMS_TOP_N"] + 8,
                                   TRAIN_KW["BATCH_SIZE"]))


@pytest.fixture(scope="module")
def tiny():
    """(jax model, jax params, flat params) of the tiny detector, the RPN
    outputs scaled down so proposals do not tie."""
    cfg = JaxConfig(TRAIN=JaxTrainConfig(**TRAIN_KW), **CFG_KW)
    jmodel = JaxFasterRCNN(num_classes=NUM_CLASSES, backbone="tiny", cfg=cfg)
    b = _tiny_batch()
    key = jax.random.PRNGKey(0)
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": key, "sampling": key}, b["data"], b["im_info"], b["gt_boxes"],
        b["num_boxes"], train=True)["params"]
    flat = _flat(params)
    flat["rpn/RPN_cls_score/kernel"] = flat["rpn/RPN_cls_score/kernel"] * 0.3
    flat["rpn/RPN_bbox_pred/kernel"] = flat["rpn/RPN_bbox_pred/kernel"] * 0.02
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return jmodel, params, flat


def _tiny_port(flat):
    cfg = Config(TRAIN=TrainConfig(**TRAIN_KW), **CFG_KW)
    model = FasterRCNN(NUM_CLASSES, "tiny", cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(flat, model))
    return model


def test_tiny_labels_and_count_trainable_match_jax(tiny):
    """Nothing of the tiny base is frozen; every leaf has the JAX label and
    the counts are JAX's."""
    _, params, flat = tiny
    model = _tiny_port(flat)
    want = {torch_key(k): v for k, v in traverse_util.flatten_dict(
        jax_param_labels(params, "tiny"), sep="/").items()}
    got = param_labels(model, "tiny")
    assert got == want and set(want) == set(model.state_dict())
    assert count_trainable(got) == jax_count_trainable(jax_param_labels(params, "tiny"))
    assert count_trainable(got) == {"weight": 10, "bias": 10, "frozen": 0}
    assert got["base.stem0.weight"] == "weight" and got["head.fc.bias"] == "bias"


def _patched_targets(mp):
    orig_at, orig_pt = jax_frcnn.anchor_target, jax_frcnn.proposal_target
    mp.setattr(jax_frcnn, "anchor_target", lambda key, *a, **kw: orig_at(AT_KEY, *a, **kw))
    mp.setattr(jax_frcnn, "proposal_target", lambda key, *a, **kw: orig_pt(PT_KEY, *a, **kw))


def test_tiny_train_forward_matches_jax(tiny):
    """The train forward's losses, sampled rois and labels (exact), class
    probabilities and the label groups' deltas (1e-4)."""
    jmodel, params, flat = tiny
    b = _tiny_batch()
    with pytest.MonkeyPatch.context() as mp:
        _patched_targets(mp)
        want = jmodel.apply({"params": params}, *(jnp.asarray(b[k]) for k in
                            ("data", "im_info", "gt_boxes", "num_boxes")), train=True,
                            rngs={"sampling": jax.random.PRNGKey(1)})
    model = _tiny_port(flat)
    got = model(*(_t(b[k]) for k in ("data", "im_info", "gt_boxes", "num_boxes")), train=True,
                generator=_tiny_draws())
    for k in ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls", "rcnn_loss_bbox"):
        w = float(want[k])
        assert abs(float(got[k].detach()) - w) <= LOSS_REL * abs(w), k
    np.testing.assert_array_equal(got["rois"].numpy(), np.asarray(want["rois"]))
    np.testing.assert_array_equal(got["rois_label"].numpy(), np.asarray(want["rois_label"]))
    for k in ("cls_prob", "bbox_pred"):
        w = np.asarray(want[k])
        assert np.abs(got[k].detach().numpy() - w).max() <= 1e-4 * np.abs(w).max(), k


def test_tiny_train_step_matches_jax(tiny):
    jmodel, params, flat = tiny
    tx, _ = jax_build_optimizer(params, "tiny", base_lr=0.01)
    with pytest.MonkeyPatch.context() as mp:
        _patched_targets(mp)
        new_state, want = jax_make_train_step(jmodel, tx)(
            TrainState(params, tx.init(params), jnp.int32(0)),
            {k: jnp.asarray(v) for k, v in _tiny_batch().items()}, jax.random.PRNGKey(7))
    model = _tiny_port(flat)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched, labels = build_optimizer(model, "tiny", base_lr=0.01)
    got = make_train_step(model, opt, sched)({k: _t(v) for k, v in _tiny_batch().items()},
                                             _tiny_draws())
    _assert_losses(got, {k: np.asarray(v) for k, v in want.items()})
    _assert_updates(model, before, _flat(new_state.params), labels)


# -- the loop -------------------------------------------------------------------

# small enough that the random net's second step does not blow up (at 1e-3
# its loss is 20x the first's, and the port's own results move by 2e-3 of
# an update with the thread count), large enough that updates stay well
# above the weights' f32 spacing
LOOP_LR = 3e-4


@pytest.fixture(scope="module")
def loop_data(tmp_path_factory):
    """Each package's copy of a 4-image VOC devkit at 96×128, and each
    package's loader over it (batch 2, seed 3)."""
    jroot, proot = tmp_path_factory.mktemp("jax_loop"), tmp_path_factory.mktemp("port_loop")
    loaders = []
    for module, root, combine, loader in (
            (jax_synthetic, jroot, jax_combined_roidb, JaxRoiBatchLoader),
            (synthetic, proot, combined_roidb, RoiBatchLoader)):
        module.make_voc_devkit(str(root), num_images=4, image_size=(96, 128),
                               classes=VOC_CLASSES)
        with data_dir(root):
            _, roidb, ratio_list, ratio_index = combine("voc_2007_trainval", training=True,
                                                        use_flipped=False)
        loaders.append(loader(roidb, ratio_list, ratio_index, 2, scales=(96,), max_num_gt=20,
                              seed=3))
    return loaders


@pytest.fixture(scope="module")
def jax_loop(loop_data):
    """Two steps of the JAX trainer's loop over epoch 1's batches: (flat
    params before, each step's metrics, each step's anchor and proposal
    keys, flat params after)."""
    jloader, _ = loop_data
    cfg = JaxConfig(TRAIN=JaxTrainConfig(**TRAIN_KW), **CFG_KW)
    jmodel = JaxFasterRCNN(num_classes=NUM_CLASSES, backbone="resnet50", cfg=cfg)
    jloader.set_epoch(1)
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in jloader]
    key = jax.random.PRNGKey(0)
    b = batches[0]
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": key, "sampling": key}, b["data"], b["im_info"], b["gt_boxes"],
        b["num_boxes"], train=True)["params"]
    from test_torch_model import _perturbed

    flat0 = _perturbed(params, np.random.RandomState(7))
    # the classifiers scaled as `_perturbed` scales the RPN's outputs: at
    # the random net's scale the class logits reach ~20
    for k in ("RCNN_cls_score/kernel", "RCNN_bbox_pred/kernel"):
        flat0[k] = flat0[k] * 0.1
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat0.items()},
                                          sep="/")
    tx, _ = jax_build_optimizer(params, "resnet50", LOOP_LR,
                                lr_schedule=jax_make_lr_schedule(LOOP_LR, 1, 0.1))
    state = TrainState(params, tx.init(params), jnp.int32(0))
    keys = []
    record = lambda tag: (lambda k: keys.append((tag, np.asarray(k))))
    orig_at, orig_pt = jax_frcnn.anchor_target, jax_frcnn.proposal_target

    def at(key, *a, **kw):
        jax.debug.callback(record("at"), key)
        return orig_at(key, *a, **kw)

    def pt(key, *a, **kw):
        jax.debug.callback(record("pt"), key)
        return orig_pt(key, *a, **kw)

    metrics, step_keys = [], []
    step_key = jax.random.PRNGKey(cfg.RNG_SEED + 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_frcnn, "anchor_target", at)
        mp.setattr(jax_frcnn, "proposal_target", pt)
        step_fn = jax_make_train_step(jmodel, tx)
        for global_step, batch in enumerate(batches):
            keys.clear()
            state, m = step_fn(state, batch, jax.random.fold_in(step_key, global_step))
            metrics.append({k: np.asarray(v) for k, v in m.items()})
            got = dict(keys)
            assert len(keys) == 2 and set(got) == {"at", "pt"}
            step_keys.append((jnp.asarray(got["at"]), jnp.asarray(got["pt"])))
    return flat0, batches, metrics, step_keys, _flat(state.params)


def test_loaders_give_the_jax_batches_after_set_epoch(loop_data, jax_loop):
    _, port_loader = loop_data
    _, want, _, _, _ = jax_loop
    port_loader.set_epoch(1)
    got = list(port_loader)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("data", "im_info", "gt_boxes", "num_boxes"):
            assert g[k].dtype == np.asarray(w[k]).dtype and np.array_equal(g[k], w[k]), k


def test_packed_loader_gives_the_jax_batches_after_set_epoch(loop_data, jax_loop, tmp_path):
    """The port's loader over its roidb packed at the loop's scale
    (`--packed_input`, no longer refused): the JAX steps' batches, to the bit."""
    _, port_loader = loop_data
    _, want, _, _, _ = jax_loop
    pack_roidb(port_loader.roidb, port_loader.scales, str(tmp_path), verbose=False)
    packed = PackedRoiBatchLoader(port_loader.roidb, port_loader.ratio_list,
                                  port_loader.ratio_index, 2, scales=port_loader.scales,
                                  max_num_gt=20, seed=3, pack_root=str(tmp_path))
    packed.set_epoch(1)
    got = list(packed)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("data", "im_info", "gt_boxes", "num_boxes"):
            assert g[k].dtype == np.asarray(w[k]).dtype and np.array_equal(g[k], w[k]), k


def test_train_loop_matches_jax(loop_data, jax_loop, tmp_path):
    """`train_epochs` over the port loader: the batches each step sees are
    the JAX steps' to the bit, the losses 1e-4, the final parameters 1e-3
    of each tensor's largest update."""
    _, port_loader = loop_data
    flat0, batches, want_metrics, step_keys, want_flat = jax_loop
    npz = str(tmp_path / "res50.npz")
    save_net_npz(npz, traverse_util.unflatten_dict(flat0, sep="/"))
    cfg = Config(TRAIN=TrainConfig(**TRAIN_KW), **CFG_KW, CONV1_FUSED=True, LAYER1_FUSED=True)
    model = load_net_npz(npz, FasterRCNN(NUM_CLASSES, "resnet50", cfg, device="cpu"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched, labels = build_optimizer(model, "resnet50", LOOP_LR,
                                         lr_schedule=make_lr_schedule(LOOP_LR, 1, 0.1))
    step = make_train_step(model, opt, sched)
    seen, metrics = [], []

    def step_fn(batch, generator, dropout):
        seen.append({k: v.clone() for k, v in batch.items()})
        return step(batch, generator, dropout)

    def draws(global_step):
        at_key, pt_key = step_keys[global_step]
        return Replay(anchor_draws(at_key, 2, 6 * 8 * 12)
                      + proposal_draws(pt_key, 2, TRAIN_KW["RPN_POST_NMS_TOP_N"] + 20,
                                       TRAIN_KW["BATCH_SIZE"])), None

    global_step, history = trainval_net.train_epochs(
        model, port_loader, step_fn, draws, start_epoch=1, epochs=1,
        on_step=lambda epoch, it, gs, m: metrics.append(m))
    assert global_step == 2 and history[0]["images"] == 4 and history[0]["steps"] == 2
    assert sched.last_epoch == 2 and opt.param_groups[0]["lr"] == pytest.approx(LOOP_LR * 0.01)
    for got_b, want_b in zip(seen, batches):
        for k, v in got_b.items():
            assert np.array_equal(v.numpy(), np.asarray(want_b[k])), k
    for got, want in zip(metrics, want_metrics):
        _assert_losses(got, want)
    _assert_updates(model, before, want_flat, labels)


# -- config, draws, refused flags ------------------------------------------------


@pytest.mark.parametrize("dataset,ls,set_cfgs,pooling", [
    ("coco", False, None, None),
    ("pascal_voc", True, ["TRAIN.SCALES", "[512]", "POOLING_MODE", "crop"], "pool"),
    ("vg", False, ["CONV1_FUSED", "False"], None),
    ("coco", False, ["RESNET.FIXED_BLOCKS", "0"], "align"),
    ("coco", False, ["LAYER1_FUSED", "False"], None),
])
def test_train_config_follows_the_jax_trainer(dataset, ls, set_cfgs, pooling):
    """`serve.build_config` with the trainer's flags gives the JAX trainer's
    config: its order, and its fused defaults as on a TPU (the stem on
    unless --set turns it off, layer1 with it where FIXED_BLOCKS >= 1
    unless --set turns it off)."""
    from tools._env import enable_fused_tpu_defaults

    want = JaxConfig()
    want = jax_cfg_update(want, JAX_DATASET_OVERRIDES[dataset])
    if ls:
        want = jax_cfg_update(want, JAX_LS_OVERRIDES)
    if set_cfgs:
        want = jax_cfg_from_list(want, set_cfgs)
    if pooling:
        want = jax_cfg_update(want, {"POOLING_MODE": pooling})
    want = enable_fused_tpu_defaults(want, set_cfgs, on_tpu=True)
    got = trainval_net.build_config(dataset, set_cfgs, large_scale=ls, pooling_mode=pooling)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_step_draws_are_keyed_on_seed_and_step():
    """The same (seed, step) gives the same sampling and dropout streams,
    another step or seed other ones, and the two streams of a step differ."""
    def draw(seed, step):
        return [torch.rand(8, generator=g) for g in trainval_net.step_draws(seed, step, "cpu")]

    a, b = draw(3, 5), draw(3, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], draw(3, 6)[0]) and not torch.equal(a[0], draw(4, 5)[0])


@pytest.mark.parametrize("argv,item", [
    (["--dist_nprocs", "2"], "needs all of --dist_coordinator, --dist_nprocs and --dist_rank"),
    (["--dist_coordinator", "localhost:1", "--dist_nprocs", "2", "--dist_rank", "0", "--bs", "3"],
     "--bs 3 does not divide by the 2 processes"),
    (["--dist_coordinator", "localhost:1", "--dist_nprocs", "2", "--dist_rank", "2"],
     "rank 2 is outside a world of 2 processes"),
    (["--aot_cache", "x"], "no counterpart"),
    (["--o", "adam"], "trains SGD"),
])
def test_waiting_flags_exit_with_what_they_wait_for(argv, item, capsys):
    with pytest.raises(SystemExit) as e:
        trainval_net.main(["--dataset", "pascal_voc", *argv, "--device", "cpu"])
    assert e.value.code == 2 and item in capsys.readouterr().err.replace("\n", " ")
