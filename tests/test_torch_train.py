"""The port's detector training against the JAX package, on the CPU in f32
(the kernels' plain versions run there): box encoding and masked overlaps,
the losses, the target layers fed the same uniforms, RoIAlignAvg's gradient,
the optimizer, the skip-step guard and one whole ResNet-50 train step.

The sampling draws of the JAX package come from `jax.random`; the port
draws from an explicit source (`models/targets.py`), which the tests replay
with the JAX draws: the uniforms the JAX functions derive from a key the
test chose, by the same splits. Then labels, keep indices and rois are
equal, not close. Tolerances: exact or 1e-6 for the elementwise formulas;
the whole step's losses 1e-4 relative and each trainable leaf's update 1e-3
of its max |update| (same f32 formulas, other summation orders in the convs
and GEMMs, and their gradients).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

import rlobjectdetection_tpu.models.faster_rcnn as jax_frcnn
from rlobjectdetection_tpu.config import Config as JaxConfig
from rlobjectdetection_tpu.config import TrainConfig as JaxTrainConfig
from rlobjectdetection_tpu.engine.optim import build_optimizer as jax_build_optimizer
from rlobjectdetection_tpu.engine.optim import make_lr_schedule as jax_make_lr_schedule
from rlobjectdetection_tpu.engine.optim import param_labels as jax_param_labels
from rlobjectdetection_tpu.engine.train import TrainState
from rlobjectdetection_tpu.engine.train import make_train_step as jax_make_train_step
from rlobjectdetection_tpu.models import FasterRCNN as JaxFasterRCNN
from rlobjectdetection_tpu.models import losses as jax_losses
from rlobjectdetection_tpu.models import targets as jax_targets
from rlobjectdetection_tpu.ops import boxes as jax_boxes
from rlobjectdetection_tpu.ops.roi_align import roi_align_avg as jax_roi_align_avg
from rlobjectdetection_tpu.ops.roi_align_vjp import roi_align_avg_cvjp
from rlobjectdetection_tpu_torch.config import Config, TrainConfig
from rlobjectdetection_tpu_torch.engine import build_optimizer, make_lr_schedule, make_train_step
from rlobjectdetection_tpu_torch.engine.checkpoint import state_dict_from_jax, torch_key
from rlobjectdetection_tpu_torch.engine.optim import clip_by_global_norm_, param_labels
from rlobjectdetection_tpu_torch.models import FasterRCNN, losses, targets
from rlobjectdetection_tpu_torch.ops import boxes, roi_align_kernel
from rlobjectdetection_tpu_torch.utils.guards import finite_mask

NUM_CLASSES = 21
LOSS_REL, UPDATE_REL = 1e-4, 1e-3
TRAIN_KW = dict(RPN_PRE_NMS_TOP_N=256, RPN_POST_NMS_TOP_N=64, BATCH_SIZE=32)
CFG_KW = dict(DTYPE="float32", NMS_TILE=64, ANCHOR_SCALES=(4, 8, 16, 32))
AT_KEY, PT_KEY = jax.random.PRNGKey(101), jax.random.PRNGKey(202)
LOSSES = ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box")


def max_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gt_boxes(rng, b, g, n_real, h, w):
    """[b, g, 5] gt boxes (x1, y1, x2, y2, cls), n_real[i] real rows, zero
    padding after."""
    gt = np.zeros((b, g, 5), np.float32)
    for i in range(b):
        for j in range(n_real[i]):
            x1, y1 = rng.randint(0, w - 24), rng.randint(0, h - 24)
            gt[i, j] = [x1, y1, min(x1 + rng.randint(12, 60), w - 1),
                        min(y1 + rng.randint(12, 60), h - 1), 1 + rng.randint(NUM_CLASSES - 1)]
    return gt


def _rand_boxes(rng, shape, lo, hi):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(0.0, (hi - lo) / 2, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


class Replay:
    """A `targets.Uniform` source that hands out given arrays in order,
    each checked against the shape asked for."""

    def __init__(self, arrays):
        self.arrays = [np.asarray(a, np.float32) for a in arrays]

    def __call__(self, shape):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a)


def anchor_draws(key, b, n):
    """anchor_target's uniforms, derived from `key` as the JAX function does:
    per image, `[N]` for the fg and the bg `_random_keep`."""
    kf, kb = jax.random.split(key)
    return [np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in jax.random.split(k2, b)])
            for k2 in (kf, kb)]


def proposal_draws(key, b, n, r):
    """proposal_target's uniforms: per image, `(n,)` fg priorities and `(R,)`
    slot draws from the two halves of its key."""
    pri, slot = [], []
    for ki in jax.random.split(key, b):
        k1, k3 = jax.random.split(ki, 2)
        pri.append(np.asarray(jax.random.uniform(k1, (n,))))
        slot.append(np.asarray(jax.random.uniform(k3, (r,))))
    return [np.stack(pri), np.stack(slot)]


# -- boxes and losses -------------------------------------------------------


def test_bbox_transform_matches_jax():
    rng = np.random.RandomState(0)
    ex, gt = _rand_boxes(rng, (3, 40), 0, 200), _rand_boxes(rng, (3, 40), 0, 200)
    want = np.asarray(jax_boxes.bbox_transform(jnp.asarray(ex), jnp.asarray(gt)))
    got = boxes.bbox_transform(_t(ex), _t(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bbox_overlaps_masked_matches_jax():
    """Zero-padded gt rows overlap 0, zero-area anchors -1; the argmax over
    gt breaks ties at the first index on both sides."""
    rng = np.random.RandomState(1)
    anchors = _rand_boxes(rng, (2, 60), 0, 150)
    anchors[:, :3] = [[5, 5, 5, 5], [0, 0, 0, 0], [40, 40, 40, 40]]
    gt = np.zeros((2, 7, 5), np.float32)
    gt[:, :4, :4] = _rand_boxes(rng, (2, 4), 0, 150)
    gt[:, 4, :4] = gt[:, 1, :4]                               # a duplicate: an exact tie
    want = np.asarray(jax_boxes.bbox_overlaps_masked(jnp.asarray(anchors), jnp.asarray(gt)))
    got = boxes.bbox_overlaps_masked(_t(anchors), _t(gt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert (want[:, 3:, 5:] == 0).all() and (want[:, :3] == -1).all()
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


@pytest.mark.parametrize("sigma,dims", [(3.0, (1, 2)), (1.0, (-1,))])
def test_smooth_l1_loss_matches_jax(sigma, dims):
    rng = np.random.RandomState(2)
    args = [rng.randn(2, 50, 4).astype(np.float32) * s for s in (0.5, 0.5, 1, 1)]
    args[2] = (args[2] > 0).astype(np.float32)
    args[3] = np.abs(args[3])
    want = float(jax_losses.smooth_l1_loss(*map(jnp.asarray, args), sigma=sigma,
                                           reduce_dims=dims))
    got = float(losses.smooth_l1_loss(*map(_t, args), sigma=sigma, reduce_dims=dims))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_jax(masked):
    rng = np.random.RandomState(3)
    logits = (rng.randn(2, 70, 5) * 4).astype(np.float32)
    labels = rng.randint(0, 5, (2, 70)).astype(np.int32)
    valid = rng.rand(2, 70) > 0.4 if masked else None
    want = float(jax_losses.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), None if valid is None else jnp.asarray(valid)))
    got = float(losses.softmax_cross_entropy(_t(logits), _t(labels),
                                             None if valid is None else _t(valid)))
    assert abs(got - want) <= 1e-6 * abs(want)
    if masked:       # an all-invalid mask divides by 1, not 0
        none = np.zeros_like(valid)
        assert float(losses.softmax_cross_entropy(_t(logits), _t(labels), _t(none))) == 0.0


# -- target layers ------------------------------------------------------------

AT_KW = dict(feat_stride=16, anchor_scales=(4, 8, 16, 32), anchor_ratios=(0.5, 1, 2),
             rpn_batch_size=64, fg_fraction=0.5)


@pytest.mark.parametrize("clobber", [False, True])
def test_anchor_target_matches_jax_under_replayed_draws(clobber):
    """Labels exact (the fg and bg subsampling included), targets and weights
    1e-6. The second image has no gt at all; im_info[0] bounds both."""
    rng = np.random.RandomState(4)
    h, w = 7, 9
    gt = _gt_boxes(rng, 2, 6, (5, 0), 112, 144)
    im_info = np.asarray([[100.0, 130.0, 1.0], [112.0, 144.0, 1.0]], np.float32)
    kw = dict(AT_KW, clobber_positives=clobber)
    want = jax_targets.anchor_target(AT_KEY, (h, w), jnp.asarray(gt), jnp.asarray(im_info), **kw)
    n = h * w * 12
    got = targets.anchor_target(Replay(anchor_draws(AT_KEY, 2, n)), (h, w), _t(gt),
                                _t(im_info), **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    labels = np.asarray(want.labels)
    # clobbering turns the best anchors of these gt boxes (IoU < 0.3) into bg
    assert (labels == 0).sum() > 0 and ((labels == 1).sum() > 0) != clobber
    for g, wnt in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bg_lo,far", [(0.1, False), (0.0, False), (0.1, True)])
def test_proposal_target_matches_jax_under_replayed_draws(bg_lo, far):
    """Labels and rois exact, targets and weights 1e-6: both pools
    (`bg_lo` 0.1 and 0), and with every proposal far from the gt boxes
    (`far`: the fg pool is the gt boxes alone, no bg), over an image with gt
    boxes and one with none (neither pool: candidate 0 as bg)."""
    rng = np.random.RandomState(5)
    b, p, r = 2, 40, 24
    gt = _gt_boxes(rng, b, 6, (4, 0), 100, 140)
    props = _rand_boxes(rng, (b, p), 0, 130)
    if far:
        props = np.tile(np.asarray([400, 400, 420, 430], np.float32), (b, p, 1))
    else:   # some proposals near the gt boxes, so fg candidates beyond the gt rows
        props[0, :8, :] = gt[0, np.arange(8) % 4, :4] + rng.uniform(-4, 4, (8, 4))
    rois = np.concatenate([np.repeat(np.arange(b, dtype=np.float32)[:, None, None], p, 1),
                           props], -1)
    kw = dict(rois_per_image=r, bg_thresh_lo=bg_lo)
    want = jax_targets.proposal_target(PT_KEY, jnp.asarray(rois), jnp.asarray(gt), **kw)
    got = targets.proposal_target(Replay(proposal_draws(PT_KEY, b, p + 6, r)), _t(rois),
                                  _t(gt), **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    for g, wnt in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-6, atol=1e-6)
    labels = np.asarray(want.labels)
    assert (labels[0] > 0).any() and (labels[1] == 0).all()


def test_random_keep_count_and_uniformity_from_a_generator():
    """The port's own draws (a torch.Generator): exactly min(budget, pool)
    kept, only from the pool, each pool element with probability
    budget / pool; the anchor layer's fg and bg counts keep their budgets."""
    n, budget, trials = 64, 8, 600
    mask = torch.zeros(n, dtype=torch.bool)
    mask[::2] = True                                          # 32 eligible
    src = targets.uniform_source(torch.Generator().manual_seed(0), "cpu")
    keep = targets._random_keep(src((trials, n)), mask.expand(trials, n), budget, budget)
    assert (keep.sum(1) == budget).all() and not keep[:, ~mask].any()
    p = keep[:, mask].float().mean(0).numpy()                 # expect budget / 32 = 0.25
    assert abs(p.mean() - 0.25) < 0.01
    assert p.min() > 0.15 and p.max() < 0.35                  # ~5 sigma at 600 trials
    assert torch.equal(targets._random_keep(src((1, n)), mask[None], 100, 64)[0], mask)
    assert not targets._random_keep(src((1, n)), mask[None], 0, 64).any()

    rng = np.random.RandomState(6)
    gt = _gt_boxes(rng, 2, 8, (8, 8), 160, 208)
    im_info = torch.tensor([[160.0, 208.0, 1.0]] * 2)
    for seed in range(4):
        at = targets.anchor_target(
            targets.uniform_source(torch.Generator().manual_seed(seed), "cpu"), (10, 13),
            _t(gt), im_info, **dict(AT_KW, rpn_batch_size=32))
        fg, bg = (at.labels == 1).sum(1), (at.labels == 0).sum(1)
        # fg to its 16; bg to 32 less the fg count before the fg subsampling
        assert (fg <= 16).all() and (fg > 0).all() and (bg > 0).all() and (fg + bg <= 32).all()


# -- RoIAlignAvg's gradient -----------------------------------------------------


def test_roi_align_avg_gradient_matches_both_jax_vjps():
    """The features' gradient on the CPU (the plain backward through the
    autograd Function) against `jax.vjp` of `roi_align_avg_cvjp` (the
    sorted-scatter backward) and of `roi_align_avg` (autodiff), f32, 1e-5:
    two images, rois partly outside the map."""
    rng = np.random.RandomState(7)
    feats = rng.randn(2, 9, 12, 40).astype(np.float32)
    rois = np.concatenate([rng.randint(0, 2, (30, 1)).astype(np.float32),
                           _rand_boxes(rng, (30,), -40, 200)], 1)
    rois[:3, 1:] = [[-60, -30, 80, 100], [150, 100, 260, 200], [30, 30, 30, 30]]
    g = rng.randn(30, 7, 7, 40).astype(np.float32)
    x = _t(feats).requires_grad_(True)
    roi_align_kernel.roi_align_avg(x, _t(rois)).backward(_t(g))
    for fn in (roi_align_avg_cvjp, jax_roi_align_avg):
        _, vjp = jax.vjp(lambda f: fn(f, jnp.asarray(rois), 7, 1.0 / 16.0), jnp.asarray(feats))
        want = np.asarray(vjp(jnp.asarray(g))[0])
        assert np.abs(want).max() > 0
        assert max_rel(x.grad.numpy(), want) <= 1e-5, fn.__name__


# -- optimizer ------------------------------------------------------------------


class _Toy(torch.nn.Module):
    """Parameters at paths the detector has: a frozen stem conv, a trainable
    stage conv, RPN weight and bias, a classifier, and a BN affine (frozen
    by name, as in the JAX labels)."""

    def __init__(self):
        super().__init__()
        mod = torch.nn.Module
        self.base = mod()
        self.base.conv1 = torch.nn.Conv2d(3, 4, 3, bias=False)
        self.base.layer2 = mod()
        self.base.layer2.block0 = mod()
        self.base.layer2.block0.conv1 = torch.nn.Conv2d(4, 6, 1, bias=False)
        self.rpn = mod()
        self.rpn.RPN_Conv = torch.nn.Conv2d(6, 5, 3)
        self.RCNN_cls_score = torch.nn.Linear(7, 3)
        self.head = mod()
        self.head.bn1 = mod()
        self.head.bn1.scale = torch.nn.Parameter(torch.ones(5))


def _jax_tree(named):
    """{torch name: array} → the JAX param tree at the same paths."""
    flat = {}
    for name, v in named.items():
        parts = name.split(".")
        parts[-1] = "kernel" if parts[-1] == "weight" else parts[-1]
        flat["/".join(parts)] = jnp.asarray(v)
    return traverse_util.unflatten_dict(flat, sep="/")


@pytest.mark.parametrize("clip_norm", [None, 0.5, 1e6])
def test_build_optimizer_matches_optax(clip_norm):
    """Three steps of the port's SGD against JAX `build_optimizer` on the same
    params and gradients: double bias LR, no bias decay, momentum, the step
    decay after 2 steps, frozen leaves untouched, the trainable-only clip
    (0.5 clips every step, 1e6 never)."""
    torch.manual_seed(0)
    model = _Toy()
    names = [n for n, _ in model.named_parameters()]
    init = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    sched_fn = make_lr_schedule(0.1, 2)
    opt, sched, labels = build_optimizer(model, "resnet50", 0.1, lr_schedule=sched_fn,
                                         clip_norm=clip_norm)
    assert labels == {"base.conv1.weight": "frozen", "base.layer2.block0.conv1.weight": "weight",
                      "rpn.RPN_Conv.weight": "weight", "rpn.RPN_Conv.bias": "bias",
                      "RCNN_cls_score.weight": "weight", "RCNN_cls_score.bias": "bias",
                      "head.bn1.scale": "frozen"}
    params = _jax_tree(init)
    tx, jlabels = jax_build_optimizer(params, "resnet50", 0.1,
                                      lr_schedule=jax_make_lr_schedule(0.1, 2),
                                      clip_norm=clip_norm)
    state = tx.init(params)
    rng = np.random.RandomState(8)
    for _ in range(3):
        grads = {n: (rng.randn(*init[n].shape) * 3).astype(np.float32) for n in names}
        for n, p in model.named_parameters():
            p.grad = None if labels[n] == "frozen" else _t(grads[n])
        opt.step()
        sched.step()
        updates, state = tx.update(_jax_tree(grads), state, params)
        params = optax.apply_updates(params, updates)
    want = {torch_key(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    for n, p in model.named_parameters():
        if labels[n] == "frozen":
            assert not p.requires_grad and np.array_equal(p.detach().numpy(), init[n]), n
        moved = np.abs(want[n] - init[n]).max()
        assert np.abs(p.detach().numpy() - want[n]).max() <= 1e-6 * max(moved, 1e-6), n
    assert sched.last_epoch == 3 and opt.param_groups[1]["lr"] == pytest.approx(2 * 0.01)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.RandomState(9)
    grads = [rng.randn(*s).astype(np.float32) for s in ((4, 5), (7,), (2, 3, 3))]
    for c in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(c).update([jnp.asarray(g) for g in grads], None)
        got = [_t(g.copy()) for g in grads]
        clip_by_global_norm_(got, c)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_param_labels_match_jax_leaf_by_leaf(train_models):
    """ResNet-50 against the JAX labels of its own params; VGG-16 against the
    JAX labels of a tree at the port's parameter and buffer paths. A JAX leaf
    the port holds as a buffer (frozen-BN constants) must be frozen there."""
    _, params, model, _ = train_models
    cases = [("resnet50", model, params)]
    vgg = FasterRCNN(NUM_CLASSES, "vgg16", Config(DTYPE="float32", POOLING_SIZE=2), device="cpu")
    cases.append(("vgg16", vgg, _jax_tree({k: np.zeros(1) for k in vgg.state_dict()})))
    for backbone, net, tree in cases:
        want = {torch_key(k): v for k, v in traverse_util.flatten_dict(
            jax_param_labels(tree, backbone), sep="/").items()}
        got = param_labels(net, backbone)
        names = dict(net.named_parameters())
        assert set(want) == set(net.state_dict())
        for k, label in want.items():
            assert got.get(k, "frozen") == label, (backbone, k)
            assert (k in names) or label == "frozen", (backbone, k)
        assert {"frozen", "weight", "bias"} == set(got.values())


def test_weights_load_in_place_into_the_optimizer(train_models):
    """A JAX dump loaded after `build_optimizer` lands in the tensors the
    optimizer holds: the weight bridge copies in place."""
    _, _, _, flat = train_models
    model = FasterRCNN(NUM_CLASSES, "resnet50", Config(**CFG_KW), device="cpu", seed=9)
    opt, _, _ = build_optimizer(model, "resnet50", 0.01)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    model.load_state_dict(state_dict_from_jax(flat, model))
    w = model.RCNN_cls_score.weight
    assert id(w) in held and len(held) == 52
    assert torch.equal(w.detach(), _t(flat["RCNN_cls_score/kernel"].T))


# -- the whole train step ---------------------------------------------------------


def _perturbed(params, rng):
    """Flat params with frozen-BN statistics away from the identity and the
    RPN outputs scaled to what a trained net gives (unscaled, the random
    backbone's features saturate the class sigmoid and the deltas)."""
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


def _batch():
    rng = np.random.RandomState(11)
    return dict(data=(rng.randn(2, 96, 128, 3) * 40).astype(np.float32),
                im_info=np.asarray([[96.0, 128.0, 1.0], [90.0, 120.0, 1.0]], np.float32),
                gt_boxes=_gt_boxes(rng, 2, 8, (4, 3), 96, 128),
                num_boxes=np.asarray([4, 3], np.int32))


def _port_model(flat):
    cfg = Config(TRAIN=TrainConfig(**TRAIN_KW), **CFG_KW, CONV1_FUSED=True, LAYER1_FUSED=True)
    model = FasterRCNN(NUM_CLASSES, "resnet50", cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(flat, model))
    return model


@pytest.fixture(scope="module")
def train_models():
    """(jax model, jax params, port model, flat params) sharing weights."""
    jcfg = JaxConfig(TRAIN=JaxTrainConfig(**TRAIN_KW), **CFG_KW)
    jmodel = JaxFasterRCNN(num_classes=NUM_CLASSES, backbone="resnet50", cfg=jcfg)
    b = _batch()
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": key, "sampling": key}, b["data"], b["im_info"], b["gt_boxes"],
        b["num_boxes"], train=True)
    flat = _perturbed(variables["params"], np.random.RandomState(7))
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return jmodel, params, _port_model(flat), flat


@pytest.fixture(scope="module")
def jax_step(train_models):
    """One JAX train step with its two target layers run under AT_KEY and
    PT_KEY (the step's own keys ignored), the monkeypatch undone after."""
    jmodel, params, _, _ = train_models
    tx, _ = jax_build_optimizer(params, "resnet50", base_lr=0.01)
    state = TrainState(params, tx.init(params), jnp.int32(0))
    orig_at, orig_pt = jax_frcnn.anchor_target, jax_frcnn.proposal_target
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_frcnn, "anchor_target", lambda key, *a, **kw: orig_at(AT_KEY, *a, **kw))
        mp.setattr(jax_frcnn, "proposal_target",
                   lambda key, *a, **kw: orig_pt(PT_KEY, *a, **kw))
        new_state, metrics = jax_make_train_step(jmodel, tx)(
            state, {k: jnp.asarray(v) for k, v in _batch().items()}, jax.random.PRNGKey(7))
    new_flat = {k: np.asarray(v) for k, v in
                traverse_util.flatten_dict(jax.device_get(new_state.params), sep="/").items()}
    return {k: np.asarray(v) for k, v in metrics.items()}, new_flat


def _step_draws():
    """The JAX step's draws at the test's size: a 6×8 map of 12 anchors, 64
    proposals + 8 gt rows an image, 32 rois an image."""
    return Replay(anchor_draws(AT_KEY, 2, 6 * 8 * 12)
                  + proposal_draws(PT_KEY, 2, TRAIN_KW["RPN_POST_NMS_TOP_N"] + 8,
                                   TRAIN_KW["BATCH_SIZE"]))


def test_train_step_matches_jax(train_models, jax_step):
    _, _, _, flat = train_models
    want_metrics, want_flat = jax_step
    model = _port_model(flat)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched, labels = build_optimizer(model, "resnet50", base_lr=0.01)
    metrics = make_train_step(model, opt, sched)({k: _t(v) for k, v in _batch().items()},
                                                 _step_draws())
    for k in LOSSES + ("loss",):
        got, want = float(metrics[k]), float(want_metrics[k])
        assert np.isfinite(want) and abs(got - want) <= LOSS_REL * abs(want), (k, got, want)
    assert int(metrics["fg_cnt"]) == int(want_metrics["fg_cnt"]) > 0
    assert int(metrics["bg_cnt"]) == int(want_metrics["bg_cnt"]) > 0

    after = model.state_dict()
    want_sd = state_dict_from_jax(want_flat, model)
    trainable = [k for k, v in labels.items() if v != "frozen"]
    assert len(trainable) == 52          # layer2-4, the RPN and both classifiers
    for k in trainable:
        want_up = (want_sd[k] - before[k]).numpy()
        got_up = (after[k] - before[k]).numpy()
        assert np.abs(want_up).max() > 0, k
        assert np.abs(got_up - want_up).max() <= UPDATE_REL * np.abs(want_up).max(), k
    for k in after:
        if k not in trainable:
            assert torch.equal(after[k], before[k]), k
            assert np.array_equal(want_sd[k].numpy(), before[k].numpy()), k


def test_skip_nonfinite_leaves_params_momentum_and_schedule(train_models):
    """A NaN gradient: `skipped` 1, the parameters, the momentum buffers and
    the schedule's count as they were; the next finite step goes through."""
    _, _, _, flat = train_models
    model = _port_model(flat)
    opt, sched, _ = build_optimizer(model, "resnet50", base_lr=0.001)
    step = make_train_step(model, opt, sched, skip_nonfinite=True)
    batch = {k: _t(v) for k, v in _batch().items()}
    gen = lambda seed: torch.Generator().manual_seed(seed)
    assert float(step(batch, gen(0))["skipped"]) == 0.0
    params = {k: v.clone() for k, v in model.state_dict().items()}
    momentum = {id(p): opt.state[p]["momentum_buffer"].clone() for p in opt.state}
    count, lrs = sched.last_epoch, [g["lr"] for g in opt.param_groups]
    hook = model.RCNN_cls_score.weight.register_hook(lambda g: g * float("nan"))
    metrics = step(batch, gen(1))
    hook.remove()
    assert float(metrics["skipped"]) == 1.0 and not bool(finite_mask(
        [model.RCNN_cls_score.weight.grad]))
    assert all(torch.equal(v, params[k]) for k, v in model.state_dict().items())
    assert all(torch.equal(opt.state[p]["momentum_buffer"], momentum[id(p)]) for p in opt.state)
    assert sched.last_epoch == count and [g["lr"] for g in opt.param_groups] == lrs
    assert float(step(batch, gen(1))["skipped"]) == 0.0 and sched.last_epoch == count + 1
    assert not torch.equal(model.RCNN_cls_score.weight, params["RCNN_cls_score.weight"])


def test_train_forward_refuses_what_is_not_ported(train_models):
    _, _, model, _ = train_models
    b = {k: _t(v) for k, v in _batch().items()}
    bad = dataclasses.replace(model.cfg, TRAIN=dataclasses.replace(model.cfg.TRAIN,
                                                                   RPN_POSITIVE_WEIGHT=0.5))
    model.cfg, cfg = bad, model.cfg
    try:
        with pytest.raises(ValueError, match="RPN_POSITIVE_WEIGHT"):
            model(b["data"], b["im_info"], b["gt_boxes"], train=True,
                  generator=torch.Generator())
    finally:
        model.cfg = cfg
    with pytest.raises(ValueError, match="gt_boxes and a generator"):
        model(b["data"], b["im_info"], train=True)
