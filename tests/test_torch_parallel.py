"""The port's data-parallel train steps (`parallel/`, the DP step of both
CLIs) on the CPU: ranks spawned on a gloo group (`parallel/dryrun.py`'s
`launch`), in f32 (the kernels' plain versions run there).

- the 2-rank detector step (one image a rank, `tiny` and ResNet-50 at
  96×128 with the stem and layer1 kernels on) against the port's
  one-process step on the same global batch: losses 1e-6 relative, each
  gradient and updated parameter 1e-5 of its tensor's largest (the
  gradient is the ranks' mean, a reassociated sum); ResNet-50's gradients
  5e-5, with the reason at the test;
- the same 2-rank step, `tiny`, against the JAX package's step on the same
  weights with its draws replayed (PR 7's bounds: losses 1e-4, updates
  1e-3); its two images sample different numbers of RPN anchors, so the
  global normalisation of the RPN's cross-entropy is what makes it equal;
- the RL step at world 2 on a ragged batch of 3 (the rank with one real
  image pads a zero-weight one) against the one-process step on the 3,
  and against the JAX package's step on the 3 on one device (the JAX
  CLI's rule for a ragged batch): loss 1e-4, gradients and updates at
  the one-process RL step's 2e-3 against JAX, with the reason at the test.
The sliced loader, the launcher rules, the CLI over two processes and the
dry run are in `test_torch_parallel_cli.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from rlobjectdetection_tpu.config import RLConfig as JaxRLConfig
from rlobjectdetection_tpu.engine.optim import build_optimizer as jax_build_optimizer
from rlobjectdetection_tpu.engine.train import TrainState
from rlobjectdetection_tpu.engine.train import make_train_step as jax_make_train_step
from rlobjectdetection_tpu.models.rl import RLPolicyNet as JaxRLPolicyNet
from rlobjectdetection_tpu_torch.config import Config, TrainConfig
from rlobjectdetection_tpu_torch.engine.checkpoint import state_dict_from_jax
from rlobjectdetection_tpu_torch.models import FasterRCNN, targets
from rlobjectdetection_tpu_torch.parallel.dryrun import launch, run_spec
from test_torch_rl import GRAD_REL as RL_GRAD_REL
from test_torch_rl import _optax_chain
from test_torch_train import _gt_boxes, anchor_draws, proposal_draws
from test_torch_trainval import (AT_KEY, CFG_KW, NUM_CLASSES, PT_KEY, TRAIN_KW, _flat,
                                 _patched_targets, _tiny_batch, tiny)  # noqa: F401 (fixture)
import torch_threads  # noqa: F401  (xdist workers share the cores)

LOSS_REL, GRAD_REL = 1e-6, 1e-5
JAX_LOSS_REL, JAX_UPDATE_REL = 1e-4, 1e-3


def _cfg(**kw):
    return Config(TRAIN=TrainConfig(**TRAIN_KW), **CFG_KW, **kw)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _assert_ranks_match_one(two, one, keys, grad_rel=GRAD_REL):
    for k in keys:
        g, w = two[0]["metrics"][k], one["metrics"][k]
        assert all(r["metrics"][k] == g for r in two), k       # global, on every rank
        assert abs(g - w) <= LOSS_REL * abs(w), (k, g, w)
    assert two[0]["grads"].keys() == one["grads"].keys() and one["grads"]
    for k in one["grads"]:
        assert _rel(two[0]["grads"][k], one["grads"][k]) <= grad_rel, k
        assert _rel(two[0]["params"][k], one["params"][k]) <= grad_rel, k


# -- the detector step --------------------------------------------------------------


@pytest.mark.parametrize("backbone,grad_rel", [("tiny", GRAD_REL), ("resnet50", 5e-5)])
def test_two_rank_step_matches_one_process(backbone, grad_rel):
    """ResNet-50's gradients and updates are held at 5e-5: its convolutions
    give one image alone and two together features 7.5e-7 apart (oneDNN
    blocks the batches otherwise), which its backward carries to 1.4e-5 of
    layer2's first gradient; with its ReLU gates where rounding decides them taken
    from the one-process run (`resnet_ties`), each within 5e-5 of its gate's
    largest input for the same reason (1.05e-5 measured): a tie, not a
    difference."""
    rng = np.random.RandomState(11)
    batch = dict(data=(rng.randn(2, 96, 128, 3) * 40).astype(np.float32),
                 im_info=np.asarray([[96.0, 128.0, 1.0], [90.0, 120.0, 1.0]], np.float32),
                 gt_boxes=_gt_boxes(rng, 2, 8, (4, 3), 96, 128),
                 num_boxes=np.asarray([4, 3], np.int32))
    spec = dict(kind="detector", backbone=backbone, num_classes=NUM_CLASSES,
                cfg=_cfg(CONV1_FUSED=True, LAYER1_FUSED=True), batch=batch, draw_seed=7,
                lr=0.01, device="cpu")
    resnet = backbone != "tiny"
    one = run_spec({**spec, "record_ties": resnet})
    two = launch(2, {**spec, "ties": one.get("ties")})
    _assert_ranks_match_one(two, one, ("loss", "rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box",
                                       "fg_cnt", "bg_cnt"), grad_rel)
    assert one["metrics"]["fg_cnt"] > 0
    if resnet:
        assert all(r["tie_counts"]["flipped_max"] <= grad_rel for r in two), \
            [r["tie_counts"] for r in two]


def test_two_rank_step_matches_jax(tiny):
    jmodel, params, flat = tiny
    b = _tiny_batch()
    tx, _ = jax_build_optimizer(params, "tiny", base_lr=0.01)
    with pytest.MonkeyPatch.context() as mp:
        _patched_targets(mp)
        new_state, want = jax_make_train_step(jmodel, tx)(
            TrainState(params, tx.init(params), jnp.int32(0)),
            {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(7))
    want_flat = _flat(new_state.params)

    draws = (anchor_draws(AT_KEY, 2, 6 * 8 * 12)
             + proposal_draws(PT_KEY, 2, TRAIN_KW["RPN_POST_NMS_TOP_N"] + 8,
                              TRAIN_KW["BATCH_SIZE"]))
    # the ranks' RPN sample counts differ: each rank's mean alone would be wrong
    at = targets.anchor_target(
        lambda shape, d=list(draws[:2]): torch.from_numpy(d.pop(0)), (6, 8),
        torch.from_numpy(b["gt_boxes"]), torch.from_numpy(b["im_info"]), feat_stride=16,
        anchor_scales=CFG_KW["ANCHOR_SCALES"], anchor_ratios=(0.5, 1, 2))
    counts = (at.labels >= 0).sum(1).tolist()
    assert counts[0] != counts[1], counts

    model = FasterRCNN(NUM_CLASSES, "tiny", _cfg(), device="cpu")
    state = state_dict_from_jax(flat, model)
    spec = dict(kind="detector", backbone="tiny", num_classes=NUM_CLASSES, cfg=_cfg(),
                state=state, batch=b, draws=draws, lr=0.01, device="cpu")
    got = launch(2, spec)[0]
    for k in ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "loss"):
        w = float(want[k])
        assert abs(got["metrics"][k] - w) <= JAX_LOSS_REL * abs(w), (k, got["metrics"][k], w)
    assert got["metrics"]["fg_cnt"] == int(want["fg_cnt"]) > 0
    assert got["metrics"]["bg_cnt"] == int(want["bg_cnt"]) > 0
    want_sd = state_dict_from_jax(want_flat, model)
    assert len(got["params"]) == 20
    for k, after in got["params"].items():
        want_up, got_up = want_sd[k] - state[k], after - state[k]
        assert want_up.abs().max() > 0, k
        assert (got_up - want_up).abs().max() <= JAX_UPDATE_REL * want_up.abs().max(), k


# -- the RL step ------------------------------------------------------------------------


def _rl_ragged_batch(counts=(5, 5, 5), n=16, a=56, h=96, w=128):
    """`train_arrays` of len(counts) images with those detections of n
    slots, as the collate lays them out."""
    rng = np.random.RandomState(3)
    b = len(counts)
    bboxes = np.zeros((b, n, 8), np.float32)
    weights = np.zeros((b, n, a), np.float32)
    targets_ = np.where(rng.rand(b, n, a) < 0.3, 1.0, -1.0).astype(np.float32)
    for i, c in enumerate(counts):
        xy = rng.uniform(0, 60, (c, 2))
        bboxes[i, :c, 0] = i
        bboxes[i, :c, 1:3] = xy
        bboxes[i, :c, 3:5] = xy + rng.uniform(16, 48, (c, 2))
        weights[i, :c] = rng.uniform(0.2, 2.0, (c, a))
        targets_[i, c:] = 0.0
    return dict(data=rng.randn(b, h, w, 3).astype(np.float32), bboxes=bboxes,
                targets=targets_, weights=weights, num_dts=np.asarray(counts, np.int32))


def test_rl_two_rank_step_on_a_ragged_batch_matches_one_process():
    """A global batch of 3 at world 2: rank 1 holds image 2 and a zero image
    (no weight, outside the loss's denominator); every image has the
    batch's most detections, so the logged unweighted term is exact too.
    ResNet-18's layout: 2 blocks a stage."""
    spec = dict(kind="rl", num_acts=56, layers=18, batch=_rl_ragged_batch(), lr=0.01,
                device="cpu")
    two, one = launch(2, spec, meanwhile=lambda: run_spec(spec))
    _assert_ranks_match_one(two, one, ("loss", "noweight"))


def test_rl_two_rank_step_on_a_ragged_batch_matches_jax():
    """A ragged batch of 3 at world 2 against the JAX package's step on the
    3 on one device, on the same weights (frozen BN statistics drawn away
    from the identity). The images hold 5, 7 and 3 detections, so rank 1's
    own most (3) is not the batch's (7): the global denominator B · max_n ·
    A and the zero-weight image are held against JAX itself. The loss
    1e-4; each parameter's gradient and update at `test_torch_rl.py`'s
    bound for the one-process step against JAX, 2e-3 of the tensor's
    largest, not the detector's 1e-3: layer4's ReLU gates within rounding
    of 0 put layer4.block1.conv2's gradient 1.59e-3 from JAX's here, in one
    process as on two ranks (which equal one process at 1e-5, above). The
    learning rate is 1: at 0.01 a BN scale's update, ~5e-7 of the scale,
    is below the f32 spacing of the parameter it is read from. The logged
    unweighted term is not compared: a rank's rows past an image's
    detections pool its own first image, not the batch's
    (`shard_rl_batch`)."""
    arrays = _rl_ragged_batch((5, 7, 3))
    jnet = JaxRLPolicyNet(num_acts=56, num_layers=18)
    jin = [jnp.asarray(arrays[k]) for k in ("data", "bboxes", "targets", "weights", "num_dts")]
    params = jax.jit(jnet.init)({"params": jax.random.PRNGKey(0)}, *jin[:4])["params"]
    rng = np.random.RandomState(7)
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[1]
        if "bn" in k and leaf in ("scale", "var"):
            flat[k] = (0.7 + 0.3 * rng.rand(*v.shape)).astype(np.float32)
        elif "bn" in k and leaf in ("bias", "mean"):
            flat[k] = (0.05 * rng.randn(*v.shape)).astype(np.float32)
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                                          sep="/")
    tx, _ = _optax_chain(params, dataclasses.replace(JaxRLConfig(), learning_rate=1.0), 1)

    @jax.jit
    def step(p, s):
        def loss_fn(q):
            return jnet.apply({"params": q}, *jin)[1]

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), grads, loss

    as_sd = lambda tree: state_dict_from_jax({k: np.asarray(v) for k, v in
                                              traverse_util.flatten_dict(
                                                  jax.device_get(tree), sep="/").items()})
    new_params, grads, loss = step(params, tx.init(params))
    want_sd, want_grads = as_sd(new_params), as_sd(grads)
    state = state_dict_from_jax(flat)
    spec = dict(kind="rl", num_acts=56, layers=18, batch=arrays, lr=1.0, device="cpu",
                state=state)
    two = launch(2, spec)
    got = two[0]["metrics"]["loss"]
    assert all(r["metrics"]["loss"] == got for r in two)
    assert abs(got - float(loss)) <= JAX_LOSS_REL * abs(float(loss)), (got, float(loss))
    assert two[0]["params"]
    for k, after in two[0]["params"].items():
        assert _rel(two[0]["grads"][k], want_grads[k]) <= RL_GRAD_REL, k
        want_up, got_up = want_sd[k] - state[k], after - state[k]
        assert want_up.abs().max() > 0, k
        assert (got_up - want_up).abs().max() <= RL_GRAD_REL * want_up.abs().max(), k


