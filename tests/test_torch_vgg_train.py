"""The port's VGG-16 training against the JAX package, on the CPU in f32 (the
block-1 kernel's plain version runs there): the head's dropout, the frozen
blocks 1-2 and one whole train step with the global-norm clip.

Dropout draws are replayed, not rederived: flax makes each `nn.Dropout`'s
key from the module path, and the test records the uniforms instead. It
patches `jax.random.bernoulli` (as `flax.linen.stochastic` calls it) to
draw `u = jax.random.uniform(key, shape)` and return `u < p`, as
`jax.random.bernoulli` does, and to hand `u` back to the host. The port's
dropout source replays those uniforms in call order, fc6's then fc7's, so
the masks are equal, not close. Sampling draws are replayed as in
tests/test_torch_train.py. Tolerances: the dropout exact in f32 and bf16;
head outputs and gradients 1e-4 of the largest (same f32 formulas, other
summation orders in the GEMMs and convs); the step's losses 1e-4 relative
and each trainable leaf's update 1e-3 of its max |update|, as for ResNet.

Max-pool routes and ReLU gates are replayed too. A 2×2 window of pool3 or
pool4 whose two largest inputs lie within rounding of each other sends its
gradient by the last bit of a conv sum, and a conv output within rounding
of 0 opens its ReLU gate or not by it; every conv below takes the
difference. At this step's input one window in each pool lies within 1e-6,
and two conv outputs lie on opposite sides of 0 (conv4_1's at -2.1e-6 in
JAX, +2.1e-6 in the port); they moved conv3_1..conv4_3's updates by up to
2.9e-3 of their largest. So the test records the JAX step's pooled inputs
and ReLU inputs (`JaxTies`), and the port's step takes those decisions
where its own would differ (`vgg_ties.replay`: the port's own forward, each
window's gradient sent to JAX's first largest element, a conv output on
the wrong side of 0 negated). Then every update holds 1e-3 (measured
1.6e-4 at most).
"""

import flax.linen as nn
import flax.linen.stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_train import (AT_KEY, LOSS_REL, LOSSES, PT_KEY, TRAIN_KW, UPDATE_REL, Replay,
                              _batch, _perturbed, _step_draws, max_rel)

import rlobjectdetection_tpu.models.faster_rcnn as jax_frcnn
from rlobjectdetection_tpu.config import Config as JaxConfig
from rlobjectdetection_tpu.config import TrainConfig as JaxTrainConfig
from rlobjectdetection_tpu.engine.optim import build_optimizer as jax_build_optimizer
from rlobjectdetection_tpu.engine.train import TrainState
from rlobjectdetection_tpu.engine.train import make_train_step as jax_make_train_step
from rlobjectdetection_tpu.models import FasterRCNN as JaxFasterRCNN
from rlobjectdetection_tpu.models.backbones.vgg import VGGBase as JaxVGGBase
from rlobjectdetection_tpu.models.backbones.vgg import VGGHead as JaxVGGHead
from rlobjectdetection_tpu_torch.config import Config, TrainConfig
from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step
from rlobjectdetection_tpu_torch.engine.checkpoint import state_dict_from_jax
from rlobjectdetection_tpu_torch.models import FasterRCNN
from rlobjectdetection_tpu_torch.models.backbones import vgg as port_vgg
from rlobjectdetection_tpu_torch.models.backbones import vgg_ties
from rlobjectdetection_tpu_torch.models.backbones.vgg import VGGBase, VGGHead, apply_dropout
from rlobjectdetection_tpu_torch.ops import vgg_block1_kernel
import torch_threads  # noqa: F401  (xdist workers share the cores)

NUM_CLASSES = 21
# POOLING_SIZE cut to 2: fc6 takes 512·2·2 inputs, not 25088
CFG_KW = dict(DTYPE="float32", NMS_TILE=64, ANCHOR_SCALES=(4, 8, 16, 32), POOLING_SIZE=2)
DROP_KEY = jax.random.PRNGKey(303)
BASE_CONVS = tuple(f"conv{b}_{i}" for b, n, _ in port_vgg.VGG16_CFG for i in range(1, n + 1))


class DropoutRecorder:
    """Patches `jax.random.bernoulli` as flax's Dropout calls it: the mask
    is `u < p` of `u = jax.random.uniform(key, shape)`, and `u` comes back
    to the host, in trace order (`draws`), jitted or not."""

    def __init__(self, mp):
        self.draws = {}
        self.calls = 0
        mp.setattr(flax.linen.stochastic.random, "bernoulli", self)

    def __call__(self, key, p, shape):
        u = jax.random.uniform(key, shape)
        i = self.calls
        self.calls += 1
        jax.debug.callback(lambda v: self.draws.__setitem__(i, np.asarray(v)), u)
        return u < p

    def replay(self):
        return Replay([self.draws[i] for i in range(self.calls)])


class JaxTies:
    """Patches flax's `nn.max_pool` and `nn.relu` as the JAX VGG base calls
    them: each pooled input comes back to the host keyed by its channels
    (unique to each pool), and the first 13 ReLU inputs (the base's convs
    in trace order) as their signs. `ties()` puts them in the form
    `vgg_ties.replay` takes: each window's first largest element (the one
    JAX's max-pool gradient takes) and conv3_1..conv5_3's positive outputs,
    NCHW."""

    def __init__(self, mp):
        self.pools, self.positive, self.relus = {}, {}, 0
        pool, relu = nn.max_pool, nn.relu

        def record_pool(x, *a, **kw):
            jax.debug.callback(lambda v: self.pools.__setitem__(v.shape[-1], np.asarray(v)), x)
            return pool(x, *a, **kw)

        def record_relu(x):
            i = self.relus
            self.relus += 1
            if i < len(BASE_CONVS):
                jax.debug.callback(lambda v: self.positive.__setitem__(BASE_CONVS[i],
                                                                       np.asarray(v) > 0), x)
            return relu(x)

        mp.setattr(nn, "max_pool", record_pool)
        mp.setattr(nn, "relu", record_relu)

    def ties(self):
        return {"pool": {c: vgg_ties.first_max_nhwc(x) for c, x in self.pools.items()},
                "positive": {n: torch.from_numpy(self.positive[n]).permute(0, 3, 1, 2)
                             for n in vgg_ties.TRAINED_CONVS}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_matches_flax_bit_for_bit(dtype):
    """flax `nn.Dropout(0.5)` in train against `apply_dropout` on the same
    input and uniforms: keep `u < 0.5`, kept values `x / 0.5` in x's dtype."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    x = np.random.RandomState(0).randn(64, 4096).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        rec = DropoutRecorder(mp)
        want = nn.Dropout(0.5).apply({}, jnp.asarray(x, jdt), deterministic=False,
                                     rngs={"dropout": DROP_KEY})
    got = apply_dropout(torch.from_numpy(x).to(dtype), rec.replay())
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == dtype and 0.45 < (want == 0).mean() < 0.55
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_vgg_head_dropout_matches_jax_under_replayed_masks():
    """The train head (fc6, ReLU, dropout, fc7, ReLU, dropout) against the
    JAX VGGHead: the same units dropped after fc7, the outputs 1e-4."""
    rng = np.random.RandomState(1)
    pooled = np.maximum(rng.randn(40, 2, 2, 512), 0).astype(np.float32)
    jhead = JaxVGGHead(dtype=jnp.float32)
    params = jhead.init(jax.random.PRNGKey(4), jnp.asarray(pooled))["params"]
    with pytest.MonkeyPatch.context() as mp:
        rec = DropoutRecorder(mp)
        want = np.asarray(jhead.apply({"params": params}, jnp.asarray(pooled), train=True,
                                      rngs={"dropout": DROP_KEY}))
    assert rec.calls == 2
    head = VGGHead(pooled_size=2)
    head.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}, head))
    with torch.no_grad():
        got = head(torch.from_numpy(pooled), train=True, dropout=rec.replay()).numpy()
        evaluated = head(torch.from_numpy(pooled)).numpy()
    dropped = rec.draws[1] >= 0.5
    assert (got[dropped] == 0).all() and (want[dropped] == 0).all()
    assert max_rel(got, want) < 1e-4
    assert not np.array_equal(evaluated, got)                 # eval draws no dropout
    with pytest.raises(ValueError, match="dropout source"):
        head(torch.from_numpy(pooled), train=True)


@pytest.mark.parametrize("conv1_fused", [False, True])
def test_vgg_base_frozen_blocks_match_jax_gradient(conv1_fused):
    """Blocks 1-2 take no gradient (frozen at construction, the activation
    detached after block 2, so the block-1 kernel's forward-only rule does
    not fire); conv3_1..conv5_3 get JAX's gradient, 1e-4 of the largest."""
    rng = np.random.RandomState(2)
    x = (rng.randn(1, 64, 80, 3) * 20).astype(np.float32)
    ct = rng.randn(1, 4, 5, 512).astype(np.float32)
    jbase = JaxVGGBase(dtype=jnp.float32)
    params = jbase.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    grads = jax.grad(lambda p: (jbase.apply({"params": p}, jnp.asarray(x)) * ct).sum())(params)
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(grads, sep="/").items()}
    base = VGGBase(torch.float32, conv1_fused=conv1_fused)
    base.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}, base))
    n0 = vgg_block1_kernel.fused_vgg_block1.launches
    (base(torch.from_numpy(x)) * torch.from_numpy(ct)).sum().backward()
    assert vgg_block1_kernel.fused_vgg_block1.launches == n0       # plain version on the CPU
    for name, p in base.named_parameters():
        block = int(name[4])
        jkey = name.replace(".weight", "/kernel").replace(".bias", "/bias")
        if block <= 2:
            assert not p.requires_grad and p.grad is None, name
            assert not np.abs(want[jkey]).any(), name
            continue
        g = p.grad.numpy()
        g = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
        assert np.abs(want[jkey]).max() > 0 and max_rel(g, want[jkey]) < 1e-4, name


def _port_vgg(flat):
    cfg = Config(TRAIN=TrainConfig(**TRAIN_KW), **CFG_KW, CONV1_FUSED=True)
    model = FasterRCNN(NUM_CLASSES, "vgg16", cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(flat, model))
    return model


@pytest.fixture(scope="module")
def vgg_models():
    """(jax model, jax params, flat params) of a VGG-16 detector at the
    test's size, the RPN outputs scaled as for ResNet."""
    jcfg = JaxConfig(TRAIN=JaxTrainConfig(**TRAIN_KW), **CFG_KW)
    jmodel = JaxFasterRCNN(num_classes=NUM_CLASSES, backbone="vgg16", cfg=jcfg)
    b = _batch()
    key = jax.random.PRNGKey(1)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": key, "sampling": key, "dropout": key}, b["data"], b["im_info"],
        b["gt_boxes"], b["num_boxes"], train=True)
    flat = _perturbed(variables["params"], np.random.RandomState(7))
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return jmodel, params, flat


def _jax_vgg_step(jmodel, params, clip_norm):
    """One JAX `make_train_step` with clip_norm, its target layers under
    AT_KEY and PT_KEY and its dropout uniforms, pool routes and ReLU gates
    recorded: (metrics, new flat params, the dropout replay, the ties)."""
    tx, _ = jax_build_optimizer(params, "vgg16", base_lr=0.01, clip_norm=clip_norm)
    state = TrainState(params, tx.init(params), jnp.int32(0))
    orig_at, orig_pt = jax_frcnn.anchor_target, jax_frcnn.proposal_target
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_frcnn, "anchor_target", lambda key, *a, **kw: orig_at(AT_KEY, *a, **kw))
        mp.setattr(jax_frcnn, "proposal_target",
                   lambda key, *a, **kw: orig_pt(PT_KEY, *a, **kw))
        rec = DropoutRecorder(mp)
        ties = JaxTies(mp)
        new_state, metrics = jax_make_train_step(jmodel, tx)(
            state, {k: jnp.asarray(v) for k, v in _batch().items()}, jax.random.PRNGKey(7))
        jax.block_until_ready(new_state)
    assert rec.calls == 2 and rec.draws[0].shape == (2 * TRAIN_KW["BATCH_SIZE"], 4096)
    assert sorted(ties.pools) == [64, 128, 256, 512]                 # pool1..pool4
    new_flat = {k: np.asarray(v) for k, v in
                traverse_util.flatten_dict(jax.device_get(new_state.params), sep="/").items()}
    return {k: np.asarray(v) for k, v in metrics.items()}, new_flat, rec.replay(), ties.ties()


# 10, the reference's clip, is below this step's global norm (27.8), so it
# engages; 1e4 does not
@pytest.mark.parametrize("clip_norm,engages", [(10.0, True), (1e4, False)])
def test_vgg16_train_step_matches_jax(vgg_models, clip_norm, engages):
    """One VGG-16 step from identical params, sampling and dropout draws,
    with JAX's max-pool routes and ReLU gates: the four losses 1e-4, the fg/bg counts equal, every
    trainable update 1e-3 of its leaf's largest, blocks 1-2 untouched; the
    clip sees the trainable gradients only (the frozen ones are never
    computed)."""
    jmodel, params, flat = vgg_models
    want_metrics, want_flat, drops, ties = _jax_vgg_step(jmodel, params, clip_norm)
    model = _port_vgg(flat)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched, labels = build_optimizer(model, "vgg16", base_lr=0.01, clip_norm=clip_norm)
    counts = {}
    with vgg_ties.replay(model.base, ties, counts):
        metrics = make_train_step(model, opt, sched)({k: torch.from_numpy(v) for k, v in
                                                      _batch().items()}, _step_draws(), drops)
    # pool2..pool4 (pool1 is in block 1); every decision taken was a tie
    # (measured 2.8e-7 and 1.3e-7 of the layer's largest)
    assert counts["pools"] == 3 and counts["routed"] < 1e-5 and counts["flipped_max"] < 1e-5
    for k in LOSSES + ("loss",):
        got, want = float(metrics[k]), float(want_metrics[k])
        assert np.isfinite(want) and abs(got - want) <= LOSS_REL * abs(want), (k, got, want)
    assert int(metrics["fg_cnt"]) == int(want_metrics["fg_cnt"]) > 0
    assert int(metrics["bg_cnt"]) == int(want_metrics["bg_cnt"]) > 0

    trainable = [k for k, v in labels.items() if v != "frozen"]
    assert len(trainable) == 32 and not any(k.startswith(("base.conv1", "base.conv2"))
                                            for k in trainable)
    for name, p in model.named_parameters():
        assert (p.grad is not None) == (name in trainable) == p.requires_grad, name
    norm = float(opt.grad_norm)
    clipped = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for g in opt.param_groups for p in g["params"]])))
    assert (norm > clip_norm) == engages
    assert clipped == pytest.approx(min(norm, clip_norm), rel=1e-5)

    after = model.state_dict()
    want_sd = state_dict_from_jax(want_flat, model)
    for k in trainable:
        want_up = (want_sd[k] - before[k]).numpy()
        got_up = (after[k] - before[k]).numpy()
        assert np.abs(want_up).max() > 0, k
        assert np.abs(got_up - want_up).max() <= UPDATE_REL * np.abs(want_up).max(), k
    for k in after:
        if k not in trainable:
            assert torch.equal(after[k], before[k]), k


def test_vgg16_dropout_draws_follow_the_sampling_draws(vgg_models):
    """Without a dropout source the head draws from the sampling source,
    after the target layers' four draws: fc6's then fc7's `[B·R, 4096]`."""
    _, _, flat = vgg_models
    model = _port_vgg(flat)
    gen = torch.Generator().manual_seed(3)
    shapes = []

    def source(shape):
        shapes.append(tuple(shape))
        return torch.rand(shape, generator=gen)

    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    out = model(b["data"], b["im_info"], b["gt_boxes"], train=True, generator=source)
    rois = 2 * TRAIN_KW["BATCH_SIZE"]
    assert len(shapes) == 6 and shapes[4:] == [(rois, 4096)] * 2
    assert np.isfinite(float(out["rcnn_loss_cls"].detach()))


@pytest.mark.parametrize("conv1_fused", [False, True])
def test_vgg_ties_replay_of_a_run_is_that_run(conv1_fused):
    """`vgg_ties.record` then `replay` on the same base and input gives that
    run's gradients to the bit (nothing flipped); a recorded sign of the
    last conv turned over flips that one output; `first_max_nhwc` gives `max_pool2d`'s
    indices on an input without ties."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy((rng.randn(1, 64, 96, 3) * 20).astype(np.float32))
    ct = torch.from_numpy(rng.randn(1, 4, 6, 512).astype(np.float32))
    base = VGGBase(torch.float32, conv1_fused=conv1_fused)

    def grads():
        base.zero_grad(set_to_none=True)
        (base(x) * ct).sum().backward()
        return {n: p.grad.clone() for n, p in base.named_parameters() if p.grad is not None}

    want, ties = grads(), {}
    with vgg_ties.record(base, ties):
        assert all(torch.equal(g, want[n]) for n, g in grads().items())
    assert sorted(ties["pool"]) == ([128, 256, 512] if conv1_fused else [64, 128, 256, 512])
    counts = {}
    with vgg_ties.replay(base, ties, counts):
        got = grads()
    assert counts == {"pools": len(ties["pool"]), "flipped": 0, "routed": 0.0, "flipped_max": 0.0}
    assert sorted(got) == sorted(want) and all(torch.equal(got[n], want[n]) for n in want)
    assert "pool" not in base.__dict__ and base.conv4_1._forward_hooks == {}

    turned = dict(ties, positive=dict(ties["positive"]))
    turned["positive"]["conv5_3"] = ties["positive"]["conv5_3"].clone()
    turned["positive"]["conv5_3"][0, 7, 1, 2] ^= True
    with vgg_ties.replay(base, turned, counts):
        grads()
    assert counts["flipped"] == 1

    feat = rng.randn(2, 9, 13, 5).astype(np.float32)
    _, idx = torch.nn.functional.max_pool2d(torch.from_numpy(feat).permute(0, 3, 1, 2), 2, 2,
                                            return_indices=True)
    assert torch.equal(vgg_ties.first_max_nhwc(feat), idx)
