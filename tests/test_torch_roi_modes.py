"""The port's `pool` and `crop` RoI modes and RoIAlignMax against the JAX
package, on the CPU: each op forward and gradient in f32 and bf16, then the
ResNet-50 detector's eval forward and one train step in each mode.

The ops see rois on the rounding points of `pool` (integer corners at odd
multiples of 8 land on .5 at scale 1/16), rois that reach past the map on
every side (empty cells, out-of-image samples), and features out of a ReLU
with an all-zero block (cells and 2×2 windows whose values tie at 0).

Tolerances (max |port - jax| / max |jax|):
  * `roi_pool` exact in both dtypes, forward and gradient, over one chunk of
    rois. Over several chunks the f32 gradient is 1e-6: XLA on the CPU adds
    each chunk's rows into the running f32 total, where the port (and XLA
    in bf16) sums each chunk from zero and adds the sums.
  * `roi_crop` and `roi_align_max` forward 1e-6 in f32 (XLA contracts the
    sample coordinates and the corner sum into fused multiply-adds), equal
    in bf16 up to one bf16 step (2^-7). A 2×2 max of samples that tie in
    exact arithmetic (a lattice symmetric about a column of zeros) is then
    decided by those last bits, so the gradient through the max is held as
    JAX's own max-VJP on the port's samples chained through JAX's sampling
    VJP. Gradients 1e-6 in f32 (summation order). In bf16 XLA's scatter-add
    rounds every add to bf16, which puts JAX's bf16 gradient 2-4% of the
    largest away from its own f32 sum at these sizes; the port's sums in
    f32 and rounds once. So the bf16 gradient is held to one bf16 step of
    JAX's f32 gradient of the same bf16-rounded features and cotangent.
  * the detector: as tests/test_torch_model.py and tests/test_torch_train.py
    (1e-4 for dense results, one proposal row in 50, losses 1e-4 relative,
    updates 1e-3 of a leaf's largest). In `crop` with its 2×2 max (the
    reference's default), the exact-arithmetic ties above occur in the
    train step (ReLU zeros around symmetric samples), and JAX (its fused
    multiply-adds) and the port (one rounding a product) decide some of
    them apart: left so, every layer2-3 update differed by up to 5.1e-2 of
    its largest. So the step's JAX max takes its gradient as JAX's max-VJP
    at the port's samples of that step, as the op test above does
    (`_routed_crop`), and every update holds 1e-3 (layer2-3 measured
    1.7e-4 at most, layer4 8.4e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_train import (AT_KEY, LOSS_REL, LOSSES, NUM_CLASSES, PT_KEY, TRAIN_KW,
                              UPDATE_REL, _batch, _perturbed, _step_draws, max_rel)

import rlobjectdetection_tpu.models.faster_rcnn as jax_frcnn
from rlobjectdetection_tpu.config import Config as JaxConfig
from rlobjectdetection_tpu.config import TrainConfig as JaxTrainConfig
from rlobjectdetection_tpu.engine.optim import build_optimizer as jax_build_optimizer
from rlobjectdetection_tpu.engine.train import TrainState
from rlobjectdetection_tpu.engine.train import make_train_step as jax_make_train_step
from rlobjectdetection_tpu.models import FasterRCNN as JaxFasterRCNN
from rlobjectdetection_tpu.ops.roi_align import roi_align as jax_roi_align
from rlobjectdetection_tpu.ops.roi_align import roi_align_max as jax_roi_align_max
from rlobjectdetection_tpu.ops.roi_crop import roi_crop as jax_roi_crop
from rlobjectdetection_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from rlobjectdetection_tpu_torch.config import Config, TrainConfig
from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step
from rlobjectdetection_tpu_torch.engine.checkpoint import state_dict_from_jax
from rlobjectdetection_tpu_torch.models import FasterRCNN
from rlobjectdetection_tpu_torch.models import faster_rcnn as port_frcnn
from rlobjectdetection_tpu_torch.ops import roi_align, roi_crop, roi_pool
import torch_threads  # noqa: F401  (xdist workers share the cores)

DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
ONE_BF16_STEP = 2.0 ** -7
GRAD_REL = {torch.float32: 1e-6, torch.bfloat16: ONE_BF16_STEP}
SCALE = 1.0 / 16.0


def _features(rng, c=16):
    """[2, 9, 12, c] ReLU'd features with an all-zero block."""
    f = np.maximum(rng.randn(2, 9, 12, c), 0).astype(np.float32)
    f[:, 2:6, 3:8] = 0.0
    return f


def _rois(rng, n):
    """n rois over a 144×192 image: the fixed cases first, then random."""
    fixed = np.asarray([
        [0, 8, 24, 40, 56],         # corners on .5 at feature scale: round away from 0
        [1, 24, 8, 72, 40],
        [0, -8, -24, 8, 24],        # negative .5 points
        [1, -40, -40, -10, -5],     # wholly above-left of the map
        [0, 150, 100, 400, 300],    # past the bottom-right: clipped, empty cells
        [1, 48, 32, 128, 96],       # over the all-zero block: tied cells
        [0, 100, 100, 100, 100],    # one pixel
        [1, 60, 40, 61, 41],
    ], np.float32)
    r = np.zeros((n, 5), np.float32)
    r[:, 0] = rng.randint(0, 2, n)
    r[:, 1:3] = rng.uniform(-40, 200, (n, 2))
    r[:, 3:5] = r[:, 1:3] + rng.uniform(0, 120, (n, 2))
    r[:len(fixed)] = fixed
    return r


def _vjp_jax(fn, x, ct):
    """(fn(x), d fn / dx · ct) of a JAX function, as float32 numpy."""
    y, vjp = jax.vjp(fn, x)
    g = vjp(jnp.asarray(ct).astype(y.dtype))[0]
    return np.asarray(y.astype(jnp.float32)), np.asarray(g.astype(jnp.float32))


def _rounded(a, dtype):
    """a rounded to `dtype`, as an f32 JAX array: the reference inputs of a
    gradient held in f32 arithmetic."""
    return jnp.asarray(torch.from_numpy(a).to(dtype).float().numpy())


def _vjp_port(fn, x, ct, dtype):
    t = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = fn(t)
    y.backward(torch.from_numpy(ct).to(y.dtype))
    return y.detach().float().numpy(), t.grad.float().numpy(), y


# -- roi_pool -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_pool_ties_split_by_rows_then_columns(dtype):
    """A 2×3 window whose max 0 ties twice in row 0 and once in row 1:
    each tied row takes half the gradient and splits it among its tied
    columns, 0.25, 0.25 and 0.5, as `jax.grad` of the two-stage max gives
    (an even split over the window would give a third each)."""
    f = np.asarray([[0.0, 0.0, -1.0], [-1.0, 0.0, -2.0]], np.float32)[None, :, :, None]
    rois = np.asarray([[0, 0, 0, 2, 1]], np.float32)
    want_y, want_g = _vjp_jax(lambda x: jax_roi_pool(x, jnp.asarray(rois), 1, 1, 1.0),
                              jnp.asarray(f, DTYPES[dtype]), np.ones((1, 1, 1, 1), np.float32))
    got_y, got_g, _ = _vjp_port(lambda x: roi_pool.roi_pool(x, torch.from_numpy(rois), 1, 1, 1.0),
                                f, np.ones((1, 1, 1, 1), np.float32), dtype)
    split = np.asarray([[0.25, 0.25, 0.0], [0.0, 0.5, 0.0]], np.float32)[None, :, :, None]
    np.testing.assert_array_equal(want_g, split)
    np.testing.assert_array_equal(got_g, split)
    assert got_y.item() == want_y.item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_pool_matches_jax_exactly(dtype):
    """One chunk of 40 rois: forward and gradient equal to the bit."""
    rng = np.random.RandomState(0)
    f, rois = _features(rng), _rois(rng, 40)
    ct = rng.randn(40, 7, 7, 16).astype(np.float32)
    want_y, want_g = _vjp_jax(lambda x: jax_roi_pool(x, jnp.asarray(rois), 7, 7, SCALE, 64),
                              jnp.asarray(f, DTYPES[dtype]), ct)
    got_y, got_g, y = _vjp_port(
        lambda x: roi_pool.roi_pool(x, torch.from_numpy(rois), 7, 7, SCALE, chunk=64), f, ct, dtype)
    assert y.dtype == dtype and y.shape == (40, 7, 7, 16)
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_g, want_g)
    # the cases are there: empty cells (0), cells over the zero block, and
    # the .5 corners that torch.round (half to even) would quantise otherwise
    assert (want_y[4] == 0).any() and (want_y[5] == 0).any() and want_y[0].any()
    corners = torch.from_numpy(rois[:3, 1:] * SCALE)
    assert not torch.equal(roi_pool._cround(corners), torch.round(corners).to(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_pool_chunks_match_jax(dtype):
    """100 rois in chunks of 16 (JAX pads the last chunk): the forward
    exact, the gradient exact in bf16 and 1e-6 in f32 (the chunk sums'
    order, module docstring)."""
    rng = np.random.RandomState(1)
    f, rois = _features(rng), _rois(rng, 100)
    ct = rng.randn(100, 7, 7, 16).astype(np.float32)
    want_y, want_g = _vjp_jax(lambda x: jax_roi_pool(x, jnp.asarray(rois), 7, 7, SCALE),
                              jnp.asarray(f, DTYPES[dtype]), ct)
    got_y, got_g, _ = _vjp_port(lambda x: roi_pool.roi_pool(x, torch.from_numpy(rois)), f, ct,
                                dtype)
    np.testing.assert_array_equal(got_y, want_y)
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got_g, want_g)
    else:
        assert max_rel(got_g, want_g) <= 1e-6


def test_roi_pool_empty_rois():
    out = roi_pool.roi_pool(torch.zeros(1, 4, 4, 8), torch.zeros(0, 5), 7, 7, SCALE)
    assert tuple(out.shape) == (0, 7, 7, 8)


# -- roi_crop -------------------------------------------------------------------


@pytest.mark.parametrize("grid", [2, 7, 14, 16, 28, 100])
def test_crop_lattice_is_jnp_linspace_bit_for_bit(grid):
    want = np.asarray(jnp.linspace(0.0, 1.0, grid))
    np.testing.assert_array_equal(roi_crop.crop_lattice(grid).numpy(), want)
    if grid == 14:    # torch.linspace computes its second half from the end
        assert not np.array_equal(torch.linspace(0, 1, grid).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_pool", [False, True])
def test_roi_crop_forward_matches_jax(dtype, max_pool):
    rng = np.random.RandomState(2)
    f, rois = _features(rng), _rois(rng, 40)
    want = jax_roi_crop(jnp.asarray(f, DTYPES[dtype]), jnp.asarray(rois), 14, SCALE,
                        max_pool=max_pool)
    got = roi_crop.roi_crop(torch.from_numpy(f).to(dtype), torch.from_numpy(rois), 14, SCALE,
                            max_pool=max_pool)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    tol = 1e-6 if dtype == torch.float32 else ONE_BF16_STEP
    assert max_rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_crop_gradient_matches_jax(dtype):
    """The sampling's gradient (no max): every corner's weighted share into
    its clipped source row, zero for the out-of-image ones."""
    rng = np.random.RandomState(3)
    f, rois = _features(rng), _rois(rng, 40)
    ct = rng.randn(40, 14, 14, 16).astype(np.float32)
    _, want_g = _vjp_jax(lambda x: jax_roi_crop(x, jnp.asarray(rois), 14, SCALE, max_pool=False),
                         _rounded(f, dtype), _rounded(ct, dtype))
    _, got_g, _ = _vjp_port(lambda x: roi_crop.roi_crop(x, torch.from_numpy(rois), 14, SCALE,
                                                        max_pool=False), f, ct, dtype)
    assert np.abs(want_g).max() > 0 and max_rel(got_g, want_g) <= GRAD_REL[dtype]


def _max_then_sample_vjp(jax_samples, jax_max, samples, f, dtype, ct):
    """JAX's f32 gradient of `jax_max ∘ jax_samples` at the `dtype`-rounded
    features and cotangent, with the max's ties decided on the port's
    `samples`: the max's VJP at those samples, then the samples' VJP
    (linear in the features, so independent of their values)."""
    _, vjp_max = jax.vjp(jax_max, jnp.asarray(samples))
    ct_samples = vjp_max(_rounded(ct, dtype))[0]
    _, vjp_samples = jax.vjp(jax_samples, _rounded(f, dtype))
    return np.asarray(vjp_samples(ct_samples)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_crop_max_pool_gradient_splits_ties_as_jax(dtype):
    """With CROP_RESIZE_WITH_MAX_POOL: the 2×2 max's gradient on identical
    samples is JAX's bit for bit (a tie splits evenly; out-of-image samples
    tie at 0), and the whole gradient is JAX's with the ties decided on the
    port's samples."""
    rng = np.random.RandomState(4)
    f, rois = _features(rng), _rois(rng, 40)
    ct = rng.randn(40, 7, 7, 16).astype(np.float32)
    with torch.no_grad():
        samples = roi_crop.roi_crop(torch.from_numpy(f).to(dtype), torch.from_numpy(rois), 14,
                                    SCALE, max_pool=False)
    pool = lambda s: s.reshape(40, 7, 2, 7, 2, -1).max(axis=(2, 4))
    s = samples.float().numpy()
    _, want_pool_g = _vjp_jax(pool, jnp.asarray(s, DTYPES[dtype]), ct)
    _, got_pool_g, _ = _vjp_port(lambda x: x.reshape(40, 7, 2, 7, 2, -1).amax(dim=(2, 4)), s, ct,
                                 dtype)
    np.testing.assert_array_equal(got_pool_g, want_pool_g)
    shared = (want_pool_g.reshape(40, 7, 2, 7, 2, -1) != 0).sum(axis=(2, 4))
    assert (shared == 4).any() and (shared == 1).any()     # tied windows and untied ones

    _, got_g, _ = _vjp_port(lambda x: roi_crop.roi_crop(x, torch.from_numpy(rois), 14, SCALE),
                            f, ct, dtype)
    want_g = _max_then_sample_vjp(
        lambda x: jax_roi_crop(x, jnp.asarray(rois), 14, SCALE, max_pool=False), pool, s, f,
        dtype, ct)
    assert np.abs(want_g).max() > 0 and max_rel(got_g, want_g) <= GRAD_REL[dtype]


# -- roi_align_max ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_max_matches_jax(dtype):
    """RoIAlignMax (nested maxima of the (P+1)² align): forward 1e-6 (f32),
    one bf16 step; the gradient with the maxima's ties decided on the
    port's samples, as for crop."""
    rng = np.random.RandomState(5)
    f, rois = _features(rng), _rois(rng, 40)
    ct = rng.randn(40, 7, 7, 16).astype(np.float32)
    jdt = DTYPES[dtype]
    want = np.asarray(jax_roi_align_max(jnp.asarray(f, jdt), jnp.asarray(rois), 7, SCALE)
                      .astype(jnp.float32))
    got, got_g, y = _vjp_port(lambda x: roi_align.roi_align_max(x, torch.from_numpy(rois)), f,
                              ct, dtype)
    assert y.dtype == dtype and got.shape == want.shape == (40, 7, 7, 16)
    assert max_rel(got, want) <= (1e-6 if dtype == torch.float32 else ONE_BF16_STEP)
    with torch.no_grad():
        samples = roi_align.roi_align(torch.from_numpy(f).to(dtype), torch.from_numpy(rois), 8, 8,
                                      SCALE).float().numpy()
    nested = lambda x: jnp.maximum(jnp.maximum(x[:, :-1, :-1], x[:, :-1, 1:]),
                                   jnp.maximum(x[:, 1:, :-1], x[:, 1:, 1:]))
    want_g = _max_then_sample_vjp(lambda x: jax_roi_align(x, jnp.asarray(rois), 8, 8, SCALE),
                                  nested, samples, f, dtype, ct)
    assert np.abs(want_g).max() > 0 and max_rel(got_g, want_g) <= GRAD_REL[dtype]


# -- the detector in each mode -------------------------------------------------------

MODES = ("pool", "crop")
CFG_KW = dict(DTYPE="float32", NMS_TILE=64, ANCHOR_SCALES=(4, 8, 16, 32))


@pytest.fixture(scope="module")
def resnet_params():
    """Flat params of a ResNet-50 detector at the test's size (the pooling
    mode holds no parameter, so one tree serves every mode)."""
    jmodel = JaxFasterRCNN(num_classes=NUM_CLASSES, backbone="resnet50",
                           cfg=JaxConfig(TRAIN=JaxTrainConfig(**TRAIN_KW), **CFG_KW))
    b = _batch()
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": key, "sampling": key}, b["data"], b["im_info"], b["gt_boxes"],
        b["num_boxes"], train=True)
    return _perturbed(variables["params"], np.random.RandomState(7))


def _models(flat, mode, max_pool=True):
    kw = dict(CFG_KW, POOLING_MODE=mode, CROP_RESIZE_WITH_MAX_POOL=max_pool)
    jmodel = JaxFasterRCNN(num_classes=NUM_CLASSES, backbone="resnet50",
                           cfg=JaxConfig(TRAIN=JaxTrainConfig(**TRAIN_KW), **kw))
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    cfg = Config(TRAIN=TrainConfig(**TRAIN_KW), **kw, CONV1_FUSED=True, LAYER1_FUSED=True)
    model = FasterRCNN(NUM_CLASSES, "resnet50", cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(flat, model))
    return jmodel, params, model


@pytest.mark.parametrize("mode", MODES)
def test_faster_rcnn_eval_matches_jax_in_mode(resnet_params, mode):
    """The eval forward; the head also fed the JAX rois (the pooling, layer4
    and the classifiers without the proposals' tie-breaking in the way)."""
    jmodel, params, model = _models(resnet_params, mode)
    b = _batch()
    want = jax.jit(lambda p, d, i: jmodel.apply({"params": p}, d, i, train=False))(
        params, jnp.asarray(b["data"]), jnp.asarray(b["im_info"]))
    data, info = torch.from_numpy(b["data"]), torch.from_numpy(b["im_info"])
    with torch.no_grad():
        out = model(data, info)
        cls_prob, bbox_pred = model.detect_head(model.base(data, fwd_only=True),
                                                torch.from_numpy(np.array(want["rois"])))
    assert max_rel(cls_prob.numpy(), want["cls_prob"]) < 1e-4
    assert max_rel(bbox_pred.numpy(), want["bbox_pred"]) < 1e-4
    rows_equal = (np.abs(out["rois"].numpy() - np.asarray(want["rois"])) <= 1e-3).all(-1)
    assert rows_equal.mean() >= 0.98, rows_equal.mean()
    assert max_rel(out["cls_prob"].numpy(), want["cls_prob"]) < 1e-4


def _routed_crop(port_samples):
    """JAX's `roi_crop` whose 2×2 max takes its gradient as JAX's max-VJP
    at the port's samples (`_max_then_sample_vjp` in the model): JAX's own
    forward, the ties decided as the port decides them."""
    s = jnp.asarray(port_samples)
    pool = lambda x: x.reshape(x.shape[0], x.shape[1] // 2, 2, x.shape[2] // 2, 2,
                               -1).max(axis=(2, 4))
    _, vjp_at_port = jax.vjp(pool, s)

    @jax.custom_vjp
    def routed_max(x):
        return pool(x)

    routed_max.defvjp(lambda x: (pool(x), None), lambda _, ct: vjp_at_port(ct))
    return lambda f, rois, grid, scale, max_pool: routed_max(
        jax_roi_crop(f, rois, grid, scale, max_pool=False))


@pytest.mark.parametrize("mode,max_pool", [("pool", True), ("crop", True), ("crop", False)])
def test_train_step_matches_jax_in_mode(resnet_params, mode, max_pool):
    """One ResNet-50 step from identical params and replayed sampling draws:
    the four losses 1e-4, the fg/bg counts equal, every trainable update 1e-3
    of its leaf's largest (under crop's 2×2 max, JAX's max takes its
    gradient at the port's samples: module docstring), the frozen prefix
    untouched."""
    jmodel, params, model = _models(resnet_params, mode, max_pool)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched, labels = build_optimizer(model, "resnet50", base_lr=0.01)
    samples = []

    def crop(f, rois, grid, scale, max_pool):
        with torch.no_grad():
            samples.append(roi_crop.roi_crop(f, rois, grid, scale, max_pool=False).numpy())
        return roi_crop.roi_crop(f, rois, grid, scale, max_pool=max_pool)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_frcnn, "roi_crop", crop)
        metrics = make_train_step(model, opt, sched)({k: torch.from_numpy(v) for k, v in
                                                      _batch().items()}, _step_draws())
    assert len(samples) == (mode == "crop")

    tx, _ = jax_build_optimizer(params, "resnet50", base_lr=0.01)
    state = TrainState(params, tx.init(params), jnp.int32(0))
    orig_at, orig_pt = jax_frcnn.anchor_target, jax_frcnn.proposal_target
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_frcnn, "anchor_target", lambda key, *a, **kw: orig_at(AT_KEY, *a, **kw))
        mp.setattr(jax_frcnn, "proposal_target",
                   lambda key, *a, **kw: orig_pt(PT_KEY, *a, **kw))
        if mode == "crop" and max_pool:
            mp.setattr(jax_frcnn, "roi_crop", _routed_crop(samples[0]))
        new_state, want_metrics = jax_make_train_step(jmodel, tx)(
            state, {k: jnp.asarray(v) for k, v in _batch().items()}, jax.random.PRNGKey(7))
        jax.block_until_ready(new_state)
    want_flat = {k: np.asarray(v) for k, v in
                 traverse_util.flatten_dict(jax.device_get(new_state.params), sep="/").items()}

    for k in LOSSES + ("loss",):
        got, want = float(metrics[k]), float(want_metrics[k])
        assert np.isfinite(want) and abs(got - want) <= LOSS_REL * abs(want), (k, got, want)
    assert int(metrics["fg_cnt"]) == int(want_metrics["fg_cnt"]) > 0
    after, want_sd = model.state_dict(), state_dict_from_jax(want_flat, model)
    trainable = [k for k, v in labels.items() if v != "frozen"]
    for k in trainable:
        want_up = (want_sd[k] - before[k]).numpy()
        got_up = (after[k] - before[k]).numpy()
        assert np.abs(want_up).max() > 0, k
        gap = np.abs(got_up - want_up).max() / np.abs(want_up).max()
        assert gap <= UPDATE_REL, (k, gap)
    for k in after:
        if k not in trainable:
            assert torch.equal(after[k], before[k]), k


@pytest.mark.parametrize("net", ["res50", "vgg16"])
@pytest.mark.parametrize("mode", MODES)
def test_serve_cli_takes_the_mode_from_set(net, mode, tmp_path, capsys):
    """`serve --set POOLING_MODE pool|crop` serves through `Detector` on both
    nets (VGG-16 with POOLING_SIZE cut to 2, so fc6 stays small)."""
    from PIL import Image

    from rlobjectdetection_tpu_torch.engine.serve import main

    rng = np.random.RandomState(6)
    Image.fromarray(rng.randint(0, 256, (70, 90, 3)).astype(np.uint8)).save(tmp_path / "a.png")
    sets = ["POOLING_MODE", mode, "TEST.SCALES", "[96]", "TEST.RPN_PRE_NMS_TOP_N", "256",
            "TEST.RPN_POST_NMS_TOP_N", "32", "DTYPE", "float32", "NMS_TILE", "64"]
    main(["--image_dir", str(tmp_path), "--net", net, "--dataset", "pascal_voc", "--device",
          "cpu", "--set"] + sets + (["POOLING_SIZE", "2"] if net == "vgg16" else []))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("a.png: ") and " detections in " in line, line
