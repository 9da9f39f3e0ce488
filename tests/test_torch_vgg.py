"""The port's VGG-16 serving path against the JAX package, on the CPU.

The block-1 kernel's plain version (what `fused_vgg_block1` runs on a CPU
tensor) is held against the JAX Pallas kernel in interpret mode, as
tests/test_vgg_stem_pallas.py runs it, on the same numpy inputs. One JAX
`FasterRCNN("vgg16", 21 classes)` is built per module and its params are
carried into the port through `state_dict_from_jax`; both then see the same
numpy inputs. The JAX model runs its plain XLA block 1 (in f32 the fused and
plain blocks compute one function, tests/test_vgg_stem_pallas.py), the port
its fused path. Tolerances, f32: rtol 1e-5 / atol 1e-4 for the block, max
|port - jax| / max |jax| <= 1e-4 for whole-model results (same formulas,
different summation order in the convs).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from rlobjectdetection_tpu.config import Config as JaxConfig
from rlobjectdetection_tpu.config import TestConfig as JaxTestConfig
from rlobjectdetection_tpu.models import FasterRCNN as JaxFasterRCNN
from rlobjectdetection_tpu.models.backbones.vgg import VGGBase as JaxVGGBase
from rlobjectdetection_tpu.ops.vgg_stem_pallas import fused_vgg_block1 as jax_fused_vgg_block1
from rlobjectdetection_tpu_torch.config import Config
from rlobjectdetection_tpu_torch.config import TestConfig as PortTestConfig
from rlobjectdetection_tpu_torch.engine.checkpoint import state_dict_from_jax
from rlobjectdetection_tpu_torch.models import FasterRCNN
from rlobjectdetection_tpu_torch.models.backbones.vgg import VGGBase
from rlobjectdetection_tpu_torch.ops import vgg_block1_kernel
import torch_threads  # noqa: F401  (xdist workers share the cores)

TOL = dict(rtol=1e-5, atol=1e-4)
REL = 1e-4
NUM_CLASSES = 21
TEST_KW = dict(RPN_PRE_NMS_TOP_N=256, RPN_POST_NMS_TOP_N=32, MAX_DETS_PER_IMAGE=20)
CFG_KW = dict(DTYPE="float32", NMS_TILE=64, ANCHOR_SCALES=(4, 8, 16, 32))


def max_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _block1_inputs(rng, b, h, w):
    """tests/test_vgg_stem_pallas.py's inputs: a nonzero b1, so a conv1_1
    that let relu(b1) through at the image border would differ there."""
    x = (rng.randn(b, h, w, 3) * 3).astype(np.float32)
    k1 = (rng.randn(3, 3, 3, 64) * 0.2).astype(np.float32)
    b1 = rng.randn(64).astype(np.float32)
    k2 = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    b2 = rng.randn(64).astype(np.float32)
    return x, k1, b1, k2, b2


def _torch_block1_args(x, k1, b1, k2, b2):
    oihw = lambda k: torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    return (torch.from_numpy(x), oihw(k1), torch.from_numpy(b1), oihw(k2),
            torch.from_numpy(b2))


@pytest.mark.parametrize("b,h,w,tp", [
    (1, 64, 80, 8),     # 4 tiles
    (2, 32, 48, 5),     # partial last tile (PH=16, tp=5)
    (1, 16, 128, 8),    # PH exactly one tile
])
def test_vgg_block1_plain_matches_pallas(b, h, w, tp):
    rng = np.random.RandomState(b * 1000 + h + w)
    args = _block1_inputs(rng, b, h, w)
    want = jax_fused_vgg_block1(*(jnp.asarray(a) for a in args), out_dtype=jnp.float32,
                                compute_dtype=jnp.float32, tile_rows=tp, interpret=True)
    got = vgg_block1_kernel.fused_vgg_block1(*_torch_block1_args(*args), dtype=torch.float32)
    assert tuple(got.shape) == want.shape == (b, h // 2, w // 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vgg_block1_plain_bf16_matches_pallas():
    """bf16 compute and output on both sides, rounded at the same points.
    The f32 sums run in different orders, so an output may round to the
    neighbouring bf16 value: one bf16 step of the largest output is at most
    2^-7 of it, hence the bound 2^-7 on max |diff| / max |want|."""
    args = _block1_inputs(np.random.RandomState(7), 1, 32, 64)
    want = jax_fused_vgg_block1(*(jnp.asarray(a) for a in args), out_dtype=jnp.bfloat16,
                                compute_dtype=jnp.bfloat16, tile_rows=4, interpret=True)
    got = vgg_block1_kernel.fused_vgg_block1(*_torch_block1_args(*args), dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, 16, 32, 64)
    assert max_rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= 2.0 ** -7


def test_pack_vgg_block1_places_each_weight_in_its_swizzled_slot():
    """The bf16 weight image holds W where wgmma's 128-byte-swizzled K-major
    B tiles expect it: tile t < 9 is conv1_2 at tap t (row co, k ci), tile
    9 conv1_1 (row co, k = ky·9 + kx·3 + ci); element (n, k) of a tile at
    bf16 index 64n + 8 (k // 8 ^ n % 8) + k % 8."""
    rng = np.random.RandomState(2)
    w1 = torch.from_numpy(rng.randn(64, 3, 3, 3).astype(np.float32))
    w2 = torch.from_numpy(rng.randn(64, 64, 3, 3).astype(np.float32))
    b = torch.zeros(64)
    image = vgg_block1_kernel.pack_vgg_block1(w1, b, w2, b, torch.bfloat16)["w"]
    assert tuple(image.shape) == (10, 4096) and image.dtype == torch.bfloat16
    slot = lambda n, k: 64 * n + 8 * ((k // 8) ^ (n % 8)) + k % 8
    w1b, w2b = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    for tap, co, ci in [(0, 0, 0), (4, 17, 33), (8, 63, 63), (2, 9, 14), (6, 40, 7)]:
        assert image[tap, slot(co, ci)] == w2b[co, ci, tap // 3, tap % 3]
    for co, ky, kx, ci in [(0, 0, 0, 0), (13, 1, 2, 1), (63, 2, 2, 2), (30, 2, 0, 1)]:
        assert image[9, slot(co, ky * 9 + kx * 3 + ci)] == w1b[co, ci, ky, kx]
    assert all(image[9, slot(co, k)] == 0 for co in (0, 31, 63) for k in range(27, 64))
    f32 = vgg_block1_kernel.pack_vgg_block1(w1, b, w2, b, torch.float32)
    assert torch.equal(f32["w2"], w2.permute(2, 3, 1, 0).reshape(9, 64, 64))
    assert torch.equal(f32["w1"], w1.permute(2, 3, 1, 0).reshape(27, 64))


def test_vgg_base_fused_matches_jax():
    """The port's VGGBase(conv1_fused=True) against the JAX
    VGGBase(conv1_fused=True, stem_interpret=True), f32, 64×80, one param
    tree carried by state_dict_from_jax."""
    rng = np.random.RandomState(11)
    x = (rng.randn(1, 64, 80, 3) * 5).astype(np.float32)
    jbase = JaxVGGBase(dtype=jnp.float32, conv1_fused=True, stem_interpret=True)
    params = JaxVGGBase(dtype=jnp.float32).init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    want = jbase.apply({"params": params}, jnp.asarray(x))
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    base = VGGBase(torch.float32, conv1_fused=True)
    base.load_state_dict(state_dict_from_jax(flat, base))
    with torch.no_grad():
        got = base(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (1, 4, 5, 512)
    assert max_rel(got.numpy(), want) < REL


def test_parameter_count_matches_jax():
    """The served configuration (81 COCO classes, 12 anchors): 138,316,573
    parameters in both trees. Shapes only: JAX traces its init, the port
    builds on the meta device."""
    jcfg = JaxConfig(ANCHOR_SCALES=(4, 8, 16, 32))
    jmodel = JaxFasterRCNN(num_classes=81, backbone="vgg16", cfg=jcfg)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
                            jnp.asarray([[64.0, 64.0, 1.0]]))["params"]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        model = FasterRCNN(81, "vgg16", Config(ANCHOR_SCALES=(4, 8, 16, 32)), device="meta")
    n_port = sum(t.numel() for t in model.state_dict().values())
    assert n_port == n_jax == 138_316_573


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, flat params) sharing weights."""
    jcfg = JaxConfig(TEST=JaxTestConfig(**TEST_KW), **CFG_KW)
    jmodel = JaxFasterRCNN(num_classes=NUM_CLASSES, backbone="vgg16", cfg=jcfg)
    x = jnp.zeros((1, 96, 128, 3), jnp.float32)
    info = jnp.asarray([[96.0, 128.0, 1.0]])
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(0)}, x, info, train=False)
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(variables["params"]), sep="/").items()}
    cfg = Config(TEST=PortTestConfig(**TEST_KW), **CFG_KW, CONV1_FUSED=True)
    with torch.device("meta"):
        model = FasterRCNN(NUM_CLASSES, "vgg16", cfg, device="meta")
    model = model.to_empty(device="cpu")
    model.load_state_dict(state_dict_from_jax(flat, model))
    return jmodel, variables["params"], model, flat


def test_state_dict_from_jax_maps_every_vgg_key(models):
    """Every key and shape: conv kernels HWIO → OIHW with biases kept,
    fc6 `[25088, 4096]` → `head.fc6.weight` `[4096, 25088]`."""
    _, _, model, flat = models
    sd = model.state_dict()
    assert len(sd) == len(flat) == 40
    for key, arr in flat.items():
        t = sd[key.replace("/kernel", "/weight").replace("/", ".")].numpy()
        back = {4: lambda a: a.transpose(2, 3, 1, 0), 2: lambda a: a.T}.get(
            t.ndim, lambda a: a)(t)
        np.testing.assert_array_equal(back, arr, err_msg=key)
    assert tuple(sd["head.fc6.weight"].shape) == (4096, 25088)
    assert tuple(sd["base.conv1_1.weight"].shape) == (64, 3, 3, 3)
    assert tuple(sd["base.conv5_3.bias"].shape) == (512,)


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
    return data, info, jax.device_get(out), jax.device_get(dict(
        base_feat=inter["base"]["__call__"][0], rpn=inter["rpn"]["__call__"][0]))


def test_faster_rcnn_vgg16_eval_matches_jax(models, jax_forward):
    """The whole eval forward; the head is also fed the JAX rois, which
    checks RoIAlignAvg at 512 channels, the (C, H, W) flatten into fc6, fc7
    and the classifiers without the proposals' tie-breaking in the way."""
    _, _, model, _ = models
    data, info, jout, jinter = jax_forward
    with torch.no_grad():
        base_feat = model.base(torch.from_numpy(data))
        rpn_cls, rpn_delta = model.rpn(base_feat)
        out = model(torch.from_numpy(data), torch.from_numpy(info))
        cls_prob, bbox_pred = model.detect_head(base_feat, torch.from_numpy(np.array(jout["rois"])))
    assert tuple(base_feat.shape) == (2, 6, 8, 512)
    assert max_rel(base_feat.numpy(), jinter["base_feat"]) < REL
    assert max_rel(rpn_cls.numpy(), jinter["rpn"][0]) < REL
    assert max_rel(rpn_delta.numpy(), jinter["rpn"][1]) < REL
    assert max_rel(cls_prob.numpy(), jout["cls_prob"]) < REL
    assert max_rel(bbox_pred.numpy(), jout["bbox_pred"]) < REL
    # as tests/test_torch_model.py: near-tied proposal scores may swap in
    # top-k and NMS, so one row in 50 may differ
    rois, want = out["rois"].numpy(), np.asarray(jout["rois"])
    assert rois.shape == want.shape == (2, 32, 5)
    assert (np.abs(rois - want) <= 1e-3).all(-1).mean() >= 0.98
    np.testing.assert_array_equal(out["roi_valid"].numpy(), np.asarray(jout["roi_valid"]))
    assert max_rel(out["cls_prob"].numpy(), jout["cls_prob"]) < REL


def test_vgg_head_flattens_in_chw_order(models):
    """An NHWC flatten into fc6 loads every key with the right shape and
    computes another function: the head must match the JAX VGGHead."""
    from rlobjectdetection_tpu.models.backbones.vgg import VGGHead as JaxVGGHead

    _, params, model, _ = models
    pooled = np.random.RandomState(3).randn(5, 7, 7, 512).astype(np.float32)
    want = JaxVGGHead(dtype=jnp.float32).apply({"params": params["head"]}, jnp.asarray(pooled))
    with torch.no_grad():
        got = model.head(torch.from_numpy(pooled))
    assert tuple(got.shape) == want.shape == (5, 4096)
    assert max_rel(got.numpy(), want) < REL


def test_detector_serves_vgg16_on_the_cpu(models):
    from rlobjectdetection_tpu_torch.engine.serve import Detector

    _, _, model, _ = models
    im = np.random.RandomState(4).randint(0, 256, (70, 90, 3)).astype(np.float32)
    cfg = dataclasses.replace(model.cfg, TEST=dataclasses.replace(model.cfg.TEST,
                                                                  SCALES=(96,)))
    n0 = vgg_block1_kernel.fused_vgg_block1.launches
    boxes, scores, classes, valid = Detector(model, cfg, "cpu").detect(im)
    assert vgg_block1_kernel.fused_vgg_block1.launches == n0     # plain version on the CPU
    assert boxes.shape == (20, 4) and scores.shape == classes.shape == valid.shape == (20,)
    assert np.isfinite(boxes).all() and np.isfinite(scores).all()
    assert int(valid.sum()) >= 1
    assert ((classes[valid] >= 1) & (classes[valid] < NUM_CLASSES)).all()
    assert (boxes[valid] >= 0).all() and (boxes[valid][:, 2] <= 89).all()
