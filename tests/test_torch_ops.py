"""The PyTorch port's tensor ops against the JAX package's on the same
numpy inputs (CPU, f32): box geometry, the frozen-BN fold, anchors, NMS,
and the blob preparation. Tolerances: 1e-5 relative / 1e-4 absolute for
float results (different summation and libm, same f32 formulas); exact for
anchors and for NMS keep sets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlobjectdetection_tpu.ops import anchors as jax_anchors
from rlobjectdetection_tpu.ops import boxes as jax_boxes
from rlobjectdetection_tpu.ops.bn_fold import bn_mul_add as jax_bn_mul_add
from rlobjectdetection_tpu.ops.nms import nms as jax_nms_fn
from rlobjectdetection_tpu.ops.nms import nms_select as jax_nms_select
from rlobjectdetection_tpu_torch.ops import anchors, boxes, nms
from rlobjectdetection_tpu_torch.ops.bn_fold import bn_mul_add
from test_nms import _rand_dets, np_greedy_nms
import torch_threads  # noqa: F401  (xdist workers share the cores)

TOL = dict(rtol=1e-5, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand_boxes(rng, shape, size=200.0):
    xy = rng.rand(*shape, 2) * size
    wh = rng.rand(*shape, 2) * size / 2 + 1
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def test_bbox_transform_inv_matches_jax(rng):
    b = _rand_boxes(rng, (2, 50))
    d = (rng.randn(2, 50, 12) * 0.5).astype(np.float32)       # 3 class groups
    want = np.asarray(jax_boxes.bbox_transform_inv(jnp.asarray(b), jnp.asarray(d)))
    got = boxes.bbox_transform_inv(_t(b), _t(d)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_clip_boxes_matches_jax(rng):
    b = (rng.randn(2, 40, 8) * 300).astype(np.float32)
    im_hw = np.array([[120.0, 160.0], [200.0, 90.0]], np.float32)
    want = np.asarray(jax_boxes.clip_boxes(jnp.asarray(b), jnp.asarray(im_hw)))
    got = boxes.clip_boxes(_t(b), _t(im_hw)).numpy()
    np.testing.assert_array_equal(got, want)


def test_bbox_overlaps_matches_jax(rng):
    a = _rand_boxes(rng, (3, 30))
    q = _rand_boxes(rng, (3, 20))
    want = np.asarray(jax_boxes.bbox_overlaps(jnp.asarray(a), jnp.asarray(q)))
    got = boxes.bbox_overlaps(_t(a), _t(q)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bn_mul_add_matches_jax(rng):
    scale, bias, mean = (rng.randn(64).astype(np.float32) for _ in range(3))
    var = (rng.rand(64) + 0.1).astype(np.float32)
    want = jax_bn_mul_add(*(jnp.asarray(v) for v in (scale, bias, mean, var)), 1e-5)
    got = bn_mul_add(*(_t(v) for v in (scale, bias, mean, var)), 1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("scales,ratios", [((8, 16, 32), (0.5, 1, 2)),
                                           ((4, 8, 16, 32), (0.5, 1, 2)),
                                           ((2, 3, 5), (0.5, 1, 2, 3))])
def test_anchors_equal_exactly(scales, ratios):
    np.testing.assert_array_equal(
        anchors.generate_anchors(ratios=ratios, scales=scales),
        jax_anchors.generate_anchors(ratios=ratios, scales=scales))
    np.testing.assert_array_equal(
        anchors.shifted_anchors(7, 11, 16, ratios=ratios, scales=scales),
        jax_anchors.shifted_anchors(7, 11, 16, ratios=ratios, scales=scales))


def _keep_set(order, keep):
    return np.sort(np.asarray(order)[np.asarray(keep)])


@pytest.mark.parametrize("n,size,thresh,tile", [
    (1, 120.0, 0.5, 256),
    (50, 120.0, 0.3, 256),
    (300, 40.0, 0.5, 256),     # small path: one N×N adjacency
    (700, 60.0, 0.5, 128),     # tiled path, suppression across tiles
    (640, 30.0, 0.7, 64),      # dense: long suppression chains
])
def test_nms_keep_set_matches_jax_and_oracle(rng, n, size, thresh, tile):
    b, s = _rand_dets(rng, n, size=size)
    s[: n // 3] = np.round(s[: n // 3], 1)       # score ties
    want = _keep_set(*jax_nms_fn(jnp.asarray(b), jnp.asarray(s), thresh, tile_size=tile))
    got = _keep_set(*nms.nms(_t(b), _t(s), thresh, tile_size=tile))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(np_greedy_nms(b, s, thresh)))


def test_nms_respects_valid_mask(rng):
    b, s = _rand_dets(rng, 64)
    valid = rng.rand(64) > 0.5
    got = _keep_set(*nms.nms(_t(b), _t(s), 0.5, valid=_t(valid)))
    want = np.where(valid)[0][np_greedy_nms(b[valid], s[valid], 0.5)]
    np.testing.assert_array_equal(got, np.sort(want))


@pytest.mark.parametrize("n,size,max_out,tile", [
    (100, 30.0, 64, 256),     # dense: fewer survivors than max_out
    (640, 60.0, 32, 64),      # tiled with the max_keep early exit
    (1200, 300.0, 300, 256),  # the eval RPN shape, scaled down
])
def test_nms_select_matches_jax(rng, n, size, max_out, tile):
    b, s = _rand_dets(rng, n, size=size)
    s[::7] = s[0]                                  # ties across the whole list
    valid = rng.rand(n) > 0.1
    jb, js, jv = jax_nms_select(jnp.asarray(b), jnp.asarray(s), 0.5, max_out,
                                valid=jnp.asarray(valid), tile_size=tile)
    tb, ts, tv = nms.nms_select(_t(b), _t(s), 0.5, max_out, valid=_t(valid),
                                tile_size=tile)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    k = int(tv.sum())
    oracle = np.where(valid)[0][np_greedy_nms(b[valid], s[valid], 0.5)]
    assert k == min(len(oracle), max_out)
    np.testing.assert_array_equal(tb.numpy()[:k], b[oracle[:k]])
    assert (tb.numpy()[k:] == 0).all()


def test_nms_select_batched_lanes_match_per_lane(rng):
    """Leading batch dims (the per-class post-processing lanes) give each
    lane's own result, whatever the other lanes keep."""
    lanes = [_rand_dets(rng, 200, size=s) for s in (20.0, 80.0, 200.0)]
    b = np.stack([l[0] for l in lanes])
    s = np.stack([l[1] for l in lanes])
    tb, ts, tv = nms.nms_select(_t(b), _t(s), 0.3, 50)
    for i in range(3):
        jb, js, jv = jax_nms_select(jnp.asarray(b[i]), jnp.asarray(s[i]), 0.3, 50)
        np.testing.assert_array_equal(tb[i].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))


def test_prep_im_for_blob_matches_jax(rng):
    from rlobjectdetection_tpu.data import minibatch
    from rlobjectdetection_tpu_torch.data import blob

    im = rng.randint(0, 256, (61, 97, 3)).astype(np.float32)
    for target in (40, 150):                        # down- and upscale
        want, ws = minibatch.prep_im_for_blob(im, minibatch.PIXEL_MEANS_BGR, target)
        got, gs = blob.prep_im_for_blob(im, blob.PIXEL_MEANS_BGR, target)
        assert gs == ws and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert blob.pad_shape(800, 1213) == minibatch.pad_shape(800, 1213) == (800, 1216)
