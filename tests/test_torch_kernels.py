"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version, which is
held here against the Pallas kernel in interpret mode, as the JAX package's
own tests run it (tests/test_stem_pallas.py, test_layer1_pallas.py,
test_roi_align_pallas.py), on the same numpy inputs in f32. The CUDA
kernels themselves run only on a GPU: tests/test_torch_gpu.py holds each one
against its plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlobjectdetection_tpu.models.backbones.resnet import ResLayer as JaxResLayer
from rlobjectdetection_tpu.ops.roi_align import roi_align as jax_roi_align_fn
from rlobjectdetection_tpu.ops.roi_align import roi_align_avg as jax_roi_align_avg
from rlobjectdetection_tpu.ops.layer1_pallas import fused_layer1 as jax_fused_layer1
from rlobjectdetection_tpu.ops.stem_pallas import fused_stem as jax_fused_stem
from rlobjectdetection_tpu_torch.engine.checkpoint import state_dict_from_jax
from rlobjectdetection_tpu_torch.models.backbones.resnet import ResLayer
from rlobjectdetection_tpu_torch.ops import layer1_kernel, roi_align, roi_align_kernel, stem_kernel
import torch_threads  # noqa: F401  (xdist workers share the cores)

TOL = dict(rtol=1e-5, atol=1e-4)


def _flat(tree, prefix=""):
    """Nested param dict → {"a/b/c": numpy}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def max_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _stem_inputs(rng, b, h, w):
    x = (rng.randn(b, h, w, 3) * 3).astype(np.float32)
    k = (rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    scale = (rng.rand(64) + 0.5).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    mean = (rng.randn(64) * 0.2).astype(np.float32)
    var = (rng.rand(64) + 0.3).astype(np.float32)
    return x, k, scale, bias, mean, var


def _torch_stem_args(x, k, *bn):
    return (torch.from_numpy(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
            *(torch.from_numpy(v) for v in bn))


@pytest.mark.parametrize("b,h,w,tp", [
    (1, 64, 80, 8),     # even dims, 2 tiles
    (2, 37, 45, 4),     # odd dims → ceil-mode edge cells, partial last tile
    (1, 29, 128, 8),    # PH smaller than one tile
])
def test_stem_plain_matches_pallas(b, h, w, tp):
    rng = np.random.RandomState(b * 1000 + h + w)
    args = _stem_inputs(rng, b, h, w)
    want = jax_fused_stem(*(jnp.asarray(a) for a in args), out_dtype=jnp.float32,
                          compute_dtype=jnp.float32, tile_rows=tp, interpret=True)
    got = stem_kernel.fused_stem(*_torch_stem_args(*args), dtype=torch.float32)
    _, _, ph, pw = stem_kernel.stem_out_shapes(h, w)
    assert tuple(got.shape) == (b, ph, pw, 64) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _layer1_params(rng, key):
    """ResLayer(64, 3) params of the JAX package with randomized BN stats."""
    layer = JaxResLayer(64, 3, 1, jnp.float32)
    params = layer.init(jax.random.PRNGKey(key), jnp.zeros((1, 8, 8, 64)))["params"]
    flat = {}
    for k, v in _flat(params).items():
        r = rng.randn(*v.shape).astype(np.float32) * 0.05
        leaf = k.rsplit("/", 1)[1]
        r += 1.0 if leaf in ("scale", "var") else 0.0
        flat[k] = np.abs(r) + 0.5 if leaf == "var" else r
    return flat


def _unflat(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _torch_layer1(flat):
    """The port's layer1 with the JAX params, frozen as wherever the fused
    layer1 runs (`fused_layer1` is forward-only and raises on a trainable
    stage)."""
    layer = ResLayer(64, 64, 3, 1).requires_grad_(False)
    layer.load_state_dict(state_dict_from_jax(flat, layer))
    return layer


@pytest.mark.parametrize("b,h,w,th", [
    (1, 9, 50, 4),      # partial last band, single 128-lane output chunk
    (2, 13, 40, 8),     # 2 images, band > H
])
def test_layer1_plain_matches_pallas(b, h, w, th):
    rng = np.random.RandomState(b * 100 + h)
    flat = _layer1_params(rng, key=b)
    x = (rng.randn(b, h, w, 64) * 0.1).astype(np.float32)
    want = jax_fused_layer1(jnp.asarray(x.transpose(0, 1, 3, 2)), _unflat(flat),
                            out_dtype=jnp.float32, compute_dtype=jnp.float32,
                            tile_rows=th, interpret=True)
    got = layer1_kernel.fused_layer1(torch.from_numpy(x), _torch_layer1(flat),
                                     dtype=torch.float32)
    assert tuple(got.shape) == want.shape == (b, h, w, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layer1_plain_matches_unfused_reslayer():
    """The folded plain version computes the module's own (unfolded) layer."""
    rng = np.random.RandomState(5)
    layer = _torch_layer1(_layer1_params(rng, key=0))
    x = torch.from_numpy((rng.randn(1, 11, 17, 64) * 0.1).astype(np.float32))
    got = layer1_kernel.fused_layer1(x, layer, dtype=torch.float32)
    with torch.no_grad():
        want = layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _rand_rois(rng, r, b, img_w=600, img_h=400):
    rois = np.zeros((r, 5), np.float32)
    rois[:, 0] = rng.randint(0, b, r)       # any image order
    rois[:, 1] = rng.rand(r) * img_w * 0.6
    rois[:, 2] = rng.rand(r) * img_h * 0.6
    rois[:, 3] = rois[:, 1] + rng.rand(r) * img_w * 0.4 + 16
    rois[:, 4] = rois[:, 2] + rng.rand(r) * img_h * 0.4 + 16
    return rois


def test_roi_align_avg_plain_matches_jax(rng):
    feats = rng.randn(2, 25, 38, 256).astype(np.float32)
    rois = _rand_rois(rng, 44, 2)
    rois[:3, 1:] = [[-40, -30, 100, 90], [500, 300, 900, 700], [10, 10, 10, 10]]
    want = np.asarray(jax_roi_align_avg(jnp.asarray(feats), jnp.asarray(rois), 7, 1 / 16.0))
    got = roi_align_kernel.roi_align_avg(torch.from_numpy(feats), torch.from_numpy(rois),
                                         7, 1 / 16.0)
    assert tuple(got.shape) == want.shape == (44, 7, 7, 256)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def test_roi_align_avg_plain_matches_pallas(rng, pallas_interpret):
    from rlobjectdetection_tpu.ops.roi_align_pallas import roi_align_avg_pallas

    feats = rng.randn(2, 25, 38, 256).astype(np.float32)
    rois = _rand_rois(rng, 44, 2)
    rois = rois[np.argsort(rois[:, 0], kind="stable")]   # the TPU kernel's order
    want = roi_align_avg_pallas(jnp.asarray(feats), jnp.asarray(rois), 7, 1 / 16.0)
    got = roi_align_kernel.roi_align_avg(torch.from_numpy(feats), torch.from_numpy(rois))
    # the Pallas kernel rounds its bilinear weights to bf16
    assert max_rel(got.numpy(), want) < 1e-2


def test_roi_align_out_of_bounds_zeroed(rng):
    """Cells whose sample point falls outside the map are exactly 0, as in
    the JAX path; the others agree with it."""
    feats = rng.randn(1, 12, 16, 128).astype(np.float32) + 3.0
    rois = np.asarray([[0, 150.0, 100.0, 400.0, 300.0]], np.float32)
    want = np.asarray(jax_roi_align_fn(jnp.asarray(feats), jnp.asarray(rois), 8, 8, 1 / 16.0))
    got = roi_align.roi_align(torch.from_numpy(feats), torch.from_numpy(rois), 8, 8,
                              1 / 16.0).numpy()
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    assert (got == 0).any()
    np.testing.assert_allclose(got, want, **TOL)


def test_wrappers_count_only_kernel_launches(rng):
    """On CPU tensors the wrappers run the plain versions and count nothing
    (the NMS op its plain body, no kernel call); a tensor on any other
    non-CUDA device is refused."""
    from rlobjectdetection_tpu_torch.ops import nms, nms_kernel
    from rlobjectdetection_tpu_torch.utils import tracing

    counters = (stem_kernel.fused_stem, layer1_kernel.fused_layer1,
                roi_align_kernel.roi_align_avg, nms_kernel.launch_nms)
    before = [f.launches for f in counters]
    calls = tracing.totals().get("nms.kernel_calls", 0)
    args = _torch_stem_args(*_stem_inputs(rng, 1, 20, 24))
    stem_kernel.fused_stem(*args, dtype=torch.float32)
    feats = torch.from_numpy(rng.randn(1, 6, 8, 32).astype(np.float32))
    roi_align_kernel.roi_align_avg(feats, torch.from_numpy(_rand_rois(rng, 4, 1, 90, 60)))
    boxes = torch.from_numpy(_rand_rois(rng, 20, 1, 90, 60)[:, 1:].copy())
    nms.nms_sorted_mask(boxes, torch.ones(20, dtype=torch.bool), 0.5, max_keep=5)
    assert [f.launches for f in counters] == before
    assert tracing.totals().get("nms.kernel_calls", 0) == calls
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align_kernel.roi_align_avg(feats.to("meta"), torch.zeros(4, 5, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        nms_kernel.launch_nms(boxes, torch.ones(20, dtype=torch.bool), 0.5, 256, None)


def test_build_reports_missing_nvcc():
    import shutil

    from rlobjectdetection_tpu_torch.ops import _build

    try:
        _build._nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc is installed here; the build itself is exercised on the GPU")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("stem",))
