"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

These tests need a CUDA device and skip without one. The file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(`--noconftest`: tests/conftest.py sets up JAX for the rest of the suite).
Tolerances are max |kernel - plain| / max |plain|: 1e-4 in f32 (summation
order), and in bf16 the bounds chip_smoke.py uses (one bf16 rounding of a
differently-ordered f32 sum, compounded through layer1's rounded
intermediates)."""

import numpy as np
import pytest
import torch

from rlobjectdetection_tpu_torch.models.backbones.resnet import ResLayer
from rlobjectdetection_tpu_torch.ops import (layer1_kernel, res_stage_kernel, roi_align,
                                             roi_align_kernel, stem_kernel, vgg_block1_kernel)


def max_rel(got, want):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled for sm_90a")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randomize_bn(module, rng):
    """Frozen-BN buffers away from the identity, so the folds are exercised."""
    for name, buf in module.named_buffers():
        leaf = name.rsplit(".", 1)[1]
        r = rng.randn(*buf.shape).astype(np.float32) * 0.1
        if leaf in ("scale", "var"):
            r = np.abs(r) + 0.5
        buf.copy_(torch.from_numpy(r))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-3)])
def test_stem_kernel_matches_plain(cuda, dtype, tol):
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(2, 37, 45, 3) * 30).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.randn(64, 3, 7, 7) * 0.1).astype(np.float32)).to(cuda)
    bn = [torch.from_numpy(v.astype(np.float32)).to(cuda) for v in
          (rng.rand(64) + 0.5, rng.randn(64), rng.randn(64) * 0.2, rng.rand(64) + 0.3)]
    n0 = stem_kernel.fused_stem.launches
    got = stem_kernel.fused_stem(x, w, *bn, dtype=dtype)
    torch.cuda.synchronize()
    assert stem_kernel.fused_stem.launches == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (2, 9, 11, 64)   # ceil-mode pool
    assert max_rel(got, stem_kernel.stem_plain(x, w, *bn, dtype=dtype)) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.28e-2)])
def test_layer1_kernel_matches_plain(cuda, dtype, tol):
    rng = np.random.RandomState(2)
    layer = ResLayer(64, 64, 3, 1).requires_grad_(False)
    _randomize_bn(layer, rng)
    layer = layer.to(cuda)
    x = torch.from_numpy(np.abs(rng.randn(2, 13, 21, 64)).astype(np.float32))
    x = x.to(cuda, dtype)
    n0 = layer1_kernel.fused_layer1.launches
    got = layer1_kernel.fused_layer1(x, layer, dtype=dtype)
    torch.cuda.synchronize()
    assert layer1_kernel.fused_layer1.launches == n0 + 3
    want = layer1_kernel.layer1_plain(x, layer1_kernel.pack_layer1(layer, dtype), dtype)
    assert max_rel(got, want) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_roi_align_kernel_matches_plain(cuda, dtype, tol):
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.randn(2, 25, 38, 300).astype(np.float32)).to(cuda, dtype)
    rois = np.zeros((40, 5), np.float32)
    rois[:, 0] = rng.randint(0, 2, 40)
    rois[:, 1:3] = rng.rand(40, 2) * 360
    rois[:, 3:5] = rois[:, 1:3] + rng.rand(40, 2) * 240 + 16
    rois[:2, 1:] = [[-40, -30, 100, 90], [500, 300, 900, 700]]   # off the map
    rois = torch.from_numpy(rois).to(cuda)
    n0 = roi_align_kernel.roi_align_avg.launches
    got = roi_align_kernel.roi_align_avg(feats, rois)
    torch.cuda.synchronize()
    assert roi_align_kernel.roi_align_avg.launches == n0 + 1
    assert max_rel(got, roi_align.roi_align_avg(feats, rois)) < tol


# bf16: kernel and plain version round the same f32 results at the same
# points, but their sums run in other orders, so an output may round to the
# neighbouring bf16 value: at most one step, 2^-7 of the largest output.
ONE_BF16_STEP = 2.0 ** -7


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", [
    (1, 800, 1216),     # the main path's image: 950 tiles, more than the persistent CTAs
    (1, 70, 150),       # 17x37 pooled cells: partial tiles on both axes
    (3, 45, 30),        # batch 3, 11x7 pooled cells: less than one tile wide
])
def test_stem_kernel_tiles(cuda, dtype, b, h, w):
    rng = np.random.RandomState(h + w)
    x = torch.from_numpy((rng.randn(b, h, w, 3) * 30).astype(np.float32)).to(cuda)
    wt = torch.from_numpy((rng.randn(64, 3, 7, 7) * 0.1).astype(np.float32)).to(cuda)
    bn = [torch.from_numpy(v.astype(np.float32)).to(cuda) for v in
          (rng.rand(64) + 0.5, rng.randn(64), rng.randn(64) * 0.2, rng.rand(64) + 0.3)]
    got = stem_kernel.fused_stem(x, wt, *bn, dtype=dtype)
    torch.cuda.synchronize()
    _, _, ph, pw = stem_kernel.stem_out_shapes(h, w)
    assert got.dtype == dtype and tuple(got.shape) == (b, ph, pw, 64)
    want = stem_kernel.stem_plain(x, wt, *bn, dtype=dtype)
    assert max_rel(got, want) < (1e-4 if dtype == torch.float32 else ONE_BF16_STEP)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.28e-2)])
@pytest.mark.parametrize("b,h,w", [
    (1, 200, 304),      # the main path's shape: 950 tiles, more than the persistent CTAs
    (2, 37, 19),        # width and height not multiples of the 8x8 tile
    (3, 9, 70),         # batch 3, one full and one partial tile row
])
def test_layer1_kernel_tiles(cuda, dtype, tol, b, h, w):
    rng = np.random.RandomState(h + w)
    layer = ResLayer(64, 64, 3, 1).requires_grad_(False)
    _randomize_bn(layer, rng)
    layer = layer.to(cuda)
    x = torch.from_numpy(np.abs(rng.randn(b, h, w, 64)).astype(np.float32)).to(cuda, dtype)
    n0 = layer1_kernel.fused_layer1.launches
    got = layer1_kernel.fused_layer1(x, layer, dtype=dtype)
    torch.cuda.synchronize()
    assert layer1_kernel.fused_layer1.launches == n0 + 3
    assert got.dtype == dtype and tuple(got.shape) == (b, h, w, 256)
    want = layer1_kernel.layer1_plain(x, layer1_kernel.pack_layer1(layer, dtype), dtype)
    assert float(want.float().abs().max()) > 0
    assert max_rel(got, want) < tol
    if dtype == torch.float32:   # the unfolded modules too (bf16 rounds elsewhere there)
        with torch.no_grad():
            ref = layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert max_rel(got, ref) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -7)])
def test_vgg_block1_kernel_matches_plain(cuda, dtype, tol):
    """36×52 → 18×26 pooled cells: partial 8×8 tiles on both axes, and a
    nonzero b1 so that the border's literal zero padding is checked. In
    bf16 kernel and plain version round the same f32 results at the same
    points, but their sums run in other orders: an output may round to the
    neighbouring bf16 value, at most 2^-7 of the largest output."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy((rng.randn(2, 36, 52, 3) * 30).astype(np.float32)).to(cuda)
    w1 = torch.from_numpy((rng.randn(64, 3, 3, 3) * 0.2).astype(np.float32)).to(cuda)
    b1 = torch.from_numpy(rng.randn(64).astype(np.float32)).to(cuda)
    w2 = torch.from_numpy((rng.randn(64, 64, 3, 3) * 0.05).astype(np.float32)).to(cuda)
    b2 = torch.from_numpy(rng.randn(64).astype(np.float32)).to(cuda)
    n0 = vgg_block1_kernel.fused_vgg_block1.launches
    got = vgg_block1_kernel.fused_vgg_block1(x, w1, b1, w2, b2, dtype=dtype)
    torch.cuda.synchronize()
    assert vgg_block1_kernel.fused_vgg_block1.launches == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (2, 18, 26, 64)
    assert max_rel(got, vgg_block1_kernel.vgg_block1_plain(x, w1, b1, w2, b2, dtype=dtype)) < tol


def _rois(rng, n, n_images, h=800, w=1216):
    """n rois over n_images images of h x w pixels (the map at 1/16), a few
    partly or wholly off the map."""
    rois = np.zeros((n, 5), np.float32)
    rois[:, 0] = rng.randint(0, n_images, n)
    rois[:, 1] = rng.rand(n) * w
    rois[:, 2] = rng.rand(n) * h
    rois[:, 3:5] = rois[:, 1:3] + rng.rand(n, 2) * 400 + 8
    if n >= 3:
        rois[:3, 1:] = [[-120, -60, 200, 140], [w - 100, h - 50, w + 300, h + 200],
                        [w + 40, h + 40, w + 500, h + 300]]
    return rois


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_images,c,r", [
    (1, 1024, 300),     # the flagship's head
    (1, 512, 300),      # VGG-16's head
    (1, 1024, 64),      # the RL refine
    (2, 1024, 128),     # the RL train step: two images
    (1, 1024, 0),       # no rois
    (1, 520, 40),       # the last 256-channel chunk holds one 8-channel group
])
def test_roi_align_kernel_main_path_shapes(cuda, dtype, n_images, c, r):
    """Against the plain version's f32 arithmetic on the same features,
    rounded once to the feature type: the kernel blends and averages in f32
    and rounds once, so bf16 may differ by one step (2^-7 of the largest
    output) where the sums run in other orders; f32 by summation order."""
    rng = np.random.RandomState(c + r)
    feats = torch.from_numpy(rng.randn(n_images, 50, 76, c).astype(np.float32)).to(cuda, dtype)
    rois = torch.from_numpy(_rois(rng, r, n_images)).to(cuda)
    n0 = roi_align_kernel.roi_align_avg.launches
    got = roi_align_kernel.roi_align_avg(feats, rois)
    torch.cuda.synchronize()
    assert roi_align_kernel.roi_align_avg.launches == n0 + (r > 0)
    assert got.dtype == dtype and tuple(got.shape) == (r, 7, 7, c)
    if r == 0:
        return
    want = roi_align.roi_align_avg(feats.float(), rois).to(dtype)
    assert float(want.float().abs().max()) > 0
    assert max_rel(got, want) <= (1e-4 if dtype == torch.float32 else ONE_BF16_STEP)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_clamps_the_batch_index(cuda, dtype):
    """A batch index outside [0, B) reads the nearest image, as the kernel
    clamps it; the plain version is given the clamped index."""
    rng = np.random.RandomState(12)
    feats = torch.from_numpy(rng.randn(2, 20, 30, 256).astype(np.float32)).to(cuda, dtype)
    rois = _rois(rng, 8, 2, 320, 480)
    rois[:4, 0] = [-1, 2, 7, -30]
    got = roi_align_kernel.roi_align_avg(feats, torch.from_numpy(rois).to(cuda))
    clamped = rois.copy()
    clamped[:, 0] = np.clip(clamped[:, 0], 0, 1)
    want = roi_align.roi_align_avg(feats.float(), torch.from_numpy(clamped).to(cuda)).to(dtype)
    assert max_rel(got, want) <= (1e-4 if dtype == torch.float32 else ONE_BF16_STEP)


def _block1_weights(rng, device):
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return (t(rng.randn(64, 3, 3, 3) * 0.2), t(rng.randn(64)), t(rng.randn(64, 64, 3, 3) * 0.05),
            t(rng.randn(64)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, ONE_BF16_STEP)])
@pytest.mark.parametrize("b,h,w", [
    (1, 800, 1216),     # the main path's image: 3,800 bf16 tiles of 4x16 cells
    (2, 70, 150),       # batch 2, 35x75 cells: partial tiles on both axes
    (1, 56, 608),       # 7x19 = 133 bf16 tiles: one more than an H100's persistent CTAs
])
def test_vgg_block1_kernel_tiles(cuda, dtype, tol, b, h, w):
    rng = np.random.RandomState(h + w)
    x = torch.from_numpy((rng.randn(b, h, w, 3) * 30).astype(np.float32)).to(cuda)
    wts = _block1_weights(rng, cuda)
    n0 = vgg_block1_kernel.fused_vgg_block1.launches
    got = vgg_block1_kernel.fused_vgg_block1(x, *wts, dtype=dtype)
    torch.cuda.synchronize()
    assert vgg_block1_kernel.fused_vgg_block1.launches == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, h // 2, w // 2, 64)
    assert max_rel(got, vgg_block1_kernel.vgg_block1_plain(x, *wts, dtype=dtype)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_vgg_block1_is_bit_identical_to_the_wrapper(cuda, dtype):
    rng = np.random.RandomState(13)
    x = torch.from_numpy((rng.randn(1, 64, 96, 3) * 30).astype(np.float32)).to(cuda)
    wts = _block1_weights(rng, cuda)
    got = vgg_block1_kernel.fused_vgg_block1(x, *wts, dtype=dtype)
    packed = vgg_block1_kernel.packed_vgg_block1(*wts, dtype, cuda)
    assert torch.equal(vgg_block1_kernel.launch_vgg_block1(x, packed, dtype), got)
    # a bf16 image takes the same kernel
    xb = x.to(torch.bfloat16)
    assert max_rel(vgg_block1_kernel.launch_vgg_block1(xb, packed, dtype),
                   vgg_block1_kernel.vgg_block1_plain(xb, *wts, dtype=dtype)) <= (
        1e-4 if dtype == torch.float32 else ONE_BF16_STEP)


@pytest.mark.gpu
def test_vgg_block1_launch_resources(cuda):
    """The bf16 kernel spills nothing and fits one persistent CTA an SM;
    the f32 FMA kernel fits at least one."""
    bf = vgg_block1_kernel.vgg_block1_info(torch.bfloat16)
    assert bf["spill_bytes"] == 0 and bf["ctas_per_sm"] >= 1 and bf["smem_bytes"] > 160_000, bf
    assert vgg_block1_kernel.vgg_block1_info(torch.float32)["ctas_per_sm"] >= 1


# bf16: kernel and plain version round the same f32 sums at the same points,
# but the sums run in other orders, so an activation may round to the
# neighbouring bf16 value, and such steps compound through the blocks' rounded
# intermediates (layer1's 1.28e-2 over three blocks is the same event).
RES_STAGE_BF16_TOL = 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,width,cin,blocks,stride", [
    (2, 26, 42, 128, 256, 3, 2),    # layer2-like: stride-2 entry, 13x21 output, partial tiles
    (2, 11, 19, 256, 512, 2, 1),    # layer3 width, stride-1 entry, partial tiles
    (1, 18, 9, 256, 1024, 2, 1),    # identity-width input to block0, one column of tiles
    (1, 100, 152, 128, 256, 4, 1),  # layer2's shape on the main path: 247 tiles
    (1, 50, 76, 256, 512, 4, 1),    # layer3's shape (4 of its 23 blocks): 70 tiles, 2x4 and
                                    # 8x4 partial tiles on the edges
    (2, 50, 76, 256, 512, 4, 1),    # the same at batch 2, as the RL train step runs it
    (1, 17, 33, 128, 512, 2, 1),    # an odd tile count (3x5), block0 with cin 512 at width 128
])
def test_res_stage_kernel_matches_plain(cuda, dtype, b, h, w, width, cin, blocks, stride):
    rng = np.random.RandomState(width + h)
    layer = ResLayer(cin, width, blocks, stride).requires_grad_(False)
    _randomize_bn(layer, rng)
    with torch.no_grad():
        for p in layer.parameters():
            p.mul_(4.0)   # keep activations O(1) through the blocks
    layer = layer.to(cuda)
    x = torch.from_numpy(np.abs(rng.randn(b, h, w, cin)).astype(np.float32)).to(cuda, dtype)
    xs = x[:, ::stride, ::stride].contiguous()
    n0 = res_stage_kernel.fused_res_stage.launches
    got = res_stage_kernel.fused_res_stage(xs, layer, blocks=blocks, width=width, dtype=dtype)
    torch.cuda.synchronize()
    assert res_stage_kernel.fused_res_stage.launches == n0 + blocks
    assert got.dtype == dtype and tuple(got.shape) == (*xs.shape[:3], 4 * width)
    want = res_stage_kernel.res_stage_plain(
        xs, res_stage_kernel.pack_res_stage(layer, blocks, width, dtype), dtype)
    assert float(want.float().abs().max()) > 0
    tol = 1e-4 if dtype == torch.float32 else RES_STAGE_BF16_TOL
    assert max_rel(got, want) < tol
    # against the unfolded modules too (f32 only: bf16 rounds elsewhere there)
    if dtype == torch.float32:
        with torch.no_grad():
            ref = layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert max_rel(got, ref) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_res_stage_is_bit_identical_to_the_wrapper(cuda, dtype):
    rng = np.random.RandomState(11)
    layer = ResLayer(512, 256, 3, 1).requires_grad_(False)
    _randomize_bn(layer, rng)
    layer = layer.to(cuda)
    x = torch.from_numpy(np.abs(rng.randn(1, 21, 30, 512)).astype(np.float32)).to(cuda, dtype)
    got = res_stage_kernel.fused_res_stage(x, layer, blocks=3, width=256, dtype=dtype)
    packed = res_stage_kernel.packed_res_stage(layer, 3, 256, dtype, cuda)
    assert torch.equal(res_stage_kernel.launch_res_stage(x, packed, dtype), got)


@pytest.mark.gpu
def test_res_stage_launch_resources(cuda):
    """The bf16 kernel spills nothing, fits two CTAs an SM, and puts more
    CTAs to work than the card has SMs for layer3 at batch 1."""
    info = res_stage_kernel.res_stage_info(torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, r in info.items():
        assert r["spill_bytes"] == 0 and r["ctas_per_sm"] >= 2 and r["cluster"] == 2, (name, r)
    assert info["layer3 blocks 1+"]["grid"] == (140, 1, 1) and 140 >= sms
    assert info["layer3 blocks 1+"]["ctas_at_once"] >= 140
    f32 = res_stage_kernel.res_stage_info(torch.float32)
    assert f32["layer3 blocks 1+"]["grid"] == (10, 7, 1) and f32["layer3 block0"]["cluster"] == 1


@pytest.mark.gpu
def test_res_stage_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    layer = ResLayer(256, 128, 2, 2).requires_grad_(False).to(cuda)
    x = torch.zeros(1, 8, 8, 256, device=cuda, dtype=torch.bfloat16)
    run = lambda xi, **kw: res_stage_kernel.fused_res_stage(xi, layer, blocks=2, width=128, **kw)
    with pytest.raises(ValueError, match="dtype"):
        run(x.float())                                   # wrong dtype
    with pytest.raises(ValueError, match="contiguous"):
        run(x.permute(0, 2, 1, 3))                       # not contiguous
    with pytest.raises(RuntimeError, match="forward-only"):
        run(x.float().requires_grad_(), dtype=torch.float32)
    layer.block1.conv2.weight.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        run(x)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 40, 40, 3, device=cuda)
    w = torch.zeros(64, 3, 7, 7, device=cuda)
    bn = [torch.ones(64, device=cuda)] * 4
    with pytest.raises(ValueError):
        stem_kernel.fused_stem(x.permute(0, 2, 1, 3), w, *bn)      # not contiguous
    with pytest.raises(ValueError, match="even"):
        vgg_block1_kernel.fused_vgg_block1(x[:, :39], torch.zeros(64, 3, 3, 3, device=cuda),
                                           bn[0], torch.zeros(64, 64, 3, 3, device=cuda), bn[0])
    with pytest.raises(ValueError):
        roi_align_kernel.roi_align_avg(torch.zeros(1, 5, 5, 8, device=cuda),
                                       torch.zeros(3, 5, device=cuda), pooled_size=6)


# The RoIAlignAvg backward kernel sums with f32 atomics in an order that
# changes from run to run, its plain version with index_add_: in f32 they
# agree to 1e-5 of the largest gradient; in bf16 both round their f32 sums
# once, so an element may round to its neighbour (one bf16 step).
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: ONE_BF16_STEP}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_images,h,w,c,r", [
    (2, 50, 76, 1024, 256),    # the flagship's train step: 2 x 128 rois
    (1, 50, 76, 512, 300),     # VGG-16's channels
    (2, 9, 11, 64, 7),         # small, rois mostly over the border
    (2, 13, 17, 36, 40),       # C not a multiple of 8, one partial channel chunk
    (1, 50, 76, 1024, 0),      # no rois: zeros
])
def test_roi_align_bwd_kernel_matches_plain(cuda, dtype, n_images, h, w, c, r):
    rng = np.random.RandomState(c + r)
    rois = torch.from_numpy(_rois(rng, r, n_images, 16 * h, 16 * w)).to(cuda)
    grad = torch.from_numpy(rng.randn(r, 7, 7, c).astype(np.float32)).to(cuda, dtype)
    shape = (n_images, h, w, c)
    n0 = roi_align_kernel.roi_align_avg_bwd.launches
    got = roi_align_kernel.roi_align_avg_bwd(grad, rois, shape)
    torch.cuda.synchronize()
    assert roi_align_kernel.roi_align_avg_bwd.launches == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == shape
    want = roi_align.roi_align_avg_backward(grad, rois, shape, dtype)
    if r == 0:
        assert not got.float().abs().any()
        return
    assert float(want.float().abs().max()) > 0
    assert max_rel(got, want) <= BWD_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_avg_gradient_runs_the_backward_kernel(cuda, dtype):
    """autograd through `roi_align_avg` on the card: the forward and the
    backward kernel launch once each, the rois get no gradient, and the
    features' gradient is the plain backward's."""
    rng = np.random.RandomState(21)
    feats = torch.from_numpy(rng.randn(2, 20, 30, 256).astype(np.float32)).to(cuda, dtype)
    feats.requires_grad_(True)
    rois = torch.from_numpy(_rois(rng, 50, 2, 320, 480)).to(cuda)
    g = torch.from_numpy(rng.randn(50, 7, 7, 256).astype(np.float32)).to(cuda, dtype)
    n0 = (roi_align_kernel.roi_align_avg.launches, roi_align_kernel.roi_align_avg_bwd.launches)
    roi_align_kernel.roi_align_avg(feats, rois).backward(g)
    torch.cuda.synchronize()
    assert (roi_align_kernel.roi_align_avg.launches,
            roi_align_kernel.roi_align_avg_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    want = roi_align.roi_align_avg_backward(g, rois, tuple(feats.shape), dtype)
    assert feats.grad.dtype == dtype and max_rel(feats.grad, want) <= BWD_TOL[dtype]


@pytest.mark.gpu
def test_roi_align_bwd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    rois = torch.zeros(3, 5, device=cuda)
    with pytest.raises(ValueError, match="pooled_size"):
        roi_align_kernel.roi_align_avg_bwd(torch.zeros(3, 6, 6, 8, device=cuda), rois,
                                           (1, 5, 5, 8))
    with pytest.raises(ValueError, match="grad must be"):
        roi_align_kernel.roi_align_avg_bwd(torch.zeros(3, 7, 7, 8, device=cuda), rois,
                                           (1, 5, 5, 16))
    with pytest.raises(ValueError, match="rois must be"):
        roi_align_kernel.roi_align_avg_bwd(torch.zeros(3, 7, 7, 8, device=cuda), rois.cpu(),
                                           (1, 5, 5, 8))


@pytest.mark.gpu
def test_train_step_bf16_on_the_card(cuda):
    """One bf16 ResNet-50 train step on the card (stem, layer1 and both
    RoIAlignAvg kernels) at 256x320, batch 2: finite losses, the kernels
    launched, the trainable parameters moved and the frozen ones not."""
    from rlobjectdetection_tpu_torch.config import Config, TrainConfig
    from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step
    from rlobjectdetection_tpu_torch.models import FasterRCNN

    cfg = Config(TRAIN=TrainConfig(RPN_PRE_NMS_TOP_N=2000, RPN_POST_NMS_TOP_N=256),
                 ANCHOR_SCALES=(4, 8, 16, 32), CONV1_FUSED=True, LAYER1_FUSED=True)
    model = FasterRCNN(21, "resnet50", cfg, device=cuda, seed=4)
    opt, sched, labels = build_optimizer(model, "resnet50", base_lr=0.001)
    rng = np.random.RandomState(6)
    gt = np.zeros((2, 10, 5), np.float32)
    gt[:, :3, :2] = rng.rand(2, 3, 2) * 200
    gt[:, :3, 2:4] = gt[:, :3, :2] + 30 + rng.rand(2, 3, 2) * 80
    gt[:, :3, 4] = rng.randint(1, 21, (2, 3))
    batch = {"data": torch.from_numpy(rng.randn(2, 256, 320, 3).astype(np.float32) * 10),
             "im_info": torch.tensor([[256.0, 320.0, 1.0]] * 2), "gt_boxes": torch.from_numpy(gt),
             "num_boxes": torch.tensor([3, 3])}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    counters = (stem_kernel.fused_stem, layer1_kernel.fused_layer1,
                roi_align_kernel.roi_align_avg, roi_align_kernel.roi_align_avg_bwd)
    n0 = [f.launches for f in counters]
    metrics = make_train_step(model, opt, sched)(batch, torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert all(np.isfinite(float(metrics[k])) for k in ("loss", "rpn_cls", "rpn_box", "rcnn_cls",
                                                         "rcnn_box"))
    assert int(metrics["fg_cnt"]) + int(metrics["bg_cnt"]) == 2 * cfg.TRAIN.BATCH_SIZE
    assert all(f.launches > n for f, n in zip(counters, n0))
    after = model.state_dict()
    for k, v in after.items():
        assert torch.equal(v, before[k]) == (labels.get(k, "frozen") == "frozen"), k
