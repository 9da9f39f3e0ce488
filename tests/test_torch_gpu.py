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


# The RoIAlignAvg backward kernel sums each element's contributions in f32
# in an order fixed by the inputs (roi, sample row, sample column), its plain
# version with index_add_ in another: in f32 they agree to 1e-5 of the
# largest gradient; in bf16 both round their f32 sums once, so an element
# may round to its neighbour (one bf16 step). Two launches of the kernel
# give the same bits.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: ONE_BF16_STEP}


def _check_bwd_kernel(grad, rois, shape, dtype):
    """One launch against the plain version, and a second launch bit for
    bit against the first."""
    n0 = roi_align_kernel.roi_align_avg_bwd.launches
    got = roi_align_kernel.roi_align_avg_bwd(grad, rois, shape)
    again = roi_align_kernel.roi_align_avg_bwd(grad, rois, shape)
    torch.cuda.synchronize()
    assert roi_align_kernel.roi_align_avg_bwd.launches == n0 + 2
    assert got.dtype == dtype and tuple(got.shape) == shape
    assert torch.equal(got, again)
    want = roi_align.roi_align_avg_backward(grad, rois, shape, dtype)
    if rois.shape[0] == 0:
        assert not got.float().abs().any()
        return
    assert float(want.float().abs().max()) > 0
    assert max_rel(got, want) <= BWD_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_images,h,w,c,r", [
    (2, 50, 76, 1024, 256),    # the flagship's train step: 2 x 128 rois
    (1, 50, 76, 512, 300),     # VGG-16's channels
    (2, 50, 76, 512, 256),     # VGG-16's train step: two channel chunks a feature row
    (2, 9, 11, 64, 7),         # small, rois mostly over the border
    (2, 13, 17, 36, 40),       # C not a multiple of 8, one partial channel chunk
    (1, 50, 76, 1024, 0),      # no rois: zeros
    (2, 20, 230, 64, 80),      # 230 columns: three column bands of 96
    (8, 50, 76, 1024, 1024),   # bench.py's train batch: 8 x 128 rois
])
def test_roi_align_bwd_kernel_matches_plain(cuda, dtype, n_images, h, w, c, r):
    rng = np.random.RandomState(c + r)
    rois = torch.from_numpy(_rois(rng, r, n_images, 16 * h, 16 * w)).to(cuda)
    grad = torch.from_numpy(rng.randn(r, 7, 7, c).astype(np.float32)).to(cuda, dtype)
    _check_bwd_kernel(grad, rois, (n_images, h, w, c), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_bwd_kernel_first_step_rois(cuda, dtype):
    """The rois of a random net's first train step: 8 boxes an image, each
    repeated 16 times (proposal_target's fg-only draw), so a row under
    overlapping boxes carries many entries. The boxes are drawn as bench.py
    draws its gt boxes: 40-190 pixels a side on an 800 x 1216 image."""
    rng = np.random.RandomState(8)
    boxes = np.zeros((16, 5), np.float32)
    boxes[:, 0] = np.repeat([0, 1], 8)
    boxes[:, 1:3] = rng.randint(0, [1016, 600], (16, 2))
    boxes[:, 3:5] = boxes[:, 1:3] + rng.randint(40, 190, (16, 2))
    rois = torch.from_numpy(np.repeat(boxes, 16, axis=0)).to(cuda)
    grad = torch.from_numpy(rng.randn(256, 7, 7, 1024).astype(np.float32)).to(cuda, dtype)
    _check_bwd_kernel(grad, rois, (2, 50, 76, 1024), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_bwd_kernel_many_rois_a_row(cuda, dtype):
    """1200 rois over one small image: every feature row takes entries from
    more rois than the kernel gathers at once (512), so it sums them in
    several batches of gathered rois, in roi order all the same."""
    rng = np.random.RandomState(9)
    rois = np.zeros((1200, 5), np.float32)
    rois[:, 1:3] = rng.uniform(-20, 40, (1200, 2))
    rois[:, 3:5] = rng.uniform(250, 330, (1200, 2))
    grad = torch.from_numpy(rng.randn(1200, 7, 7, 64).astype(np.float32)).to(cuda, dtype)
    _check_bwd_kernel(grad, torch.from_numpy(rois).to(cuda), (1, 20, 20, 64), dtype)


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


@pytest.mark.gpu
def test_vgg16_train_step_kernels_vs_plain_on_the_card(cuda):
    """One f32 VGG-16 step at 256x320, batch 2 (blocks 1-2 frozen, dropout,
    clip 10) with the block-1 and both RoIAlignAvg kernels against the same
    step with their plain versions, from the same parameters and draws: the
    losses 1e-4, each trainable update 1e-3 of its largest, the frozen
    blocks untouched. The plain run takes the kernel run's max-pool routes
    and ReLU gates where rounding decides them (`vgg_ties`: see
    tests/test_torch_vgg_train.py)."""
    from rlobjectdetection_tpu_torch.config import Config, TrainConfig
    from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step
    from rlobjectdetection_tpu_torch.models import FasterRCNN, faster_rcnn
    from rlobjectdetection_tpu_torch.models.backbones import vgg, vgg_ties

    cfg = Config(TRAIN=TrainConfig(RPN_PRE_NMS_TOP_N=2000, RPN_POST_NMS_TOP_N=256),
                 ANCHOR_SCALES=(4, 8, 16, 32), CONV1_FUSED=True, DTYPE="float32")
    model = FasterRCNN(21, "vgg16", cfg, device=cuda, seed=4)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(7)
    gt = np.zeros((2, 10, 5), np.float32)
    gt[:, :3, :2] = rng.rand(2, 3, 2) * 200
    gt[:, :3, 2:4] = gt[:, :3, :2] + 30 + rng.rand(2, 3, 2) * 80
    gt[:, :3, 4] = rng.randint(1, 21, (2, 3))
    batch = {"data": torch.from_numpy(rng.randn(2, 256, 320, 3).astype(np.float32) * 10),
             "im_info": torch.tensor([[256.0, 320.0, 1.0]] * 2), "gt_boxes": torch.from_numpy(gt)}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    counters = (vgg_block1_kernel.fused_vgg_block1, roi_align_kernel.roi_align_avg,
                roi_align_kernel.roi_align_avg_bwd)

    def step():
        model.load_state_dict(state)
        opt, sched, labels = build_optimizer(model, "vgg16", base_lr=0.01, clip_norm=10.0)
        metrics = make_train_step(model, opt, sched)(
            batch, torch.Generator(device=cuda).manual_seed(1),
            torch.Generator(device=cuda).manual_seed(2))
        after = model.state_dict()
        return ({k: float(metrics[k]) for k in ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box")},
                {k: after[k] - state[k] for k, v in labels.items() if v != "frozen"}, labels)

    n0 = [f.launches for f in counters]
    ties, counts = {}, {}
    with vgg_ties.record(model.base, ties):
        got, got_up, labels = step()
    assert [f.launches for f in counters] == [n + 1 for n in n0]
    assert all(torch.equal(model.state_dict()[k], state[k]) for k in state
               if labels.get(k, "frozen") == "frozen")
    with pytest.MonkeyPatch.context() as mp, vgg_ties.replay(model.base, ties, counts):
        mp.setattr(faster_rcnn, "roi_align_avg", roi_align.roi_align_avg)
        mp.setattr(vgg, "fused_vgg_block1", vgg_block1_kernel.vgg_block1_plain)
        want, want_up, _ = step()
    assert [f.launches for f in counters] == [n + 1 for n in n0] and counts["pools"] == 3
    # every decision taken was a tie (chip_smoke.py's TIE_SIZE_TOL)
    assert counts["routed"] < 1e-5 and counts["flipped_max"] < 1e-5, counts
    for k, v in want.items():
        assert np.isfinite(v) and abs(got[k] - v) <= 1e-4 * abs(v), (k, got[k], v)
    for k, up in want_up.items():
        assert float(up.abs().max()) > 0 and max_rel(got_up[k], up) <= 1e-3, k


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["pool", "crop"])
def test_roi_modes_on_the_card_match_the_cpu(cuda, mode):
    """roi_pool / roi_crop (plain PyTorch) on the card against the same
    function on the CPU in f32, output and gradient 1e-5: integer division,
    the gathers and the gradients' sums on CUDA."""
    from rlobjectdetection_tpu_torch.ops import roi_crop, roi_pool

    op = {"pool": lambda f, r: roi_pool.roi_pool(f, r, 7, 7, 1.0 / 16.0),
          "crop": lambda f, r: roi_crop.roi_crop(f, r, 14, 1.0 / 16.0)}[mode]
    rng = np.random.RandomState(12)
    feats = np.maximum(rng.randn(2, 20, 30, 64), 0).astype(np.float32)
    rois = torch.from_numpy(_rois(rng, 40, 2, 320, 480))
    ct = torch.from_numpy(rng.randn(40, 7, 7, 64).astype(np.float32))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        f = torch.from_numpy(feats).to(dev).requires_grad_(True)
        out = op(f, rois.to(dev))
        out.backward(ct.to(dev))
        grads.append((out.detach().cpu(), f.grad.cpu()))
    (out, grad), (want_out, want_grad) = grads
    assert float(want_grad.abs().max()) > 0
    assert max_rel(out, want_out) <= 1e-5 and max_rel(grad, want_grad) <= 1e-5


@pytest.mark.gpu
def test_eval_loop_gives_detector_detect_on_each_image(cuda, tmp_path, monkeypatch):
    """`engine/test_net.py`'s eval loop (batch 1, device_prefetch) on two
    synthetic COCO images at TEST.SCALES [800], bf16: each image's
    detections equal `Detector.detect` on the same file to the bit (the
    same blob, model and kernels), and the stem, layer1 and RoIAlignAvg
    kernels launch in the loop."""
    from rlobjectdetection_tpu_torch.data.blob import read_image_bgr
    from rlobjectdetection_tpu_torch.data.imdb import combined_roidb
    from rlobjectdetection_tpu_torch.data.synthetic import make_coco_dataset
    from rlobjectdetection_tpu_torch.engine import test_net
    from rlobjectdetection_tpu_torch.engine.serve import Detector, build_config
    from rlobjectdetection_tpu_torch.models import FasterRCNN

    make_coco_dataset(str(tmp_path), num_images=2, image_size=(480, 640))
    monkeypatch.setenv("RLOD_DATA_DIR", str(tmp_path))
    imdb_obj, roidb, ratio_list, ratio_index = combined_roidb(
        "coco_2014_minival", training=False, use_flipped=False)
    cfg = build_config("coco", ["TEST.SCALES", "[800]", "DTYPE", "bfloat16"])
    model = FasterRCNN(imdb_obj.num_classes, "resnet50", cfg, device=cuda)
    counters = (stem_kernel.fused_stem, layer1_kernel.fused_layer1, roi_align_kernel.roi_align_avg)
    before = [f.launches for f in counters]
    dets, stats = test_net.detect_loop(model, cfg, roidb, ratio_list, ratio_index, batch=1)
    assert all(f.launches > n for f, n in zip(counters, before))
    assert stats["shape_buckets"] == {(800, 1088): 2}
    detector = Detector(model, cfg, cuda)
    for i, e in enumerate(roidb):
        want = detector.detect(read_image_bgr(e["image"]))
        for got, w in zip(dets[i], want):
            assert got.dtype == w.dtype
            np.testing.assert_array_equal(got, w)


GPU_TINY_SET = ["TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N", "64",
                "TRAIN.BATCH_SIZE", "32", "TRAIN.SCALES", "[128]", "TRAIN.USE_FLIPPED", "False",
                "TEST.SCALES", "[128]", "ANCHOR_SCALES", "(2,3,5)", "DTYPE", "bfloat16"]


@pytest.fixture
def voc_root(tmp_path, monkeypatch):
    from rlobjectdetection_tpu_torch.data.synthetic import make_voc_devkit

    make_voc_devkit(str(tmp_path / "voc"), num_images=4, image_size=(128, 160),
                    classes=("aeroplane", "bicycle", "bird"))
    monkeypatch.setenv("RLOD_DATA_DIR", str(tmp_path / "voc"))
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["tiny", "res50"])
def test_trainval_cli_steps_on_the_card(cuda, voc_root, net):
    """Two CLI steps (one epoch of 4 images at batch 2) on the card, bf16:
    a finite checkpoint at step 2, and each kernel of the path launched at
    least once a step (layer1 three times)."""
    from rlobjectdetection_tpu_torch.engine import trainval_net
    from rlobjectdetection_tpu_torch.engine.checkpoint import read_checkpoint

    counters = {"roi_align_avg": roi_align_kernel.roi_align_avg,
                "roi_align_avg_bwd": roi_align_kernel.roi_align_avg_bwd}
    if net == "res50":
        counters.update(stem=stem_kernel.fused_stem, layer1=layer1_kernel.fused_layer1)
    before = {k: f.launches for k, f in counters.items()}
    result = trainval_net.main(["--dataset", "pascal_voc", "--net", net, "--epochs", "1",
                                "--bs", "2", "--nw", "2", "--save_dir", "models",
                                "--set", *GPU_TINY_SET])
    moved = {k: f.launches - before[k] for k, f in counters.items()}
    assert result["step"] == 2
    assert all(n >= (6 if k == "layer1" else 2) for k, n in moved.items()), moved
    ck = read_checkpoint(result["checkpoints"][0])
    assert ck["step"] == 2 and all(torch.isfinite(v).all() for v in ck["model"].values())


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A checkpoint of a card model loads into a fresh card model bit for
    bit, and the stem and layer1 kernels, called before the load, pack
    again and give the loaded weights' output."""
    from rlobjectdetection_tpu_torch.config import Config
    from rlobjectdetection_tpu_torch.engine import build_optimizer
    from rlobjectdetection_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.ops.pack_cache import cached_pack

    cfg = Config(DTYPE="bfloat16", CONV1_FUSED=True, LAYER1_FUSED=True)
    src = FasterRCNN(21, "resnet50", cfg, device=cuda, seed=9)
    with torch.no_grad():
        _randomize_bn(src, np.random.RandomState(4))
    opt, sched, _ = build_optimizer(src, "resnet50", 0.01)
    path = str(tmp_path / "c.pth")
    save_checkpoint(path, src, opt, sched, epoch=1, step=5)
    model = FasterRCNN(21, "resnet50", cfg, device=cuda, seed=3)
    opt2, sched2, _ = build_optimizer(model, "resnet50", 0.01)
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 128, 160, 3).astype(np.float32)
                         * 30).to(cuda)
    with torch.no_grad():
        model.base(x, fwd_only=True)
        packs = cached_pack.packs
        meta = load_checkpoint(path, model, opt2, sched2)
        got = model.base(x, fwd_only=True)
        assert cached_pack.packs >= packs + 2
        assert torch.equal(got, src.base(x, fwd_only=True))
    assert meta["step"] == 5
    want = src.state_dict()
    assert all(torch.equal(v, want[k]) and v.is_cuda for k, v in model.state_dict().items())


@pytest.mark.gpu
def test_demo_on_one_image_on_the_card(cuda, voc_root):
    """`demo` with a card checkpoint writes the image's `_det.jpg`, and its
    detections are `Detector.detect`'s."""
    import shutil

    from rlobjectdetection_tpu_torch.data.blob import read_image_bgr
    from rlobjectdetection_tpu_torch.engine import demo, trainval_net
    from rlobjectdetection_tpu_torch.engine.checkpoint import load_checkpoint, read_checkpoint
    from rlobjectdetection_tpu_torch.engine.serve import Detector
    from rlobjectdetection_tpu_torch.models import FasterRCNN

    ckpt = trainval_net.main(["--dataset", "pascal_voc", "--net", "res50", "--epochs", "1",
                              "--bs", "2", "--nw", "0", "--save_dir", "models",
                              "--set", *GPU_TINY_SET])["checkpoints"][0]
    images = voc_root / "one"
    images.mkdir()
    shutil.copy(voc_root / "voc" / "VOCdevkit2007" / "VOC2007" / "JPEGImages" / "000000.jpg",
                images)
    dets = demo.main(["--net", "res50", "--image_dir", str(images), "--load_name", ckpt,
                      "--set", *GPU_TINY_SET])
    assert (images / "000000_det.jpg").exists()
    payload = read_checkpoint(ckpt)
    model = FasterRCNN(21, "resnet50", demo.build_config(None, GPU_TINY_SET), device=cuda)
    load_checkpoint(payload, model)
    want = Detector(model, model.cfg, cuda).detect(read_image_bgr(str(images / "000000.jpg")))
    for got, w in zip(dets["000000.jpg"], want):
        np.testing.assert_array_equal(got, w)
