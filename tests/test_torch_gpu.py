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
import torch_threads  # noqa: F401  (xdist workers share the cores)


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
    from rlobjectdetection_tpu_torch.utils import tracing

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
        packs = tracing.totals().get("pack.misses", 0)
        meta = load_checkpoint(path, model, opt2, sched2)
        got = model.base(x, fwd_only=True)
        assert tracing.totals().get("pack.misses", 0) >= packs + 2
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


# -- a served image's blob (csrc/image_blob.cu) -------------------------------------

# (h, w, target, dtype, pad_to): the serve pool's eight COCO sizes at 800, a
# downscale, 1-pixel edges, h·scale and w·scale at .5, uint8, a pad_to canvas
IMAGE_BLOB_CASES = [(480, 640, 800, "float32", None), (640, 480, 800, "float32", None),
                    (427, 640, 800, "float32", None), (640, 427, 800, "float32", None),
                    (375, 500, 800, "float32", None), (500, 375, 800, "float32", None),
                    (612, 612, 800, "float32", None), (512, 640, 800, "float32", None),
                    (61, 97, 40, "float32", None), (1, 7, 5, "float32", None),
                    (9, 1, 3, "float32", None), (4, 6, 5, "float32", None),
                    (6, 4, 5, "float32", None), (2, 5, 5, "float32", None),
                    (480, 640, 800, "uint8", None), (61, 97, 150, "uint8", None),
                    (480, 640, 800, "float32", (1024, 1312)), (480, 640, 800, "uint8", (832, 1120))]


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,target,dtype,pad_to", IMAGE_BLOB_CASES)
def test_image_blob_kernel_matches_plain_to_the_bit(cuda, h, w, target, dtype, pad_to):
    """The kernel's blob against the plain version's on the CPU, every bit
    (the pad's zeros included), from a contiguous image and from one with a
    column stride (the wrapper copies it)."""
    from rlobjectdetection_tpu_torch.data.blob import (PIXEL_MEANS_BGR, blob_scale, pad_shape,
                                                       resized_shape)
    from rlobjectdetection_tpu_torch.ops.image_blob import image_blob, launch_image_blob

    im = np.random.default_rng(h * w).integers(0, 256, (h, 2 * w, 3)).astype(dtype)
    scale = blob_scale(h, w, target)
    size = resized_shape(h, w, scale)
    pad = pad_shape(*size) if pad_to is None else pad_to
    means = torch.tensor(PIXEL_MEANS_BGR.reshape(3))
    n0 = launch_image_blob.launches
    for src, on_card in ((im[:, :w].copy(), torch.from_numpy(im[:, :w].copy()).to(cuda)),
                         (im[:, ::2].copy(), torch.from_numpy(im).to(cuda)[:, ::2])):
        got = image_blob(on_card, means.to(cuda), scale, size, pad)
        torch.cuda.synchronize()
        want = image_blob(torch.from_numpy(src), means, scale, size, pad)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert launch_image_blob.launches == n0 + 2


@pytest.mark.gpu
def test_detector_stages_the_image_and_builds_the_blob_on_the_card(cuda):
    """A CUDA `Detector` over the serve pool's eight sizes: each request
    launches the blob kernel once, allocates no staging buffer after the
    first pass, and copies nothing pageable but the RPN's anchors; its
    blob and im_info equal the host-built ones to the bit."""
    from rlobjectdetection_tpu_torch.data.blob import PIXEL_MEANS_BGR, prep_im_for_blob
    from rlobjectdetection_tpu_torch.data.minibatch import im_list_to_blob
    from rlobjectdetection_tpu_torch.engine.serve import Detector, build_config
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.ops.anchors import shifted_anchors
    from rlobjectdetection_tpu_torch.utils import tracing

    cfg = build_config("coco", ["TEST.SCALES", "[800]", "DTYPE", "bfloat16"])
    detector = Detector(FasterRCNN(81, "resnet50", cfg, device=cuda), cfg, cuda)
    rng = np.random.default_rng(5)
    sizes = [(480, 640), (640, 480), (427, 640), (640, 427), (375, 500), (500, 375),
             (612, 612), (512, 640)]
    images = [rng.integers(0, 256, (h, w, 3)).astype(np.float32) for h, w in sizes]
    for im in images:
        detector.detect(im)
    count = lambda k: tracing.totals().get(k, 0)
    for im in images:
        before = {k: count(k) for k in ("blob.kernel_calls", "blob.staging_allocs",
                                        "h2d.pageable_bytes")}
        detector.detect(im)
        moved = {k: count(k) - n for k, n in before.items()}
        resized, scale = prep_im_for_blob(im, PIXEL_MEANS_BGR, 800)
        want = im_list_to_blob([resized])
        anchors = shifted_anchors(want.shape[1] // 16, want.shape[2] // 16, 16,
                                  ratios=tuple(cfg.ANCHOR_RATIOS),
                                  scales=tuple(cfg.ANCHOR_SCALES))
        assert moved == {"blob.kernel_calls": 1, "blob.staging_allocs": 0,
                         "h2d.pageable_bytes": anchors.nbytes}, (im.shape, moved)
        data, info = detector.inputs(im)
        assert torch.equal(data.cpu().view(torch.int32),
                           torch.from_numpy(want).view(torch.int32))
        assert info.cpu().numpy().tolist() == np.array(
            [[*resized.shape[:2], scale]], np.float32).tolist()


# -- NMS ---------------------------------------------------------------------------

def _nms_boxes(rng, lanes, n):
    """`[lanes, n, 4]` f32 boxes in score order: jittered clusters (the
    RPN's and a class's overlaps) and scattered boxes, half of them on
    integers, with pairs whose IoU is exactly 0.7 or 0.3 in f32 (widths 17
    over 3 px, 13 over 7 px, any height), duplicates of earlier boxes and
    boxes one pixel wide or high."""
    centres = rng.rand(lanes, max(1, n // 40), 2) * 900 + 50
    pick = rng.randint(0, centres.shape[1], (lanes, n))
    ctr = np.take_along_axis(centres, pick[..., None], 1) + rng.randn(lanes, n, 2) * 8
    ctr = np.where(rng.rand(lanes, n, 1) < 0.2, rng.rand(lanes, n, 2) * 1000, ctr)
    wh = 20 + rng.rand(lanes, 1, 2) * 80 * np.exp(rng.randn(lanes, n, 2) * 0.2)
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    boxes = np.where(rng.rand(lanes, n, 1) < 0.5, np.round(boxes), boxes)
    for lane in range(lanes):
        for _ in range(n // 20):                       # a tie pair at i < j
            i, j = np.sort(rng.choice(n, 2, replace=False))
            x, y, h = rng.randint(0, 900), rng.randint(0, 900), rng.randint(1, 60)
            w, s = (17, 3) if rng.rand() < 0.5 else (13, 7)
            boxes[lane, i] = (x, y, x + w - 1, y + h - 1)
            boxes[lane, j] = (x + s, y, x + s + w - 1, y + h - 1)
        for _ in range(n // 20):                       # a duplicate
            i, j = np.sort(rng.choice(n, 2, replace=False))
            boxes[lane, j] = boxes[lane, i]
        thin = rng.rand(n) < 0.03                      # one pixel wide or high
        boxes[lane, thin, 2] = boxes[lane, thin, 0]
        flat = rng.rand(n) < 0.03
        boxes[lane, flat, 3] = boxes[lane, flat, 1]
    return boxes.astype(np.float32)


def _prefix_equal(got, want, max_keep):
    """Each lane equal through its `max_keep`-th survivor of `want`, False after it."""
    before = want.to(torch.int32).cumsum(-1) - want.to(torch.int32)
    upto = before < max_keep
    return bool(torch.equal(got[upto], want[upto]) and not got[~upto].any())


# (lanes, N, tile_size): the op's edges at the 64-box words and at the one-CTA
# limit (512), the main path's shapes (per-class 80 and 1600 × 300, RPN 6000
# and 2 × 12000), and the IoU form against the kernel's path (300 boxes in
# the divided form, 600 in the product form)
@pytest.mark.gpu
@pytest.mark.parametrize("max_keep", [None, 100, 300, 2000])
@pytest.mark.parametrize("thresh", [0.3, 0.7])
@pytest.mark.parametrize("lanes,n,tile", [
    (1, 0, 256), (1, 1, 256), (1, 63, 256), (1, 64, 256), (1, 65, 256), (80, 300, 256),
    (1, 512, 256), (1, 513, 256), (1, 6000, 256), (2, 12000, 256), (1600, 300, 256),
    (3, 300, 64), (2, 600, 512)])
def test_nms_kernel_matches_the_plain_body(cuda, monkeypatch, lanes, n, tile, thresh, max_keep):
    """`rlod::nms_sorted_mask` on the card (the kernel) against the op's body
    `_nms_sorted_mask` on the same tensors: the same mask to the bit without
    `max_keep`, each lane's mask through its `max_keep`-th survivor with it;
    `nms_select` gives the same outputs to the bit either way."""
    from rlobjectdetection_tpu_torch.ops import nms as nms_mod
    from rlobjectdetection_tpu_torch.ops.nms_kernel import launch_nms, scratch_words

    rng = np.random.RandomState(lanes * 100003 + n * 7 + tile + int(thresh * 10))
    boxes = torch.from_numpy(_nms_boxes(rng, lanes, n)).to(cuda)
    valid = torch.from_numpy(rng.rand(lanes, n) > 0.15).to(cuda)
    n0 = launch_nms.launches
    got = nms_mod.nms_sorted_mask(boxes, valid, thresh, tile_size=tile, max_keep=max_keep)
    torch.cuda.synchronize()
    one_launch = scratch_words(lanes, n) == 0
    assert launch_nms.launches == n0 + (0 if n == 0 else 1 if one_launch else 2)
    want = nms_mod._nms_sorted_mask(boxes, valid, thresh, tile, max_keep)
    assert got.dtype == torch.bool and got.shape == valid.shape and got.is_cuda
    if max_keep is None:
        assert torch.equal(got, want)
    else:
        assert _prefix_equal(got, want, max_keep)
    if lanes * n <= 20000:                            # the body on the CPU agrees
        assert torch.equal(nms_mod._nms_sorted_mask(boxes.cpu(), valid.cpu(), thresh, tile,
                                                    max_keep), want.cpu())

    if n == 0:                                        # nms_select takes N >= 1
        return
    scores = torch.from_numpy(np.round(rng.rand(lanes, n), 2).astype(np.float32)).to(cuda)
    max_out = n if max_keep is None else max_keep
    sel = nms_mod.nms_select(boxes, scores, thresh, max_out, valid=valid, tile_size=tile)
    monkeypatch.setattr(nms_mod, "nms_sorted_mask",
                        lambda b, v, t, tile_size, max_keep: nms_mod._nms_sorted_mask(
                            b, v, t, tile_size, max_keep))
    plain = nms_mod.nms_select(boxes, scores, thresh, max_out, valid=valid, tile_size=tile)
    for g, w in zip(sel, plain):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_nms_kernel_counts_its_calls_and_walked_candidates(cuda):
    """With the recorder on, one call counts `nms.kernel_calls` 1, no host
    sync, and `nms.walked` the candidates up to each lane's `max_keep`-th
    survivor (all of a lane that keeps fewer); with it off, the call counts
    itself and reads nothing back."""
    from rlobjectdetection_tpu_torch.ops import nms as nms_mod
    from rlobjectdetection_tpu_torch.utils import tracing

    rng = np.random.RandomState(5)
    boxes = torch.from_numpy(_nms_boxes(rng, 2, 6000)).to(cuda)
    valid = torch.from_numpy(rng.rand(2, 6000) > 0.15).to(cuda)
    want = nms_mod._nms_sorted_mask(boxes, valid, 0.7, 256, None)
    csum = want.to(torch.int64).cumsum(-1)
    walked = sum(int(torch.searchsorted(c, 300)) + 1 if c[-1] >= 300 else 6000 for c in csum)
    tracing.reset()
    tracing.enable()
    try:
        nms_mod.nms_sorted_mask(boxes, valid, 0.7, max_keep=300)
        nms_mod.nms_sorted_mask(boxes[:, :300].contiguous(), valid[:, :300].contiguous(), 0.3)
    finally:
        tracing.disable()
    big, small = tracing.spans()
    assert big["name"] == small["name"] == "model.nms"
    assert big["counts"] == {"nms.kernel_calls": 1, "nms.walked": walked}
    assert small["counts"] == {"nms.kernel_calls": 1, "nms.walked": 600}
    nms_mod.nms_sorted_mask(boxes, valid, 0.7, max_keep=300)
    assert tracing.totals() == {"nms.kernel_calls": 3, "nms.walked": walked + 600}
    tracing.reset()


@pytest.mark.gpu
def test_nms_kernel_refuses_what_it_does_not_take(cuda):
    from rlobjectdetection_tpu_torch.ops import nms as nms_mod
    from rlobjectdetection_tpu_torch.ops.nms_kernel import launch_nms, scratch_words

    # the C side's scratch: none at N <= 512, the words of every lane above
    # it, and too many lanes refused before any allocation
    assert scratch_words(70000, 512) == 0 and scratch_words(2, 513) == 2 * 9 * 513
    assert scratch_words(65536, 513) == -1
    boxes = torch.rand(2, 8, 4, device=cuda)
    valid = torch.ones(2, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        launch_nms(torch.rand(8, 2, 4, device=cuda).transpose(0, 1), valid, 0.5, 256, None)
    with pytest.raises(ValueError, match="f32"):
        launch_nms(boxes.double(), valid, 0.5, 256, None)
    with pytest.raises(ValueError, match="f32"):
        launch_nms(boxes[0, 0], valid[0, 0], 0.5, 256, None)          # rank 1
    with pytest.raises(ValueError, match="f32"):
        launch_nms(torch.rand(2, 8, 5, device=cuda), valid, 0.5, 256, None)
    with pytest.raises(ValueError, match="bool"):
        launch_nms(boxes, valid.to(torch.uint8), 0.5, 256, None)
    with pytest.raises(ValueError, match="bool"):
        launch_nms(boxes, valid[:, :4], 0.5, 256, None)
    with pytest.raises(ValueError, match="bool"):
        launch_nms(boxes, valid.cpu(), 0.5, 256, None)
    with pytest.raises(ValueError, match="max_keep"):
        launch_nms(boxes, valid, 0.5, 256, -1)
    with pytest.raises(ValueError, match="contiguous"):                # through the op
        nms_mod.nms_sorted_mask(torch.rand(8, 2, 4, device=cuda).transpose(0, 1), valid, 0.5)


# -- the FPN pooler: multi-level RoIAlignV2 (csrc/roi_align_levels.cu) ----------------

# The forward sums each bin's samples in f32 in another order than the plain
# version: in bf16 an output may round to the neighbouring bf16 value (2^-7
# of the largest covers one step at any magnitude below it), in f32 the
# orders differ by f32 rounding. The backward's atomics add in an order
# that changes from launch to launch: the same bounds.
FPN_TOLS = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _fpn_inputs(dev, dtype, seed=0):
    """P2..P5 of the training cell (two 800×1216 blobs, 256 channels) and
    1024 rois of sides 8..1000 pixels (every level), a few of zero width."""
    import math

    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn((2, h, w, 256), generator=g).to(dev, dtype)
             for h, w in ((200, 304), (100, 152), (50, 76), (25, 38))]
    side = torch.exp(torch.empty(1024, 2).uniform_(math.log(8.0), math.log(1000.0), generator=g))
    ctr = torch.rand(1024, 2, generator=g) * torch.tensor([1216.0, 800.0])
    boxes = torch.cat([ctr - side / 2, ctr + side / 2], 1)
    boxes[:16, 2] = boxes[:16, 0]
    rois = torch.cat([(torch.arange(1024) % 2).float()[:, None], boxes], 1).to(dev)
    return feats, rois


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_levels_kernels_match_plain(cuda, dtype):
    from rlobjectdetection_tpu_torch.ops import roi_align_levels as lv

    feats, rois = _fpn_inputs(cuda, dtype)
    assert set(lv.roi_levels(rois).tolist()) == {0, 1, 2, 3}
    n0, b0 = lv.roi_align_levels.launches, lv.roi_align_levels_bwd.launches
    got = lv._forward(*feats, rois)
    want = lv.roi_align_levels_plain(feats, rois)
    assert got.dtype == dtype and max_rel(got, want) <= FPN_TOLS[dtype]
    grad = torch.randn(got.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                       device=cuda).to(dtype)
    shapes = [int(x) for f in feats for x in f.shape]
    gots = lv.roi_align_levels_bwd(grad, rois, shapes)
    wants = lv.roi_align_levels_plain_backward(grad, rois, lv._level_shapes(shapes), dtype)
    for a, b in zip(gots, wants):
        assert a.dtype == dtype and a.shape == b.shape and max_rel(a, b) <= FPN_TOLS[dtype]
    torch.cuda.synchronize()
    assert (lv.roi_align_levels.launches, lv.roi_align_levels_bwd.launches) == (n0 + 1, b0 + 1)


@pytest.mark.gpu
def test_roi_align_levels_op_autograd_on_the_card(cuda):
    """The op's autograd launches both kernels and gives the plain
    backward's gradient."""
    from rlobjectdetection_tpu_torch.ops import roi_align_levels as lv

    feats, rois = _fpn_inputs(cuda, torch.float32, seed=2)
    leaves = [f.requires_grad_() for f in feats]
    out = lv.roi_align_levels(leaves, rois)
    w = torch.randn(out.shape, device=cuda)
    (out * w).sum().backward()
    wants = lv.roi_align_levels_plain_backward(w, rois, [f.shape for f in feats], torch.float32)
    for f, want in zip(leaves, wants):
        assert max_rel(f.grad, want) <= FPN_TOLS[torch.float32]


@pytest.mark.gpu
def test_roi_align_levels_refuses_what_it_does_not_take(cuda):
    from rlobjectdetection_tpu_torch.ops import roi_align_levels as lv

    feats, rois = _fpn_inputs(cuda, torch.float32, seed=3)
    with pytest.raises(ValueError, match="contiguous"):
        lv._forward(feats[0], feats[1], feats[2], feats[3].transpose(1, 2), rois)
    with pytest.raises(ValueError, match="rois"):
        lv._forward(*feats, rois.double())
    with pytest.raises(ValueError, match="f32 or bf16"):
        lv._forward(*[f.half() for f in feats], rois)


# -- the frozen BN's epilogue (`rlod::frozen_bn_act`, `csrc/frozen_bn_act.cu`) ----------

# (label, N, planes, H, W): the sites' maps at the main path's widths, with
# row counts (N·H·W) that are no multiple of a CTA's rows or of a grid's
BN_ACT_SHAPES = [("layer2", 2, 128, 99, 151), ("layer3", 2, 256, 49, 77),
                 ("c4_head_layer4", 299, 512, 4, 4), ("fpn_layer4", 2, 512, 25, 39)]


def _bn_act_site(dev, dtype, form, n, planes, h, w, seed=0):
    """(x, bn, r, bn_r) of a site of `form` on the card: bn1/bn2 ("relu")
    at `planes` channels, bn3 at 4·planes; maps NCHW views of NHWC memory."""
    from rlobjectdetection_tpu_torch.models.backbones.resnet import FrozenBatchNorm

    c = planes if form == "relu" else 4 * planes
    g = torch.Generator().manual_seed(seed)

    def bn():
        m = FrozenBatchNorm(c)
        with torch.no_grad():
            m.scale.copy_(torch.rand(c, generator=g) + 0.5)
            m.bias.copy_(torch.randn(c, generator=g) * 0.3)
            m.mean.copy_(torch.randn(c, generator=g) * 0.3)
            m.var.copy_(torch.rand(c, generator=g) + 0.3)
        return m.to(dev)

    x = lambda: torch.randn((n, h, w, c), generator=g).to(dev, dtype).permute(0, 3, 1, 2)
    return (x(), bn(), None if form == "relu" else x(),
            bn() if form == "downsample" else None)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["relu", "identity", "downsample"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,n,planes,h,w", BN_ACT_SHAPES)
def test_frozen_bn_act_kernel_equals_the_plain_path(cuda, label, n, planes, h, w, dtype, form):
    """Forward and backward of the kernel against the modules' chain and
    autograd on it, to the bit."""
    from rlobjectdetection_tpu_torch.ops import frozen_bn_act as fba

    x, bn, r, bn_r = _bn_act_site(cuda, dtype, form, n, planes, h, w)
    grad = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                       device=cuda).to(dtype)

    def run(fn):
        xs = x.detach().requires_grad_(True)
        rs = None if r is None else r.detach().requires_grad_(True)
        y = fn(xs, bn, rs, bn_r)
        y.backward(grad)
        return [y.detach(), xs.grad] + ([] if rs is None else [rs.grad])

    f0, b0 = fba.launch_frozen_bn_act.launches, fba.launch_frozen_bn_act_bwd.launches
    got = run(fba.frozen_bn_act)
    torch.cuda.synchronize()
    assert (fba.launch_frozen_bn_act.launches, fba.launch_frozen_bn_act_bwd.launches) == (
        f0 + 1, b0 + 1)
    want = run(fba.frozen_bn_act_modules)
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    # the op's plain body on the card gives the same bits as well
    mul, add = fba.bn_constants(bn, dtype)
    mul_r, add_r = (None, None) if bn_r is None else fba.bn_constants(bn_r, dtype)
    assert torch.equal(fba.frozen_bn_act_plain(x, mul, add, r, mul_r, add_r), got[0])


@pytest.mark.gpu
def test_frozen_bn_act_takes_any_layout_and_refuses_what_it_cannot_run(cuda):
    """An NCHW-contiguous map is copied to channels-last and launched; a
    dtype or C the kernel does not take raises, as the other ops do."""
    from rlobjectdetection_tpu_torch.ops import frozen_bn_act as fba
    from rlobjectdetection_tpu_torch.utils import tracing

    x, bn, r, _ = _bn_act_site(cuda, torch.bfloat16, "identity", 2, 64, 20, 24)
    want = fba.frozen_bn_act_modules(x, bn, r)
    x = x.contiguous()                                  # NCHW-contiguous
    totals = lambda: [tracing.totals().get(k, 0) for k in ("frozen_bn.plain_calls",
                                                           "frozen_bn.kernel_calls")]
    plain, kernel = totals()
    n0 = fba.launch_frozen_bn_act.launches
    y = fba.frozen_bn_act(x, bn, r)
    assert totals() == [plain, kernel + 1] and fba.launch_frozen_bn_act.launches == n0 + 1
    assert y.is_contiguous(memory_format=torch.channels_last) and torch.equal(y, want)
    with pytest.raises(ValueError, match="16-byte"):
        fba.frozen_bn_act(x[:, :60], bn, r[:, :60])
    with pytest.raises(ValueError, match="f32/bf16"):
        fba.frozen_bn_act(x.half(), bn, r.half())
    assert fba.launch_frozen_bn_act.launches == n0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet_with_the_frozen_bn_kernel_equals_the_plain_modules(cuda, dtype, monkeypatch):
    """A ResNet-50 base (stem and layer1 kernels, layer2-3 trained) and C4
    head, forward and backward: with the frozen-BN kernel at every
    bottleneck site, and with the modules' chain, the same bits (cuDNN
    deterministic)."""
    from rlobjectdetection_tpu_torch.models.backbones import resnet
    from rlobjectdetection_tpu_torch.models.backbones.resnet import ResNetBase, ResNetHead
    from rlobjectdetection_tpu_torch.ops import frozen_bn_act as fba
    from rlobjectdetection_tpu_torch.utils import tracing

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    torch.manual_seed(0)
    base = ResNetBase(50, dtype, conv1_fused=True, layer1_fused=True, frozen_stages=1)
    head = ResNetHead(50)
    rng = np.random.RandomState(5)
    with torch.no_grad():
        _randomize_bn(base, rng)
        _randomize_bn(head, rng)
    base, head = base.to(cuda), head.to(cuda)
    data = torch.from_numpy((rng.randn(2, 224, 320, 3) * 30).astype(np.float32)).to(cuda)
    weights = torch.from_numpy(rng.randn(6, 2048).astype(np.float32)).to(cuda, dtype)

    def run():
        base.zero_grad(set_to_none=True)
        head.zero_grad(set_to_none=True)
        feat = base(data)                                          # [2, 14, 20, 1024]
        pooled = torch.cat([feat[:, :7, :7], feat[:, 5:12, 9:16], feat[:, 7:, 13:]])
        out = head(pooled.contiguous())                            # [6, 2048]
        ((out * weights).float().sum() + feat.float().square().mean()).backward()
        params = [p for m in (base, head) for p in m.parameters() if p.requires_grad]
        return [feat.detach(), out.detach()] + [p.grad for p in params]

    t0 = tracing.totals()
    got = run()
    torch.cuda.synchronize()
    moved = {k: tracing.totals().get(k, 0) - t0.get(k, 0)
             for k in ("frozen_bn.kernel_calls", "frozen_bn.plain_calls")}
    # layer2 (4 blocks), layer3 (6) and the head's layer4 (3): 3 sites a
    # block, each forward and backward
    assert moved == {"frozen_bn.kernel_calls": 2 * 3 * (4 + 6 + 3), "frozen_bn.plain_calls": 0}
    monkeypatch.setattr(resnet, "frozen_bn_act", fba.frozen_bn_act_modules)
    want = run()
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("downsample", [False, True])
def test_exported_bottleneck_launches_the_frozen_bn_kernel(cuda, downsample):
    """`torch.export` on the card traces a conv's output as NCHW (cuDNN
    gives channels-last): the op still takes every site, and the replay
    launches the kernel at each and gives the eager bits."""
    from rlobjectdetection_tpu_torch.models.backbones.resnet import Bottleneck, nhwc_to_nchw
    from rlobjectdetection_tpu_torch.ops import frozen_bn_act as fba

    torch.manual_seed(0)
    block = Bottleneck(512 if downsample else 1024, 256, downsample=downsample)
    with torch.no_grad():
        _randomize_bn(block, np.random.RandomState(4))
    block = block.to(cuda).requires_grad_(False)

    class Site(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block = block

        def forward(self, x):
            return self.block(nhwc_to_nchw(x.to(torch.bfloat16)))

    site = Site().eval()
    x = torch.randn((2, 25, 38, 512 if downsample else 1024), device=cuda)
    with torch.no_grad():
        program = torch.export.export(site, (x,))
        used = [str(n.target) for n in program.graph.nodes if n.op == "call_function"
                and str(n.target).startswith("rlod.")]
        assert used == ["rlod.frozen_bn_act.default"] * 3
        n0 = fba.launch_frozen_bn_act.launches
        got = program.module()(x)
        torch.cuda.synchronize()
        assert fba.launch_frozen_bn_act.launches == n0 + 3
        assert torch.equal(got, site(x))
