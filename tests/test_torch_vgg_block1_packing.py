"""The bf16 VGG block-1 kernel's weight image, on the CPU.

`pack_vgg_block1` writes the ten 8 KB tiles the kernel copies into shared
memory as they are (csrc/vgg_block1.cu): conv1_2 a tap, then conv1_1. The
kernel reads them only through wgmma's B descriptor (csrc/wgmma.cuh
`desc_sw128`: start 32 bytes a k16 step, 8-row groups SBO = 1024 bytes
apart, 128 bytes a row, then the 128-byte swizzle). Here the image is
decoded with that address arithmetic and block 1 is run as the kernel runs
it, through the decoded tiles: conv1_1 as an im2col GEMM over K = 64 taps
(ky, kx, ci) on the image's in-bounds positions, literal zeros around them,
conv1_2 as nine shifted GEMMs, the 2×2 max. It matches `vgg_block1_plain`;
a wrong swizzle fails. So the layout is proven before a card runs it."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rlobjectdetection_tpu_torch.ops import vgg_block1_kernel
from rlobjectdetection_tpu_torch.utils import tracing
import torch_threads  # noqa: F401  (xdist workers share the cores)


def pack_misses() -> int:
    return tracing.totals().get("pack.misses", 0)


SBO = 1024
# f32 sums, no intermediate rounding on either side: summation order only.
# bf16: both round the same f32 sums at the same points, in other orders, so
# an output may round to the neighbouring bf16 value (2^-7 of the largest).
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def descriptor_offset(n, k):
    """Byte offset at which the wgmma descriptor of k16 step k // 16 reads
    element (row n, k) of a tile: start + (n // 8) * SBO + (n % 8) * 128 +
    2 * (k % 16), then address bits [4, 7) XORed with bits [7, 10)."""
    a = 32 * (k // 16) + (n // 8) * SBO + (n % 8) * 128 + 2 * (k % 16)
    return a ^ (((a >> 7) & 7) << 4)


ELEMENT = torch.from_numpy(descriptor_offset(np.arange(64)[:, None], np.arange(64)[None, :]) // 2)


def decode(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[10, 4096] image → conv1_2 [9, 64, 64] (tap, co, ci) and conv1_1
    [64, 64] (co, k), as f32."""
    tiles = image[:, ELEMENT].float()
    return tiles[:9], tiles[9]


def _inputs(rng, b, h, w):
    """A nonzero b1, so a conv1_1 that let relu(b1) through at the image
    border would differ there."""
    x = torch.from_numpy((rng.randn(b, h, w, 3) * 3).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(64, 3, 3, 3) * 0.2).astype(np.float32))
    b1 = torch.from_numpy(rng.randn(64).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(64, 64, 3, 3) * 0.05).astype(np.float32))
    b2 = torch.from_numpy(rng.randn(64).astype(np.float32))
    return x, w1, b1, w2, b2


def block1_through_image(x, image, b1, b2, dtype):
    """Block 1 on NHWC x through the decoded image, in the kernel's order;
    bf16 rounds where the kernel rounds (image, conv1_1 output, result)."""
    rnd = (lambda t: t.to(dtype).float()) if dtype == torch.bfloat16 else (lambda t: t)
    conv12, conv11 = decode(image)
    xp = F.pad(x.to(torch.bfloat16).float(), (0, 0, 1, 1, 1, 1))      # conv1_1's padding
    b, h, w, _ = x.shape
    cols = torch.zeros(b, h, w, 64)                                     # im2col, K = 64
    for ky in range(3):
        for kx in range(3):
            k = ky * 9 + kx * 3
            cols[..., k:k + 3] = xp[:, ky:ky + h, kx:kx + w]
    y1 = rnd(torch.relu(cols @ conv11.t() + b1))
    y1 = F.pad(y1, (0, 0, 1, 1, 1, 1))                                 # literal zeros
    acc = torch.zeros(b, h, w, 64)
    for tap in range(9):
        acc += y1[:, tap // 3:tap // 3 + h, tap % 3:tap % 3 + w] @ conv12[tap].t()
    y2 = torch.relu(acc + b2).permute(0, 3, 1, 2)
    return F.max_pool2d(y2, 2, 2).permute(0, 2, 3, 1).to(dtype)


def test_image_decodes_to_the_weights():
    x, w1, b1, w2, b2 = _inputs(np.random.RandomState(0), 1, 4, 4)
    pk = vgg_block1_kernel.pack_vgg_block1(w1, b1, w2, b2, torch.bfloat16)
    assert set(pk) == {"w", "b1", "b2"}
    assert pk["w"].dtype == torch.bfloat16 and tuple(pk["w"].shape) == (10, 4096)
    assert pk["b1"].dtype == pk["b2"].dtype == torch.float32
    conv12, conv11 = decode(pk["w"])
    wt = w2.to(torch.bfloat16).float()
    for tap in range(9):
        assert torch.equal(conv12[tap], wt[:, :, tap // 3, tap % 3])
    assert torch.equal(conv11[:, :27], w1.to(torch.bfloat16).float().permute(0, 2, 3, 1)
                       .reshape(64, 27))


def test_conv11_padded_taps_carry_zero_weights():
    """K = 27 taps padded to 64: the kernel's two k16 steps read 27..31
    against zero weights, and nothing past 31."""
    _, w1, b1, w2, b2 = _inputs(np.random.RandomState(1), 1, 2, 2)
    w1 = w1.abs() + 1.0                                                 # no zero of its own
    _, conv11 = decode(vgg_block1_kernel.pack_vgg_block1(w1, b1, w2, b2, torch.bfloat16)["w"])
    assert bool((conv11[:, :27] != 0).all())
    assert bool((conv11[:, 27:] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", [(1, 6, 8), (2, 10, 14)])
def test_gemm_through_image_matches_plain(dtype, b, h, w):
    x, w1, b1, w2, b2 = _inputs(np.random.RandomState(h + w), b, h, w)
    image = vgg_block1_kernel.pack_vgg_block1(w1, b1, w2, b2, torch.bfloat16)["w"]
    got = block1_through_image(x, image, b1, b2, dtype)
    # the image holds bf16 weights and the kernel reads a bf16 image: the
    # f32 comparison is against the plain version on those values
    rb = lambda t: t.to(torch.bfloat16).float()
    want = vgg_block1_kernel.vgg_block1_plain(rb(x), rb(w1), b1, rb(w2), b2, dtype=dtype)
    assert got.shape == want.shape == (b, h // 2, w // 2, 64)
    scale = float(want.float().abs().max())
    assert scale > 0
    assert float((got.float() - want.float()).abs().max()) / scale <= TOL[dtype]


def _wrong_swizzle(tiles):
    """The swizzle keyed on the 8-row group instead of the row in it."""
    n = torch.arange(64)[:, None]
    src = torch.arange(8)[None, :] ^ ((n // 8) % 8)
    chunks = tiles.reshape(*tiles.shape[:-1], 8, 8)
    return torch.gather(chunks, -2, src[..., None].expand(64, 8, 8).expand_as(chunks)).reshape(
        tiles.shape)


def test_wrong_swizzle_fails(monkeypatch):
    x, w1, b1, w2, b2 = _inputs(np.random.RandomState(5), 1, 6, 8)
    monkeypatch.setattr(vgg_block1_kernel, "swizzle128", _wrong_swizzle)
    image = vgg_block1_kernel.pack_vgg_block1(w1, b1, w2, b2, torch.bfloat16)["w"]
    conv12, _ = decode(image)
    assert not torch.equal(conv12[0], w2.to(torch.bfloat16).float()[:, :, 0, 0])
    got = block1_through_image(x, image, b1, b2, torch.float32)
    rb = lambda t: t.to(torch.bfloat16).float()
    want = vgg_block1_kernel.vgg_block1_plain(rb(x), rb(w1), b1, rb(w2), b2, dtype=torch.float32)
    assert float((got - want).abs().max()) / float(want.abs().max()) > 0.1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packs_once_and_again_after_a_weight_change(dtype):
    _, w1, b1, w2, b2 = _inputs(np.random.RandomState(8), 1, 2, 2)
    src = (w1, b1, w2, b2)
    cpu = torch.device("cpu")
    n0 = pack_misses()
    first = vgg_block1_kernel.packed_vgg_block1(*src, dtype, cpu)
    assert vgg_block1_kernel.packed_vgg_block1(*src, dtype, cpu) is first
    assert pack_misses() == n0 + 1
    for edit in (lambda: b1.add_(1.0), lambda: w2.mul_(2.0)):   # a bias, conv1_2's weight
        with torch.no_grad():
            edit()
        repacked = vgg_block1_kernel.packed_vgg_block1(*src, dtype, cpu)
        assert repacked is not first
        want = vgg_block1_kernel.pack_vgg_block1(*src, dtype)
        assert repacked.keys() == want.keys()
        assert all(torch.equal(repacked[k], want[k]) for k in want)
        first = repacked
    assert pack_misses() == n0 + 3
