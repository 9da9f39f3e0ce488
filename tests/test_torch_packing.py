"""The packed weight layouts the stem and layer1 kernels read, on the CPU.

Each test runs a plain im2col GEMM that reads the packed operands the way
the CUDA kernel addresses them (csrc/stem.cu, csrc/layer1.cu) and holds it
against the plain version (`stem_plain`, `layer1_plain`), which the CPU
parity tests hold against the JAX package's Pallas kernels. So the layout
is proven before a card runs it. Also: the wrappers pack once and pack
again after an in-place weight edit."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rlobjectdetection_tpu_torch.models.backbones.resnet import ResLayer
from rlobjectdetection_tpu_torch.ops import layer1_kernel, stem_kernel
from rlobjectdetection_tpu_torch.utils import tracing
import torch_threads  # noqa: F401  (xdist workers share the cores)


def pack_misses() -> int:
    return tracing.totals().get("pack.misses", 0)


# bf16: the GEMM and the plain version round the same f32 results at the
# same points, with sums in other orders: an output may round to the
# neighbouring bf16 value, one step, 2^-7 of the largest output. layer1
# compounds such steps through its rounded intermediates: 1.28e-2, its bound
# on the card.
STEM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
LAYER1_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.28e-2}


def max_rel(got, want):
    got, want = got.float().numpy(), want.float().numpy()
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _stem_args(rng, b, h, w):
    x = torch.from_numpy((rng.randn(b, h, w, 3) * 30).astype(np.float32))
    wt = torch.from_numpy((rng.randn(64, 3, 7, 7) * 0.1).astype(np.float32))
    bn = [torch.from_numpy(v.astype(np.float32)) for v in
          (rng.rand(64) + 0.5, rng.randn(64), rng.randn(64) * 0.2, rng.rand(64) + 0.3)]
    return x, wt, bn


def stem_im2col_gemm(x, wk, mul, add, dtype):
    """The stem through packed operands, addressed as the kernels do. Image
    rows are flattened to (pixel, channel) values, zero-padded past the row:
    the taps of conv cell (cy, cx) in kernel row ky are the values from
    (2cy + ky, 6cx) on (bf16: STEM_ROW_TAPS of them against [64, 224], zero
    past tap 21; f32: 21 against HWIO [7, 7, 3, 64]). Conv cells past the
    conv output are 0 before the pool; bf16 rounds them before the max."""
    b, h, w, _ = x.shape
    oh, ow, ph, pw = stem_kernel.stem_out_shapes(h, w)
    hp, wp = 2 * oh + 5, 2 * ow + 5
    xp = F.pad(x.to(dtype).float(), (0, 0, 3, wp - w - 3, 3, hp - h - 3))
    rows = F.pad(xp.reshape(b, hp, wp * 3), (0, stem_kernel.STEM_ROW_TAPS))
    r = 2 * torch.arange(oh)[:, None] + torch.arange(7)[None, :]                 # [oh, 7]
    c = 6 * torch.arange(ow)[:, None] + torch.arange(stem_kernel.STEM_ROW_TAPS)   # [ow, 32]
    taps = rows[:, r[:, None, :, None], c[None, :, None, :]]    # [b, oh, ow, 7, 32]
    if dtype == torch.bfloat16:
        y = taps.reshape(b, oh, ow, -1) @ wk.float().t()
    else:
        y = taps[..., :21].reshape(b, oh, ow, 147) @ wk.float().reshape(147, 64)
    y = torch.relu(y * mul + add).to(dtype).float()
    y = F.pad(y, (0, 0, 0, 2 * pw + 1 - ow, 0, 2 * ph + 1 - oh))
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    return y.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", [
    (2, 37, 45),     # odd sizes: ceil-mode edge cells
    (1, 29, 128),    # few pooled rows, many columns
    (1, 64, 80),     # even sizes
])
def test_stem_packed_layout_matches_plain(dtype, b, h, w):
    rng = np.random.RandomState(h * w)
    x, wt, bn = _stem_args(rng, b, h, w)
    wk, mul, add = stem_kernel.pack_stem(wt, *bn, dtype)
    assert wk.dtype == dtype and mul.dtype == add.dtype == torch.float32
    assert tuple(wk.shape) == ((64, 224) if dtype == torch.bfloat16 else (7, 7, 3, 64))
    got = stem_im2col_gemm(x, wk, mul, add, dtype)
    want = stem_kernel.stem_plain(x, wt, *bn, dtype=dtype)
    assert got.shape == want.shape
    assert max_rel(got, want) < STEM_TOL[dtype]


def test_stem_bf16_packing_zero_pads_each_kernel_row():
    rng = np.random.RandomState(0)
    _, wt, bn = _stem_args(rng, 1, 8, 8)
    wk = stem_kernel.pack_stem(wt, *bn, torch.bfloat16)[0].reshape(64, 7, 32)
    assert (wk[:, :, 21:] == 0).all()
    want = wt.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(64, 7, 21)    # (co, ky, (kx, ci))
    assert torch.equal(wk[:, :, :21], want)


def _layer1(rng):
    layer = ResLayer(64, 64, 3, 1).requires_grad_(False)
    with torch.no_grad():
        for name, buf in layer.named_buffers():
            r = rng.randn(*buf.shape).astype(np.float32) * 0.1
            if name.rsplit(".", 1)[1] in ("scale", "var"):
                r = np.abs(r) + 0.5
            buf.copy_(torch.from_numpy(r))
    return layer


def layer1_im2col_gemm(x, packed, dtype):
    """layer1 through its [N][K] packing as GEMMs: conv1 and conv3 (and the
    downsample) as products with w1 [64, Cin], w3 [256, 64], wd [256, Cin];
    the 3x3 as nine shifted products with w2 [tap, co, ci] over the
    zero-padded conv1 output. Intermediates rounded as the kernel rounds
    them."""
    rnd = lambda t: t.to(dtype).float()
    y = x.to(dtype).float()
    _, h, w, _ = y.shape
    for pk in packed:
        a1 = rnd(torch.relu(y @ pk["w1"].float().t() + pk["b1"]))
        a1p = F.pad(a1, (0, 0, 1, 1, 1, 1))
        a2 = sum(a1p[:, dy:dy + h, dx:dx + w] @ pk["w2"][3 * dy + dx].float().t()
                 for dy in range(3) for dx in range(3))
        a2 = rnd(torch.relu(a2 + pk["b2"]))
        out = a2 @ pk["w3"].float().t() + pk["b3"]
        out = out + (y @ pk["wd"].float().t() if pk["wd"] is not None else y)
        y = rnd(torch.relu(out))
    return y.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", [(2, 13, 21), (1, 9, 50), (2, 13, 40)])
def test_layer1_packed_layout_matches_plain(dtype, b, h, w):
    rng = np.random.RandomState(b * 100 + h)
    layer = _layer1(rng)
    x = torch.from_numpy(np.abs(rng.randn(b, h, w, 64)).astype(np.float32))
    packed = layer1_kernel.pack_layer1(layer, dtype)
    shapes = [{k: None if v is None else tuple(v.shape) for k, v in pk.items()} for pk in packed]
    assert shapes[0]["w1"] == (64, 64) and shapes[0]["wd"] == (256, 64)
    assert shapes[1]["w1"] == (64, 256) and shapes[1]["wd"] is None
    assert all(s["w2"] == (9, 64, 64) and s["w3"] == (256, 64) for s in shapes)
    got = layer1_im2col_gemm(x, packed, dtype)
    want = layer1_kernel.layer1_plain(x, packed, dtype)
    assert float(want.float().abs().max()) > 0
    assert max_rel(got, want) < LAYER1_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer1_packs_once_and_again_after_a_weight_change(dtype):
    rng = np.random.RandomState(7)
    layer = _layer1(rng)
    x = torch.from_numpy(np.abs(rng.randn(1, 6, 9, 64)).astype(np.float32)).to(dtype)
    n0 = pack_misses()
    first = layer1_kernel.fused_layer1(x, layer, dtype=dtype)
    packed = layer._layer1_packed[dtype][1]
    again = layer1_kernel.fused_layer1(x, layer, dtype=dtype)
    assert pack_misses() == n0 + 1 and layer._layer1_packed[dtype][1] is packed
    assert torch.equal(first, again)
    with torch.no_grad():
        layer.block2.conv3.weight.mul_(2.0)
    changed = layer1_kernel.fused_layer1(x, layer, dtype=dtype)
    assert pack_misses() == n0 + 2 and layer._layer1_packed[dtype][1] is not packed
    assert not torch.equal(changed, first)
    assert torch.equal(changed, layer1_kernel.layer1_plain(
        x, layer1_kernel.pack_layer1(layer, dtype), dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_packs_once_and_again_after_a_weight_change(dtype):
    rng = np.random.RandomState(8)
    _, wt, bn = _stem_args(rng, 1, 8, 8)
    cpu = torch.device("cpu")
    n0 = pack_misses()
    first = stem_kernel.packed_stem(wt, *bn, dtype, cpu)
    assert stem_kernel.packed_stem(wt, *bn, dtype, cpu) is first
    assert pack_misses() == n0 + 1
    for edit in (lambda: bn[3].mul_(2.0), lambda: wt.add_(1.0)):   # a BN buffer, the weight
        with torch.no_grad():
            edit()
        repacked = stem_kernel.packed_stem(wt, *bn, dtype, cpu)
        assert repacked is not first
        for got, want in zip(repacked, stem_kernel.pack_stem(wt, *bn, dtype)):
            assert torch.equal(got, want)
        first = repacked
    assert pack_misses() == n0 + 3
