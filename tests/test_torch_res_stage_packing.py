"""The bf16 residual-stage kernel's weight image, on the CPU.

`pack_res_stage_stream` writes each block's weights as the byte image of
the shared-memory stages the two CTAs of a cluster stream
(csrc/res_stage.cu). Here the image is decoded with the address arithmetic
of the kernel's wgmma B descriptor (csrc/wgmma.cuh `desc_sw128`: start
32 bytes a k16 step, 8-row groups SBO = 1024 bytes apart, 128 bytes a row,
then the 128-byte swizzle) and walked in the kernel's consumption order:
the decoded weights are `pack_res_stage`'s, and an im2col GEMM through the
decoded stages, each CTA's half of the output channels computed on its own
and concatenated, matches `res_stage_plain`. A wrong swizzle or a wrong
split fails both. So the layout is proven before a card runs it."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rlobjectdetection_tpu_torch.models.backbones.resnet import ResLayer
from rlobjectdetection_tpu_torch.ops import res_stage_kernel
import torch_threads  # noqa: F401  (xdist workers share the cores)

SBO = 1024
# bf16: the GEMM and the plain version round the same f32 sums at the same
# points, with the sums in other orders: an activation may round to the
# neighbouring bf16 value, and such steps compound through the blocks (the
# kernel's bound on the card, tests/test_torch_gpu.py). f32: summation order.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def descriptor_offset(n, k):
    """Byte offset at which the wgmma descriptor of k16 step k // 16 reads
    element (row n, k) of a stage: start + (n // 8) * SBO + (n % 8) * 128 +
    2 * (k % 16), then address bits [4, 7) XORed with bits [7, 10)."""
    a = 32 * (k // 16) + (n // 8) * SBO + (n % 8) * 128 + 2 * (k % 16)
    return a ^ (((a >> 7) & 7) << 4)


ELEMENT = torch.from_numpy(descriptor_offset(np.arange(64)[:, None], np.arange(64)[None, :]) // 2)


def decode_stage(stage: torch.Tensor) -> torch.Tensor:
    """[4096] stage image → the [64, 64] (output channel, k) block it holds."""
    return stage[ELEMENT].float()


class Stream:
    """CTA r's stages in the order the kernel consumes them."""

    def __init__(self, image, r):
        self.stages = iter(image[r])

    def take(self):
        return decode_stage(next(self.stages))

    def done(self):
        return next(self.stages, None) is None


def decode_block(image, width, cin, down):
    """The [N][K] weights a block's image holds, walked as the kernel walks it."""
    wh, c3 = width // 2, 2 * width
    w1, w2 = torch.zeros(width, cin), torch.zeros(9, width, width)
    w3, wd = torch.zeros(4 * width, width), torch.zeros(4 * width, cin) if down else None
    for r in range(2):
        s = Stream(image, r)
        for k0 in range(0, cin, 64):
            for n0 in range(r * wh, (r + 1) * wh, 64):
                w1[n0:n0 + 64, k0:k0 + 64] = s.take()
        for tap in range(9):
            for k0 in range(0, width, 64):
                for n0 in range(r * wh, (r + 1) * wh, 64):
                    w2[tap, n0:n0 + 64, k0:k0 + 64] = s.take()
        for q in range(r * c3, (r + 1) * c3, 128):
            for w, k in ((w3, width), (wd, cin if down else 0)):
                for k0 in range(0, k, 64):
                    for n0 in (q, q + 64):
                        w[n0:n0 + 64, k0:k0 + 64] = s.take()
        assert s.done()
    return dict(w1=w1, w2=w2, w3=w3, wd=wd)


def stream_gemm(x, packed, images, width, dtype):
    """The stage as im2col GEMMs through the decoded stages, in the kernel's
    order: CTA r computes its half of each conv's output channels (conv3 in
    passes of 128), the halves are concatenated, intermediates rounded as
    the kernel rounds them."""
    rnd = lambda t: t.to(dtype).float()
    y = x.to(dtype).float()
    _, h, w, _ = y.shape
    wh, c3 = width // 2, 2 * width
    for pk, image in zip(packed, images):
        cin, down = y.shape[-1], pk["wd"] is not None
        streams = [Stream(image, r) for r in range(2)]
        halves = []
        for s in streams:                                          # conv1
            acc = torch.zeros(*y.shape[:3], wh)
            for k0 in range(0, cin, 64):
                for j in range(0, wh, 64):
                    acc[..., j:j + 64] += y[..., k0:k0 + 64] @ s.take().t()
            halves.append(acc)
        a1 = F.pad(rnd(torch.relu(torch.cat(halves, -1) + pk["b1"])), (0, 0, 1, 1, 1, 1))
        halves = []
        for s in streams:                                          # conv2
            acc = torch.zeros(*y.shape[:3], wh)
            for tap in range(9):
                win = a1[:, tap // 3:tap // 3 + h, tap % 3:tap % 3 + w]
                for k0 in range(0, width, 64):
                    for j in range(0, wh, 64):
                        acc[..., j:j + 64] += win[..., k0:k0 + 64] @ s.take().t()
            halves.append(acc)
        a2 = rnd(torch.relu(torch.cat(halves, -1) + pk["b2"]))
        passes = []
        for s in streams:                                          # conv3 (+ downsample)
            for _ in range(c3 // 128):
                acc = torch.zeros(*y.shape[:3], 128)
                for a, k in ((a2, width), (y, cin if down else 0)):
                    for k0 in range(0, k, 64):
                        for j in (0, 64):
                            acc[..., j:j + 64] += a[..., k0:k0 + 64] @ s.take().t()
                passes.append(acc)
        assert all(s.done() for s in streams)
        out = torch.cat(passes, -1) + pk["b3"]
        y = rnd(torch.relu(out if down else out + y))
    return y.to(dtype)


def _stage(rng, cin, width, blocks):
    layer = ResLayer(cin, width, blocks, 1).requires_grad_(False)
    with torch.no_grad():
        for name, buf in layer.named_buffers():
            r = rng.randn(*buf.shape).astype(np.float32) * 0.1
            if name.rsplit(".", 1)[1] in ("scale", "var"):
                r = np.abs(r) + 0.5
            buf.copy_(torch.from_numpy(r))
        for p in layer.parameters():
            p.mul_(4.0)   # keep activations O(1) through the blocks
    return layer


SHAPES = [
    (2, 5, 7, 128, 256, 2),     # layer2's width, block0 cin 256, then an identity block
    (1, 4, 6, 256, 512, 2),     # layer3's width, block0 cin 512, then cin 1024
]


@pytest.mark.parametrize("b,h,w,width,cin,blocks", SHAPES)
def test_stream_image_decodes_to_the_packed_weights(b, h, w, width, cin, blocks):
    layer = _stage(np.random.RandomState(width), cin, width, blocks)
    packed = res_stage_kernel.pack_res_stage(layer, blocks, width, torch.bfloat16)
    for i, pk in enumerate(packed):
        image = res_stage_kernel.pack_res_stage_stream(pk, width)
        k = pk["w1"].shape[1]
        stages = res_stage_kernel.stream_stages(width, k, pk["wd"] is not None)
        assert image.dtype == torch.bfloat16 and tuple(image.shape) == (2, stages, 4096)
        got = decode_block(image, width, k, pk["wd"] is not None)
        for name in ("w1", "w2", "w3", "wd"):
            assert (got[name] is None) == (pk[name] is None), (i, name)
            if pk[name] is not None:
                assert torch.equal(got[name], pk[name].float()), (i, name)


def test_stream_stages_at_the_main_path_shapes():
    """Stages a CTA streams: layer3's identity block 136 (1.11 MB, half of
    its 2.23 MB of bf16 weights), block0 184; layer2's 46 and 34."""
    count = res_stage_kernel.stream_stages
    assert (count(256, 1024, False), count(256, 512, True)) == (136, 184)
    assert (count(128, 512, False), count(128, 256, True)) == (34, 46)
    # each CTA streams exactly half of a block's weights
    for width, cin, down in ((256, 1024, False), (256, 512, True), (128, 256, True)):
        n = width * cin + 9 * width * width + 4 * width * width + (4 * width * cin if down else 0)
        assert 2 * count(width, cin, down) * 64 * 64 == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,width,cin,blocks", SHAPES)
def test_stream_gemm_matches_plain(dtype, b, h, w, width, cin, blocks):
    rng = np.random.RandomState(b * 10 + width)
    layer = _stage(rng, cin, width, blocks)
    x = torch.from_numpy(np.abs(rng.randn(b, h, w, cin)).astype(np.float32))
    packed = res_stage_kernel.pack_res_stage(layer, blocks, width, dtype)
    images = [res_stage_kernel.pack_res_stage_stream(pk, width) for pk in packed]
    got = stream_gemm(x, packed, images, width, dtype)
    want = res_stage_kernel.res_stage_plain(x, packed, dtype)
    assert got.shape == want.shape == (b, h, w, 4 * width)
    scale = float(want.float().abs().max())
    assert scale > 0
    assert float((got.float() - want.float()).abs().max()) / scale < TOL[dtype]


def _wrong_swizzle(tiles):
    """The swizzle keyed on the 8-row group instead of the row in it."""
    n = torch.arange(64)[:, None]
    src = torch.arange(8)[None, :] ^ ((n // 8) % 8)
    chunks = tiles.reshape(*tiles.shape[:-1], 8, 8)
    return torch.gather(chunks, -2, src[..., None].expand(64, 8, 8).expand_as(chunks)).reshape(
        tiles.shape)


@pytest.mark.parametrize("mutation", ["swizzle", "split"])
def test_stream_mutations_fail(monkeypatch, mutation):
    """A deliberately wrong image (swizzle keyed on the wrong row bits, or
    the two CTAs' halves swapped) decodes to other weights and fails the
    GEMM check."""
    rng = np.random.RandomState(5)
    width, cin = 128, 256
    layer = _stage(rng, cin, width, 1)
    x = torch.from_numpy(np.abs(rng.randn(1, 4, 5, cin)).astype(np.float32))
    packed = res_stage_kernel.pack_res_stage(layer, 1, width, torch.float32)
    if mutation == "swizzle":
        monkeypatch.setattr(res_stage_kernel, "swizzle128", _wrong_swizzle)
    images = [res_stage_kernel.pack_res_stage_stream(pk, width) for pk in packed]
    if mutation == "split":
        images = [im.flip(0) for im in images]
    decoded = decode_block(images[0], width, cin, True)
    assert not torch.equal(decoded["w1"], packed[0]["w1"].float())
    got = stream_gemm(x, packed, images, width, torch.float32)
    want = res_stage_kernel.res_stage_plain(x, packed, torch.float32)
    assert float((got - want).abs().max()) / float(want.abs().max()) > 0.1
