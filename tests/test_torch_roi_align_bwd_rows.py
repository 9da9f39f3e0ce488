"""The RoIAlignAvg backward kernel's rule, emulated in numpy on the CPU.

`csrc/roi_align.cu::roi_align_avg_bwd_kernel` gathers by destination row:
the CTA of feature row (b, y) walks the rois in index order and takes an
entry (roi, sample row sy, w_y) for every inside sample row whose corner
rows idx_y(sy) or idx_y(sy) + 1 are y (w_y = 1 - h for the upper corner row,
h for the lower; idx_y is the clamped start, so a sample in [H-1, H) keeps
rows H-2 and H-1 with a ratio >= 1). It computes each entry's 8 sample
gradients (1/4 of the up to four pooled cells a sample feeds, added in the
plain version's order), then each owner of a column adds w_y * w_x * g of
every inside sample whose corner columns reach it, entries in order, sample
columns in order. Here that rule runs in numpy f32, one operation at a
time, and is held against `roi_align.roi_align_avg_backward` and against
`jax.vjp` of the JAX `roi_align_avg_cvjp` to 1e-5 of the largest gradient
(summation order only). It also checks that a row takes at most 8 entries a
roi (one a sample row), which is what the kernel's entry buffer holds, and
within the 16 a roi that the design allows. So the kernel's rule is pinned
before any chip time, as `tests/test_torch_vgg_block1_packing.py` pins the
VGG block-1 weight image."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlobjectdetection_tpu.ops.roi_align_vjp import roi_align_avg_cvjp
from rlobjectdetection_tpu_torch.ops import roi_align
import torch_threads  # noqa: F401  (xdist workers share the cores)

A, P = 8, 7
SCALE = 1.0 / 16.0
F32 = np.float32


def axis_geometry(roi, axis, size):
    """(idx, ratio, inside) of the 8 samples of one roi along rows (axis 0)
    or columns (axis 1), as the kernel's axis_span / axis_sample compute
    them."""
    lo = F32(roi[2 if axis == 0 else 1]) * F32(SCALE)
    hi = F32(roi[4 if axis == 0 else 3]) * F32(SCALE)
    length = max((hi - lo) + F32(1), F32(0))
    step = length / F32(A - 1)
    coord = np.arange(A, dtype=F32) * step + lo
    start = np.minimum(np.floor(coord), F32(size - 2))
    idx = np.clip(start.astype(np.int64), 0, size - 2)
    return idx, coord - start, (coord >= 0) & (coord < size)


def batch_of(roi, n_images):
    return min(max(int(roi[0]), 0), n_images - 1)


def row_entries(rois, n_images, h, b, y):
    """The entries row (b, y) takes, in the kernel's (roi, sy) order."""
    out = []
    for r, roi in enumerate(rois):
        if batch_of(roi, n_images) != b:
            continue
        idx, ratio, inside = axis_geometry(roi, 0, h)
        for sy in range(A):
            if inside[sy] and idx[sy] == y:
                out.append((r, sy, F32(1) - ratio[sy]))
            elif inside[sy] and idx[sy] + 1 == y:
                out.append((r, sy, ratio[sy]))
    return out


def sample_grads(g, sy):
    """The 8 sample gradients of sample row sy from one roi's d pooled
    `[P, P, C]`: cells (sy, sx), (sy, sx-1), (sy-1, sx), (sy-1, sx-1) in
    that order, a missing cell adding 0, times 1/4."""
    zero = np.zeros(g.shape[-1], F32)
    out, prev_up, prev_dn = [], zero, zero
    for sx in range(A):
        dn = g[sy, sx] if sx < P and sy < P else zero
        up = g[sy - 1, sx] if sx < P and sy > 0 else zero
        out.append(F32(0.25) * (((dn + prev_dn) + up) + prev_up))
        prev_up, prev_dn = up, dn
    return out


def emulate(grad, rois, feat_shape):
    """d features by the kernel's rule, f32. Also returns the entry counts
    of every (row, roi) pair."""
    n_images, h, w, c = feat_shape
    d = np.zeros(feat_shape, F32)
    per_roi = []
    for b in range(n_images):
        for y in range(h):
            entries = row_entries(rois, n_images, h, b, y)
            per_roi += list(np.bincount([e[0] for e in entries], minlength=len(rois)))
            for r, sy, wy in entries:
                xidx, xr, xin = axis_geometry(rois[r], 1, w)
                g = sample_grads(grad[r], sy)
                for sx in range(A):
                    if not xin[sx]:
                        continue
                    d[b, y, xidx[sx]] += (wy * (F32(1) - xr[sx])) * g[sx]
                    d[b, y, xidx[sx] + 1] += (wy * xr[sx]) * g[sx]
    return d, per_roi


def max_rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _boxes(rng, n, n_images, h, w):
    rois = np.zeros((n, 5), F32)
    rois[:, 0] = rng.randint(0, n_images, n)
    rois[:, 1] = rng.uniform(-40, 16 * w, n)
    rois[:, 2] = rng.uniform(-40, 16 * h, n)
    rois[:, 3:5] = rois[:, 1:3] + rng.uniform(0, 120, (n, 2))
    return rois


def case(name, rng):
    """(rois, feat_shape) of each case."""
    if name == "over the border":   # roi 0's last sample row at 8.5 on a 9-row map
        rois = _boxes(rng, 12, 2, 9, 11)
        rois[:4] = [[0, -60, 96, 80, 120], [1, 100, -50, 200, 40], [0, 130, 100, 260, 180],
                    [1, -300, -300, -200, -200]]
        return rois, (2, 9, 11, 16)
    if name == "16 copies of one roi":
        roi = [[0, 30, 20, 120, 100]]
        return np.array(roi * 16 + [[0, 10, 50, 60, 130]], F32), (1, 9, 11, 16)
    if name == "8 sample rows in one pixel row":   # y2 = y1 - 16: the samples coincide
        return np.array([[0, 20, 52, 90, 36], [0, 40, 52, 100, 36], [0, 10, 10, 60, 70]],
                        F32), (1, 9, 11, 16)
    if name == "two images, a row no roi reaches":
        rois = _boxes(rng, 10, 2, 4, 11)
        rois[:, 4] = np.minimum(rois[:, 4], 64)    # samples above row 6 of 12
        return rois, (2, 12, 11, 16)
    if name == "C = 36":
        return _boxes(rng, 15, 2, 9, 11), (2, 9, 11, 36)
    return np.zeros((0, 5), F32), (2, 9, 11, 16)     # R = 0


CASES = ["over the border", "16 copies of one roi", "8 sample rows in one pixel row",
         "two images, a row no roi reaches", "C = 36", "R = 0"]


@pytest.mark.parametrize("name", CASES)
def test_row_gather_matches_plain_and_jax_backward(name):
    rng = np.random.RandomState(CASES.index(name))
    rois, feat_shape = case(name, rng)
    n_images, h, w, c = feat_shape
    grad = rng.randn(len(rois), P, P, c).astype(F32)
    got, per_roi = emulate(grad, rois, feat_shape)
    assert max(per_roi, default=0) <= A <= 16

    plain = roi_align.roi_align_avg_backward(torch.from_numpy(grad), torch.from_numpy(rois),
                                             feat_shape, torch.float32, SCALE).numpy()
    if len(rois) == 0:
        assert not got.any() and not plain.any()
        return
    _, vjp = jax.vjp(lambda f: roi_align_avg_cvjp(f, jnp.asarray(rois), P, SCALE),
                     jnp.zeros(feat_shape, jnp.float32))
    want = np.asarray(vjp(jnp.asarray(grad))[0])
    assert np.abs(plain).max() > 0
    assert max_rel(got, plain) <= 1e-5
    assert max_rel(got, want) <= 1e-5

    if name == "over the border":
        idx, ratio, inside = axis_geometry(rois[0], 0, h)
        assert inside[-1] and idx[-1] == h - 2 and ratio[-1] >= 1
        assert got[0, h - 2].any() and got[0, h - 1].any()
    if name == "16 copies of one roi":
        counts = [np.bincount([e[0] for e in row_entries(rois, 1, h, 0, y)],
                              minlength=len(rois))[:16] for y in range(h)]
        assert all((n == n[0]).all() for n in counts) and max(n[0] for n in counts) > 0
    if name == "8 sample rows in one pixel row":
        idx = axis_geometry(rois[0], 0, h)[0]
        assert (idx == idx[0]).all()
        for y in (idx[0], idx[0] + 1):
            assert [e[:2] for e in row_entries(rois, 1, h, 0, y)][:A] == [(0, sy)
                                                                          for sy in range(A)]
    if name == "two images, a row no roi reaches":
        empty = [(b, y) for b in range(n_images) for y in range(h)
                 if not row_entries(rois, n_images, h, b, y)]
        assert empty
        for b, y in empty:
            assert not got[b, y].any() and not plain[b, y].any()
