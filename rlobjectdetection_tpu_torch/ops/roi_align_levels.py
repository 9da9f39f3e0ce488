"""Multi-level RoIAlignV2: the box head's pooler of the FPN detector
(Detectron2's ROIPooler, POOLER_TYPE ROIAlignV2, P2-P5), forward and the
features' gradient.

Each roi (batch_idx, x1, y1, x2, y2 in image pixels) is pooled from one
level: k = ⌊4 + log2(√area / 224 + 1e-8)⌋ clamped to [2, 5], area = (x2 −
x1)(y2 − y1), computed as 2 + [v ≥ ½] + [v ≥ 1] + [v ≥ 2] with v = √area /
224 + 1e-8 in f32 (`roi_levels`). On level k's map (stride 2^k) the roi is
shifted by −0.5 pixel (aligned=True) with no minimum size, cut into 7×7
bins, and each bin is the mean of a ⌈roi_h / 7⌉ × ⌈roi_w / 7⌉ grid of
bilinear samples (sampling_ratio 0), a sample outside [−1, size] being 0,
as torchvision's `roi_align` computes it.

`roi_align_levels` is the op `rlod::roi_align_levels` (`ops/library.py`)
with its autograd: on CUDA tensors the kernels of `csrc/roi_align_levels.cu`
(`_forward`, then `roi_align_levels_bwd` through the op
`rlod::roi_align_levels_bwd`: f32 atomics into one zeroed map a level, cast
to the feature type); on CPU tensors the plain versions below. Each kernel
counts its launches (`roi_align_levels.launches`,
`roi_align_levels_bwd.launches`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

POOLED = 7
LEVELS = (2, 3, 4, 5)
CANONICAL_SIZE = 224.0
_DTYPES = (torch.float32, torch.bfloat16)


def roi_levels(rois: torch.Tensor) -> torch.Tensor:
    """Each roi's level index (0 for P2 .. 3 for P5), `[R]` int64."""
    x1, y1, x2, y2 = (rois[:, k].float() for k in range(1, 5))
    # a tensor divisor: a CUDA tensor over a python number multiplies by its
    # reciprocal, which the kernel's division does not
    v = torch.sqrt((x2 - x1) * (y2 - y1)) / torch.full_like(x1, CANONICAL_SIZE) + 1e-8
    return (v >= 0.5).long() + (v >= 1.0).long() + (v >= 2.0).long()


def _axis(start, bin_, grid, n_grid: int, size):
    """Samples along one axis: `[R, P, G]` low and high corner, the high
    corner's weight and whether the sample counts (inside [−1, size] and
    within the roi's grid)."""
    dev = start.device
    p = torch.arange(POOLED, dtype=torch.float32, device=dev)[None, :, None]
    i = torch.arange(n_grid, dtype=torch.float32, device=dev)[None, None, :]
    g = grid.float()[:, None, None]
    c = ((start[:, None, None] + p * bin_[:, None, None])
         + ((i + 0.5) * bin_[:, None, None]) / g.clamp_min(1.0))
    size = size.float()[:, None, None]
    ok = (c >= -1.0) & (c <= size) & (i < g)
    c = torch.where(ok, c, 0.0).clamp_min(0.0)
    lo = c.floor()
    top = lo >= size - 1
    lo = torch.where(top, size - 1, lo)
    hi = torch.where(top, lo, lo + 1)
    c = torch.where(top, lo, c)
    return lo.long(), hi.long(), c - lo, ok


def _corners(shapes, rois: torch.Tensor):
    """The four corners of every sample of every bin: [(row, weight)], each
    `[R, P, Gh, P, Gw]`: the row of the maps' rows stacked level by level
    (`[Σ B·H_k·W_k, C]`) and the bilinear weight over the bin's sample count
    (0 for a sample that does not count)."""
    b = shapes[0][0]
    dev = rois.device
    sizes = torch.tensor([[s[1], s[2]] for s in shapes], device=dev)
    offsets = torch.tensor([0] + [s[0] * s[1] * s[2] for s in shapes[:-1]], device=dev).cumsum(0)
    level = roi_levels(rois)
    scale = 1.0 / (2.0 ** (level.float() + LEVELS[0]))
    h, w = sizes[level, 0], sizes[level, 1]
    start_x, start_y = rois[:, 1] * scale - 0.5, rois[:, 2] * scale - 0.5
    roi_w = (rois[:, 3] * scale - 0.5) - start_x
    roi_h = (rois[:, 4] * scale - 0.5) - start_y
    pooled = torch.full_like(roi_h, float(POOLED))
    bin_h, bin_w = roi_h / pooled, roi_w / pooled
    grid_h, grid_w = torch.ceil(bin_h).long(), torch.ceil(bin_w).long()
    count = (grid_h * grid_w).clamp_min(1).float()
    gh = max(int(grid_h.max()), 1) if len(rois) else 1
    gw = max(int(grid_w.max()), 1) if len(rois) else 1
    y0, y1, ly, oky = _axis(start_y, bin_h, grid_h, gh, h)           # [R, P, Gh]
    x0, x1, lx, okx = _axis(start_x, bin_w, grid_w, gw, w)           # [R, P, Gw]
    base = offsets[level] + rois[:, 0].long().clamp(0, b - 1) * h * w
    e = lambda t: t[:, :, :, None, None]                             # y → [R, P, Gh, 1, 1]
    f = lambda t: t[:, None, None]                                   # x → [R, 1, 1, P, Gw]
    rr = lambda t: t[:, None, None, None, None]
    ok = e(oky) & f(okx)
    out = []
    for yy, wy in ((y0, 1.0 - ly), (y1, ly)):
        for xx, wx in ((x0, 1.0 - lx), (x1, lx)):
            row = rr(base) + e(yy) * rr(w) + f(xx)
            out.append((row, torch.where(ok, e(wy) * f(wx), 0.0) / rr(count)))
    return out


# rois a block of the plain versions: their sample grids are padded to the
# block's largest, so a block's gathers stay small
PLAIN_BLOCK = 16


def roi_align_levels_plain(feats, rois: torch.Tensor) -> torch.Tensor:
    """feats: the four maps P2..P5 `[B, H_k, W_k, C]` (one dtype); rois
    `[R, 5]` f32 → `[R, 7, 7, C]` in the feature dtype (f32 inside)."""
    c = feats[0].shape[-1]
    flat = torch.cat([f.reshape(-1, c).float() for f in feats])
    shapes = [f.shape for f in feats]
    out = flat.new_zeros((rois.shape[0], POOLED, POOLED, c))
    for at in range(0, rois.shape[0], PLAIN_BLOCK):
        for row, wt in _corners(shapes, rois[at:at + PLAIN_BLOCK]):
            out[at:at + PLAIN_BLOCK] += (flat[row] * wt[..., None]).sum(dim=(2, 4))
    return out.to(feats[0].dtype)


def roi_align_levels_plain_backward(grad: torch.Tensor, rois: torch.Tensor, shapes,
                                    dtype: torch.dtype):
    """The features' gradients of `roi_align_levels_plain`: grad `[R, 7, 7,
    C]` → one `[B, H_k, W_k, C]` map a level in `dtype`, summed in f32."""
    c = shapes[0][-1]
    rows = sum(s[0] * s[1] * s[2] for s in shapes)
    flat = torch.zeros((rows, c), dtype=torch.float32, device=grad.device)
    g = grad.float()[:, :, None, :, None, :]                          # [R, P, 1, P, 1, C]
    for at in range(0, rois.shape[0], PLAIN_BLOCK):
        gb = g[at:at + PLAIN_BLOCK]
        for row, wt in _corners(shapes, rois[at:at + PLAIN_BLOCK]):
            flat.index_add_(0, row.reshape(-1), (gb * wt[..., None]).reshape(-1, c))
    out, at = [], 0
    for s in shapes:
        n = s[0] * s[1] * s[2]
        out.append(flat[at:at + n].reshape(s).to(dtype, copy=True))
        at += n
    return tuple(out)


def _entry(name: str):
    fn = getattr(_build.load("roi_align_levels"), name)
    fn.restype = ctypes.c_int
    # six pointers (forward: the maps, rois, out; backward: grad, rois, the
    # four f32 maps), R, B, C, the maps' (H, W), the dtype code, the stream
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def _hw(shapes):
    return (ctypes.c_int * 8)(*[int(x) for s in shapes for x in s[1:3]])


def _check(op: str, feats, rois: torch.Tensor):
    dev = feats[0].device
    if dev.type != "cuda":
        raise ValueError(f"{op}: unsupported device {dev}")
    b, c, dt = feats[0].shape[0], feats[0].shape[-1], feats[0].dtype
    for f in feats:
        if (f.ndim != 4 or f.shape[0] != b or f.shape[-1] != c or f.dtype != dt
                or f.device != dev or not f.is_contiguous()):
            raise ValueError(f"{op}: the four maps must be contiguous [B, H, W, C] tensors of "
                             f"one batch, width, dtype and device")
    if dt not in _DTYPES:
        raise ValueError(f"{op}: features must be f32 or bf16, got {dt}")
    if (rois.ndim != 2 or rois.shape[1] != 5 or rois.dtype != torch.float32
            or rois.device != dev or not rois.is_contiguous()):
        raise ValueError(f"{op}: rois must be a contiguous [R, 5] f32 tensor on {dev}")


def _forward(p2, p3, p4, p5, rois: torch.Tensor) -> torch.Tensor:
    """The forward kernel (plain version on CPU tensors), no gradient."""
    feats = (p2, p3, p4, p5)
    with torch.no_grad():
        if p2.device.type == "cpu":
            return roi_align_levels_plain(feats, rois)
        _check("roi_align_levels", feats, rois)
        b, c = p2.shape[0], p2.shape[-1]
        out = torch.empty((rois.shape[0], POOLED, POOLED, c), dtype=p2.dtype, device=p2.device)
        if rois.shape[0] == 0:
            return out
        hw = _hw([f.shape for f in feats])
        err = _entry("rlod_roi_align_levels_fwd")(
            *(f.data_ptr() for f in feats), rois.data_ptr(), out.data_ptr(), rois.shape[0], b,
            c, ctypes.cast(hw, ctypes.c_void_p),
            _build.dtype_code(p2.dtype), torch.cuda.current_stream(p2.device).cuda_stream)
        _build.check(err, "roi_align_levels kernel")
        roi_align_levels.launches += 1
        return out


def _level_shapes(feat_shapes) -> list:
    return [tuple(int(x) for x in feat_shapes[4 * k:4 * k + 4]) for k in range(len(LEVELS))]


def roi_align_levels_bwd(grad: torch.Tensor, rois: torch.Tensor, feat_shapes):
    """The backward kernel (plain backward on CPU tensors): grad `[R, 7, 7,
    C]`, rois as the forward's, feat_shapes the four maps' (B, H, W, C)
    flat → their gradients in grad's dtype."""
    shapes = _level_shapes(feat_shapes)
    with torch.no_grad():
        if grad.device.type == "cpu":
            return roi_align_levels_plain_backward(grad, rois, shapes, grad.dtype)
        if grad.dtype not in _DTYPES or not grad.is_contiguous() or tuple(grad.shape) != (
                rois.shape[0], POOLED, POOLED, shapes[0][-1]):
            raise ValueError(f"roi_align_levels backward: grad must be a contiguous "
                             f"[{rois.shape[0]}, 7, 7, C] f32/bf16 tensor, got "
                             f"{tuple(grad.shape)} {grad.dtype}")
        acc = [torch.zeros(s, dtype=torch.float32, device=grad.device) for s in shapes]
        hw = _hw(shapes)
        err = _entry("rlod_roi_align_levels_bwd")(
            grad.data_ptr(), rois.data_ptr(), *(a.data_ptr() for a in acc), rois.shape[0],
            shapes[0][0], shapes[0][-1], ctypes.cast(hw, ctypes.c_void_p),
            _build.dtype_code(grad.dtype), torch.cuda.current_stream(grad.device).cuda_stream)
        _build.check(err, "roi_align_levels backward kernel")
        roi_align_levels_bwd.launches += 1
        return tuple(a.to(grad.dtype) for a in acc)


def roi_align_levels(feats, rois: torch.Tensor) -> torch.Tensor:
    """feats: P2..P5 `[B, H_k, W_k, C]` NHWC f32/bf16 (strides 4..32 of one
    canvas); rois `[R, 5]` f32 in image pixels, any order. Returns `[R, 7, 7,
    C]` in the feature dtype; the features' gradient comes from
    `roi_align_levels_bwd`, the rois take none."""
    if len(feats) != len(LEVELS):
        raise ValueError(f"roi_align_levels takes the {len(LEVELS)} maps P2..P5, got "
                         f"{len(feats)}")
    feats = [f.contiguous() for f in feats]
    return torch.ops.rlod.roi_align_levels(*feats, rois.contiguous())


roi_align_levels.launches = 0
roi_align_levels_bwd.launches = 0
