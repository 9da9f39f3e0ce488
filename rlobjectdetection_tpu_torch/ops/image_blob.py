"""A served image's blob built where the model runs: the pixel means
subtracted, the INTER_LINEAR resize by `scale` and the zero pad, in one
pass.

`image_blob(image, means, scale, size, pad)` takes a decoded `[h, w, 3]`
BGR image (f32 or uint8), the pixel means `[3]` f32, the resize factor,
the resized size `size` = (oh, ow) (`data/blob.py::resized_shape`) and the
padded shape `pad` = (H, W) ≥ (oh, ow), W a multiple of 4, and returns
the f32 `[1, H, W, 3]` blob that `data/blob.py::prep_im_for_blob` and the
zero pad give the same image, to the bit: always the op `rlod::image_blob`
(`ops/library.py`). On a CUDA tensor it launches `csrc/image_blob.cu`
(`launch_image_blob`: each call counts `blob.kernel_calls` and its
`.launches`); on a CPU tensor it runs `image_blob_plain`, the numpy
resize's arithmetic in PyTorch on the same taps.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..data.blob import linear_taps
from ..utils import tracing
from . import _build

_DTYPES = {torch.float32: 0, torch.uint8: 1}


def image_blob(image, means, scale: float, size, pad) -> torch.Tensor:
    """The `[1, H, W, 3]` f32 blob of `image`, through the op."""
    return torch.ops.rlod.image_blob(image, means, float(scale), list(size), list(pad))


def _check_sizes(image, size, pad) -> None:
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype not in _DTYPES:
        raise ValueError(f"image_blob: an [h, w, 3] f32 or uint8 image is needed, got "
                         f"{tuple(image.shape)} {image.dtype}")
    (oh, ow), (ph, pw) = size, pad
    if not (0 < oh <= ph and 0 < ow <= pw) or pw % 4:
        raise ValueError(f"image_blob: the resized size {tuple(size)} must fit in the padded "
                         f"shape {tuple(pad)}, whose width is a multiple of 4")


def image_blob_plain(image, means, scale: float, size, pad) -> torch.Tensor:
    """The op's CPU body (on any device): `_resize`'s taps and arithmetic
    (the means subtracted in f32 first; the rows interpolated, then the
    columns, each product and sum rounded to f32), in a zero canvas of
    `pad`."""
    _check_sizes(image, size, pad)
    h, w = image.shape[:2]
    (oh, ow), (ph, pw) = size, pad
    dev = image.device
    im = image.to(torch.float32) - means
    y0, y1, fy = (torch.from_numpy(t).to(dev) for t in linear_taps(oh, h, scale))
    x0, x1, fx = (torch.from_numpy(t).to(dev) for t in linear_taps(ow, w, scale))
    fy = fy[:, None, None]
    rows = im[y0] * (1.0 - fy) + im[y1] * fy
    fx = fx[None, :, None]
    blob = torch.zeros((1, ph, pw, 3), dtype=torch.float32, device=dev)
    blob[0, :oh, :ow] = rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx
    return blob


@functools.cache
def _entry():
    fn = _build.load("image_blob").rlod_image_blob
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_double]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_void_p])
    return fn


def launch_image_blob(image, means, scale: float, size, pad) -> torch.Tensor:
    """The kernel on CUDA tensors: `image` copied where it is not
    contiguous, `means` `[3]` f32 on its device. Every element of the
    returned blob is written by the kernel, the pad's zeros included.
    Raises on anything else."""
    _check_sizes(image, size, pad)
    if image.device.type != "cuda" or means.device != image.device or \
            means.dtype != torch.float32 or tuple(means.shape) != (3,):
        raise ValueError(f"image_blob: a CUDA image and its [3] f32 means on its device are "
                         f"needed, got {image.device} and {tuple(means.shape)} {means.dtype} "
                         f"on {means.device}")
    image, means = image.contiguous(), means.contiguous()
    h, w = image.shape[:2]
    (oh, ow), (ph, pw) = size, pad
    out = torch.empty((1, ph, pw, 3), dtype=torch.float32, device=image.device)
    tracing.count("blob.kernel_calls")
    err = _entry()(image.data_ptr(), _DTYPES[image.dtype], means.data_ptr(), float(scale),
                   h, w, oh, ow, ph, pw, out.data_ptr(),
                   torch.cuda.current_stream(image.device).cuda_stream)
    _build.check(err, "image_blob kernel")
    launch_image_blob.launches += 1
    return out


launch_image_blob.launches = 0
