"""The frozen BatchNorm's epilogue of a ResNet bottleneck: the BN affine,
the residual and the ReLU in one pass forward and one pass backward.

A site is one of three forms, each ending in a ReLU:

    relu(bn(x))                bn1, bn2, the plain stem's bn1
    relu(bn(x) + r)            bn3 of an identity block
    relu(bn(x) + bn_r(r))      bn3 of block 0, its downsample BN folded in

`frozen_bn_act(x, bn, r, bn_r)` is what `models/backbones/resnet.py` calls
at every site of a frozen BN: always the op `rlod::frozen_bn_act`
(`ops/library.py`) with its backward `rlod::frozen_bn_act_bwd`. On a CUDA
tensor the op launches `csrc/frozen_bn_act.cu` (`launch_frozen_bn_act`,
`launch_frozen_bn_act_bwd`; each call counts `frozen_bn.kernel_calls` and
each launch its wrapper's `.launches`): it copies an input that is not
contiguous as channels-last and 16-byte aligned, and raises `ValueError`
on a dtype other than f32 or bf16 or a C that is not a whole number of
16-byte vectors. On a CPU tensor it runs `frozen_bn_act_plain` /
`frozen_bn_act_plain_bwd`, the modules' arithmetic and autograd's on it
verbatim. The kernel rounds where that arithmetic rounds, so both give
the same bits.

A BN whose affine takes gradients (the RL net's layer4) is another
function: a `Bottleneck` built with a trainable affine calls
`trainable_bn_act`, the BN modules' own composition
(`frozen_bn_act_modules`), and counts `frozen_bn.plain_calls`
(`utils/tracing.py`); `frozen_bn_act` refuses such a BN.

The op takes each BN's (mul, add) in the compute dtype, computed by
`FrozenBatchNorm.affine` (the module's own expression) once and cached on
the module (`pack_cache.cached_pack`, keyed on its four buffers' storage
and version: a loaded or edited BN computes them again and counts
`pack.misses`). Under `torch.export` they are computed inline, so the
exported program holds the expression and the op.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import tracing
from . import _build
from .pack_cache import cached_pack

_DTYPES = (torch.float32, torch.bfloat16)


def frozen_bn_act_modules(x, bn, r=None, bn_r=None):
    """relu(bn(x) [+ r | + bn_r(r)]) through the modules: the chain the op
    replaces, and the site of a trainable affine."""
    out = bn(x)
    if r is not None:
        out = out + (r if bn_r is None else bn_r(r))
    return torch.relu(out)


def frozen_bn_act_plain(x, mul, add, r=None, mul_r=None, add_r=None):
    """The op's CPU body: relu(x·mul + add [+ r | + (r·mul_r + add_r)]) on
    NCHW x with per-channel constants, as the modules compute it."""
    out = x * mul[:, None, None] + add[:, None, None]
    if r is not None:
        out = out + (r if mul_r is None else r * mul_r[:, None, None] + add_r[:, None, None])
    return torch.relu(out)


def frozen_bn_act_plain_bwd(g, y, mul, mul_r=None, residual: bool = False) -> list:
    """The backward's CPU body, autograd's steps on the forward: [g_x] or
    [g_x, g_r] from the output's gradient g and the output y."""
    gs = torch.ops.aten.threshold_backward(g, y, 0)
    gx = gs * mul[:, None, None]
    if not residual:
        return [gx]
    return [gx, gs if mul_r is None else gs * mul_r[:, None, None]]


def _channels_last(t: torch.Tensor) -> bool:
    """Contiguous as channels-last and 16-byte aligned."""
    return (t.is_contiguous(memory_format=torch.channels_last)
            and t.storage_offset() * t.element_size() % 16 == 0)


def _as_channels_last(t):
    """t, or a channels-last copy where it is not contiguous as channels-last
    and aligned (an NCHW-contiguous map, a gradient in another layout, a
    conv's output as `torch.export` traces it)."""
    return t if t is None or _channels_last(t) else t.clone(memory_format=torch.channels_last)


def bn_constants(bn, dtype: torch.dtype):
    """The BN's (mul, add) in `dtype`, contiguous: computed inline under
    `torch.export`, else cached on the module per dtype. The cached pair is
    made outside inference mode, so a train step may save it for backward
    after a request under `torch.inference_mode()` filled the cache."""
    if bn.scale.requires_grad or bn.bias.requires_grad:
        raise ValueError("frozen_bn_act: the BN's affine takes gradients; a Bottleneck "
                         "built with a trainable affine calls trainable_bn_act")
    if torch.compiler.is_compiling():
        return bn.affine(dtype)
    src = (bn.scale, bn.bias, bn.mean, bn.var)

    def compute():
        with torch.inference_mode(False), torch.no_grad():
            return tuple(t.contiguous() for t in bn.affine(dtype))

    return cached_pack(bn, "_affine_packed", dtype, (bn.eps, bn.var.device), src, compute)


def frozen_bn_act(x, bn, r=None, bn_r=None):
    """relu(bn(x)), relu(bn(x) + r) or relu(bn(x) + bn_r(r)) on NCHW maps of
    frozen BNs, through the op."""
    mul, add = bn_constants(bn, x.dtype)
    mul_r, add_r = (None, None) if bn_r is None else bn_constants(bn_r, x.dtype)
    return torch.ops.rlod.frozen_bn_act(x, mul, add, r, mul_r, add_r)


def trainable_bn_act(x, bn, r=None, bn_r=None):
    """The same site where a BN's affine takes gradients: the modules'
    composition, counted as a plain call."""
    tracing.count("frozen_bn.plain_calls")
    return frozen_bn_act_modules(x, bn, r, bn_r)


@functools.cache
def _entry(name: str, n_ptrs: int):
    fn = getattr(_build.load("frozen_bn_act"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return fn


def _check(op: str, like: torch.Tensor, *tensors) -> None:
    if like.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {like.device}")
    if like.dtype not in _DTYPES or like.ndim != 4:
        raise ValueError(f"{op}: a 4-d f32/bf16 tensor is needed, got {tuple(like.shape)} "
                         f"{like.dtype}")
    c = like.shape[1]
    if c * like.element_size() % 16:
        raise ValueError(f"{op}: {c} channels are not a whole number of 16-byte vectors")
    for t in tensors:
        if t is None:
            continue
        per_channel = t.ndim == 1
        if (t.dtype != like.dtype or t.device != like.device
                or (tuple(t.shape) != (c,) if per_channel else t.shape != like.shape)
                or not (t.is_contiguous() if per_channel
                        else t.is_contiguous(memory_format=torch.channels_last))
                or t.data_ptr() % 16):
            raise ValueError(f"{op}: every operand must be a 16-byte aligned {like.dtype} "
                             f"tensor on {like.device}, [{c}] or {tuple(like.shape)} channels "
                             f"last, got {tuple(t.shape)} {t.dtype}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_frozen_bn_act(x, mul, add, r=None, mul_r=None, add_r=None) -> torch.Tensor:
    """The forward kernel on CUDA tensors: x (and r) `[N, C, H, W]`, copied
    to channels-last where they are not, mul/add (mul_r/add_r) `[C]`, all of
    x's dtype; returns y channels-last. Raises on anything else."""
    if (mul_r is None) != (add_r is None) or (mul_r is not None and r is None):
        raise ValueError("frozen_bn_act: mul_r and add_r come together, with r")
    x, r = _as_channels_last(x), _as_channels_last(r)
    _check("frozen_bn_act", x, x, mul, add, r, mul_r, add_r)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    tracing.count("frozen_bn.kernel_calls")
    if x.numel() == 0:
        return y
    n, c, h, w = x.shape
    err = _entry("rlod_frozen_bn_act_fwd", 7)(
        x.data_ptr(), _ptr(r), mul.data_ptr(), add.data_ptr(), _ptr(mul_r), _ptr(add_r),
        y.data_ptr(), n * h * w, c, _build.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "frozen_bn_act kernel")
    launch_frozen_bn_act.launches += 1
    return y


def launch_frozen_bn_act_bwd(g, y, mul, mul_r=None, residual: bool = False) -> list:
    """The backward kernel on CUDA tensors: [g_x] or, with `residual`,
    [g_x, g_r] from the output's gradient g (copied to channels-last where it
    is not) and the saved output y. Raises on anything else."""
    g = _as_channels_last(g)
    _check("frozen_bn_act backward", y, g, y, mul, mul_r)
    gx = torch.empty_like(y, memory_format=torch.channels_last)
    gr = torch.empty_like(y, memory_format=torch.channels_last) if residual else None
    tracing.count("frozen_bn.kernel_calls")
    if y.numel() == 0:
        return [gx] if gr is None else [gx, gr]
    n, c, h, w = y.shape
    err = _entry("rlod_frozen_bn_act_bwd", 6)(
        g.data_ptr(), y.data_ptr(), mul.data_ptr(), _ptr(mul_r), gx.data_ptr(), _ptr(gr),
        n * h * w, c, _build.dtype_code(y.dtype), torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "frozen_bn_act backward kernel")
    launch_frozen_bn_act_bwd.launches += 1
    return [gx] if gr is None else [gx, gr]


launch_frozen_bn_act.launches = 0
launch_frozen_bn_act_bwd.launches = 0
