"""`rlod::frozen_bn_act` on the CPU: a bottleneck's frozen BN, residual and
ReLU as one op (`ops/frozen_bn_act.py`), in each of its three site forms
(bn1/bn2, bn3 with an identity residual, bn3 with the downsample BN folded
in) and in f32 and bf16. The op's CPU body and its autograd give the
modules' bits; the cached constants follow a loaded or edited BN; a
bottleneck built with a trainable affine stays on the modules, and the op
refuses such a BN; on the CPU the op takes any layout and dtype;
`torch.export` keeps the op opaque. The kernel against the same
composition on the card: `tests/test_torch_gpu.py -k frozen_bn`.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from rlobjectdetection_tpu_torch.models.backbones.resnet import (Bottleneck, FrozenBatchNorm,
                                                                 nhwc_to_nchw)
from rlobjectdetection_tpu_torch.ops import frozen_bn_act as fba
from rlobjectdetection_tpu_torch.utils import tracing
import torch_threads  # noqa: F401  (xdist workers share the cores)

FORMS = ("relu", "identity", "downsample")
DTYPES = (torch.float32, torch.bfloat16)
CASES = [(f, d) for f in FORMS for d in DTYPES]
IDS = [f"{f}-{str(d)[6:]}" for f, d in CASES]
C = 16


def _bn(seed: int, c: int = C, **kw) -> FrozenBatchNorm:
    """A frozen BN with statistics away from the identity."""
    rng = np.random.RandomState(seed)
    bn = FrozenBatchNorm(c, **kw)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5))
        bn.bias.copy_(torch.from_numpy(rng.randn(c).astype(np.float32) * 0.3))
        bn.mean.copy_(torch.from_numpy(rng.randn(c).astype(np.float32) * 0.3))
        bn.var.copy_(torch.from_numpy(rng.rand(c).astype(np.float32) + 0.3))
    return bn


def _map(seed: int, dtype, c: int = C) -> torch.Tensor:
    """`[2, c, 5, 7]` as an NCHW view of NHWC memory."""
    x = np.random.RandomState(seed).randn(2, 5, 7, c).astype(np.float32)
    return nhwc_to_nchw(torch.from_numpy(x)).to(dtype)


def _site(form: str, dtype, **kw):
    """(x, bn, r, bn_r) of a site of `form`."""
    r = None if form == "relu" else _map(2, dtype)
    bn_r = _bn(3, **kw) if form == "downsample" else None
    return _map(1, dtype), _bn(1, **kw), r, bn_r


def _count(name: str) -> int:
    return tracing.totals().get(name, 0)


@pytest.mark.parametrize("form,dtype", CASES, ids=IDS)
def test_op_body_equals_the_modules(form, dtype):
    x, bn, r, bn_r = _site(form, dtype)
    want = fba.frozen_bn_act_modules(x, bn, r, bn_r)
    mul, add = bn.affine(dtype)
    mul_r, add_r = (None, None) if bn_r is None else bn_r.affine(dtype)
    got = torch.ops.rlod.frozen_bn_act(x, mul, add, r, mul_r, add_r)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    plain = _count("frozen_bn.plain_calls")
    assert torch.equal(fba.frozen_bn_act(x, bn, r, bn_r), want)
    assert _count("frozen_bn.plain_calls") == plain       # the site took the op


@pytest.mark.parametrize("form,dtype", CASES, ids=IDS)
def test_gradients_equal_the_modules(form, dtype):
    x, bn, r, bn_r = _site(form, dtype)
    g = _map(4, dtype)
    with torch.inference_mode():          # a request fills the constants' cache first
        fba.frozen_bn_act(x, bn, r, bn_r)

    def grads(fn):
        xs = x.detach().requires_grad_(True)
        rs = None if r is None else r.detach().requires_grad_(True)
        y = fn(xs, bn, rs, bn_r)
        y.backward(g)
        return [y.detach(), xs.grad] + ([] if rs is None else [rs.grad])

    got, want = grads(fba.frozen_bn_act), grads(fba.frozen_bn_act_modules)
    assert len(got) == len(want) == (2 if r is None else 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the ReLU cut some gradient: the gates are exercised
    assert bool((got[1] == 0).any()) and bool((got[1] != 0).any())


@pytest.mark.parametrize("form,dtype", CASES, ids=IDS)
def test_constants_follow_a_loaded_or_edited_bn(form, dtype):
    x, bn, r, bn_r = _site(form, dtype)
    bns = [m for m in (bn, bn_r) if m is not None]
    misses = _count("pack.misses")
    fba.frozen_bn_act(x, bn, r, bn_r)
    assert _count("pack.misses") == misses + len(bns)
    fba.frozen_bn_act(x, bn, r, bn_r)
    assert _count("pack.misses") == misses + len(bns)          # cached
    # load other statistics: the constants are computed again
    for m, seed in zip(bns, (7, 8)):
        m.load_state_dict(_bn(seed).state_dict())
    got = fba.frozen_bn_act(x, bn, r, bn_r)
    assert _count("pack.misses") == misses + 2 * len(bns)
    assert torch.equal(got, fba.frozen_bn_act_modules(x, bn, r, bn_r))
    # an in-place edit of one buffer, likewise
    with torch.no_grad():
        bns[-1].var.mul_(3.0)
    got = fba.frozen_bn_act(x, bn, r, bn_r)
    assert _count("pack.misses") == misses + 2 * len(bns) + 1
    assert torch.equal(got, fba.frozen_bn_act_modules(x, bn, r, bn_r))


@pytest.mark.parametrize("form,dtype", CASES, ids=IDS)
def test_a_trainable_affine_takes_the_plain_path(form, dtype):
    x, bn, r, bn_r = _site(form, dtype, affine_trainable=True)
    with pytest.raises(ValueError, match="trainable"):
        fba.frozen_bn_act(x, bn, r, bn_r)
    plain, misses = _count("frozen_bn.plain_calls"), _count("pack.misses")
    y = fba.trainable_bn_act(x, bn, r, bn_r)
    assert _count("frozen_bn.plain_calls") == plain + 1
    assert _count("pack.misses") == misses
    assert torch.equal(y, fba.frozen_bn_act_modules(x, bn, r, bn_r))
    y.float().sum().backward()
    assert all(m.scale.grad is not None for m in (bn, bn_r) if m is not None)

    # a bottleneck built with a trainable affine: its three sites, none the op
    torch.manual_seed(0)
    block = Bottleneck(4 * C, C, downsample=form == "downsample", bn_affine_trainable=True)
    plain = _count("frozen_bn.plain_calls")
    block(_map(5, dtype, 4 * C)).float().sum().backward()
    assert _count("frozen_bn.plain_calls") == plain + 3
    assert _count("pack.misses") == misses
    assert block.bn1.scale.grad is not None and block.bn3.bias.grad is not None


@pytest.mark.parametrize("form,dtype", CASES, ids=IDS)
def test_fake_shapes_and_export_keep_the_op(form, dtype):
    x, bn, r, bn_r = _site(form, dtype)
    mul, add = bn.affine(dtype)
    mul_r, add_r = (None, None) if bn_r is None else bn_r.affine(dtype)
    with FakeTensorMode(allow_non_fake_inputs=True):
        y = torch.ops.rlod.frozen_bn_act(x, mul, add, r, mul_r, add_r)
        grads = torch.ops.rlod.frozen_bn_act_bwd(y, y, mul, mul_r, r is not None)
    assert tuple(y.shape) == tuple(x.shape) and y.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert len(grads) == (1 if r is None else 2)
    assert all(tuple(g.shape) == tuple(x.shape) and g.dtype == dtype for g in grads)

    # a bottleneck whose bn3 site has this form (bn1, bn2 are the first)
    torch.manual_seed(0)
    block = Bottleneck(64 if form == "downsample" else 4 * C, C,
                       downsample=form == "downsample").requires_grad_(False)
    with torch.no_grad():
        for name, buf in block.named_buffers():
            buf.copy_(_bn(len(name), buf.shape[0]).state_dict()[name.rsplit(".", 1)[1]])

    class Site(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block = block

        def forward(self, v):
            return (self.block(v) if form != "relu"
                    else fba.frozen_bn_act(v, self.block.bn1))

    site = Site()
    v = _map(5, dtype, 4 * C) if form != "relu" else _map(5, dtype)
    program = torch.export.export(site, (v,))
    used = [str(n.target) for n in program.graph.nodes if n.op == "call_function"
            and str(n.target).startswith("rlod.")]
    assert used == ["rlod.frozen_bn_act.default"] * (3 if form != "relu" else 1)
    with torch.no_grad():
        assert torch.equal(program.module()(v), site(v))


@pytest.mark.parametrize("case", ["nchw", "float64", "partial_vector", "misaligned"])
def test_inputs_the_kernel_does_not_take_run_the_op_on_the_cpu(case):
    """On the CPU the op's body takes any layout and dtype; on the card the
    launch copies such a layout and refuses such a dtype or C
    (`tests/test_torch_gpu.py`)."""
    dtype = torch.float64 if case == "float64" else torch.bfloat16
    c = 4 if case == "partial_vector" else C          # 4 bf16: half a 16-byte vector
    x, bn = _map(1, dtype, c), _bn(1, c)
    if case == "nchw":
        x = x.contiguous()
    if case == "misaligned":                          # one element past a 16-byte boundary
        flat = torch.from_numpy(np.random.RandomState(1).randn(2 * 5 * 7 * C + 1)
                                .astype(np.float32)).to(dtype)
        x = nhwc_to_nchw(flat[1:].reshape(2, 5, 7, C))
    plain, misses = _count("frozen_bn.plain_calls"), _count("pack.misses")
    y = fba.frozen_bn_act(x, bn)
    assert _count("frozen_bn.plain_calls") == plain
    assert _count("pack.misses") == misses + 1           # the op took the site
    assert torch.equal(y, torch.relu(bn(x)))
