"""The port's fused residual stage and its ResNetBase gating against the JAX
package.

On the CPU `fused_res_stage` runs its plain PyTorch version, held here
against the Pallas kernel in interpret mode (as tests/test_res_stage_pallas.py
runs it) and the JAX `ResNetBase`, on the same numpy inputs. The CUDA kernel
itself runs only on a GPU: tests/test_torch_gpu.py holds it against the
plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlobjectdetection_tpu.models.backbones.resnet import ResLayer as JaxResLayer
from rlobjectdetection_tpu.models.backbones.resnet import ResNetBase as JaxResNetBase
from rlobjectdetection_tpu.ops.res_stage_pallas import fused_res_stage as jax_fused_res_stage
from rlobjectdetection_tpu_torch.engine.checkpoint import state_dict_from_jax
from rlobjectdetection_tpu_torch.models.backbones import resnet as port_resnet
from rlobjectdetection_tpu_torch.models.backbones.resnet import ResLayer, ResNetBase
from rlobjectdetection_tpu_torch.ops import res_stage_kernel

from test_torch_kernels import _flat, _unflat, max_rel
import torch_threads  # noqa: F401  (xdist workers share the cores)


def _stage_params(rng, planes, blocks, stride, cin, key):
    """A JAX ResLayer's flat params with every value randomised around the
    identity BN (the JAX test's recipe), and the port's layer loaded with
    them."""
    params = JaxResLayer(planes, blocks, stride, jnp.float32).init(
        jax.random.PRNGKey(key), jnp.zeros((1, 8, 8, cin), jnp.float32))["params"]
    flat = {}
    for k, v in _flat(params).items():
        leaf = k.rsplit("/", 1)[1]
        r = rng.randn(*v.shape).astype(np.float32) * 0.05
        r += 1.0 if leaf in ("scale", "var") else 0.0
        flat[k] = np.abs(r) + 0.5 if leaf == "var" else r
    layer = ResLayer(cin, planes, blocks, stride).requires_grad_(False)
    layer.load_state_dict(state_dict_from_jax(flat, layer))
    return flat, layer


@pytest.mark.parametrize("b,h,w,planes,blocks,stride,cin,chunk", [
    (1, 13, 11, 8, 3, 2, 16, 48),   # layer2-like: stride-2 entry, 3 chunks
    (2, 7, 9, 8, 2, 1, 32, 1024),   # stride-1 entry, single chunk, 2 images
    (1, 10, 6, 16, 4, 2, 8, 16),    # tiny chunk = many partial-halo chunks
    (1, 5, 16, 8, 2, 1, 16, 32),    # Wo a multiple of 16 (aligned row case)
])
def test_res_stage_plain_matches_pallas(b, h, w, planes, blocks, stride, cin, chunk):
    """f32 at the JAX test's own tolerance (rtol 1e-4, atol 1e-3)."""
    rng = np.random.RandomState(b * 100 + h + planes)
    flat, layer = _stage_params(rng, planes, blocks, stride, cin, key=b)
    x = (rng.randn(b, h, w, cin) * 0.1).astype(np.float32)
    xs = x[:, ::stride, ::stride]
    want = jax_fused_res_stage(jnp.asarray(xs), _unflat(flat), blocks=blocks, width=planes,
                               out_dtype=jnp.float32, compute_dtype=jnp.float32,
                               chunk=chunk, interpret=True)
    got = res_stage_kernel.fused_res_stage(torch.from_numpy(np.ascontiguousarray(xs)), layer,
                                           blocks=blocks, width=planes, dtype=torch.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


def test_res_stage_plain_matches_pallas_bf16():
    """bf16 compute: the two round the same f32 sums at the same points.
    Here they agree bit for bit (measured 0), but XLA and PyTorch may sum in
    other orders, so an activation could land on the neighbouring bf16 value;
    the bound is one bf16 step of the largest output, 2^-7."""
    rng = np.random.RandomState(17)
    flat, layer = _stage_params(rng, 16, 3, 2, 32, key=4)
    xs = (np.abs(rng.randn(2, 20, 14, 32)) * 0.5).astype(np.float32)[:, ::2, ::2]
    xs_bf = np.array(jnp.asarray(xs, jnp.bfloat16).astype(jnp.float32))
    want = jax_fused_res_stage(jnp.asarray(xs_bf, jnp.bfloat16), _unflat(flat), blocks=3,
                               width=16, out_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16,
                               chunk=32, interpret=True)
    got = res_stage_kernel.fused_res_stage(
        torch.from_numpy(np.ascontiguousarray(xs_bf)).to(torch.bfloat16), layer, blocks=3,
        width=16, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (2, 10, 7, 64)
    assert max_rel(got.float().numpy(), np.asarray(want, np.float32)) <= 2.0 ** -7


@pytest.fixture(scope="module")
def base_params():
    """A JAX ResNetBase(50) param tree with randomised frozen-BN statistics,
    and the same weights in the port's state-dict form."""
    rng = np.random.RandomState(5)
    x = jnp.zeros((1, 64, 48, 3), jnp.float32)
    params = JaxResNetBase(num_layers=50, dtype=jnp.float32, frozen_stages=3).init(
        jax.random.PRNGKey(3), x)["params"]
    flat = {}
    for k, v in _flat(params).items():
        leaf = k.rsplit("/", 1)[1]
        if leaf in ("scale", "var"):
            v = (0.7 + 0.3 * rng.rand(*v.shape)).astype(np.float32)
        elif leaf in ("bias", "mean"):
            v = (0.05 * rng.randn(*v.shape)).astype(np.float32)
        flat[k] = np.asarray(v)
    return _unflat(flat), state_dict_from_jax(flat)


def _port_base(sd, **kw):
    base = ResNetBase(50, torch.float32, **kw)
    base.load_state_dict(sd)
    return base


@pytest.fixture
def stage_calls(monkeypatch):
    """The widths `ResNetBase` hands to `fused_res_stage`, in call order."""
    calls = []

    def spy(x, layer, **kw):
        calls.append(kw["width"])
        return res_stage_kernel.fused_res_stage(x, layer, **kw)

    monkeypatch.setattr(port_resnet, "fused_res_stage", spy)
    return calls


def test_resnet_base_fused_stages_match_jax(base_params, stage_calls):
    """ResNetBase(stages_fused=23) against the JAX module with its Pallas
    stages in interpret mode, f32, and the gate: stage n fuses iff n is in
    stages_fused and (frozen_stages >= n or fwd_only)."""
    params, sd = base_params
    x = (np.random.RandomState(6).randn(1, 64, 48, 3) * 5).astype(np.float32)
    want = JaxResNetBase(num_layers=50, dtype=jnp.float32, frozen_stages=3, stages_fused=23,
                         stem_interpret=True).apply({"params": params}, jnp.asarray(x))
    fused = _port_base(sd, frozen_stages=3, stages_fused=23)
    with torch.no_grad():
        got = fused(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (1, 4, 3, 1024)
    assert max_rel(got.numpy(), want) < 1e-4
    assert stage_calls == [128, 256]

    # frozen_stages=1 keeps the plain stages in training (fwd_only=False)...
    trainy = _port_base(sd, frozen_stages=1, stages_fused=23)
    stage_calls.clear()
    with torch.no_grad():
        got2 = trainy(torch.from_numpy(x))
    assert stage_calls == []
    assert max_rel(got2.numpy(), want) < 1e-4
    # ...and fwd_only=True engages them again (the eval path)
    with torch.no_grad():
        got3 = trainy(torch.from_numpy(x), fwd_only=True)
    assert stage_calls == [128, 256]
    assert max_rel(got3.numpy(), want) < 1e-4
    # digit-coded: 2 fuses layer2 alone, 3 layer3 alone
    for code, widths in ((2, [128]), (3, [256])):
        stage_calls.clear()
        with torch.no_grad():
            _port_base(sd, frozen_stages=3, stages_fused=code)(torch.from_numpy(x))
        assert stage_calls == widths


def test_resnet_base_frozen_stages_cut_the_gradient(base_params):
    """frozen_stages=2: layer3 trains and nothing before it does, so the
    fused layer2 runs in a train forward while layer3 takes a gradient, as
    the JAX stop_gradient allows."""
    _, sd = base_params
    base = _port_base(sd, frozen_stages=2, stages_fused=23)
    assert [n for n, p in base.named_parameters() if p.requires_grad] == [
        n for n, _ in base.named_parameters() if n.startswith("layer3.")]
    x = torch.from_numpy((np.random.RandomState(7).randn(1, 64, 48, 3) * 5).astype(np.float32))
    n0 = res_stage_kernel.fused_res_stage.launches
    base(x).sum().backward()
    assert base.layer3.block0.conv1.weight.grad.abs().sum() > 0
    assert base.layer2.block0.conv1.weight.grad is None
    assert base.conv1.weight.grad is None
    assert res_stage_kernel.fused_res_stage.launches == n0   # the CPU runs the plain version


def test_resnet_base_rejects_malformed_stages_fused():
    """stages_fused is digit-coded {0, 2, 3, 23}; the JAX module asserts at
    call time, the port raises at construction."""
    with pytest.raises(ValueError, match="digit-coded"):
        ResNetBase(50, torch.float32, stages_fused=32)
    bad = JaxResNetBase(num_layers=50, dtype=jnp.float32, frozen_stages=3, stages_fused=32,
                        stem_interpret=True)
    with pytest.raises(AssertionError, match="digit-coded"):
        bad.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))


def test_fused_res_stage_is_forward_only():
    """It raises where autograd would need its gradient, and nowhere else:
    no silent cut."""
    rng = np.random.RandomState(0)
    _, layer = _stage_params(rng, 8, 2, 1, 32, key=0)
    x = torch.from_numpy(rng.randn(1, 6, 6, 32).astype(np.float32))
    run = lambda xi: res_stage_kernel.fused_res_stage(xi, layer, blocks=2, width=8,
                                                      dtype=torch.float32)
    with pytest.raises(RuntimeError, match="forward-only"):
        run(x.clone().requires_grad_())
    with torch.no_grad():
        run(x.clone().requires_grad_())
    layer.block1.conv3.weight.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        run(x)


def test_res_stage_packs_once_and_again_after_a_weight_change():
    """The packed weights are cached per stage and dtype, and packed again
    when a weight is edited in place or loaded."""
    rng = np.random.RandomState(1)
    _, layer = _stage_params(rng, 8, 2, 1, 32, key=1)
    x = torch.from_numpy(rng.randn(1, 5, 7, 32).astype(np.float32))
    run = lambda: res_stage_kernel.fused_res_stage(x, layer, blocks=2, width=8,
                                                   dtype=torch.float32)
    first = run()
    packed = layer._res_stage_packed[torch.float32][1]
    run()
    assert layer._res_stage_packed[torch.float32][1] is packed
    with torch.no_grad():
        layer.block1.bn2.var.mul_(4.0)
    changed = run()
    assert layer._res_stage_packed[torch.float32][1] is not packed
    with torch.no_grad():
        want = layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert max_rel(changed.numpy(), want.numpy()) < 1e-5
    assert not torch.allclose(changed, first)
