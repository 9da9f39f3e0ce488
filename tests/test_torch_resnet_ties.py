"""`resnet_ties`: a ResNet run records its ReLU gates and another run takes
them, for holding the kernels' train step against their plain versions
(chip_smoke.py's training-CLI check). On the CPU in f32: replaying a run's
own gates changes no bit; replaying another input's gates gives the
forward and gradient of the same bottleneck written out with those gates;
frozen blocks are left alone.
"""

import numpy as np
import torch

from rlobjectdetection_tpu_torch.models.backbones import resnet_ties
from rlobjectdetection_tpu_torch.models.backbones.resnet import Bottleneck, ResLayer, nchw_to_nhwc
from rlobjectdetection_tpu_torch.models.rpn import RPNHead
import torch_threads  # noqa: F401  (xdist workers share the cores)


def _x(seed, shape):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _grads(model, x):
    model.zero_grad()
    out = model(x)
    (out * _x(9, out.shape)).sum().backward()
    return out.detach(), [p.grad.clone() for p in model.parameters()]


class _Net(torch.nn.Module):
    """A residual stage under the detector's RPN head."""

    def __init__(self):
        super().__init__()
        self.layer = ResLayer(8, 4, blocks=2, stride=2)
        self.rpn = RPNHead(3, 16)

    def forward(self, x):
        return torch.cat(self.rpn(nchw_to_nhwc(self.layer(x))), -1)


def test_replaying_its_own_gates_changes_no_bit():
    torch.manual_seed(0)
    net = _Net()
    x = _x(1, (2, 8, 12, 10))
    ties, counts = {}, {}
    with resnet_ties.record(net, ties):
        want, want_g = _grads(net, x)
    assert sorted(ties) == [(f"layer.block{b}", i) for b in range(2) for i in range(3)] + [
        ("rpn.RPN_Conv", 0)]
    with resnet_ties.replay(net, ties, counts):
        got, got_g = _grads(net, x)
    assert counts == {"flipped": 0, "flipped_max": 0.0}
    assert torch.equal(got, want) and all(map(torch.equal, got_g, want_g))
    # the modules' own forwards are back, and no hook is left
    assert "forward" not in vars(net.layer.block0) and not net.rpn.RPN_Conv._forward_hooks


def test_replay_takes_the_recorded_gates():
    torch.manual_seed(0)
    block = Bottleneck(16, 4)
    x1, x2 = _x(1, (2, 16, 6, 5)), _x(2, (2, 16, 6, 5))
    ties, counts = {}, {}
    with resnet_ties.record(block, ties):
        block(x1)
    with resnet_ties.replay(block, ties, counts):
        got, got_g = _grads(block, x2)

    # the same bottleneck written out, each ReLU input on the other side of
    # 0 from the recorded run's negated before the gate (value only)
    flipped, flipped_max = [0], [0.0]

    def gate(i, a):
        flip = (a > 0) != ties[("", i)]
        flipped[0] += int(flip.sum())
        size = a.detach().abs()
        flipped_max[0] = max(flipped_max[0], float(torch.where(flip, size, 0).max() / size.max()))
        return torch.relu(a + torch.where(flip, -2 * a, 0).detach())

    def written_out(x):
        out = gate(0, block.bn1(block.conv1(x)))
        out = gate(1, block.bn2(block.conv2(out)))
        return gate(2, block.bn3(block.conv3(out)) + x)

    block.zero_grad()
    out = written_out(x2)
    (out * _x(9, out.shape)).sum().backward()
    want, want_g = out.detach(), [p.grad.clone() for p in block.parameters()]
    assert flipped[0] > 0 and counts["flipped"] == flipped[0]
    assert counts["flipped_max"] == flipped_max[0]
    assert torch.equal(got, want) and all(map(torch.equal, got_g, want_g))


def test_frozen_blocks_are_not_gated():
    layer = ResLayer(8, 4, blocks=2).requires_grad_(False)
    layer.block1.conv2.weight.requires_grad_(True)
    ties = {}
    with resnet_ties.record(layer, ties):
        layer(_x(1, (1, 8, 6, 6)))
    assert sorted(ties) == [("block1", i) for i in range(3)]
