"""The ResNet detector's rounding-decided ReLU gates, for holding two runs
of one train step against each other (the kernels against their plain
versions).

Where a ReLU's input lies within rounding of 0, the last bit of the sums
before it decides whether the gate passes the value and its gradient; one
such gate that a train step differentiates moves a leaf's largest update
by a few 1e-3. `record` notes one run's gates: the three of every
bottleneck with a trained parameter (layer2-3 of the base and the head's
layer4 at RESNET.FIXED_BLOCKS 1) and the RPN's conv (`rpn.RPN_Conv`, whose
gradient reaches layer3 through the base features). `replay` has another
run keep its own forward but take those gates: an input on the other side
of 0 from the recorded run's takes its sign (the value negated, the
gradient untouched), as `vgg_ties.replay` does for VGG-16's convs. Frozen
blocks take no gradient, so their gates do not matter.
"""

from __future__ import annotations

import contextlib

import torch

from .resnet import Bottleneck


def _gated_forward(block: Bottleneck, gate):
    """`Bottleneck.forward` with each of its three ReLUs' inputs passed
    through `gate(i, x)` first."""

    def forward(x):
        out = torch.relu(gate(0, block.bn1(block.conv1(x))))
        out = torch.relu(gate(1, block.bn2(block.conv2(out))))
        out = block.bn3(block.conv3(out))
        sc = block.downsample_bn(block.downsample_conv(x)) if block.downsample else x
        return torch.relu(gate(2, out + sc))

    return forward


@contextlib.contextmanager
def _gated(model: torch.nn.Module, gate):
    """Within the context, every ReLU input `record` names goes through
    `gate(key, x)` (which returns the value the ReLU takes)."""
    blocks = [(n, m) for n, m in model.named_modules() if isinstance(m, Bottleneck)
              and any(p.requires_grad for p in m.parameters())]
    for name, block in blocks:
        block.forward = _gated_forward(block, lambda i, x, name=name: gate((name, i), x))
    rpn = getattr(model, "rpn", None)
    hooks = [] if rpn is None else [rpn.RPN_Conv.register_forward_hook(
        lambda m, inp, out: gate(("rpn.RPN_Conv", 0), out))]
    try:
        yield
    finally:
        for _, block in blocks:
            del block.forward
        for h in hooks:
            h.remove()


def record(model: torch.nn.Module, ties: dict):
    """Within the context, `model`'s forward fills `ties`: {(block name,
    gate index) or ("rpn.RPN_Conv", 0): its ReLU input > 0}."""

    def gate(key, x):
        ties[key] = (x > 0).detach()
        return x

    return _gated(model, gate)


def replay(model: torch.nn.Module, ties: dict, counts: dict | None = None):
    """Within the context, `model`'s forward takes the gates in `ties` (as
    `record` fills them) where its own would differ. `counts`, if given,
    gets the number of ReLU inputs whose sign was flipped ("flipped") and
    the largest of them relative to its gate's largest input magnitude
    ("flipped_max"): rounding size where only ties were decided apart."""
    counts = {} if counts is None else counts
    counts.update(flipped=0, flipped_max=0.0)

    def gate(key, x):
        flip = (x > 0) != ties[key]
        size = x.detach().abs()
        counts["flipped"] += int(flip.sum())
        counts["flipped_max"] = max(counts["flipped_max"], float(
            torch.where(flip, size, 0).max() / size.max().clamp_min(1e-30)))
        return x + torch.where(flip, -2 * x, 0).detach()

    return _gated(model, gate)
