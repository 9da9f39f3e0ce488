"""The detector's optimizer (counterpart of
`rlobjectdetection_tpu/engine/optim.py`).

SGD with momentum 0.9 over the reference's parameter groups: weights at the
learning rate with weight decay, biases at twice the rate (TRAIN.DOUBLE_BIAS)
without decay (TRAIN.BIAS_DECAY False); the frozen backbone prefix and every
BN constant take no update. As optax's chain (`add_decayed_weights` →
`trace` → `scale_by_schedule`), which `torch.optim.SGD` computes with
dampening 0: d = g + wd·p, m = d + μ·m, p -= lr·m. The step-decay schedule
counts optimizer steps (a `LambdaLR`, stepped once a step). An optional
global-norm clip runs over the trainable parameters only, with optax's
`clip_by_global_norm` formula.

    opt, sched, labels = build_optimizer(model, "resnet101", base_lr=0.01)
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn


def resnet_param_trainable(path: Sequence[str], fixed_blocks: int = 1) -> bool:
    """Trainability of a ResNet base param path from the base's root, e.g.
    ("layer1", "block0", "conv1", "weight"): BN never, conv1 never,
    layer1..layer`fixed_blocks` not."""
    if "bn" in "/".join(path):
        return False
    if path[0] in ("conv1", "bn1"):
        return False
    return not any(fixed_blocks >= i and path[0] == f"layer{i}" for i in range(1, 4))


def vgg_param_trainable(path: Sequence[str], fixed_blocks: int = 2) -> bool:
    """Conv blocks 1..`fixed_blocks` of VGG-16 are frozen (the reference
    freezes blocks 1 and 2)."""
    name = path[0]
    if name.startswith("conv"):
        return int(name[4]) > fixed_blocks
    return True


def _label_of(keys: tuple, backbone: str, fixed_blocks: int) -> str:
    if keys and keys[0] == "base":
        sub = keys[1:]
        if backbone == "vgg16":
            # VGG's freeze depth is the reference's (blocks 1-2), not FIXED_BLOCKS
            if not vgg_param_trainable(sub, fixed_blocks=2):
                return "frozen"
        elif backbone.startswith("resnet"):
            if not resnet_param_trainable(sub, fixed_blocks=fixed_blocks):
                return "frozen"
        # `tiny` (the test backbone): nothing frozen
    if any(k.startswith("bn") or k.endswith("_bn") for k in keys):
        return "frozen"
    if keys and keys[-1] in ("mean", "var"):
        return "frozen"
    return "bias" if keys and keys[-1] == "bias" else "weight"


def param_labels(model: nn.Module, backbone: str, fixed_blocks: int = 1) -> dict[str, str]:
    """{parameter name: 'frozen' | 'weight' | 'bias'} over
    `model.named_parameters()`, by the JAX package's rules."""
    return {name: _label_of(tuple(name.split(".")), backbone, fixed_blocks)
            for name, _ in model.named_parameters()}


def count_trainable(labels: dict[str, str]) -> dict[str, int]:
    """How many tensors carry each label."""
    counts = {"weight": 0, "bias": 0, "frozen": 0}
    for label in labels.values():
        counts[label] += 1
    return counts


def make_lr_schedule(base_lr: float, decay_step_iters: int, gamma: float = 0.1):
    """count → learning rate: step decay by `gamma` every `decay_step_iters`
    optimizer steps."""

    def schedule(count: int) -> float:
        return base_lr * (gamma ** (count // decay_step_iters))

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's `clip_by_global_norm` in place: g unchanged when the global
    norm is below `max_norm`, else (g / norm) · max_norm (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`). Returns the norm; no host sync."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                 for g in grads]))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


class SGD(torch.optim.SGD):
    """`torch.optim.SGD` that first clips the gradients of all its
    parameters (the trainable ones: `build_optimizer` leaves the frozen out)
    by their global norm when `clip_norm` is set, and keeps that norm before
    the clip as `grad_norm` (a device tensor)."""

    def __init__(self, groups, lr: float, momentum: float, clip_norm: float | None = None):
        super().__init__(groups, lr=lr, momentum=momentum)
        self.clip_norm = clip_norm
        self.grad_norm = None

    @torch.no_grad()
    def step(self, closure=None):
        if self.clip_norm is not None:
            grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
            if grads:
                self.grad_norm = clip_by_global_norm_(grads, self.clip_norm)
        return super().step(closure)


def build_optimizer(model: nn.Module, backbone: str, base_lr: float, *, momentum: float = 0.9,
                    weight_decay: float = 0.0005, double_bias: bool = True,
                    bias_decay: bool = False, fixed_blocks: int = 1,
                    lr_schedule: Callable[[int], float] | None = None,
                    clip_norm: float | None = None):
    """(optimizer, scheduler, labels) for `model`'s parameters as labelled by
    `param_labels`. Frozen parameters are left out of the optimizer and set
    `requires_grad_(False)`, so autograd computes no gradient for them.
    `lr_schedule` (count → lr, e.g. `make_lr_schedule`) defaults to
    constant `base_lr`; step the scheduler once after each optimizer step."""
    labels = param_labels(model, backbone, fixed_blocks)
    groups = {"weight": [], "bias": []}
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
        else:
            groups[labels[name]].append(p)
    opt = SGD([{"params": groups["weight"], "lr": base_lr, "weight_decay": weight_decay},
               {"params": groups["bias"], "lr": base_lr * (2.0 if double_bias else 1.0),
                "weight_decay": weight_decay if bias_decay else 0.0}],
              lr=base_lr, momentum=momentum, clip_norm=clip_norm)
    schedule = lr_schedule or (lambda _: base_lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda count: schedule(count) / base_lr)
    return opt, sched, labels
