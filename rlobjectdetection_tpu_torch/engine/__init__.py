"""Post-processing, the weight bridge from the JAX package, serving, the
eval entry point (`test_net`), the detector's optimizer and train step,
and the RL refinement steps."""

from .optim import build_optimizer, make_lr_schedule, param_labels
from .train import make_forward_fn, make_train_step

__all__ = ["build_optimizer", "make_forward_fn", "make_lr_schedule", "make_train_step",
           "param_labels"]
