"""Post-processing, the weight bridge from the JAX package, torch
checkpoints and the weight converter, serving, the entry points
(`trainval_net`, `test_net`, `demo`), the detector's optimizer and train
step, and the RL refinement steps."""

from .optim import build_optimizer, count_trainable, make_lr_schedule, param_labels
from .train import make_forward_fn, make_train_step

__all__ = ["build_optimizer", "count_trainable", "make_forward_fn", "make_lr_schedule",
           "make_train_step", "param_labels"]
