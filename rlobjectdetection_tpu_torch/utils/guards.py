"""Numerical guards (counterpart of `rlobjectdetection_tpu/utils/guards.py`):
a finiteness check over gradients and the skip-step policy built on it."""

from __future__ import annotations

from typing import Iterable

import torch


def finite_mask(tensors: Iterable[torch.Tensor | None]) -> torch.Tensor:
    """Scalar bool tensor: every floating-point tensor of `tensors` is finite
    (None entries, as unused parameters' gradients, are skipped)."""
    checks = [torch.isfinite(t).all() for t in tensors
              if t is not None and t.is_floating_point()]
    return torch.stack(checks).all() if checks else torch.tensor(True)


def skip_nonfinite_step(opt: torch.optim.Optimizer, sched) -> bool:
    """The skip-bad-step policy: apply `opt.step()` and `sched.step()` only
    when every gradient the optimizer holds is finite. A skipped step leaves
    the parameters, the momentum and the schedule's count as they were (the
    JAX step rolls back its whole optimizer state, schedule count included),
    so an Inf never poisons the momentum. Returns True when it skipped.
    Reads one bool from the device."""
    grads = [p.grad for group in opt.param_groups for p in group["params"]]
    if not bool(finite_mask(grads)):
        return True
    opt.step()
    sched.step()
    return False
