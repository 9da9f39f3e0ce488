"""The rule every forward-only kernel wrapper keeps.

The fused kernels (stem, layer1, VGG block 1, the residual stage,
RoIAlignAvg) have no backward: each wrapper runs under `torch.no_grad()`.
So that this never cuts a gradient without a word, a wrapper first calls
`forward_only`, which raises where autograd would need the op's gradient,
on the CPU as on the card: the plain version the CPU runs must not give a
gradient the kernel cannot.
"""

from __future__ import annotations

from typing import Iterable

import torch


def forward_only(op: str, tensors: Iterable[torch.Tensor]) -> None:
    """Raise RuntimeError when grad is enabled and any of `tensors` (the
    op's input and every weight it reads) requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} is forward-only: it has no backward, and its input or a weight it reads "
            f"requires grad; freeze the weights and detach the input, or run it under "
            f"torch.no_grad()")
