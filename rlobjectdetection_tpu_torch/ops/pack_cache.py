"""Packed kernel operands, cached beside the weights they come from.

The fused kernels read BN-folded, re-laid-out, cast copies of frozen
weights. Packing them costs dozens of small ops, so each wrapper packs once
and keeps the result on an object that lives as long as the weights (the
stage module, or the stem's weight tensor). The key holds every source
tensor's storage and version counter, so loading or editing a weight in
place packs again.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..utils import tracing


def cached_pack(holder, attr: str, slot, extra, tensors: Iterable[torch.Tensor],
                pack: Callable):
    """`pack()`, cached in `holder.__dict__[attr][slot]` as (key, value);
    the key is `extra` and each tensor's (data_ptr, version). Each miss
    counts to `pack.misses` (`utils/tracing.py`)."""
    key = (extra, tuple((t.data_ptr(), t._version) for t in tensors))
    cache = holder.__dict__.setdefault(attr, {})
    hit = cache.get(slot)
    if hit is None or hit[0] != key:
        cache[slot] = hit = (key, pack())
        tracing.count("pack.misses")
    return hit[1]


class PinnedPacks(torch.nn.Module):
    """Packed kernel operands held as non-persistent buffers: a model
    exported with `torch.export` carries them in its artifact, so a replay
    packs nothing. `PinnedPacks({name: operands})` takes each kernel's
    operands as its `packed_*` function returns them (a tuple, a dict or a
    list of dicts, None where a block has no such operand); `get(name)`
    gives them back in that structure. A snapshot: packs pinned before a
    weight changes do not follow it."""

    def __init__(self, packs: dict):
        super().__init__()
        self._specs = {}
        for name, value in packs.items():
            leaves, spec = tree_flatten(value)
            slots = []
            for i, leaf in enumerate(leaves):
                if leaf is None:
                    slots.append(None)
                else:
                    self.register_buffer(f"{name}_{i}", leaf, persistent=False)
                    slots.append(f"{name}_{i}")
            self._specs[name] = (slots, spec)

    def get(self, name: str):
        """The operands pinned under `name`, or None where none are."""
        if name not in self._specs:
            return None
        slots, spec = self._specs[name]
        return tree_unflatten([None if s is None else getattr(self, s) for s in slots], spec)
