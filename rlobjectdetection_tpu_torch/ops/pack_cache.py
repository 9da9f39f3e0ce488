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


def cached_pack(holder, attr: str, slot, extra, tensors: Iterable[torch.Tensor],
                pack: Callable):
    """`pack()`, cached in `holder.__dict__[attr][slot]` as (key, value);
    the key is `extra` and each tensor's (data_ptr, version)."""
    key = (extra, tuple((t.data_ptr(), t._version) for t in tensors))
    cache = holder.__dict__.setdefault(attr, {})
    hit = cache.get(slot)
    if hit is None or hit[0] != key:
        cache[slot] = hit = (key, pack())
        cached_pack.packs += 1
    return hit[1]


cached_pack.packs = 0   # cache misses, for the tests
