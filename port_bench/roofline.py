"""An `rlod::` op's share of its roofline over the profiled calls."""

from __future__ import annotations

import json

from port_bench.counts import OP_WORK, PEAK_BYTES


def _feat_shape(args: dict, forward_dims: list, i: int):
    """The feature map's shape of a backward call: its concrete `feat_shape`
    argument where the trace records it, else the matching forward call's."""
    concrete = args.get("Concrete Inputs") or []
    if len(concrete) > 2 and concrete[2]:
        return json.loads(concrete[2])
    return forward_dims[min(i, len(forward_dims) - 1)][0]


def share(trace, op: str) -> float | None:
    """100 · Σ max(bytes / peak bytes, ops / peak ops) / Σ device seconds of
    the profiled calls of `op`. Raises when a call launched no device work:
    the attribution has failed, and a share of 0 would be a lie."""
    if trace is None:
        return None
    calls = trace.op_device_s(op)
    if not calls:
        raise RuntimeError(f"{op}: no call in the profiled window")
    forward = [a.get("Input Dims") for _, a in trace.op_device_s("rlod::roi_align_avg")]
    bound = device = 0.0
    for i, (secs, args) in enumerate(calls):
        if secs <= 0:
            raise RuntimeError(f"{op}: call {i} has no device time under it in the trace")
        dims, types = args.get("Input Dims"), args.get("Input type")
        if op == "rlod::roi_align_avg_bwd":
            ops, nbytes, peak = OP_WORK[op](dims, types, _feat_shape(args, forward, i))
        else:
            ops, nbytes, peak = OP_WORK[op](dims, types)
        bound += max(nbytes / PEAK_BYTES, ops / peak)
        device += secs
    return 100.0 * bound / device
