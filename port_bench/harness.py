"""What every driver shares: the run's context, the device's description,
the sample statistics, and the judgement of compared numbers against their
limits."""

from __future__ import annotations

import math
import os
import statistics
import sys
import time
from dataclasses import dataclass

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class WindowClosed(Exception):
    """Raised from a loop's callback to end the measured window."""


@dataclass
class Run:
    """One run of one cell: its arguments, configuration and traffic, and
    where it may write."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    t0: float                                  # process start, on perf_counter
    device: str = "cuda"
    workdir: str = ""
    control: int = 0               # 1: the reference a precision lower, 2: on half a batch

    def log(self, msg: str) -> None:
        print(f"[port_bench {time.perf_counter() - self.t0:8.2f}s] {msg}", file=sys.stderr,
              flush=True)


def sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def device_info(device: str, peak_bytes: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak_bytes)}


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of all values, linear between ranks."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def seed_ints(seed: int, key: int, n: int = 1):
    """n 63-bit integers derived from (seed, key)."""
    return [int(x) >> 1 for x in
            np.random.SeedSequence((int(seed), int(key))).generate_state(n, np.uint64)]


def norm_gap(got: dict, want: dict, names, floor_share: float = 1e-3):
    """Each leaf's gap between two norms, |‖got‖ − ‖want‖|, over the larger
    of ‖want‖ and the median leaf's ‖want‖; leaves whose ‖want‖ is under
    `floor_share` of the median are left out (their values are rounding).
    Returns (the worst leaf's gap, that leaf, the median leaf's gap, leaves
    compared, leaves left out)."""
    wn = {n: float(want[n].double().norm()) for n in names}
    med = statistics.median(wn.values())
    gaps = {n: abs(float(got[n].double().norm()) - wn[n]) / max(wn[n], med)
            for n in names if wn[n] >= floor_share * med}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf, statistics.median(gaps.values()), len(gaps), len(names) - len(gaps)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number against its limit (a reading above it, or not a
    number, fails): (all within, {name: {value, limit}})."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        within = value is not None and math.isfinite(value) and value <= limit
        ok &= within
        out[name] = {"value": value, "limit": limit}
    return ok, out
