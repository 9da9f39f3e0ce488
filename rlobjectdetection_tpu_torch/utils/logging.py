"""Logging, meters, the metrics writer and the profiler hooks (counterpart
of `rlobjectdetection_tpu/utils/logging.py`).

`init_log` emits on rank 0 only (`SLURM_PROCID`, else the
`torch.distributed` rank where a process group is up, else 0), with an
`rk{rank}` prefix; `AveMeter` is a sliding-window mean; `MetricsWriter`
writes scalars through tensorboardX where it is installed and does nothing
where it is not; `start_profiler_trace` / `stop_profiler_trace` wrap
`torch.profiler` (CPU and, where there is a card, CUDA activities) and
write a Chrome trace under the log dir (the handle start returns is what
stop takes, where JAX's pair keeps it in the runtime).
"""

from __future__ import annotations

import logging
import os
from collections import deque

import numpy as np


def _process_rank() -> int:
    if "SLURM_PROCID" in os.environ:
        return int(os.environ["SLURM_PROCID"])
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def init_log(name: str, level=logging.INFO) -> logging.Logger:
    """A logger that emits on rank 0 only; calling it again adds no second
    handler or filter."""
    rank = _process_rank()
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(f"rk{rank} %(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
    if not logger.filters:
        logger.addFilter(lambda record: _process_rank() == 0)
    return logger


class AveMeter:
    """Mean of the last `window` values."""

    def __init__(self, window: int = 20):
        self.window = window
        self.reset()

    def reset(self):
        self.vals = deque(maxlen=self.window)
        self.val = 0.0

    def update(self, val):
        self.val = float(val)
        self.vals.append(self.val)

    @property
    def avg(self):
        return sum(self.vals) / max(len(self.vals), 1)


def accuracy(output, target, topk=(1,)):
    """Top-k accuracy in percent of numpy scores `[N, C]` against labels `[N]`."""
    pred = np.argsort(-output, axis=1)[:, :max(topk)]
    correct = pred == target[:, None]
    return [correct[:, :k].any(axis=1).mean() * 100.0 for k in topk]


def ensure_file(path: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"file not found: {path}")


def ensure_dir(path: str):
    os.makedirs(path, exist_ok=True)


class MetricsWriter:
    """Scalar summaries through tensorboardX; a no-op where tensorboardX is
    not installed."""

    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        ensure_dir(log_dir)
        self._writer = SummaryWriter(log_dir)

    def scalar_summary(self, tag: str, value, step: int):
        if self._writer:
            self._writer.add_scalar(tag, float(value), step)

    def close(self):
        if self._writer:
            self._writer.close()


def start_profiler_trace(log_dir: str):
    """Start a `torch.profiler` trace of CPU and CUDA activity (CPU only
    where there is no card); returns the handle `stop_profiler_trace`
    takes. The port's spans (`utils/tracing.py`) show in it as
    `user_annotation` events beside the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof, log_dir


def stop_profiler_trace(trace) -> str:
    """Stop the trace and write it as `<log_dir>/trace.json` (Chrome trace
    format); returns that path."""
    prof, log_dir = trace
    prof.stop()
    ensure_dir(log_dir)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path
