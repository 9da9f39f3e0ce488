"""The measured window of a training loop driven by `train_epochs`: a
wrapper around the step function and the loop's `on_step` callback.

The first `record` steps are set-up: `before(i, batch)` and `after(i,
batch, out)` see each of them (the cell's loop module keeps what its check needs).
After the last of them the window opens, synchronised. It closes at the
first step's end after `seconds`, synchronised, by raising
`WindowClosed` out of the loop. With `trace`, a profiler covers
`profile_steps` steps from 40% into the window; those steps and their
time are kept apart. The host time between two step calls (the loop
taking its next batch from `device_prefetch`, and its own work) is summed
outside the profiled steps. With `busy` (and no `trace`), the card's
activity is recorded over the whole window (`DeviceBusy`)."""

from __future__ import annotations

import time

import torch

from .harness import WindowClosed
from .trace import DeviceBusy, Profiled


class StepWindow:
    def __init__(self, r, record: int, batch: int, profile_steps: int, sync,
                 shape_of=lambda batch: tuple(batch["data"].shape), busy: bool = False):
        self.r, self.record, self.batch, self.shape_of = r, record, batch, shape_of
        self.profile_steps, self.sync = profile_steps, sync
        self.busy = DeviceBusy(sync) if busy and not r.trace else None
        self.n = 0
        self.t_start = self.exit = self.prof = self.trace = self.prof_t = None
        self.images = self.prof_images = self.prof_count = 0
        self.wait = self.prof_span = 0.0
        self.losses, self.shapes, self.profiled = [], [], []

    def wrap(self, step, before=None, after=None):
        def step_fn(batch, generator, dropout):
            i = self.n
            enter = time.perf_counter()
            if self.t_start is not None and self.prof is None and self.exit is not None:
                self.wait += enter - self.exit
            if i < self.record and before is not None:
                before(i, batch)
            out = step(batch, generator, dropout)
            if i < self.record and after is not None:
                after(i, batch, out)
            if self.t_start is not None:
                if self.prof is not None:
                    self.profiled.append(len(self.losses))
                self.losses.append(out["loss"])
                self.shapes.append(self.shape_of(batch))
            self.n += 1
            self.exit = time.perf_counter()
            return out

        return step_fn

    def on_step(self, epoch, it, global_step, metrics):
        if self.n == self.record:
            if self.t_start is None:
                if self.busy is not None:
                    self.busy.__enter__()
                self.sync()
                self.t_start = self.exit = time.perf_counter()
            return
        if self.t_start is None:
            return
        self.images += self.batch
        el = time.perf_counter() - self.t_start
        if self.r.trace:
            if self.prof is None and self.trace is None and el >= 0.4 * self.r.seconds:
                self.prof = Profiled(self.sync, self.r.workdir)
                self.prof_t, self.prof_images = time.perf_counter(), -self.images
                self.prof.__enter__()
            elif self.prof is not None:
                self.prof_count += 1
                if self.prof_count == self.profile_steps:
                    self.prof.__exit__(None, None, None)
                    self.prof_span = time.perf_counter() - self.prof_t
                    self.prof_images += self.images
                    self.trace, self.prof = self.prof.trace, None
                    self.exit = time.perf_counter()
        if el >= self.r.seconds and self.prof is None:
            raise WindowClosed

    def close(self) -> dict:
        """Synchronises and returns the window's span: its edges and length,
        steps, images, non-finite losses, host wait, each step's `shape_of(batch)`,
        the profiled steps and their trace, and the card's busy seconds over
        the window (None without `busy`)."""
        self.sync()
        t_end = time.perf_counter()
        if self.busy is not None:
            self.busy.__exit__(None, None, None)
        losses = torch.stack(self.losses).float().cpu()
        return {"t_start": self.t_start, "t_end": t_end, "window": t_end - self.t_start,
                "steps": len(self.losses), "images": self.images,
                "failed": int((~torch.isfinite(losses)).sum()), "wait": self.wait,
                "shapes": self.shapes, "profiled": self.profiled,
                "prof_t": self.prof_t, "prof_span": self.prof_span,
                "prof_images": self.prof_images,
                "trace": self.trace, "busy_s": None if self.busy is None else self.busy.busy_s}
