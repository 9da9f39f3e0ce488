"""Async input pipeline: batch assembly on worker threads, and the copy to
the card ahead of the consumer (the JAX package's `data/prefetch.py` in
PyTorch's idiom).

Image decode (Pillow) and the numpy resize release the GIL, so a thread
pool overlaps them without pickling the roidb into worker processes;
`RoiBatchLoader.batch_plan()` makes each batch an independent (indices,
ratio, seed) job, so completion order cannot change the data.

`device_prefetch` then keeps `depth` batches already on their way to the
card: each is copied from pinned memory with `non_blocking=True` on a side
stream, and the consumer's stream waits on that copy's event, so the copy
of batch i+1 rides under the compute of batch i.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from ..utils import tracing


class AsyncLoader:
    """Wraps a loader with `batch_plan()` / `assemble_job(job)`: assembles up
    to `num_workers` batches at once, keeps `prefetch` finished batches
    queued, yields in plan order."""

    def __init__(self, loader, num_workers: int = 4, prefetch: int = 2):
        # Clamp to schedulable cores: concurrent _assemble jobs on an
        # oversubscribed core thrash the cache and the allocator on the
        # batch blobs, and collapse throughput.
        try:
            cores = len(os.sched_getaffinity(0))
        except AttributeError:
            cores = os.cpu_count() or 1
        self.loader = loader
        self.num_workers = max(1, min(num_workers, cores))
        self.prefetch = max(1, prefetch)

    def __iter__(self) -> Iterator:
        plan = self.loader.batch_plan()
        if not plan:
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            inflight = collections.deque()
            it = iter(plan)

            def submit(job):
                return pool.submit(self.loader.assemble_job, job)

            for _ in range(self.num_workers + self.prefetch):
                job = next(it, None)
                if job is None:
                    break
                inflight.append(submit(job))
            while inflight:
                batch = inflight.popleft().result()
                job = next(it, None)
                if job is not None:
                    inflight.append(submit(job))
                yield batch


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`: on a CUDA device copied from
    pinned memory with `non_blocking=True` (on the current stream: call it
    inside `device_prefetch`'s `put_fn`); elsewhere the array itself."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def device_prefetch(batches, put_fn, device: str | torch.device, depth: int = 2):
    """Generator: `put_fn(batch)` applied `depth` batches ahead of the
    consumer, in order.

    On a CUDA device each `put_fn` runs on a side stream (its copies are
    `to_device`'s pinned, non-blocking ones); before a result is yielded,
    the consumer's current stream waits on the event recorded after its
    `put_fn`, and every CUDA tensor in it is marked as used by that stream
    (`record_stream`), so the caching allocator does not hand its memory to
    the side stream while the consumer still reads it. On any other device
    `put_fn` runs as it is. Each `put_fn`, with its pinning and the enqueue
    of its copies, runs in the span `data.h2d`."""
    dev = torch.device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(b):
        with tracing.span("data.h2d"):
            if side is None:
                return put_fn(b), None
            with torch.cuda.stream(side):
                out = put_fn(b)
                done = torch.cuda.Event()
                done.record(side)
            return out, done

    queue = collections.deque()
    it = iter(batches)
    try:
        for _ in range(depth):
            b = next(it, None)
            if b is None:
                break
            queue.append(put(b))
        while queue:
            nxt = next(it, None)
            if nxt is not None:
                queue.append(put(nxt))
            out, done = queue.popleft()
            if done is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(done)
                for t in _tensors(out):
                    if t.is_cuda:
                        t.record_stream(consumer)
            yield out
    finally:
        # a consumer that stops early stops the source too (an AsyncLoader
        # then joins its worker threads)
        close = getattr(it, "close", None)
        if close is not None:
            close()
