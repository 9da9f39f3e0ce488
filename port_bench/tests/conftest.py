"""Helpers of the harness's CPU tests: the benchmark's configuration and
traffic cut to a tiny size, and a driver run on the CPU."""

from __future__ import annotations

import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_SIZES = [[64, 48], [48, 64], [64, 43], [43, 64], [50, 38], [38, 50], [61, 61], [64, 51]]


def tiny(traffic: str, dtype: str = "bfloat16"):
    """(config, traffic) of res101_coco (or rl_res101_coco) at 96 px with
    small proposal and detection counts."""
    with open(os.path.join(ROOT, "port_bench", "traffic", traffic + ".json")) as f:
        tr = json.load(f)
    rl = tr["driver"] == "rl_train_loop"
    with open(os.path.join(ROOT, "port_bench", "configs",
                           ("rl_res101_coco" if rl else "res101_coco") + ".json")) as f:
        c = json.load(f)
    if rl:
        c.update(img_short=[96], img_size=160, max_stat_dets=300)
        tr["split"].update(images=8, sizes=TINY_SIZES)
        tr["detections"]["per_image"] = 20
        tr["warm_epochs"] = 1
        return c, tr
    c["dtype"] = dtype
    c["train"].update(scales=[96], rpn_pre_nms_top_n=600, rpn_post_nms_top_n=100,
                      rois_per_image=32)
    c["test"].update(scales=[96], rpn_pre_nms_top_n=300, rpn_post_nms_top_n=50,
                     max_per_image=20)
    if "split" in tr:
        tr["split"].update(images=8, sizes=TINY_SIZES)
        tr["warm_epochs"] = 1
    else:
        tr["pool"].update(images=8, sizes=TINY_SIZES)
        tr["check_requests"] = 2
    return c, tr


def drive(traffic: str, tmp_path, seed: int = 2 ** 31 + 11, dtype: str = "bfloat16",
          seconds: float = 1.0, limits: dict | None = None) -> dict:
    """One run of the traffic's driver on the CPU at the tiny size."""
    import torch

    from port_bench import harness
    from port_bench.drivers import rl_train_loop, serve_loop, train_loop

    torch.set_num_threads(2)
    c, tr = tiny(traffic, dtype)
    if limits is not None:
        c["limits"] = limits
    r = harness.Run(workload=traffic, seed=seed, seconds=seconds, trace=False, config=c,
                    traffic=tr, t0=time.perf_counter(), device="cpu", workdir=str(tmp_path))
    drivers = {"serve_loop": serve_loop, "train_loop": train_loop,
               "rl_train_loop": rl_train_loop}
    return drivers[tr["driver"]].run(r)


@pytest.fixture
def cuda():
    """Skips the test where no CUDA device is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
