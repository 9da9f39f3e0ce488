"""The VGG block-1 and RoIAlignAvg kernels of a checkout of the port, timed
alone on an H100 at the main path's shapes.

    python tools/probe_vgg_roi.py [ROOT]

Imports `rlobjectdetection_tpu_torch` from ROOT (default: this checkout),
so one call can time two trees in turns (parent, change, change, parent).
Builds the two kernels there, then times with CUDA events (median of 50,
the 50 MB L2 flushed before each), bf16, seeded random inputs. A kernel's
time (`ms`) is that of a CUDA graph holding its one launch, so no host work
is in it: a wrapper's Python costs 10-40 µs, as much as RoIAlignAvg itself.
Its wrapper, called as the model calls it, is timed beside (`wrapper_ms`),
and RoIAlignAvg also warm (`warm_ms`: ten launches back to back in one
graph, no flush, the features in L2), which says whether device memory or
the gather from L2 holds it.

  * `vgg_block1` on `[1, 800, 1216, 3]` f32: the kernel on operands packed
    once (a tree without `launch_vgg_block1` is driven through its C entry
    on its own packing, `pack_w2`, made once), the wrapper on a cache hit,
    and cuDNN's conv + bias → ReLU → conv + bias → ReLU → 2×2 max-pool;
  * RoIAlignAvg at C=1024 R=300 (the flagship's head), C=512 R=300
    (VGG-16's) and C=1024 R=64 (the RL refine), on `[1, 50, 76, C]` with
    rois drawn over an 800×1216 image (4-400 pixels a side, a few off the
    map);

each with its bound (the larger of bytes over 3.35 TB/s and operations over
the bf16 tensor-core or f32 peak) and its max |diff| / max |plain| against
the plain version. Prints the card's name and power limit, then one JSON
line. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import BF16_TENSOR_FLOPS, F32_FLOPS, bound, graph_ms, time_ms  # noqa: E402

REPS = 50


def bound_ms(nbytes: float, flops: float, peak: float) -> float:
    return bound(nbytes, flops, peak)[0]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def vgg_block1(vk, flush) -> dict:
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    x = t(rng.randn(1, 800, 1216, 3) * 50)
    w = (t(rng.randn(64, 3, 3, 3) * 0.1), t(rng.randn(64) * 0.1),
         t(rng.randn(64, 64, 3, 3) * 0.03), t(rng.randn(64) * 0.1))
    if hasattr(vk, "launch_vgg_block1"):
        packed = vk.packed_vgg_block1(*w, bf16, dev)
        kernel = lambda: vk.launch_vgg_block1(x, packed, bf16)
    else:   # a tree whose wrapper packs on every call: its own packing, made once
        w1k = w[0].to(bf16).float().permute(2, 3, 1, 0).reshape(27, 64).contiguous()
        w2k, b1k, b2k = vk.pack_w2(w[2], bf16), w[1].contiguous(), w[3].contiguous()
        entry = vk._entry()

        def kernel():
            out = torch.empty((1, 400, 608, 64), dtype=bf16, device=dev)
            err = entry(x.data_ptr(), 0, w1k.data_ptr(), b1k.data_ptr(), w2k.data_ptr(),
                        b2k.data_ptr(), out.data_ptr(), 1, 1, 800, 1216,
                        torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return out
    with torch.no_grad():
        out = kernel()
        err = rel_err(out, vk.vgg_block1_plain(x, *w, dtype=bf16))
        wb = [v.to(bf16) for v in w]
        xn = x.to(bf16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        cudnn = lambda: F.max_pool2d(torch.relu(F.conv2d(torch.relu(F.conv2d(
            xn, wb[0], wb[1], padding=1)), wb[2], wb[3], padding=1)), 2, 2)
        res = dict(ms=graph_ms(kernel, flush, REPS),
                   wrapper_ms=time_ms(lambda: vk.fused_vgg_block1(x, *w, dtype=bf16), flush,
                                      REPS),
                   library_ms=time_ms(cudnn, flush, REPS))
    nbytes = x.numel() * 4 + sum(v.numel() * 4 for v in w) + out.numel() * 2
    return dict(res, bound_ms=bound_ms(nbytes, 2.0 * 800 * 1216 * 64 * (27 + 576),
                                       BF16_TENSOR_FLOPS), max_rel=err)


def rois(rng, n: int) -> np.ndarray:
    r = np.zeros((n, 5), np.float32)
    r[:, 1] = rng.rand(n) * 1216
    r[:, 2] = rng.rand(n) * 800
    r[:, 3:5] = r[:, 1:3] + 4 + rng.rand(n, 2) * 396
    r[:4, 1:] = [[-60, -40, 150, 100], [1100, 700, 1500, 1000], [1250, 820, 1400, 900],
                 [0, 0, 1215, 799]]
    return r


def roi_align(rk, ra, c: int, n: int, flush) -> dict:
    dev = torch.device("cuda")
    rng = np.random.RandomState(c + n)
    feats = torch.from_numpy(rng.randn(1, 50, 76, c).astype(np.float32)).to(dev, torch.bfloat16)
    r = torch.from_numpy(rois(rng, n)).to(dev)
    with torch.no_grad():
        out = rk.roi_align_avg(feats, r)
        err = rel_err(out, ra.roi_align_avg(feats.float(), r).to(torch.bfloat16))
        run = lambda: rk.roi_align_avg(feats, r)
        ms = graph_ms(run, flush, REPS)
        warm_ms = graph_ms(run, flush, REPS, launches=10)
        wrapper_ms = time_ms(run, flush, REPS)
    inside = ra.roi_align_coords(r, 50, 76, 8, 8, 1.0 / 16.0)[-1]
    flops = c * (7.0 * int(inside.sum()) + 4.0 * n * 49)
    nbytes = feats.numel() * 2 + r.numel() * 4 + out.numel() * 2
    return dict(ms=ms, warm_ms=warm_ms, wrapper_ms=wrapper_ms,
                bound_ms=bound_ms(nbytes, flops, F32_FLOPS),
                max_rel=err)


def main() -> None:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent)
    sys.path.insert(0, str(root.resolve()))   # ahead of this checkout
    if not torch.cuda.is_available():
        sys.exit("probe_vgg_roi: needs a CUDA device")
    from rlobjectdetection_tpu_torch.ops import _build, roi_align as ra
    from rlobjectdetection_tpu_torch.ops import roi_align_kernel as rk, vgg_block1_kernel as vk

    _build.build(("vgg_block1", "roi_align"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    res = {"tree": str(root), "vgg_block1": vgg_block1(vk, flush)}
    for c, n in ((1024, 300), (512, 300), (1024, 64)):
        res[f"roi_align_avg C={c} R={n}"] = roi_align(rk, ra, c, n, flush)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
