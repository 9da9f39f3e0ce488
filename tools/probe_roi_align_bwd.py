"""The RoIAlignAvg backward kernel of a checkout of the port, timed alone on
an H100 at the detector train step's roi sets.

    python tools/probe_roi_align_bwd.py --make-rois FILE
    python tools/probe_roi_align_bwd.py [ROOT] --rois FILE

`--make-rois` runs this checkout's flagship train path as `chip_smoke.py`
does (ResNet-101 C4 with the smoke's seeded weights and frozen-BN
statistics, `bench.py`'s synthetic batch at 2 images, SGD at 0.01, bf16)
and saves two roi sets of 256 to FILE (npz):

  * (a) `first`: the rois the train forward samples from the first step's
    parameters. The random net's proposals overlap no gt box, so each image
    draws its 128 rois from its 8 gt boxes: about 16 copies of each;
  * (b) `steady`: the rois it samples after three train steps (16 fg +
    240 bg over the two images).

The timing mode imports `rlobjectdetection_tpu_torch` from ROOT (default:
this checkout), so one call can time two trees in turns (parent, change,
change, parent) on the same roi sets; it builds ROOT's roi_align kernels
and times `roi_align_avg_bwd` at (a) and (b) on [2, 50, 76, 1024] and at
(c) `bench.py`'s train batch, R = 1024 (128 an image) on [8, 50, 76, 1024]
with rois drawn as `tests/test_torch_gpu.py::_rois` draws them. For each,
in bf16 and f32: the kernel as a CUDA graph of its launch (`ms`), the
wrapper as called (`wrapper_ms`) and the plain version (`plain_ms`), each
the median of 30 CUDA-event timings with the 50 MB L2 flushed before each;
the bound (d pooled and rois read once, d features written once, over
3.35 TB/s, against the operations over the f32 peak); max |diff| /
max |plain|; whether two launches gave the same bits; and the entries a
feature row takes (mean and most), which set the kernel's batches. Prints
the card's name and power limit, then one JSON line. Needs a CUDA device
and nvcc.

    python tools/probe_roi_align_bwd.py --phases --rois FILE

builds this checkout's `csrc/roi_align.cu` as it is and with parts of the
backward taken out (`no_accumulate`: no entry is accumulated, the sums stay
0; `no_samples`: no sample gradient is computed, the accumulation reads
whatever shared memory holds; `walk_and_write`: both out, only the roi walk,
the entry lists and the stores of zeros), and times each bf16 launch alone
(CUDA graph, median of 30, L2 flushed) at (a), (b) and (c). Only `full`
computes the gradient; the others are timings.

    python tools/probe_roi_align_bwd.py --timeline --rois FILE

builds the kernel with each CTA's start and end (`%globaltimer`, before its
stores), its entry count and each warp's time in the accumulation written
to a device array, launches it once (bf16, L2 flushed) at (a), (b) and
(c), and prints the kernel's span, the CTAs' mean and longest time, their
busy share of the span (the sum of CTA times over span x SMs), the longest
CTAs with their entries, and the busiest warp's accumulation time over the
mean warp's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import F32_FLOPS, bound, graph_ms, nbytes, time_ms  # noqa: E402

REPS = 30


def make_rois(path: str) -> None:
    """Roi sets (a) and (b) of this checkout's train path, saved to path."""
    from chip_smoke import NUM_CLASSES, randomize_frozen_bn, train_batch
    from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step
    from rlobjectdetection_tpu_torch.engine.serve import build_config
    from rlobjectdetection_tpu_torch.models import FasterRCNN

    dev = torch.device("cuda")
    cfg = build_config("coco", ["DTYPE", "bfloat16"])
    model = FasterRCNN(NUM_CLASSES, "resnet101", cfg, device=dev, seed=3)
    randomize_frozen_bn(model, seed=3)
    batch = train_batch(dev)

    def sampled_rois():
        with torch.no_grad():
            out = model(batch["data"], batch["im_info"], batch["gt_boxes"], train=True,
                        generator=torch.Generator(device=dev).manual_seed(7))
        return out["rois"].reshape(-1, 5).cpu().numpy()

    first = sampled_rois()
    opt, sched, _ = build_optimizer(model, "resnet101", base_lr=0.01)
    step = make_train_step(model, opt, sched)
    gen = torch.Generator(device=dev).manual_seed(7)
    for _ in range(3):
        float(step(batch, gen)["loss"])
    steady = sampled_rois()
    np.savez(path, first=first, steady=steady)
    print(json.dumps({"rois": path, **{k: {"shape": v.shape, "distinct": len(np.unique(v, axis=0))}
                                       for k, v in (("first", first), ("steady", steady))}}))


def bench_rois(rng, n: int, n_images: int, h: int = 800, w: int = 1216) -> np.ndarray:
    """As `tests/test_torch_gpu.py::_rois`: n rois over n_images images of
    h x w pixels, a few partly or wholly off the map."""
    rois = np.zeros((n, 5), np.float32)
    rois[:, 0] = rng.randint(0, n_images, n)
    rois[:, 1] = rng.rand(n) * w
    rois[:, 2] = rng.rand(n) * h
    rois[:, 3:5] = rois[:, 1:3] + rng.rand(n, 2) * 400 + 8
    rois[:3, 1:] = [[-120, -60, 200, 140], [w - 100, h - 50, w + 300, h + 200],
                    [w + 40, h + 40, w + 500, h + 300]]
    return rois


def row_entries(ra, rois: torch.Tensor, feat_shape) -> dict:
    """Mean and most entries a feature row takes: inside sample rows whose
    corner rows idx_y or idx_y + 1 are the row."""
    n_images, h, w, _ = feat_shape
    b, hs, _, _, _, inside = ra.roi_align_coords(rois, h, w, 8, 8, 1.0 / 16.0)
    row_in = inside.any(-1)                                     # [R, 8] sample row inside
    base = (b.long().clamp(0, n_images - 1) * h)[:, None] + hs.long()
    rows = torch.cat([base[row_in], base[row_in] + 1])
    counts = torch.bincount(rows, minlength=n_images * h).float()
    return {"mean": float(counts.mean()), "max": int(counts.max())}


def probe(rk, ra, rois: torch.Tensor, feat_shape, dtype, flush) -> dict:
    dev = rois.device
    g = torch.Generator(device=dev).manual_seed(5)
    grad = torch.randn((rois.shape[0], 7, 7, feat_shape[3]), generator=g, device=dev).to(dtype)
    run = lambda: rk.roi_align_avg_bwd(grad, rois, feat_shape)
    got, again = run(), run()
    want = ra.roi_align_avg_backward(grad, rois, feat_shape, dtype)
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    _, fh, fw, c = feat_shape
    inside = ra.roi_align_coords(rois, fh, fw, 8, 8, 1.0 / 16.0)[-1]
    flops = c * (8.0 * int(inside.sum()) + 4.0 * rois.shape[0] * 49)
    return dict(ms=graph_ms(run, flush, REPS), wrapper_ms=time_ms(run, flush, REPS),
                plain_ms=time_ms(lambda: ra.roi_align_avg_backward(grad, rois, feat_shape, dtype),
                                 flush, REPS),
                bound_ms=bound(nbytes(grad, rois, got), flops, F32_FLOPS)[0], max_rel=err,
                repeat_equal=bool(torch.equal(got, again)))


VARIANTS = {
    "full": (),
    "no_accumulate": (("      while (reach) {", "      while (false) {"),),
    "no_samples": (("      if (warp < n_batch && c < C) {", "      if (false) {"),),
}
VARIANTS["walk_and_write"] = VARIANTS["no_accumulate"] + VARIANTS["no_samples"]


TIMELINE = (
    ("template <typename T, bool VEC_OK>\n__global__ void __launch_bounds__(BWD_THREADS, 1)",
     "__device__ unsigned long long rlod_cta[8 * 65536];\n"
     "__device__ __forceinline__ long long rlod_now() {\n  unsigned long long v;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v) :: \"memory\");\n"
     "  return static_cast<long long>(v);\n}\n"
     "template <typename T, bool VEC_OK>\n__global__ void __launch_bounds__(BWD_THREADS, 1)"),
    ("  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n  const int b",
     "  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n"
     "  const long long t0 = rlod_now();\n"
     "  int seen = 0;\n  long long own = 0;\n  const int b"),
    ("      unsigned reach = (any | any >> 16) & 0xffffu;\n      __syncthreads();\n",
     "      unsigned reach = (any | any >> 16) & 0xffffu;\n      __syncthreads();\n"
     "      const long long q1 = rlod_now();\n"),
    ("      __syncthreads();\n    }\n  };",
     "      own += rlod_now() - q1;\n      __syncthreads();\n    }\n  };"),
    ("    n_entries += total & 0xffff;\n",
     "    n_entries += total & 0xffff;\n    seen += total & 0xffff;\n"),
    ("  // 4. write the warp's columns once, in the feature type\n",
     "  {\n    const size_t i = blockIdx.x + static_cast<size_t>(gridDim.x)\n"
     "        * (blockIdx.y + gridDim.y * blockIdx.z);\n"
     "    unsigned long long* o = rlod_cta + 8 * (i % 65536);\n"
     "    if (lane == 0) {\n      atomicMax(o + 6, static_cast<unsigned long long>(own));\n"
     "      atomicAdd(o + 7, static_cast<unsigned long long>(own));\n    }\n"
     "    if (t == 0) {\n      unsigned sm;\n"
     "      asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "      o[0] = t0; o[1] = rlod_now(); o[2] = sm; o[3] = seen;\n"
     "    }\n  }\n"
     "  // 4. write the warp's columns once, in the feature type\n"),
)


def build_variant(name: str, pairs, out_dir: Path, extra: str = ""):
    """This checkout's roi_align.cu with `pairs` replaced, built by nvcc
    into out_dir: (process, library path)."""
    from rlobjectdetection_tpu_torch.ops import _build

    text = (_build.CSRC / "roi_align.cu").read_text()
    for old, new in pairs:
        if old not in text:
            raise ValueError(f"{name}: roi_align.cu no longer holds {old!r}")
        text = text.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"roi_align_{name}.cu", out_dir / f"libroi_align_{name}.so"
    cu.write_text(text + extra)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                             str(so), str(cu)]), so


def bwd_entry(so: Path):
    fn = ctypes.CDLL(str(so)).rlod_roi_align_avg_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def timeline(sets: dict, flush, out_dir: Path) -> dict:
    """Per-CTA start, end and entries of one bf16 launch at each roi set,
    and how long its busiest warp accumulated against its mean warp."""
    from rlobjectdetection_tpu_torch.ops import _build

    read = ('\nextern "C" int rlod_cta_read(void* out) {\n'
            '  return static_cast<int>(cudaMemcpyFromSymbol(out, rlod_cta, sizeof(rlod_cta)));\n}\n'
            'extern "C" int rlod_cta_zero() {\n  void* p;\n'
            '  cudaError_t e = cudaGetSymbolAddress(&p, rlod_cta);\n'
            '  if (e != cudaSuccess) return static_cast<int>(e);\n'
            '  return static_cast<int>(cudaMemset(p, 0, sizeof(rlod_cta)));\n}\n')
    proc, so = build_variant("timeline", TIMELINE, out_dir, read)
    if proc.wait() != 0:
        raise RuntimeError("nvcc failed for the timeline build")
    fn, lib = bwd_entry(so), ctypes.CDLL(str(so))
    dev, res = torch.device("cuda"), {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (rois, shape) in sets.items():
        r = torch.from_numpy(np.ascontiguousarray(rois, np.float32)).to(dev)
        g = torch.Generator(device=dev).manual_seed(5)
        grad = torch.randn((r.shape[0], 7, 7, shape[3]), generator=g, device=dev).to(torch.bfloat16)
        out = torch.empty(shape, dtype=torch.bfloat16, device=dev)
        for _ in range(2):   # the second launch is the one read
            _build.check(lib.rlod_cta_zero(), "timeline reset")
            flush.zero_()
            _build.check(fn(grad.data_ptr(), r.data_ptr(), out.data_ptr(), r.shape[0], *shape,
                            1.0 / 16.0, 1, torch.cuda.current_stream().cuda_stream),
                         "timeline launch")
            torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (8 * 65536))()
        _build.check(lib.rlod_cta_read(buf), "timeline read")
        n = shape[0] * shape[1] * -(-shape[3] // 256) * -(-shape[2] // 80)
        a = np.frombuffer(buf, dtype=np.uint64).reshape(-1, 8)[:n].astype(np.float64)
        t0, t1, entries = a[:, 0] - a[:, 0].min(), a[:, 1] - a[:, 0].min(), a[:, 3]
        dur, span = (t1 - t0) / 1e3, (t1.max() - t0.min()) / 1e3       # µs
        top = np.argsort(-dur)[:5]
        res[label] = {"ctas": n, "span_us": span, "cta_mean_us": dur.mean(),
                      "cta_max_us": dur.max(), "busy_share": dur.sum() / (span * sms),
                      "longest": [[float(dur[i]), int(entries[i]), float(t0[i] / 1e3)]
                                  for i in top],
                      "accumulate_busiest_over_mean_warp": float(a[:, 6].sum()
                                                                 / (a[:, 7].sum() / 16)),
                      "last_start_us": float(t0.max() / 1e3)}
    return res


def phases(sets: dict, flush, out_dir: Path) -> dict:
    """Each variant of the backward built and timed at each roi set (bf16)."""
    from rlobjectdetection_tpu_torch.ops import _build

    jobs = {name: build_variant(name, pairs, out_dir) for name, pairs in VARIANTS.items()}
    dev, res = torch.device("cuda"), {}
    for name, (proc, so) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}")
        fn = bwd_entry(so)
        for label, (rois, shape) in sets.items():
            r = torch.from_numpy(np.ascontiguousarray(rois, np.float32)).to(dev)
            g = torch.Generator(device=dev).manual_seed(5)
            grad = torch.randn((r.shape[0], 7, 7, shape[3]), generator=g,
                               device=dev).to(torch.bfloat16)
            out = torch.empty(shape, dtype=torch.bfloat16, device=dev)

            def run():
                _build.check(fn(grad.data_ptr(), r.data_ptr(), out.data_ptr(), r.shape[0], *shape,
                                1.0 / 16.0, 1, torch.cuda.current_stream().cuda_stream), name)
            res[f"{name} {label}"] = graph_ms(run, flush, REPS)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--rois", help="npz of roi sets (a) and (b) from --make-rois")
    ap.add_argument("--make-rois", help="write roi sets (a) and (b) to this npz and stop")
    ap.add_argument("--phases", action="store_true",
                    help="time this checkout's kernel with parts taken out")
    ap.add_argument("--timeline", action="store_true",
                    help="each CTA's start, end and entries in one launch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_roi_align_bwd: needs a CUDA device")
    if args.make_rois:
        make_rois(args.make_rois)
        return
    if not args.rois:
        sys.exit("probe_roi_align_bwd: --rois FILE (from --make-rois) is required")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))   # ahead of this checkout
    from rlobjectdetection_tpu_torch.ops import _build, roi_align as ra
    from rlobjectdetection_tpu_torch.ops import roi_align_kernel as rk

    _build.build(("roi_align",))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    saved = np.load(args.rois)
    sets = {"a first-step R=256": (saved["first"], (2, 50, 76, 1024)),
            "b steady R=256": (saved["steady"], (2, 50, 76, 1024)),
            "c bench R=1024": (bench_rois(np.random.RandomState(0), 1024, 8), (8, 50, 76, 1024))}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    if args.phases or args.timeline:
        run = phases if args.phases else timeline
        print(json.dumps(run(sets, flush, root / "chiprun_out" / "probe_build")), flush=True)
        return
    res = {"tree": str(root), "kernel_file": str(Path(rk.__file__).resolve())}
    for label, (rois, shape) in sets.items():
        r = torch.from_numpy(np.ascontiguousarray(rois, np.float32)).to(dev)
        res[f"{label} entries a row"] = row_entries(ra, r, shape)
        for dtype in (torch.bfloat16, torch.float32):
            res[f"{label} {str(dtype)[6:]}"] = probe(rk, ra, r, shape, dtype, flush)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
