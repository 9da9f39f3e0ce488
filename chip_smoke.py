"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `rlobjectdetection_tpu_torch/csrc` with
nvcc (sm_90a), all five sources in parallel, and prints the stem's, layer1's, VGG
block 1's and the residual stage's launch resources (registers, shared
memory a CTA, CTAs an SM, spills; the stage's grid and cluster too) as the
runtime reports them. Then, for each of the two served
detectors (81 COCO classes, 800×1216, bf16 compute, seeded random weights)
behind `Detector`:

  * the flagship, ResNet-101 C4 with the fused stem and layer1 kernels;
  * VGG-16 with the fused block-1 kernel;

it serves three requests with every launch count set to 0 just before and
read just after, times the stages of one request, holds every kernel of
that path against its plain PyTorch version at the shapes the requests gave
it, in bf16 and in f32, times kernel, plain version and the library call
that computes the same function (the stem, layer1 and block-1 kernels on
pre-packed operands, their wrappers' cache-hit time beside), and holds the
whole backbone with the kernels against the plain modules. RoIAlignAvg runs
on both paths (1024 and 512 channels; the kernel timed as a CUDA graph of
its launch, its wrapper as called beside). The flagship's stages are timed
a second time with its layer2/layer3 on the residual-stage kernel
(`stages_fused = 23`, the detector's eval path; served with
`STAGE_FUSED=0`), and that base is held against the plain modules too.

Then the RL box-refinement net (ResNet-101 trunk warm-started from the
flagship, 56 actions, f32 params, bf16 compute, stem, layer1 and fused
layer2/layer3 kernels): three refine requests of one 800×1216 image and 64
boxes each through `Refiner`, then three `rl_train_step`s at batch 2 × 64
boxes, with the launch counts set to 0 before the requests and read after
the steps; the residual-stage kernel (on pre-packed operands, its
wrapper's cache-hit time beside) against its plain version and cuDNN at
layer2's and layer3's shapes, RoIAlignAvg at the refine's 64 rois, the
whole trunk and the action values with the kernels against the plain
modules.

Then the detector's train step (the flagship's weights, `bench.py`'s
synthetic batch at 2 images, SGD at 0.01, bf16 compute): three steps with
the launch counts of the stem, layer1 and both RoIAlignAvg kernels read over
them, one step's stages, the RoIAlignAvg backward kernel against its plain
version (R=256 at C=1024, and a small shape) timed as a CUDA graph of its
launch, and one whole step with the kernels against the same step with
their plain versions, in f32 and in bf16, from the first step's parameters.

Every phase raises on failure and the script exits non-zero: no CUDA, a
kernel that does not build or launch, a kernel that disagrees with its plain
version, a request that gives a wrong shape, non-finite values, no valid
detection, a train step whose loss is not finite, that moves the frozen
trunk or leaves the head unchanged, a whole train step whose losses or
updates leave their bounds, or a kernel the path did not launch. The
line before the last
is the card's name and power limit from nvidia-smi; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

NUM_CLASSES = 81
IMAGE_SIZES = ((480, 729), (600, 900), (427, 640))   # all serve as 800×1216 blobs
BLOB_SHAPE = (1, 800, 1216, 3)
# max |kernel - plain| / max |plain|. bf16: the bounds DESIGN.md recorded for
# the Pallas kernels against XLA at these shapes; f32: summation order only.
BF16_TOL = {"stem": 2.45e-3, "layer1": 1.28e-2, "roi_align_avg": 1e-2}
# RoIAlignAvg on VGG-16's 512-channel features against the plain version in
# bf16 arithmetic, which rounds its bilinear weights, their products and
# every sum to bf16: it measured 1.099e-2 (two bf16 steps at a largest output of 5.7) on an H100
# (700 W), so the bound is 2e-2. Against the plain version's f32 arithmetic,
# the kernel's own, it is held at one bf16 step.
BF16_TOL["roi_align_avg C=512"] = 2e-2
# The same check at the RL refine's 64 rois on the trunk's 1024-channel
# features measured 1.064e-2 on an H100 (700 W) against the bf16-arithmetic
# plain version, whose own roundings it is (the kernel was 2.65e-3 from the
# plain version's f32 arithmetic, under one bf16 step); so its bound is
# 2e-2, as at C=512.
BF16_TOL["roi_align_avg R=64"] = 2e-2
F32_TOL = 1e-4
# The whole C4 base, kernel stem + layer1 against the plain modules. In f32
# the two compute one function (summation order only). In bf16 they round at
# different points: the plain modules round each conv output and each BN
# mul and add to bf16 (as the JAX FrozenBatchNorm does), the kernels fold BN
# into the weights in f32 and round once per conv. Those differences compound
# through the 27 blocks of layer2-3; measured 2.33e-2 on an H100 (700 W), above
# the 1.96e-2 DESIGN.md recorded for the Pallas kernels against XLA, so the
# bound is 3e-2.
BASE_FEAT_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# Where kernel and plain version round the same f32 results to bf16 at the
# same points, the sums still run in other orders, so an output may round to
# the neighbouring bf16 value: one bf16 step of the largest output is at
# most 2^-7 of it. VGG-16 block 1 measured 4.785e-3 on an H100 (700 W), 1.0
# at a largest output of 209; the 4.24e-3 ROADMAP §2 item 4 records for the
# Pallas kernel against XLA is the same one-step event (1/236).
ONE_BF16_STEP = 2.0 ** -7
VGG_BLOCK1_TOL = {torch.bfloat16: ONE_BF16_STEP, torch.float32: F32_TOL}
# The whole VGG-16 base, kernel block 1 against the plain modules. Blocks
# 2-5 are the same cuDNN convs on both sides. The plain block 1 casts its
# biases to bf16 (as flax's nn.Conv does) where the kernel keeps them in f32,
# and its sums run in other orders, so some block-1 outputs differ by a bf16
# step; those differences carry through blocks 2-5: measured 9.90e-3 (mean
# 6.4e-4) on an H100 (700 W), so the bound is 2e-2.
VGG_BASE_FEAT_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# The fused layer2/layer3 kernel against its plain version in bf16: both
# round the same f32 sums at the same points, but the sums run in other
# orders, so an activation may round to the neighbouring bf16 value, and such
# steps compound through the rounded intermediates of 4 and 23 blocks:
# measured 6.849e-3 (layer2) and 1.914e-2 (layer3, 0.25 at a largest output
# of 13) on an H100 (700 W), so the bound is 3e-2.
RES_STAGE_TOL = {torch.bfloat16: 3e-2, torch.float32: F32_TOL}
# The RL net's whole trunk with every kernel (stem, layer1, layer2-3) against
# the plain modules, which round each conv output and each BN mul and add to
# bf16 where the kernels fold BN in f32 and round once per conv: measured
# 2.885e-2 (mean 1.8e-3) on an H100 (700 W), above the flagship's 2.333e-2
# with the stem and layer1 kernels alone, so the bound is 4e-2. The action
# values that trunk gives (the same RoIAlignAvg kernel, layer4 and fc on both
# sides) measured 8.671e-3, so their bound is 2e-2.
RL_BASE_FEAT_TOL = {torch.bfloat16: 4e-2, torch.float32: F32_TOL}
RL_PRED_TOL = {torch.bfloat16: 2e-2, torch.float32: F32_TOL}
RL_BOXES, RL_TRAIN_BATCH = 64, 2
# The detector's train step at batch 2 (`bench.py` trains at 8). One step
# with the stem, layer1 and RoIAlignAvg kernels against the same step with
# their plain versions, from identical parameters and sampling draws: in f32
# the two compute one function (summation order only), so the four losses
# agree to 1e-4 and each trainable tensor's update to 1e-3 of its largest
# element (measured 8.7e-4 on an H100 (700 W): a ReLU gate within rounding
# of 0 may open on one side only). In bf16 the kernels round where the plain
# modules do not (the base's 3e-2 above), which moves the losses: their gaps
# measured 1.83e-3 at most on an H100 (700 W), so the bound is 5e-3.
TRAIN_BATCH, TRAIN_STEPS = 2, 3
TRAIN_LOSS_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}
TRAIN_UPDATE_TOL = 1e-3
# The backward kernel sums with f32 atomics, its plain version with
# index_add_: other orders, so 1e-5 of the largest gradient in f32.
BWD_F32_TOL = 1e-5
REPS, WARMUP = 20, 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def max_errs(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    d = (got.float() - want.float()).abs().max().item()
    return d, d / (want.float().abs().max().item() + 1e-12)


def time_ms(fn, flush: torch.Tensor, reps: int = REPS) -> float:
    """Median of `reps` CUDA-event timings of fn() after WARMUP calls, with
    the 50 MB L2 overwritten before each timed call (the serving path finds
    its inputs cold: each request's tensors are fresh)."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, flush: torch.Tensor, reps: int = REPS, launches: int = 1) -> float:
    """time_ms of a CUDA graph holding what `launches` calls of fn() launch,
    over `launches` (no flush between them): the device's time alone, where
    the host work around a short kernel (RoIAlignAvg's wrapper takes 10-40 µs
    of Python) would otherwise be timed with it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, flush, reps) / launches


def bound(nbytes: int, flops: float, peak_flops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over HBM rate vs operations
    over the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def nvidia_smi_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi did not run: {e}")
    check(res.returncode == 0, f"nvidia-smi exit {res.returncode}: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def full_f32():
    """f32 convolutions and matmuls without TF32, for the f32 comparisons;
    the flags are restored after, so the bf16 path runs as served."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def randomize_frozen_bn(model: torch.nn.Module, seed: int) -> None:
    """Frozen-BN statistics away from the identity, from a numpy seed, so the
    kernels' BN folds do real work."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            leaf = name.rsplit(".", 1)[1]
            if leaf in ("scale", "var"):
                v = rng.uniform(0.7, 1.0 if leaf == "scale" else 1.3, buf.shape)
            else:
                v = rng.normal(0.0, 0.05, buf.shape)
            buf.copy_(torch.from_numpy(v.astype(np.float32)))


def serve_requests(label: str, detector, images, counters: dict) -> dict:
    """Serve each image through `detector.detect` with every launch count
    set to 0 just before; check each request's detections and that every
    counted kernel launched in it. Returns the counts over all requests."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    latencies = []
    for i, im in enumerate(images):
        check(detector.blob(im)[0].shape == BLOB_SHAPE, f"{label} request {i}: blob shape")
        before = {k: f.launches for k, f in counters.items()}
        t0 = time.perf_counter()
        boxes, scores, classes, valid = detector.detect(im)     # ends in a device sync
        latencies.append((time.perf_counter() - t0) * 1e3)
        check(boxes.shape == (100, 4) and scores.shape == classes.shape == valid.shape == (100,),
              f"{label} request {i}: shapes {boxes.shape} {scores.shape}")
        check(np.isfinite(boxes).all() and np.isfinite(scores).all(),
              f"{label} request {i}: non-finite")
        check(int(valid.sum()) >= 1, f"{label} request {i}: no valid detection")
        check(((classes[valid] >= 1) & (classes[valid] < NUM_CLASSES)).all(),
              f"{label} request {i}: class out of range")
        moved = {k: f.launches - before[k] for k, f in counters.items()}
        check(all(moved.values()), f"{label} request {i}: kernel launch counts moved {moved}")
        print(f"{label} request {i}: image {im.shape[0]}x{im.shape[1]} -> blob 800x1216, "
              f"{int(valid.sum())} detections, {latencies[-1]:.2f} ms, launches {moved}",
              flush=True)
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} path: 3 requests, latency ms {[round(t, 3) for t in latencies]}, "
          f"peak memory {peak} bytes, launches {launches}", flush=True)
    check(all(launches.values()), f"{label}: a kernel of the path was not launched: {launches}")
    return launches


def request_stages(label: str, detector, image, base_stage: str, head_stage: str):
    """Where one request's time goes: host clock around each stage, each
    ended by a device sync (so the stages do not overlap as they do when
    served). The base runs as the detector's eval forward runs it
    (`fwd_only` for a ResNet base). Returns the request's blob and im_info on
    the card."""
    from rlobjectdetection_tpu_torch.engine.detect import postprocess_detections
    from rlobjectdetection_tpu_torch.models.backbones.resnet import ResNetBase

    model, cfg, dev = detector.model, detector.cfg, detector.device
    stages, t = {}, 0.0

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        stages[name] = round((time.perf_counter() - t) * 1e3, 3)
        t = time.perf_counter()

    with torch.no_grad():
        for _ in range(2):                      # the second pass is the one kept
            t = time.perf_counter()
            blob, im_info = detector.blob(image)
            data = torch.from_numpy(blob).to(dev)
            info = torch.from_numpy(im_info).to(dev)
            lap("prep (numpy resize and pad, copy to the card)")
            feat = (model.base(data, fwd_only=True) if isinstance(model.base, ResNetBase)
                    else model.base(data))
            lap(base_stage)
            rois, _, roi_valid = model.proposals(feat, info)
            lap("rpn (head convs, decode, top-k, NMS)")
            cls_prob, bbox_pred = model.detect_head(feat, rois)
            lap(head_stage)
            dets = postprocess_detections(
                rois[0], cls_prob[0], bbox_pred[0], info[0], roi_valid[0],
                num_classes=model.num_classes, max_per_image=cfg.TEST.MAX_DETS_PER_IMAGE,
                nms_thresh=cfg.TEST.NMS)
            lap("postprocess (per-class NMS, top-100)")
            for d in dets:
                d.cpu()
            lap("copy detections to the host")
    print(f"{label} request stages ms: {stages}", flush=True)
    return data, info


def parity(name, dtype, got, want, tol):
    torch.cuda.synchronize()
    abs_err, rel_err = max_errs(got, want)
    print(f"{name} {str(dtype)[6:]}: max abs {abs_err:.3e}, max rel {rel_err:.3e} "
          f"(bound {tol:.2e})", flush=True)
    check(rel_err <= tol, f"{name} {dtype}: max rel {rel_err:.3e} > {tol:.2e}")
    return abs_err, rel_err


def roi_align_check(label, base_feat, rois, flush, bf16_plain_tol) -> dict:
    """RoIAlignAvg on a request's base_feat and rois. The kernel blends and
    averages bf16 features in f32 and rounds once: it is held against the
    plain version's f32 arithmetic on the same features, rounded once (one
    bf16 step), against the plain version in bf16 arithmetic (bf16 products
    and sums, as the JAX path computes; `bf16_plain_tol` covers their own
    roundings), and in f32."""
    from rlobjectdetection_tpu_torch.ops import roi_align, roi_align_kernel

    pooled = roi_align_kernel.roi_align_avg(base_feat, rois)
    feat_f32 = base_feat.float()
    err = parity(f"roi_align_avg {label} (plain in f32, rounded once)", torch.bfloat16, pooled,
                 roi_align.roi_align_avg(feat_f32, rois).to(torch.bfloat16), ONE_BF16_STEP)
    err = parity(f"roi_align_avg {label}", torch.bfloat16, pooled,
                 roi_align.roi_align_avg(base_feat, rois), bf16_plain_tol)
    parity(f"roi_align_avg {label}", torch.float32, roi_align_kernel.roi_align_avg(feat_f32, rois),
           roi_align.roi_align_avg(feat_f32, rois), F32_TOL)
    # operations this run's rois need: 7 per inside sample (the bilinear
    # blend; outside samples are skipped) and 4 per output cell (the mean)
    _, fh, fw, c = base_feat.shape
    inside = roi_align.roi_align_coords(rois, fh, fw, 8, 8, 1.0 / 16.0)[-1]
    flops = c * (7.0 * int(inside.sum()) + 4.0 * rois.shape[0] * 49)
    b_roi, f_roi = bound(nbytes(base_feat, rois, pooled), flops, F32_FLOPS)
    run = lambda: roi_align_kernel.roi_align_avg(base_feat, rois)
    return dict(
        err=err, ms=graph_ms(run, flush), wrapper_ms=time_ms(run, flush),
        plain_ms=time_ms(lambda: roi_align.roi_align_avg(base_feat, rois), flush),
        library_ms=None, bound_ms=b_roi, bound_by=f_roi)


@contextlib.contextmanager
def plain_modules(base):
    """The backbone without its kernels: the plain stem (and so the plain
    layer1) and plain stages; restored after."""
    saved = base.conv1_fused, getattr(base, "stages_fused", 0)
    base.conv1_fused = False
    if hasattr(base, "stages_fused"):
        base.stages_fused = 0
    try:
        yield
    finally:
        base.conv1_fused = saved[0]
        if hasattr(base, "stages_fused"):
            base.stages_fused = saved[1]


def kernels_vs_plain(label, fn, holders, tols) -> None:
    """fn() with the kernels against fn() with the plain modules, in bf16
    and in f32 (each holder's `dtype` set to it), max |diff| / max |plain|."""
    for dtype in (torch.bfloat16, torch.float32):
        for h in holders:
            h.dtype = dtype
        with full_f32() if dtype == torch.float32 else contextlib.nullcontext():
            got = fn()
            with plain_modules(holders[-1]):
                want = fn()
        torch.cuda.synchronize()
        tol = tols[dtype]
        _, rel = max_errs(got, want)
        mean_rel = ((got.float() - want.float()).abs().mean()
                    / want.float().abs().max()).item()
        print(f"{label} {str(dtype)[6:]} (kernels vs plain modules): "
              f"max rel {rel:.3e}, mean rel {mean_rel:.3e} (bound {tol:.2e})", flush=True)
        check(rel <= tol, f"{label} {dtype}: max rel {rel:.3e} > {tol:.2e}")
    for h in holders:
        h.dtype = torch.bfloat16


def base_check(label, base, data, tols) -> None:
    """The whole backbone with its kernels against the plain modules."""
    kernels_vs_plain(f"base_feat ({label})", lambda: base(data), [base], tols)


def flagship(cfg, images) -> tuple[dict, dict, dict]:
    """ResNet-101 C4: three requests, stages, the stem, layer1 and
    RoIAlignAvg kernels against their plain versions, the whole C4 base.
    Returns the kernels' results, the launch counts and the state dict."""
    from rlobjectdetection_tpu_torch.engine.serve import Detector
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.models.backbones.resnet import nhwc_to_nchw
    from rlobjectdetection_tpu_torch.ops import layer1_kernel, roi_align_kernel, stem_kernel
    from rlobjectdetection_tpu_torch.ops.bn_fold import bn_mul_add

    dev = torch.device("cuda")
    check(cfg.CONV1_FUSED and cfg.LAYER1_FUSED and cfg.ANCHOR_SCALES == (4, 8, 16, 32),
          f"flagship config expected, got {cfg}")
    model = FasterRCNN(NUM_CLASSES, "resnet101", cfg, device=dev, seed=3)
    randomize_frozen_bn(model, seed=3)
    n_params = sum(t.numel() for t in model.state_dict().values())
    print(f"model: resnet101 C4, {NUM_CLASSES} classes, {n_params} parameters "
          f"(params + frozen-BN statistics), compute {cfg.DTYPE}", flush=True)
    check(n_params == 48_191_389, f"parameter count {n_params} != 48191389")
    detector = Detector(model, cfg, dev)
    counters = {"stem": stem_kernel.fused_stem, "layer1": layer1_kernel.fused_layer1,
                "roi_align_avg": roi_align_kernel.roi_align_avg}
    launches = serve_requests("main", detector, images, counters)
    data, info = request_stages("main", detector, images[0], "base (stem, layer1-3)",
                                "head (roi_align_avg, layer4, classifiers)")
    # the same request with layer2/layer3 on the residual-stage kernel
    model.base.stages_fused = 23
    request_stages("main STAGE_FUSED=23", detector, images[0],
                   "base (stem, layer1, layer2-3 kernels)",
                   "head (roi_align_avg, layer4, classifiers)")
    model.base.stages_fused = 0

    # each kernel against its plain version at the shapes the requests gave it
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    base, bn = model.base, model.base.bn1
    stem_w = (base.conv1.weight, bn.scale, bn.bias, bn.mean, bn.var)
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}
    with torch.no_grad():
        # stem: [1, 800, 1216, 3] f32 image -> [1, 200, 304, 64]
        stem_bf = stem_kernel.fused_stem(data, *stem_w, dtype=bf16)
        err = parity("stem", bf16, stem_bf, stem_kernel.stem_plain(data, *stem_w, dtype=bf16),
                     BF16_TOL["stem"])
        with full_f32():
            stem_f32 = stem_kernel.fused_stem(data, *stem_w, dtype=f32)
            parity("stem", f32, stem_f32, stem_kernel.stem_plain(data, *stem_w, dtype=f32),
                   F32_TOL)
        mul, add = (v.to(bf16)[:, None, None] for v in bn_mul_add(*stem_w[1:]))
        w_bf = base.conv1.weight.to(bf16)
        oh, ow = stem_kernel.stem_out_shapes(*BLOB_SHAPE[1:3])[:2]
        b_stem, f_stem = bound(nbytes(data, *stem_w, stem_bf), 2.0 * oh * ow * 64 * 147,
                               BF16_TENSOR_FLOPS)
        # the kernel alone on pre-packed operands; the wrapper (cache hit) beside it
        stem_packed = stem_kernel.packed_stem(*stem_w, bf16, dev)
        results["stem"] = dict(
            err=err, ms=time_ms(lambda: stem_kernel.launch_stem(data, stem_packed, bf16), flush),
            wrapper_ms=time_ms(lambda: stem_kernel.fused_stem(data, *stem_w, dtype=bf16), flush),
            plain_ms=time_ms(lambda: stem_kernel.stem_plain(data, *stem_w, dtype=bf16), flush),
            library_ms=time_ms(lambda: F.max_pool2d(torch.relu(
                F.conv2d(nhwc_to_nchw(data.to(bf16)), w_bf, stride=2,
                                           padding=3) * mul + add), 3, 2, 0, ceil_mode=True),
                flush),
            bound_ms=b_stem, bound_by=f_stem)

        # layer1, fed the stem's output: [1, 200, 304, 64] -> [1, 200, 304, 256]
        packed_bf = layer1_kernel.pack_layer1(base.layer1, bf16)
        l1_bf = layer1_kernel.fused_layer1(stem_bf, base.layer1, dtype=bf16)
        err = parity("layer1", bf16, l1_bf, layer1_kernel.layer1_plain(stem_bf, packed_bf, bf16),
                     BF16_TOL["layer1"])
        with full_f32():
            l1_f32 = layer1_kernel.fused_layer1(stem_f32, base.layer1, dtype=f32)
            parity("layer1", f32, l1_f32, layer1_kernel.layer1_plain(
                stem_f32, layer1_kernel.pack_layer1(base.layer1, f32), f32), F32_TOL)
        _, h1, w1, _ = stem_bf.shape
        macs = (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256) + 2 * (256 * 64 + 9 * 64 * 64 + 64 * 256)
        weights = [v for pk in packed_bf for v in pk.values() if v is not None]
        b_l1, f_l1 = bound(nbytes(stem_bf, l1_bf, *weights), 2.0 * h1 * w1 * macs,
                           BF16_TENSOR_FLOPS)
        stem_nchw = nhwc_to_nchw(stem_bf)
        l1_packed = layer1_kernel.packed_layer1(base.layer1, bf16, dev)
        results["layer1"] = dict(
            err=err, ms=time_ms(lambda: layer1_kernel.launch_layer1(stem_bf, l1_packed, bf16),
                                flush),
            wrapper_ms=time_ms(lambda: layer1_kernel.fused_layer1(stem_bf, base.layer1,
                                                                  dtype=bf16), flush),
            plain_ms=time_ms(lambda: layer1_kernel.layer1_plain(stem_bf, packed_bf, bf16), flush),
            library_ms=time_ms(lambda: base.layer1(stem_nchw), flush),
            bound_ms=b_l1, bound_by=f_l1)

        # RoIAlignAvg on the request's base_feat and rois: [1, 50, 76, 1024], [300, 5]
        base_feat = base(data)
        rois = model.proposals(base_feat, info)[0].reshape(-1, 5).contiguous()
        check(tuple(base_feat.shape) == (1, 50, 76, 1024) and tuple(rois.shape) == (300, 5),
              f"head inputs {tuple(base_feat.shape)} {tuple(rois.shape)}")
        results["roi_align_avg"] = roi_align_check("C=1024", base_feat, rois, flush,
                                                   BF16_TOL["roi_align_avg"])

        # the whole C4 base: kernel stem + layer1 against the plain modules;
        # then with layer2/layer3 on the stage kernel too, under the RL trunk's
        # bound (the same kernels, the same rounding points)
        check(bool(torch.isfinite(base_feat.float()).all()), "base_feat is not finite")
        base_check("stem+layer1 kernels", base, data, BASE_FEAT_TOL)
        base.stages_fused = 23
        kernels_vs_plain("base_feat (stem+layer1+layer2-3 kernels, STAGE_FUSED=23)",
                         lambda: base(data, fwd_only=True), [base], RL_BASE_FEAT_TOL)
        base.stages_fused = 0
    # on the host, so the VGG-16 path's peak memory stays its own
    return results, launches, {k: v.cpu() for k, v in model.state_dict().items()}


def vgg16(cfg, images) -> tuple[dict, dict]:
    """VGG-16: three requests, stages, the block-1 kernel and RoIAlignAvg at
    512 channels against their plain versions, the whole VGG base."""
    from rlobjectdetection_tpu_torch.engine.serve import Detector
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.models.backbones.resnet import nhwc_to_nchw
    from rlobjectdetection_tpu_torch.ops import roi_align_kernel, vgg_block1_kernel

    dev = torch.device("cuda")
    model = FasterRCNN(NUM_CLASSES, "vgg16", cfg, device=dev, seed=3)
    n_params = sum(t.numel() for t in model.state_dict().values())
    print(f"model: vgg16, {NUM_CLASSES} classes, {n_params} parameters, compute "
          f"{cfg.DTYPE}", flush=True)
    check(n_params == 138_316_573, f"parameter count {n_params} != 138316573")
    detector = Detector(model, cfg, dev)
    counters = {"vgg_block1": vgg_block1_kernel.fused_vgg_block1,
                "roi_align_avg": roi_align_kernel.roi_align_avg}
    launches = serve_requests("vgg16", detector, images, counters)
    data, info = request_stages("vgg16", detector, images[0],
                                "base (block 1 kernel, blocks 2-5)",
                                "head (roi_align_avg, fc6/fc7, classifiers)")

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    base = model.base
    c1, c2 = base.conv1_1, base.conv1_2
    w = (c1.weight, c1.bias, c2.weight, c2.bias)
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}
    with torch.no_grad():
        # block 1: [1, 800, 1216, 3] f32 image -> [1, 400, 608, 64]
        block = lambda dtype: vgg_block1_kernel.fused_vgg_block1(data, *w, dtype=dtype)
        packed = vgg_block1_kernel.packed_vgg_block1(*w, bf16, dev)
        plain = lambda dtype: vgg_block1_kernel.vgg_block1_plain(data, *w, dtype=dtype)
        out_bf = block(bf16)
        err = parity("vgg_block1", bf16, out_bf, plain(bf16), VGG_BLOCK1_TOL[bf16])
        with full_f32():
            parity("vgg_block1", f32, block(f32), plain(f32), VGG_BLOCK1_TOL[f32])
        w_bf = [t.to(bf16) for t in w]
        _, h, wd, _ = data.shape
        b_blk, f_blk = bound(nbytes(data, *w, out_bf), 2.0 * h * wd * 64 * (27 + 576),
                             BF16_TENSOR_FLOPS)
        # the kernel alone on pre-packed operands; the wrapper (cache hit) beside it
        results["vgg_block1"] = dict(
            err=err, ms=time_ms(lambda: vgg_block1_kernel.launch_vgg_block1(data, packed, bf16),
                                flush),
            wrapper_ms=time_ms(lambda: block(bf16), flush),
            plain_ms=time_ms(lambda: plain(bf16), flush),
            library_ms=time_ms(lambda: F.max_pool2d(torch.relu(F.conv2d(torch.relu(F.conv2d(
                nhwc_to_nchw(data.to(bf16)), w_bf[0], w_bf[1], padding=1)), w_bf[2], w_bf[3],
                padding=1)), 2, 2), flush),
            bound_ms=b_blk, bound_by=f_blk)

        # RoIAlignAvg on the request's base_feat and rois: [1, 50, 76, 512], [300, 5]
        base_feat = base(data)
        rois = model.proposals(base_feat, info)[0].reshape(-1, 5).contiguous()
        check(tuple(base_feat.shape) == (1, 50, 76, 512) and tuple(rois.shape) == (300, 5),
              f"vgg16 head inputs {tuple(base_feat.shape)} {tuple(rois.shape)}")
        results["roi_align_avg C=512"] = roi_align_check("C=512", base_feat, rois, flush,
                                                         BF16_TOL["roi_align_avg C=512"])

        check(bool(torch.isfinite(base_feat.float()).all()), "vgg16 base_feat is not finite")
        base_check("vgg block-1 kernel", base, data, VGG_BASE_FEAT_TOL)
    return results, launches


def rl_batch(rng, n_images: int) -> dict:
    """A collated RL batch at 800×1216: RGB pixels through the port's
    normalisation, 64 boxes per image drawn as `bench.py::make_rl_step`
    draws them, targets ±1 and weights U(0.5, 1.5)."""
    from rlobjectdetection_tpu_torch.config import RLConfig
    from rlobjectdetection_tpu_torch.data.rl_coco import collate, normalize_image

    cfg, (h, w), n = RLConfig(), BLOB_SHAPE[1:3], RL_BOXES
    bw, bh = min(190, w // 4), min(190, h // 4)
    samples = []
    for i in range(n_images):
        img = normalize_image(rng.randint(0, 256, (h, w, 3)), cfg.normalize_mean,
                              cfg.normalize_std)
        x1 = rng.randint(0, w - bw - 1, n)
        y1 = rng.randint(0, h - bh - 1, n)
        x2 = x1 + rng.randint(min(30, bw // 2), bw, n)
        y2 = y1 + rng.randint(min(30, bh // 2), bh, n)
        boxes = np.stack([x1, y1, x2, y2, np.full(n, 0.9), np.ones(n), np.full(n, i)], 1)
        labels = np.stack(np.broadcast_arrays(
            np.arange(56)[None, :], rng.choice([-1.0, 1.0], (n, 56)),
            rng.rand(n, 56) + 0.5), -1)
        samples.append((img, boxes.astype(np.float32), labels.astype(np.float32),
                        [h, w, 1.0, h, w, f"synthetic-{i}"]))
    return collate(samples, 56)


def rl_net(det_state: dict) -> tuple[dict, dict]:
    """The RL refinement net: three refine requests and three train steps
    with the launch counts read over both, one request's stages, the
    residual-stage kernel against its plain version at layer2's and
    layer3's shapes, the whole trunk and the action values against the plain
    modules."""
    from rlobjectdetection_tpu_torch.config import RLConfig
    from rlobjectdetection_tpu_torch.engine.rl import (Refiner, make_rl_optimizer,
                                                       rl_train_step)
    from rlobjectdetection_tpu_torch.models.backbones.resnet import nhwc_to_nchw
    from rlobjectdetection_tpu_torch.models.rl import Action, RLPolicyNet, warm_start_from_detector
    from rlobjectdetection_tpu_torch.ops import (layer1_kernel, res_stage_kernel,
                                                 roi_align_kernel, stem_kernel)

    dev = torch.device("cuda")
    cfg = RLConfig()
    model = RLPolicyNet(56, 101, torch.bfloat16, conv1_fused=True, layer1_fused=True,
                        stages_fused=23, device=dev, seed=3)
    model.load_state_dict(warm_start_from_detector(model.state_dict(), det_state))
    copied = [k for k in det_state if k.startswith(("base.", "head."))]
    state = model.state_dict()
    check(all(torch.equal(state[k].cpu(), det_state[k]) for k in copied),
          "warm start: the trunk and layer4 are not the detector's")
    n_params = sum(t.numel() for t in state.values())
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"model: RL policy net, resnet101 trunk + stride-1 layer4, 56 actions, {n_params} "
          f"parameters (params + frozen-BN statistics), {n_train} trained, "
          f"{len(copied)} tensors warm-started from the flagship, compute bfloat16", flush=True)
    action = Action(cfg.act_delta, iou_thres=cfg.act_iou_thres)
    refiner = Refiner(model, action, maxk=1)
    counters = {"stem": stem_kernel.fused_stem, "layer1": layer1_kernel.fused_layer1,
                "roi_align_avg": roi_align_kernel.roi_align_avg,
                "res_stage": res_stage_kernel.fused_res_stage}
    rng = np.random.RandomState(3)
    requests = [rl_batch(rng, 1) for _ in range(3)]
    train_batch = rl_batch(rng, RL_TRAIN_BATCH)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    latencies = []
    for i, batch in enumerate(requests):
        before = {k: f.launches for k, f in counters.items()}
        t0 = time.perf_counter()
        pred, moved, prec = refiner(batch)
        latencies.append((time.perf_counter() - t0) * 1e3)
        check(pred.shape == (1, RL_BOXES, 56) and np.isfinite(pred).all(),
              f"rl request {i}: pred {pred.shape}, finite {np.isfinite(pred).all()}")
        check(len(moved) == 1 and moved[0].shape == (RL_BOXES, 4) and np.isfinite(moved[0]).all(),
              f"rl request {i}: moved boxes {[m.shape for m in moved]}")
        xyxy = batch["bboxes"][0, :, 1:5]
        xywh = np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]], 1)
        moved_n = int((moved[0] != xywh).any(1).sum())
        delta = {k: f.launches - before[k] for k, f in counters.items()}
        check(all(delta.values()), f"rl request {i}: kernel launch counts moved {delta}")
        print(f"rl request {i}: {BLOB_SHAPE[1]}x{BLOB_SHAPE[2]}, {RL_BOXES} boxes -> pred {pred.shape}, max |pred| "
              f"{np.abs(pred).max():.3f}, precision@1 {prec:.1f}, {moved_n} box moved, "
              f"{latencies[-1]:.2f} ms, launches {delta}", flush=True)
    peak_refine = torch.cuda.max_memory_allocated()

    torch.cuda.reset_peak_memory_stats()
    opt, sched = make_rl_optimizer(model, cfg, steps_per_epoch=100)
    inputs = [torch.from_numpy(train_batch[k]).to(dev) for k in ("data", "bboxes")]
    inputs += [torch.from_numpy(np.ascontiguousarray(train_batch["labels"][..., j])).to(dev)
               for j in (1, 2)]
    inputs.append(torch.from_numpy(train_batch["num_dts"]).to(dev))
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    step_ms, losses = [], []
    for step in range(3):
        t0 = time.perf_counter()
        loss, noweight = rl_train_step(model, opt, sched, *inputs)
        loss, noweight = float(loss), float(noweight)      # ends in a device sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        check(np.isfinite(loss) and np.isfinite(noweight), f"rl train step {step}: loss {loss}")
    state = model.state_dict()
    frozen_moved = [k for k in state if k.startswith("base.") and not torch.equal(state[k], state0[k])]
    check(not frozen_moved, f"rl train: frozen trunk tensors changed: {frozen_moved[:4]}")
    trained = ["fc.weight", "fc.bias", "fc8.weight", "fc8.bias"] + [
        f"head.layer4.block{b}.{bn}.{leaf}" for b in range(3) for bn in ("bn1", "bn2", "bn3")
        for leaf in ("scale", "bias")]
    unchanged = [k for k in trained if torch.equal(state[k], state0[k])]
    check(not unchanged, f"rl train: head tensors unchanged: {unchanged}")
    stats_moved = [k for k in state if k.endswith((".mean", ".var"))
                   and not torch.equal(state[k], state0[k])]
    check(not stats_moved, f"rl train: BN statistics changed: {stats_moved[:4]}")
    launches = {k: f.launches for k, f in counters.items()}
    check(all(launches.values()), f"rl: a kernel of the path was not launched: {launches}")
    print(f"rl path: 3 refine requests, latency ms {[round(t, 3) for t in latencies]}, peak "
          f"memory {peak_refine} bytes; 3 train steps at batch {RL_TRAIN_BATCH} x {RL_BOXES} "
          f"boxes, step ms {[round(t, 3) for t in step_ms]}, loss {[round(v, 4) for v in losses]}, "
          f"peak memory {torch.cuda.max_memory_allocated()} bytes; trunk ({sum(k.startswith('base.') for k in state)} "
          f"tensors) bit-identical, {len(trained)} head tensors changed; launches {launches}",
          flush=True)
    del opt, sched, state0

    # one request's stages, each ended by a device sync
    batch = requests[0]
    data = torch.from_numpy(batch["data"]).to(dev)
    bboxes = torch.from_numpy(batch["bboxes"]).to(dev)
    rois = bboxes.reshape(-1, 8)[:, :5].contiguous()
    stages, t = {}, 0.0

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        stages[name] = round((time.perf_counter() - t) * 1e3, 3)
        t = time.perf_counter()

    with torch.no_grad():
        for _ in range(2):                      # the second pass is the one kept
            t = time.perf_counter()
            feat = model.base(data)
            lap("trunk (stem, layer1, layer2-3 kernels)")
            roi_feat = roi_align_kernel.roi_align_avg(feat, rois)
            lap("roi_align_avg")
            pred = model.fc(torch.relu(model.fc8(model.head(roi_feat)))).float()
            lap("head + fc (layer4, fc8, fc)")
            p = pred.cpu().numpy().reshape(1, RL_BOXES, 56)
            xywh = batch["bboxes"][..., 1:5].copy()
            xywh[..., 2:] -= xywh[..., :2]
            action.move_from_act(xywh, p, batch["labels"][..., 1], 1)
            lap("move (copy to the host, teacher-forced top-1 move)")
    print(f"rl request stages ms: {stages}", flush=True)

    # the residual-stage kernel at the shapes the requests gave it
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    base = model.base
    bf16, f32 = torch.bfloat16, torch.float32
    err_abs = err_rel = 0.0
    totals = dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0)
    with torch.no_grad():
        bn = base.bn1
        stem_w = (base.conv1.weight, bn.scale, bn.bias, bn.mean, bn.var)
        full = layer1_kernel.fused_layer1(stem_kernel.fused_stem(data, *stem_w, dtype=bf16),
                                          base.layer1, dtype=bf16)
        for name, layer in (("layer2", base.layer2), ("layer3", base.layer3)):
            x = full[:, ::2, ::2].contiguous()
            width, blocks = layer.planes, layer.blocks
            run = lambda xi, dtype: res_stage_kernel.fused_res_stage(
                xi, layer, blocks=blocks, width=width, dtype=dtype)
            packed = res_stage_kernel.pack_res_stage(layer, blocks, width, bf16)
            out = run(x, bf16)
            a, r = parity(f"res_stage {name} {tuple(x.shape)}", bf16, out,
                          res_stage_kernel.res_stage_plain(x, packed, bf16), RES_STAGE_TOL[bf16])
            err_abs, err_rel = max(err_abs, a), max(err_rel, r)
            with full_f32():
                parity(f"res_stage {name}", f32, run(x.float(), f32),
                       res_stage_kernel.res_stage_plain(
                           x.float(), res_stage_kernel.pack_res_stage(layer, blocks, width, f32),
                           f32), RES_STAGE_TOL[f32])
            cin, ho, wo = x.shape[-1], x.shape[1], x.shape[2]
            macs = (cin * width + 9 * width * width + 4 * width * width + cin * 4 * width
                    + (blocks - 1) * (4 * width * width + 9 * width * width + 4 * width * width))
            weights = [v for pk in packed for v in pk.values() if v is not None]
            b_ms, b_by = bound(nbytes(x, out, *weights), 2.0 * ho * wo * macs, BF16_TENSOR_FLOPS)
            full_nchw = nhwc_to_nchw(full)
            # the kernel alone on pre-packed operands; the wrapper (cache hit) beside it
            packed_k = res_stage_kernel.packed_res_stage(layer, blocks, width, bf16, dev)
            r = dict(ms=time_ms(lambda: res_stage_kernel.launch_res_stage(x, packed_k, bf16),
                                flush),
                     wrapper_ms=time_ms(lambda: run(x, bf16), flush),
                     plain_ms=time_ms(lambda: res_stage_kernel.res_stage_plain(x, packed, bf16),
                                      flush),
                     library_ms=time_ms(lambda: layer(full_nchw), flush))
            print(f"res_stage {name}: {blocks} blocks, {2.0 * ho * wo * macs / 1e9:.3f} GFLOP, "
                  f"kernel_ms {r['ms']:.4f}, wrapper_ms {r['wrapper_ms']:.4f}, plain_ms "
                  f"{r['plain_ms']:.4f}, library_ms {r['library_ms']:.4f} (cuDNN ResLayer, "
                  f"channels-last bf16), bound_ms {b_ms:.4f} ({b_by})", flush=True)
            for k in ("ms", "wrapper_ms", "plain_ms", "library_ms"):
                totals[k] += r[k]
            totals["flops"] += 2.0 * ho * wo * macs
            totals["nbytes"] += nbytes(x, out, *weights)
            full = out
        b_ms, b_by = bound(totals["nbytes"], totals["flops"], BF16_TENSOR_FLOPS)
        results = {"res_stage": dict(err=(err_abs, err_rel), ms=totals["ms"],
                                     wrapper_ms=totals["wrapper_ms"],
                                     plain_ms=totals["plain_ms"],
                                     library_ms=totals["library_ms"], bound_ms=b_ms,
                                     bound_by=b_by)}

        # RoIAlignAvg at the refine's shape: [1, 50, 76, 1024], [64, 5]
        results["roi_align_avg C=1024 R=64"] = roi_align_check(
            "C=1024 R=64", feat, rois, flush, BF16_TOL["roi_align_avg R=64"])

        # the whole trunk, and the action values, kernels against plain modules
        kernels_vs_plain("rl base_feat", lambda: base(data), [base], RL_BASE_FEAT_TOL)
        kernels_vs_plain("rl pred", lambda: model(data, bboxes)[0], [model, base], RL_PRED_TOL)
    return results, launches


def bench_gt(rng, b: int, g: int, h: int, w: int) -> np.ndarray:
    """`bench.py::_gt`: 8 random boxes of 40-190 px a image with a class in
    1..80, zero rows up to g."""
    gt = np.zeros((b, g, 5), dtype=np.float32)
    for i in range(b):
        for j in range(8):
            x1, y1 = rng.randint(0, w - 200), rng.randint(0, h - 200)
            gt[i, j] = [x1, y1, x1 + rng.randint(40, 190), y1 + rng.randint(40, 190),
                        1 + rng.randint(80)]
    return gt


def train_batch(dev) -> dict:
    """`bench.py`'s synthetic train batch (seed 3) at TRAIN_BATCH images."""
    rng = np.random.RandomState(3)
    b, (h, w) = TRAIN_BATCH, BLOB_SHAPE[1:3]
    batch = {"data": rng.randn(b, h, w, 3).astype(np.float32) * 10,
             "im_info": np.array([[h, w, 1.0]] * b, dtype=np.float32),
             "gt_boxes": bench_gt(rng, b, 50, h, w),
             "num_boxes": np.full((b,), 8, dtype=np.int32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


@contextlib.contextmanager
def plain_train_path(model):
    """The train step without its kernels: the plain stem and layer1 modules
    and the plain RoIAlignAvg, differentiated by autograd; restored after."""
    from rlobjectdetection_tpu_torch.models import faster_rcnn
    from rlobjectdetection_tpu_torch.ops import roi_align

    saved = faster_rcnn.roi_align_avg
    faster_rcnn.roi_align_avg = roi_align.roi_align_avg
    try:
        with plain_modules(model.base):
            yield
    finally:
        faster_rcnn.roi_align_avg = saved


def one_train_step(model, batch, seed: int):
    """One step from the model's parameters with a fresh optimizer (SGD,
    base_lr 0.01): (metrics as floats, {trainable name: update})."""
    from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step

    opt, sched, labels = build_optimizer(model, "resnet101", base_lr=0.01)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if labels[n] != "frozen"}
    metrics = make_train_step(model, opt, sched)(
        batch, torch.Generator(device=batch["data"].device).manual_seed(seed))
    metrics = {k: float(v) for k, v in metrics.items()}
    updates = {n: p.detach() - before[n] for n, p in model.named_parameters() if n in before}
    return metrics, updates


def train_stages(model, batch, seed: int) -> dict:
    """Where one train step's time goes: the train forward's parts, the
    backward and the optimizer step, host clock around each, each ended by
    a device sync (so they do not overlap as they do in a step)."""
    from rlobjectdetection_tpu_torch.engine import build_optimizer
    from rlobjectdetection_tpu_torch.models.losses import smooth_l1_loss, softmax_cross_entropy
    from rlobjectdetection_tpu_torch.models.targets import (anchor_target, proposal_target,
                                                            uniform_source)

    c, t = model.cfg, model.cfg.TRAIN
    opt, sched, _ = build_optimizer(model, "resnet101", base_lr=0.01)
    data, info, gt = batch["data"], batch["im_info"], batch["gt_boxes"]
    stages, t0 = {}, 0.0

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        stages[name] = round((time.perf_counter() - t0) * 1e3, 3)
        t0 = time.perf_counter()

    for _ in range(2):                          # the second pass is the one kept
        uniform = uniform_source(torch.Generator(device=data.device).manual_seed(seed),
                                 data.device)
        b, a = data.shape[0], model.num_anchors
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        base_feat = model.base(data)
        lap("base (stem, layer1 kernels, layer2-3 cuDNN)")
        rpn_cls, rpn_delta = model.rpn(base_feat)
        rois = model._propose(rpn_cls, rpn_delta, info, t)[0]
        lap("rpn (head convs, decode, top-12000, NMS to 2000)")
        at = anchor_target(uniform, tuple(base_feat.shape[1:3]), gt, info,
                           feat_stride=c.FEAT_STRIDE[0], anchor_scales=c.ANCHOR_SCALES,
                           anchor_ratios=c.ANCHOR_RATIOS, rpn_batch_size=t.RPN_BATCHSIZE)
        logits2 = torch.stack([rpn_cls[..., :a].reshape(b, -1),
                               rpn_cls[..., a:].reshape(b, -1)], dim=-1)
        loss = softmax_cross_entropy(logits2, at.labels.clamp_min(0), at.labels >= 0)
        loss = loss + smooth_l1_loss(rpn_delta.float().reshape(b, -1, 4), at.bbox_targets,
                                     at.bbox_inside_weights, at.bbox_outside_weights,
                                     sigma=3.0, reduce_dims=(1, 2))
        lap("anchor_target + RPN losses")
        pt = proposal_target(uniform, rois, gt, rois_per_image=t.BATCH_SIZE)
        lap("proposal_target (sample 128 rois an image)")
        cls_score, bbox_pred = model._scores(base_feat, pt.rois)
        labels = pt.labels.reshape(-1)
        sel = F.one_hot(labels.long(), model.num_classes).float()
        bbox_pred = torch.einsum("ncd,nc->nd", bbox_pred.reshape(-1, model.num_classes, 4), sel)
        loss = loss + softmax_cross_entropy(cls_score, labels) + smooth_l1_loss(
            bbox_pred, pt.bbox_targets.reshape(-1, 4), pt.bbox_inside_weights.reshape(-1, 4),
            pt.bbox_outside_weights.reshape(-1, 4))
        lap("head (roi_align_avg, layer4, classifiers, R-CNN losses)")
        loss.backward()
        lap("backward (roi_align_avg_bwd kernel, layer2-4, RPN, classifiers)")
        opt.step()
        sched.step()
        lap("optimizer step (SGD)")
        float(loss.detach())
        lap("copy the loss to the host")
    return stages


def roi_align_bwd_check(label, feat_shape, rois, grad, flush) -> dict:
    """The backward kernel against its plain version on the same inputs: in
    f32 to 1e-5 of the largest gradient (the kernel's atomics and the plain
    version's index_add_ sum in other orders); in bf16 both sum in f32 and
    round once, so an element may round to its neighbour: one bf16 step.
    Timed as a CUDA graph of the launch, its wrapper as called beside."""
    from rlobjectdetection_tpu_torch.ops import roi_align, roi_align_kernel

    grad32 = grad.float()
    parity(f"roi_align_avg_bwd {label}", torch.float32,
           roi_align_kernel.roi_align_avg_bwd(grad32, rois, feat_shape),
           roi_align.roi_align_avg_backward(grad32, rois, feat_shape, torch.float32),
           BWD_F32_TOL)
    got = roi_align_kernel.roi_align_avg_bwd(grad, rois, feat_shape)
    err = parity(f"roi_align_avg_bwd {label}", torch.bfloat16, got,
                 roi_align.roi_align_avg_backward(grad, rois, feat_shape, torch.bfloat16),
                 ONE_BF16_STEP)
    # operations this run's rois need: 8 per inside sample (its gradient
    # from the pooled column sums, four weights, four sums) and 4 per pooled
    # cell (its share to the column sums)
    _, fh, fw, c = feat_shape
    inside = roi_align.roi_align_coords(rois, fh, fw, 8, 8, 1.0 / 16.0)[-1]
    flops = c * (8.0 * int(inside.sum()) + 4.0 * rois.shape[0] * 49)
    b_bwd, f_bwd = bound(nbytes(grad, rois, got), flops, F32_FLOPS)
    run = lambda: roi_align_kernel.roi_align_avg_bwd(grad, rois, feat_shape)
    r = dict(err=err, ms=graph_ms(run, flush), wrapper_ms=time_ms(run, flush),
             plain_ms=time_ms(lambda: roi_align.roi_align_avg_backward(
                 grad, rois, feat_shape, torch.bfloat16), flush),
             library_ms=None, bound_ms=b_bwd, bound_by=f_bwd)
    print(f"roi_align_avg_bwd {label}: grad {tuple(grad.shape)}, d features {tuple(feat_shape)}, "
          f"f32 scratch {4 * got.numel()} bytes (zeroed, reduced into, read back: the simple "
          f"design's overhead above the bound)", flush=True)
    return r


def step_vs_plain(model, batch, state: dict, dtype) -> list[str]:
    """One train step from `state` with the kernels and one with their plain
    versions (same sampling seed): prints the four losses' relative gaps and
    the largest update gap of a trainable tensor (relative to its largest
    update); returns the bounds they break."""
    model.dtype = model.base.dtype = dtype
    with full_f32() if dtype == torch.float32 else contextlib.nullcontext():
        model.load_state_dict(state)
        got, got_up = one_train_step(model, batch, seed=9)
        model.load_state_dict(state)
        with plain_train_path(model):
            want, want_up = one_train_step(model, batch, seed=9)
    gaps = {k: abs(got[k] - want[k]) / abs(want[k]) for k in
            ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box")}
    up_rel, up_leaf = max((((got_up[n] - want_up[n]).abs().max()
                            / want_up[n].abs().max()).item(), n) for n in want_up)
    print(f"train step {str(dtype)[6:]} (kernels vs plain versions): losses "
          f"{[round(got[k], 6) for k in gaps]} vs {[round(want[k], 6) for k in gaps]}, "
          f"relative gaps {gaps} (bound {TRAIN_LOSS_TOL[dtype]:.1e}); fg/bg "
          f"{int(got['fg_cnt'])}/{int(got['bg_cnt'])} vs "
          f"{int(want['fg_cnt'])}/{int(want['bg_cnt'])}; largest update gap "
          f"{up_rel:.3e} of a leaf's max |update| ({up_leaf})", flush=True)
    failed = []
    if max(gaps.values()) > TRAIN_LOSS_TOL[dtype]:
        failed.append(f"train step {dtype}: loss gaps {gaps} > {TRAIN_LOSS_TOL[dtype]}")
    if dtype == torch.float32 and up_rel > TRAIN_UPDATE_TOL:
        failed.append(f"train step f32: update gap {up_rel:.3e} ({up_leaf}) > "
                      f"{TRAIN_UPDATE_TOL}")
    return failed


def train_path(det_state: dict) -> tuple[dict, dict]:
    """The detector's train step: three bf16 steps of the flagship at batch
    2 with the launch counts read over them, one step's stages, the backward
    kernel against its plain version, and one step with the kernels against
    the plain modules in f32 and in bf16."""
    from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step
    from rlobjectdetection_tpu_torch.engine.serve import build_config
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.ops import layer1_kernel, roi_align_kernel, stem_kernel

    dev = torch.device("cuda")
    cfg = build_config("coco", ["DTYPE", "bfloat16"])
    t = cfg.TRAIN
    check(cfg.CONV1_FUSED and cfg.LAYER1_FUSED and cfg.RESNET.FIXED_BLOCKS == 1
          and cfg.ANCHOR_SCALES == (4, 8, 16, 32) and cfg.MAX_NUM_GT_BOXES == 50
          and (t.RPN_PRE_NMS_TOP_N, t.RPN_POST_NMS_TOP_N, t.RPN_BATCHSIZE, t.BATCH_SIZE)
          == (12000, 2000, 256, 128), f"train config expected, got {cfg}")
    model = FasterRCNN(NUM_CLASSES, "resnet101", cfg, device=dev, seed=3)
    model.load_state_dict(det_state)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(dev)
    counters = {"stem": stem_kernel.fused_stem, "layer1": layer1_kernel.fused_layer1,
                "roi_align_avg": roi_align_kernel.roi_align_avg,
                "roi_align_avg_bwd": roi_align_kernel.roi_align_avg_bwd}
    opt, sched, labels = build_optimizer(model, "resnet101", base_lr=0.01)
    step = make_train_step(model, opt, sched)
    gen = torch.Generator(device=dev).manual_seed(7)
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"model: resnet101 C4 train step, batch {TRAIN_BATCH} x {BLOB_SHAPE[1]}x"
          f"{BLOB_SHAPE[2]}, {n_train} trained parameters in "
          f"{sum(v != 'frozen' for v in labels.values())} tensors, SGD base_lr 0.01, "
          f"compute {cfg.DTYPE}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    step_ms, losses = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        loss = float(metrics["loss"])                   # ends in a device sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
        parts = {k: float(metrics[k]) for k in ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box")}
        losses.append(parts)
        check(np.isfinite(loss) and all(np.isfinite(v) for v in parts.values()),
              f"train step {i}: loss {loss} {parts}")
        print(f"train step {i}: {step_ms[-1]:.2f} ms, loss {loss:.5f} {parts}, fg_cnt "
              f"{int(metrics['fg_cnt'])}, bg_cnt {int(metrics['bg_cnt'])}", flush=True)
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"train path: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, step ms "
          f"{[round(v, 3) for v in step_ms]}, peak memory {peak} bytes, launches {launches}",
          flush=True)
    check(all(launches.values()), f"train: a kernel of the path was not launched: {launches}")
    frozen_moved = [k for k, v in model.state_dict().items()
                    if labels.get(k, "frozen") == "frozen" and not torch.equal(v, state0[k])]
    check(not frozen_moved, f"train: frozen tensors changed: {frozen_moved[:4]}")
    del opt, sched, step

    model.load_state_dict(state0)
    print(f"train step stages ms: {train_stages(model, batch, seed=11)}", flush=True)

    # the backward kernel at the flagship's train shape (the rois a train
    # forward samples) and at a small shape with rois over the border
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    model.load_state_dict(state0)
    with torch.no_grad():
        base_feat = model.base(batch["data"])
        out = model(batch["data"], batch["im_info"], batch["gt_boxes"], train=True,
                    generator=torch.Generator(device=dev).manual_seed(7))
    rois = out["rois"].reshape(-1, 5).contiguous()
    feat_shape = tuple(base_feat.shape)
    check(feat_shape == (2, 50, 76, 1024) and tuple(rois.shape) == (256, 5),
          f"train head inputs {feat_shape} {tuple(rois.shape)}")
    g = torch.Generator(device=dev).manual_seed(5)
    grad = torch.randn((256, 7, 7, 1024), generator=g, device=dev).to(torch.bfloat16)
    results = {"roi_align_avg_bwd": roi_align_bwd_check("R=256 C=1024", feat_shape, rois, grad,
                                                        flush)}
    rng = np.random.RandomState(13)
    small = rng.uniform(-40, 160, (7, 4)).astype(np.float32)
    small[:, 2:] = small[:, :2] + rng.uniform(0, 120, (7, 2))
    small_rois = torch.from_numpy(np.concatenate(
        [rng.randint(0, 2, (7, 1)).astype(np.float32), small], 1)).to(dev)
    small_grad = torch.randn((7, 7, 7, 64), generator=g, device=dev).to(torch.bfloat16)
    roi_align_bwd_check("R=7 C=64", (2, 9, 11, 64), small_rois, small_grad, flush)
    del base_feat, out, flush

    # the whole step, kernels against plain versions, from identical
    # parameters and sampling draws: the first step's. The random net's
    # proposals overlap no gt box there, so the sampled rois are the gt boxes
    # whatever the proposals, and the comparison hangs on no NMS tie. (Once
    # the net has trained, the two bf16 paths' roundings move the proposals
    # and with them the sampled rois.) Both dtypes print before either fails.
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        failed += step_vs_plain(model, batch, state0, dtype)
    model.dtype = model.base.dtype = torch.bfloat16
    check(not failed, "; ".join(failed))
    return results, launches


def report(name, r, launches, label=None) -> None:
    wrapper = f"wrapper_ms {r['wrapper_ms']:.4f}, " if "wrapper_ms" in r else ""
    print(f"{label or name}: kernel_ms {r['ms']:.4f}, {wrapper}plain_ms {r['plain_ms']:.4f}, "
          f"library_ms "
          f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f')}, "
          f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}), "
          f"launches {launches}, bf16 max rel {r['err'][1]:.3e}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the smoke run needs a GPU")

    from rlobjectdetection_tpu_torch.engine.serve import build_config
    from rlobjectdetection_tpu_torch.ops import _build

    # 1. device
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {sorted(built)} "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()), flush=True)
    from rlobjectdetection_tpu_torch.ops import (layer1_kernel, res_stage_kernel, stem_kernel,
                                                 vgg_block1_kernel)
    for dtype in (torch.bfloat16, torch.float32):
        print(f"launch resources {str(dtype)[6:]} (registers a thread, shared memory bytes a "
              f"CTA, CTAs an SM, spill bytes a thread, as the runtime reports them; for the "
              f"residual stage also its grid at batch 1, CTAs a cluster and CTAs the card runs "
              f"at once): stem {stem_kernel.stem_info(dtype)}, layer1 "
              f"{layer1_kernel.layer1_info(dtype)}, vgg_block1 "
              f"{vgg_block1_kernel.vgg_block1_info(dtype)}, res_stage "
              f"{res_stage_kernel.res_stage_info(dtype)}", flush=True)

    # 3. the two served detectors, one after the other (the first freed
    # before the second, so each path's peak memory is its own)
    cfg = build_config("coco", ["TEST.SCALES", "[800]", "DTYPE", "bfloat16"])
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.float32) for h, w in IMAGE_SIZES]
    results, launches, det_state = flagship(cfg, images)
    torch.cuda.empty_cache()
    vgg_results, vgg_launches = vgg16(cfg, images)
    torch.cuda.empty_cache()

    # 4. the RL refinement net, warm-started from the flagship
    rl_results, rl_launches = rl_net(det_state)
    torch.cuda.empty_cache()

    # 5. the detector's train step, from the flagship's weights
    train_results, train_launches = train_path(det_state)

    # 6. the kernels line: launches over both detectors' requests, over the
    # RL path's requests and train steps for the residual stage, and over the
    # detector's train steps for the RoIAlignAvg backward
    roi_launches = launches["roi_align_avg"] + vgg_launches["roi_align_avg"]
    results["vgg_block1"] = vgg_results["vgg_block1"]
    results["res_stage"] = rl_results["res_stage"]
    roi_rl = rl_results.pop("roi_align_avg C=1024 R=64")
    results["roi_align_avg_bwd"] = train_results["roi_align_avg_bwd"]
    launches = dict(launches, vgg_block1=vgg_launches["vgg_block1"], roi_align_avg=roi_launches,
                    res_stage=rl_launches["res_stage"],
                    roi_align_avg_bwd=train_launches["roi_align_avg_bwd"])
    sources = {"stem": ("csrc/stem.cu", "rlobjectdetection_tpu/ops/stem_pallas.py:297"),
               "layer1": ("csrc/layer1.cu", "rlobjectdetection_tpu/ops/layer1_pallas.py:317"),
               "roi_align_avg": ("csrc/roi_align.cu",
                                 "rlobjectdetection_tpu/ops/roi_align_pallas.py:108"),
               "vgg_block1": ("csrc/vgg_block1.cu",
                              "rlobjectdetection_tpu/ops/vgg_stem_pallas.py:270"),
               "res_stage": ("csrc/res_stage.cu",
                             "rlobjectdetection_tpu/ops/res_stage_pallas.py:284"),
               "roi_align_avg_bwd": ("csrc/roi_align.cu",
                                     "rlobjectdetection_tpu/ops/roi_align_vjp.py:39 (XLA)")}
    where = {"roi_align_avg": "in 6 requests",
             "res_stage": "in 3 RL requests and 3 RL train steps (layer2 + layer3)",
             "roi_align_avg_bwd": f"in {TRAIN_STEPS} detector train steps"}
    kernels = []
    for name, r in results.items():
        report(name, r, f"{launches[name]} {where.get(name, 'in 3 requests')}",
               "roi_align_avg C=1024" if name == "roi_align_avg" else None)
        kernels.append({"name": name, "route": "cuda",
                        "source": "rlobjectdetection_tpu_torch/" + sources[name][0],
                        "replaces": sources[name][1], "launches": launches[name],
                        "max_abs_err": r["err"][0], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    report("roi_align_avg", vgg_results["roi_align_avg C=512"],
           f"{vgg_launches['roi_align_avg']} in the 3 vgg16 requests", "roi_align_avg C=512")
    report("roi_align_avg", roi_rl, f"{rl_launches['roi_align_avg']} in the RL requests and "
           f"train steps", "roi_align_avg C=1024 R=64")
    print(f"detector train path launches over {TRAIN_STEPS} steps: {train_launches}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
