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

Between the two detectors, the eval path: `engine/test_net.py`'s eval
loop, called as a function, with the flagship's weights over a synthetic
COCO split made in a temporary directory under `output/` (8 images of
480×640, 80 categories; 800×1088 blobs), once at batch 1 (over
`device_prefetch`) and once at batch 2 (shape buckets), the stem's,
layer1's and RoIAlignAvg's launch counts set to 0 before each run and read
after. Check 1: each image's detections equal `Detector.detect` on the same
file, to the bit. Check 2, on what each run produced itself (kept by the
loop's `on_batch` hook): every image in one row, a batch-2 row holding its
image's batch-1 blob bits and im_info, each image's detections those of its
row's own outputs, all exactly; batch 2's base features, and the head run
on each image's batch-1 features with the batch-2 row's own rois against
that row's outputs, held to the bf16 bound of one backbone computed two
ways; and how many detection sets differ. Check 3: the gt as detections
scores AP 1.0 through the port's COCOeval, with neither cv2 nor pycocotools
loaded. It prints the loop's rates, one image's stages and the scoring
time, then holds the stem, layer1, the whole base and RoIAlignAvg against
their plain versions at the loop's shapes (1×800×1088 and 2×800×1088
blobs, 300 and 600 rois); the kernels line reports each kernel's largest
error over the requests' and the loop's shapes.

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

Then the RL CLI (`engine/trainval_rl.py`, called in process) on the
`engine/rl_hw_validate.py` fixture made under `output/` (8 synthetic COCO
images of 480×640, 80 categories; the detections are the gt shifted by
(7, -5)): the ΔIoU dataset's build with its weight statistic timed; the
flagship's weights with frozen-BN statistics from one of the CLI's
batches (`calibrated_state`) as `--pretrained`; two epochs of ResNet-101
at the CLI's defaults (800 / 1200, batch 2, f32) with 4 assembly threads,
every logged loss finite, a checkpoint each epoch, the stem, layer1,
stage and RoIAlignAvg kernels launched at least their count a step and
packed no more than once each, epoch 2's rates and peak memory, the
checkpoint's bytes and save and load times; `-e --resume` at the bf16 and
the f32 wire (composed eval rates, Preck, the mAP before and after the
moves, after at least before); the four kernels against their plain
versions in f32 at one of its [2, 800, 1088, 3] batches and the whole
trunk against the plain modules; the f32 trunk timed with the stage
kernel, with cuDNN's layer2-3 (TF32 allowed, as the CLI runs) and without
TF32; `engine/rl_resume_validate.py` at the same shapes in fresh processes
under deterministic algorithms. It prints its seconds as `rl cli phase:
N s`.

Then the detector's train step (the flagship's weights, `bench.py`'s
synthetic batch at 2 images, SGD at 0.01, bf16 compute): three steps with
the launch counts of the stem, layer1 and both RoIAlignAvg kernels read over
them, one step's stages, the RoIAlignAvg backward kernel against its plain
version and two of its launches against each other bit for bit (R=256 at
C=1024 with the rois the first step samples and with those a step samples
after the three, and a small shape), timed as a CUDA graph of its launch,
and one whole step with the kernels against the same step with their plain
versions, in f32 and in bf16, from the first step's parameters.

Then VGG-16's train step (the served VGG-16's weights, the same batch,
blocks 1-2 frozen, fc6/fc7 dropout from a seeded generator on the card,
SGD at 0.01 with the global norm clipped at 10): three bf16 steps with the
block-1, RoIAlignAvg and backward kernels' launches read over them (one
each a step), each step's time and gradient norm before the clip, one
step's stages, the backward kernel at C=512 against its plain version and
bit for bit against itself (first-step and steady rois), and one whole step
with the kernels against their plain versions in f32 and in bf16.

Then the training CLI (`engine/trainval_net.py`, called in process) on a
synthetic COCO set made under `output/` (32 images of 480×640, 80
categories, in the train and valminusminival splits; 4 more in minival,
whose files must not collide with valminusminival's): the flagship from
`--pretrained` weights (the flagship's, frozen-BN statistics taken from a
CLI batch as a pretrained net's are) at batch 2 and at batch 8, two
epochs each at lr 0.01, with epoch 2's images/s (wall and steady), host
assembly, the card's wait between steps and peak memory printed, and the
stem, layer1 and both RoIAlignAvg launch counts read over the batch-2 run
(at least one a step, layer1 three); one of the CLI's batches with the
kernels against their plain versions (f32, bf16); the checkpoint's bytes
and its save and load times; `engine/resume_validate.py` (8 images, 2
epochs, batch 2, fresh processes under deterministic algorithms);
`test_net --load_dir` on the epoch-2 checkpoint (its COCOeval table, its
pooling_mode restored, image 0's detections equal to `Detector.detect`'s
on the same weights, to the bit); `demo` over 3 minival images (3
`_det.jpg` files).

Last, the flagship with POOLING_MODE pool, then crop (plain PyTorch on the
card: XLA in JAX, no TPU kernel): three requests and one request's stages,
two train steps, the op on the card against the same op on a CPU copy in
f32 (output and gradient) at a request's and at a later step's rois, and
the op's times at the request's and the train step's shapes.

Every phase raises on failure and the script exits non-zero: no CUDA, a
kernel that does not build or launch, a kernel that disagrees with its plain
version, a request that gives a wrong shape, non-finite values, no valid
detection, an eval loop whose detections leave `Detector.detect`'s, whose
rows are not their images' or whose gt does not score AP 1.0, a training
CLI run that writes a non-finite checkpoint, launches a kernel less than
once a step, does not resume to the same tensors, or whose `test_net` or
`demo` fails, an RL CLI run whose logged losses are not finite, whose
checkpoint is not, whose moved boxes score a lower mAP than the unmoved
ones or that does not resume to the same tensors, a train step whose
loss is not finite, that moves the frozen
trunk or leaves the head unchanged, a whole train step whose losses or
updates leave their bounds, a pool or crop result on the card that leaves
the CPU's, or a kernel the path did not launch. The
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
# VGG-16's step is held to the same bounds. In f32 the two runs' max-pool
# routes and ReLU gates, where rounding decides them, are taken out of the
# comparison rather than the bound: the plain run keeps its own forward but
# sends each pool window's gradient where the kernel run's went, and a
# conv3_1..conv5_3 output on the other side of 0 takes the kernel run's sign
# (`models/backbones/vgg_ties.py`). Left so, conv3_1..conv4_3's updates
# measured 1.6e-3 apart on an H100 (700 W). The decisions so taken must be
# ties: each window's own max and its routed value, and each flipped
# output and 0, within 1e-5 of the layer's largest magnitude (f32 block-1
# outputs differ by 9.3e-7 of their largest between the two paths).
TIE_SIZE_TOL = 1e-5
# The eval loop at batch 2: each row's class probabilities and deltas against
# the head run on its image's batch-1 features with that row's own rois,
# max |diff| / max |batch 1|. cuDNN's batch-2 algorithms move the base
# features by bf16 steps (1.72e-2, under BASE_FEAT_TOL), which layer4 and
# the softmax carry on: measured 3.81e-2 (probabilities) and 1.23e-2
# (deltas) on an H100 (700 W), so the bound is 5e-2. The same head on
# another image's features measured 0.138 and 0.082 at least: a row handed
# to the wrong image lies outside the bound, and the check holds that it does.
EVAL_HEAD_TOL = 5e-2
VGG_CLIP = 10.0    # the reference's global-norm clip for VGG-16
# roi_pool / roi_crop (plain PyTorch) on the card against the CPU in f32:
# the same formulas; the gathers' gradients sum in other orders on the card.
ROI_MODE_TOL = 1e-5
# The backward kernel sums each element in an order fixed by its inputs, its
# plain version with index_add_ in another, so 1e-5 of the largest gradient
# in f32.
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


class Laps:
    """Where a pass's time goes: the host clock around each stage, each
    ended by a device sync (so stages do not overlap as they do in a run).
    `start()` begins a pass; `lap(name)` ends a stage; a later pass's
    stages replace the earlier ones'."""

    def __init__(self):
        self.stages, self.t = {}, 0.0

    def start(self):
        self.t = time.perf_counter()

    def __call__(self, name):
        torch.cuda.synchronize()
        self.stages[name] = round((time.perf_counter() - self.t) * 1e3, 3)
        self.t = time.perf_counter()


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
    lap = Laps()
    with torch.no_grad():
        for _ in range(2):                      # the second pass is the one kept
            lap.start()
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
    print(f"{label} request stages ms: {lap.stages}", flush=True)
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


def stem_layer1_parity(label, base, data):
    """The stem kernel on `data` and layer1's on the stem's output, each
    against its plain version in bf16 and in f32. Returns the bf16 (max abs,
    max rel) of each, the stem's weights, the bf16 stem and layer1 outputs
    and layer1's bf16 packed weights."""
    from rlobjectdetection_tpu_torch.ops import layer1_kernel, stem_kernel

    bn, bf16, f32 = base.bn1, torch.bfloat16, torch.float32
    stem_w = (base.conv1.weight, bn.scale, bn.bias, bn.mean, bn.var)
    errs = {}
    stem_bf = stem_kernel.fused_stem(data, *stem_w, dtype=bf16)
    errs["stem"] = parity(f"stem{label}", bf16, stem_bf,
                          stem_kernel.stem_plain(data, *stem_w, dtype=bf16), BF16_TOL["stem"])
    with full_f32():
        stem_f32 = stem_kernel.fused_stem(data, *stem_w, dtype=f32)
        parity(f"stem{label}", f32, stem_f32, stem_kernel.stem_plain(data, *stem_w, dtype=f32),
               F32_TOL)
    packed_bf = layer1_kernel.pack_layer1(base.layer1, bf16)
    l1_bf = layer1_kernel.fused_layer1(stem_bf, base.layer1, dtype=bf16)
    errs["layer1"] = parity(f"layer1{label}", bf16, l1_bf,
                            layer1_kernel.layer1_plain(stem_bf, packed_bf, bf16),
                            BF16_TOL["layer1"])
    with full_f32():
        l1_f32 = layer1_kernel.fused_layer1(stem_f32, base.layer1, dtype=f32)
        parity(f"layer1{label}", f32, l1_f32, layer1_kernel.layer1_plain(
            stem_f32, layer1_kernel.pack_layer1(base.layer1, f32), f32), F32_TOL)
    return errs, stem_w, stem_bf, l1_bf, packed_bf


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
    base = model.base
    bf16 = torch.bfloat16
    results = {}
    with torch.no_grad():
        # stem: [1, 800, 1216, 3] f32 image -> [1, 200, 304, 64]; layer1, fed
        # the stem's output: [1, 200, 304, 64] -> [1, 200, 304, 256]
        errs, stem_w, stem_bf, l1_bf, packed_bf = stem_layer1_parity("", base, data)
        err = errs["stem"]
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

        err = errs["layer1"]
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


EVAL_IMAGES = 8
EVAL_IMAGE_SIZE = (480, 640)      # resized to 800×1067, padded to 800×1088
EVAL_BLOB_HW = (800, 1088)


def eval_stages(model, cfg, jobs) -> dict:
    """Where one image's time goes in the eval loop: host clock around each
    stage, each ended by a device sync (in the loop they overlap). The
    second pass is the one kept."""
    from rlobjectdetection_tpu_torch.data.prefetch import to_device
    from rlobjectdetection_tpu_torch.engine.test_net import postprocess_batch

    dev = next(model.parameters()).device
    lap = Laps()
    with torch.inference_mode():
        for _ in range(2):
            lap.start()
            idxs, b, _ = jobs.assemble_job(jobs.plan[0])
            lap("host assembly (PIL decode, numpy resize, pad)")
            data, info = to_device(b["data"], dev), to_device(b["im_info"], dev)
            lap("copy to the card (pinned, non-blocking)")
            out = model(data, info)
            lap("forward")
            packed = postprocess_batch(model, out, info, len(idxs), cfg)
            lap("postprocess (per-class NMS, top-100)")
            packed.cpu()
            lap("copy to the host")
    return lap.stages


def eval_kernel_checks(model, loader, flush) -> dict:
    """The eval loop's kernels against their plain versions at the shapes
    the loop gives them: the stem and layer1 on the first image's
    [1, 800, 1088, 3] blob and on the first two images' [2, 800, 1088, 3]
    canvas, the whole C4 base on each, and RoIAlignAvg on each one's
    features and proposals (300 and 600 rois on [1 | 2, 50, 68, 1024]).
    Returns each kernel's largest bf16 (max abs, max rel) over these."""
    dev = next(model.parameters()).device
    errs = {}
    with torch.no_grad():
        for n in (1, 2):
            b = (loader._assemble([0], 1.0) if n == 1 else
                 loader._assemble([0, 1], 1.0, pad_hw=EVAL_BLOB_HW, pad_count=2))
            data = torch.from_numpy(b["data"]).to(dev)
            info = torch.from_numpy(b["im_info"]).to(dev)
            check(tuple(data.shape) == (n, *EVAL_BLOB_HW, 3), f"eval blob {tuple(data.shape)}")
            e = stem_layer1_parity(f" (eval loop, {n}x800x1088)", model.base, data)[0]
            base_check(f"eval loop, {n}x800x1088", model.base, data, BASE_FEAT_TOL)
            feat = model.base(data, fwd_only=True)
            rois = model.proposals(feat, info)[0].reshape(-1, 5).contiguous()
            check(tuple(feat.shape) == (n, 50, 68, 1024) and tuple(rois.shape) == (300 * n, 5),
                  f"eval head inputs {tuple(feat.shape)} {tuple(rois.shape)}")
            e["roi_align_avg"] = roi_align_check(f"eval loop C=1024 B={n} R={300 * n}", feat,
                                                 rois, flush, BF16_TOL["roi_align_avg"])["err"]
            for k, v in e.items():
                errs[k] = tuple(map(max, errs.get(k, (0.0, 0.0)), v))
    return errs


def fingerprint(data: torch.Tensor) -> torch.Tensor:
    """Each blob row's f32 bits summed as integers: exact, order-free."""
    return torch.sum(data.view(torch.int32), dim=(1, 2, 3), dtype=torch.int64)


def loop_rows_check(model, cfg, loader, runs) -> dict:
    """Check 2 on what the loop itself produced: `runs[batch]` holds its
    detections and, for each batch as detect_loop's on_batch hook saw it,
    the indices, the blob rows' fingerprints, im_info and the model's
    outputs. Held exactly: each run sends every image through one row; a
    batch-2 row holds the bits and im_info of its image's batch-1 blob; each
    image's detections are those its row's own outputs give. Held to the
    bf16 bounds: batch 2's base features against batch 1's, and each batch-2
    row's class probabilities and deltas against the head run on its
    image's batch-1 features with that row's own rois (largest gap over the
    largest value); the head's gap against another image's features
    (image i xor 1: what a row handed to the wrong image would show) is held
    beyond that bound. Recorded: how many of the row's rois lie within 1 px
    of one the batch-1 loop proposed."""
    from rlobjectdetection_tpu_torch.engine.test_net import postprocess_batch, unpack_dets

    dev = next(model.parameters()).device
    rows = {batch: {} for batch in runs}
    for batch, (dets, _, _, caught) in runs.items():
        for idxs, fp, info, out in caught:
            check(len(idxs) <= batch and fp.shape[0] == info.shape[0] == batch,
                  f"check 2 batch {batch}: {len(idxs)} images in a {fp.shape[0]}-row batch")
            packed = postprocess_batch(model, out, info, len(idxs), cfg).cpu().numpy()
            for j, i in enumerate(idxs):
                check(i not in rows[batch], f"check 2 batch {batch}: image {i} in two rows")
                rows[batch][i] = (fp[j], info[j], {k: v[j] for k, v in out.items()})
                for got, want in zip(dets[i], unpack_dets(packed[j])):
                    check(np.array_equal(got, want), f"check 2 batch {batch}: image {i}'s "
                                                     f"detections are not its row's")
        check(sorted(rows[batch]) == list(range(EVAL_IMAGES)),
              f"check 2 batch {batch}: images seen {sorted(rows[batch])}")
    one, two = rows[1], rows[2]
    check(len({int(one[i][0]) for i in one}) == EVAL_IMAGES, "check 2: blob fingerprints repeat")
    gaps = {"cls_prob": 0.0, "bbox_pred": 0.0}
    wrong = {"cls_prob": float("inf"), "bbox_pred": float("inf")}
    near = []
    with torch.no_grad():
        singles = [torch.from_numpy(loader._assemble([i], 1.0)["data"]).to(dev)
                   for i in range(EVAL_IMAGES)]
        f1 = [model.base(d, fwd_only=True) for d in singles]
        for i in range(EVAL_IMAGES):
            fp, info, out = two[i]
            check(int(fp) == int(one[i][0]) == int(fingerprint(singles[i])[0]),
                  f"check 2: the batch-2 row of image {i} does not hold its batch-1 blob")
            check(torch.equal(info, one[i][1]), f"check 2: image {i}'s im_info {info.tolist()} "
                                                f"!= {one[i][1].tolist()}")
            rois = out["rois"][None].clone()
            rois[..., 0] = 0.0
            for k, feat in ((i, f1[i]), (i ^ 1, f1[i ^ 1])):
                cls, bbox = model.detect_head(feat, rois)
                e = {"cls_prob": max_errs(out["cls_prob"], cls[0])[1],
                     "bbox_pred": max_errs(out["bbox_pred"], bbox[0])[1]}
                for name, v in e.items():
                    if k == i:
                        gaps[name] = max(gaps[name], v)
                    else:
                        wrong[name] = min(wrong[name], v)
            r1 = one[i][2]["rois"]
            near.append(float(((out["rois"][:, None, 1:] - r1[None, :, 1:]).abs().amax(-1)
                               .amin(-1) <= 1.0).float().mean()))
        pair = loader._assemble([0, 1], 1.0, pad_hw=EVAL_BLOB_HW, pad_count=2)
        f2 = model.base(torch.from_numpy(pair["data"]).to(dev), fwd_only=True)
        base_rel = max_errs(f2, torch.cat(f1[:2]))[1]
    torch.cuda.synchronize()
    return {"base_feat max rel (images 0-1)": base_rel,
            "cls_prob max rel (own rois)": gaps["cls_prob"],
            "bbox_pred max rel (own rois)": gaps["bbox_pred"],
            "cls_prob max rel against another image (least)": wrong["cls_prob"],
            "bbox_pred max rel against another image (least)": wrong["bbox_pred"],
            "rois within 1 px of a batch-1 roi (least image)": min(near)}


def eval_path(cfg, det_state: dict) -> tuple[dict, dict]:
    """The eval loop of `engine/test_net.py` over a synthetic COCO split of
    EVAL_IMAGES images (80 categories, so the flagship's 81-class head) at
    TEST.SCALES [800]: once at batch 1 (over `device_prefetch`), once at
    batch 2 (shape buckets), the launch counts set to 0 before each and read
    after. Check 1: each image's detections equal `Detector.detect` on the
    same file; check 2: what each run produced, row by row
    (`loop_rows_check`), with batch 2's all_boxes against batch 1's
    recorded; check 3: the gt as detections scores AP 1.0 with the port's
    COCOeval. The stem, layer1 and RoIAlignAvg kernels are then held against
    their plain versions at the loop's shapes. Returns the launches over both
    runs and each kernel's largest bf16 error at those shapes."""
    import io
    import os
    import shutil
    import tempfile

    from rlobjectdetection_tpu_torch.data.blob import read_image_bgr
    from rlobjectdetection_tpu_torch.data.imdb import combined_roidb
    from rlobjectdetection_tpu_torch.data.loader import RoiBatchLoader
    from rlobjectdetection_tpu_torch.data.synthetic import make_coco_dataset
    from rlobjectdetection_tpu_torch.engine import test_net
    from rlobjectdetection_tpu_torch.engine.detect import detections_to_all_boxes
    from rlobjectdetection_tpu_torch.engine.serve import Detector
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.ops import layer1_kernel, roi_align_kernel, stem_kernel

    dev = torch.device("cuda")
    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output")
    os.makedirs(out_root, exist_ok=True)
    root = tempfile.mkdtemp(prefix="eval_path_", dir=out_root)
    prev_root = os.environ.get("RLOD_DATA_DIR")
    try:
        make_coco_dataset(root, num_images=EVAL_IMAGES, image_size=EVAL_IMAGE_SIZE,
                          classes=tuple(f"category{i:02d}" for i in range(1, NUM_CLASSES)),
                          seed=3)
        os.environ["RLOD_DATA_DIR"] = root
        with contextlib.redirect_stdout(io.StringIO()):
            imdb_obj, roidb, ratio_list, ratio_index = combined_roidb(
                "coco_2014_minival", training=False, use_flipped=False)
        check(imdb_obj.num_classes == NUM_CLASSES and len(roidb) == EVAL_IMAGES,
              f"eval roidb: {imdb_obj.num_classes} classes, {len(roidb)} images")
        model = FasterRCNN(NUM_CLASSES, "resnet101", cfg, device=dev)
        model.load_state_dict(det_state)
        counters = {"stem": stem_kernel.fused_stem, "layer1": layer1_kernel.fused_layer1,
                    "roi_align_avg": roi_align_kernel.roi_align_avg}
        runs, launches = {}, {k: 0 for k in counters}
        for batch in (1, 2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for f in counters.values():
                f.launches = 0
            caught = []
            keep = lambda idxs, data, info, out: caught.append(
                (list(idxs), fingerprint(data), info, out))
            with contextlib.redirect_stdout(io.StringIO()):
                dets, stats = test_net.detect_loop(model, cfg, roidb, ratio_list, ratio_index,
                                                   batch=batch, on_batch=keep)
            moved = {k: f.launches for k, f in counters.items()}
            stats["peak_bytes"] = torch.cuda.max_memory_allocated()
            check(all(moved.values()), f"eval loop batch {batch}: a kernel of the path was "
                                       f"not launched: {moved}")
            check(stats["shape_buckets"] == {EVAL_BLOB_HW: EVAL_IMAGES},
                  f"eval loop batch {batch}: shapes {stats['shape_buckets']}")
            for i, (boxes, scores, classes, valid) in enumerate(dets):
                check(boxes.shape == (100, 4) and np.isfinite(boxes).all()
                      and np.isfinite(scores).all() and int(valid.sum()) >= 1
                      and ((classes[valid] >= 1) & (classes[valid] < NUM_CLASSES)).all(),
                      f"eval loop batch {batch} image {i}: bad detections")
            launches = {k: launches[k] + moved[k] for k in counters}
            runs[batch] = dets, stats, moved, caught

        # check 1: the loop's detections against Detector.detect on each file
        detector = Detector(model, cfg, dev)
        gap, equal = 0.0, True
        for i, e in enumerate(roidb):
            want = detector.detect(read_image_bgr(e["image"]))
            for got, w in zip(runs[1][0][i], want):
                equal &= got.shape == w.shape and np.array_equal(got, w)
                if got.dtype.kind == "f":
                    gap = max(gap, float(np.abs(got - w).max()))
                else:
                    check(np.array_equal(got, w), f"check 1 image {i}: classes or validity differ")
        print(f"eval path check 1 (loop at batch 1 vs Detector.detect, {EVAL_IMAGES} images): "
              f"{'equal to the bit' if equal else 'largest gap ' + repr(gap)}", flush=True)
        check(equal, f"check 1: the loop's detections differ from Detector.detect by {gap}")

        # check 2: each run's own rows; then batch 2 against batch 1, class
        # by class, and where they part
        loader = RoiBatchLoader(roidb, ratio_list, ratio_index, 1, scales=cfg.TEST.SCALES,
                                max_num_gt=cfg.MAX_NUM_GT_BOXES, training=False)
        rows = loop_rows_check(model, cfg, loader, runs)
        one = detections_to_all_boxes(runs[1][0], NUM_CLASSES)
        two = detections_to_all_boxes(runs[2][0], NUM_CLASSES)
        cells = [(j, i) for j in range(1, NUM_CLASSES) for i in range(EVAL_IMAGES)]
        n_diff = sum(one[j][i].shape != two[j][i].shape for j, i in cells)
        gap2 = max((float(np.abs(one[j][i] - two[j][i]).max()) for j, i in cells
                    if one[j][i].size and one[j][i].shape == two[j][i].shape), default=0.0)
        print(f"eval path check 2 (each run's rows: images, blob bits, im_info and "
              f"detections exact; batch 2 vs batch 1): {rows}; {n_diff} of {len(cells)} "
              f"(class, image) cells differ in count, largest gap where they agree {gap2!r}",
              flush=True)
        # cuDNN runs layer2-4 with other algorithms on a batch of two: the
        # features move by bf16 steps, held to the bound of one backbone
        # computed two ways in bf16, and the head on the same rois to
        # EVAL_HEAD_TOL, which a row handed to the wrong image must exceed;
        # the random weights' RPN scores lie so close that those steps
        # reorder the proposals, so detection sets may differ and are
        # recorded, not held
        k = "base_feat max rel (images 0-1)"
        check(rows[k] <= BASE_FEAT_TOL[torch.bfloat16],
              f"check 2: {k} {rows[k]:.3e} > {BASE_FEAT_TOL[torch.bfloat16]:.1e}")
        for out in ("cls_prob", "bbox_pred"):
            own = rows[f"{out} max rel (own rois)"]
            other = rows[f"{out} max rel against another image (least)"]
            check(own <= EVAL_HEAD_TOL < other,
                  f"check 2: {out} max rel {own:.3e} (own image), {other:.3e} (another "
                  f"image), bound {EVAL_HEAD_TOL}")

        # the scoring stage, on the loop's own detections
        out_dir = os.path.join(root, "eval_out")
        os.makedirs(out_dir)
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            imdb_obj.evaluate_detections(one, out_dir)
            score_ms = (time.perf_counter() - t0) * 1e3

        # check 3: the gt as detections scores AP 1.0 (no cv2, no pycocotools)
        gt_boxes = [[np.concatenate([e["boxes"][e["gt_classes"] == j].astype(np.float32),
                                     np.ones((int((e["gt_classes"] == j).sum()), 1),
                                             np.float32)], 1) for e in roidb]
                    for j in range(NUM_CLASSES)]
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            gt_stats = imdb_obj.evaluate_detections(gt_boxes, out_dir)
        ap_line = next(l for l in text.getvalue().splitlines()
                       if "Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all" in l)
        print(f"eval path check 3 (gt as detections, port COCOeval): {ap_line.strip()}; "
              f"cv2 loaded {'cv2' in sys.modules}, pycocotools loaded "
              f"{'pycocotools' in sys.modules}", flush=True)
        check(gt_stats[0] == 1.0 and gt_stats[1] == 1.0, f"check 3: gt AP {gt_stats[:3]}")
        check("cv2" not in sys.modules and "pycocotools" not in sys.modules,
              "the eval path loaded cv2 or pycocotools")

        stages = eval_stages(model, cfg, test_net.EvalJobs(loader, 1, cfg.TEST.SCALES))
        stages["scoring (COCOeval of the loop's detections, 8 images)"] = round(score_ms, 3)
        print(f"eval path stages ms (batch 1, one image, each stage synced): {stages}",
              flush=True)
        for batch in (1, 2):
            _, st, moved, _ = runs[batch]
            n = st["images"]
            print(f"eval path batch {batch}: {n / st['wall_s']:.3f} images/s wall, "
                  f"{n / st['device_s']:.3f} device-timed, "
                  f"{st['steady_images'] / max(st['steady_s'], 1e-9):.3f} steady over "
                  f"{st['steady_images']} images; host assembly "
                  f"{st['assembly_ms_per_image']:.3f} ms an image (worker threads), device "
                  f"{st['device_s'] * 1e3 / n:.3f} ms an image (forward, postprocess, copy "
                  f"back); {st['wait_s'] * 1e3:.3f} ms between batches after the first "
                  f"(the device idle); peak memory {st['peak_bytes']} bytes; shape buckets "
                  f"{ {f'{h}x{w}': k for (h, w), k in st['shape_buckets'].items()} }; "
                  f"launches {moved}", flush=True)

        # the kernels against their plain versions at the loop's shapes
        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
        errs = eval_kernel_checks(model, loader, flush)
        del model, detector, runs, flush
        torch.cuda.empty_cache()
        return launches, errs
    finally:
        if prev_root is None:
            os.environ.pop("RLOD_DATA_DIR", None)
        else:
            os.environ["RLOD_DATA_DIR"] = prev_root
        shutil.rmtree(root, ignore_errors=True)


def vgg16(cfg, images) -> tuple[dict, dict, dict]:
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
    # on the host, so the next path's peak memory stays its own
    return results, launches, {k: v.cpu() for k, v in model.state_dict().items()}


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
    lap = Laps()
    with torch.no_grad():
        for _ in range(2):                      # the second pass is the one kept
            lap.start()
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
    print(f"rl request stages ms: {lap.stages}", flush=True)

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


RL_CLI_IMAGES = 8
RL_CLI_IMAGE_SIZE = (480, 640)           # 800×1066 at the CLI's short side, 800×1088 blobs
RL_CLI_BLOB = (2, 800, 1088, 3)
RL_CLI_LAYERS = 101
RL_CLI_SHORT, RL_CLI_MAX_SIZE = 800, 1200    # RLConfig's train and test sizes
# host threads of the weight statistic and of batch assembly
RL_CLI_STAT_WORKERS, RL_CLI_WORKERS = 8, 4


def rl_cli_kernel_checks(model, data: torch.Tensor, rois: torch.Tensor) -> dict:
    """The RL CLI's kernels against their plain versions in f32 (no TF32)
    at its shapes: the stem and layer1 on a [2, 800, 1088, 3] batch, the
    residual stage's layer2 and layer3 on their inputs, RoIAlignAvg on the
    trunk's [2, 50, 68, 1024] features with the batch's rois, and the whole
    trunk with its kernels against the plain modules. Returns each kernel's
    (max abs, max rel)."""
    from rlobjectdetection_tpu_torch.ops import (layer1_kernel, res_stage_kernel, roi_align,
                                                 roi_align_kernel, stem_kernel)

    base, f32, label = model.base, torch.float32, f" (RL CLI, {tuple(data.shape)})"
    errs = {}
    with torch.no_grad(), full_f32():
        bn = base.bn1
        stem_w = (base.conv1.weight, bn.scale, bn.bias, bn.mean, bn.var)
        x = stem_kernel.fused_stem(data, *stem_w, dtype=f32)
        errs["stem"] = parity(f"stem{label}", f32, x,
                              stem_kernel.stem_plain(data, *stem_w, dtype=f32), F32_TOL)
        stem = x
        x = layer1_kernel.fused_layer1(stem, base.layer1, dtype=f32)
        errs["layer1"] = parity(f"layer1{label}", f32, x, layer1_kernel.layer1_plain(
            stem, layer1_kernel.pack_layer1(base.layer1, f32), f32), F32_TOL)
        errs["res_stage"] = (0.0, 0.0)
        for name, layer in (("layer2", base.layer2), ("layer3", base.layer3)):
            xs = x[:, ::2, ::2].contiguous()
            x = res_stage_kernel.fused_res_stage(xs, layer, blocks=layer.blocks,
                                                 width=layer.planes, dtype=f32)
            want = res_stage_kernel.res_stage_plain(
                xs, res_stage_kernel.pack_res_stage(layer, layer.blocks, layer.planes, f32), f32)
            errs["res_stage"] = tuple(map(max, errs["res_stage"], parity(
                f"res_stage {name}{label}", f32, x, want, RES_STAGE_TOL[f32])))
        errs["roi_align_avg"] = parity(
            f"roi_align_avg (RL CLI, C=1024 R={rois.shape[0]})", f32,
            roi_align_kernel.roi_align_avg(x, rois), roi_align.roi_align_avg(x, rois), F32_TOL)
        got = base(data)
        with plain_modules(base):
            want = base(data)
        parity(f"rl cli base_feat{label} (kernels vs plain modules)", f32, got, want,
               RL_BASE_FEAT_TOL[f32])
    return errs


def rl_cli_path(det_state: dict) -> tuple[dict, dict]:
    """The RL CLI (`engine/trainval_rl.py`, called in process) on the
    `rl_hw_validate` fixture made under `output/` (8 synthetic COCO images
    of 480×640, 80 categories, detections the gt shifted by (7, -5)): the
    dataset's build with its weight statistic; two epochs of ResNet-101 at
    the CLI's defaults (800 / 1200, batch 2, f32) from the flagship's
    calibrated weights with 4 assembly threads, its logged losses finite, a
    checkpoint each epoch, epoch 2's rates, the checkpoint's bytes and
    save and load times; `-e --resume` at both wires with the pre- and
    post-move mAP; `engine/rl_resume_validate.py` at the same shapes in
    fresh processes; the stem, layer1, stage and RoIAlignAvg kernels
    against their plain versions in f32 at one of the CLI's batches, and
    the f32 trunk timed with the stage kernel and with cuDNN's layer2-3.
    Returns the launches over the training and eval runs and each kernel's
    f32 error."""
    import io
    import os
    import shutil
    import tempfile

    from rlobjectdetection_tpu_torch.config import RLConfig
    from rlobjectdetection_tpu_torch.data.rl_coco import (COCODataLoader, COCODataset,
                                                           COCOTransform)
    from rlobjectdetection_tpu_torch.engine import (rl_hw_validate, rl_resume_validate,
                                                    trainval_rl)
    from rlobjectdetection_tpu_torch.engine.checkpoint import (load_checkpoint, read_checkpoint,
                                                               save_params)
    from rlobjectdetection_tpu_torch.engine.rl import make_rl_optimizer
    from rlobjectdetection_tpu_torch.engine.serve import build_config
    from rlobjectdetection_tpu_torch.models.rl import Action
    from rlobjectdetection_tpu_torch.ops import (layer1_kernel, res_stage_kernel,
                                                 roi_align_kernel, stem_kernel)
    from rlobjectdetection_tpu_torch.ops.pack_cache import cached_pack

    dev = torch.device("cuda")
    repo = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(repo, "output"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="rl_cli_", dir=os.path.join(repo, "output"))
    try:
        classes = tuple(f"category{i:02d}" for i in range(1, NUM_CLASSES))
        ann, dt_file, img_dir = rl_hw_validate.build_fixture(root, RL_CLI_IMAGES,
                                                             RL_CLI_IMAGE_SIZE, classes=classes)
        cfg = RLConfig()
        action = Action(list(cfg.act_delta), iou_thres=cfg.act_iou_thres, wtrans=cfg.act_wtrans)
        t0 = time.perf_counter()
        dataset = COCODataset(img_dir, ann, dt_file, action,
                              transform_fn=COCOTransform(RL_CLI_SHORT, RL_CLI_MAX_SIZE),
                              normalize_mean=cfg.normalize_mean, normalize_std=cfg.normalize_std,
                              max_stat_dets=5000, stat_workers=RL_CLI_STAT_WORKERS)
        build_ms = (time.perf_counter() - t0) * 1e3
        n_dets = sum(len(v) for v in dataset.dt_boxes.values())
        print(f"rl cli dataset: {len(dataset)} images, {n_dets} detections x {action.num_acts} "
              f"actions, built in {build_ms:.1f} ms with the weight statistic "
              f"({RL_CLI_STAT_WORKERS} threads; pos {dataset.pos_tot}, neg {dataset.neg_tot})",
              flush=True)
        loader = COCODataLoader(dataset, 2)
        loader.set_epoch(0)
        batch = loader.assemble_job(loader.batch_plan()[0])
        check(batch["data"].shape == RL_CLI_BLOB, f"the RL CLI's batch is {batch['data'].shape}")

        # the flagship's weights with BN statistics from this batch's pixels
        # (the RL normalisation), for --pretrained
        data = torch.from_numpy(batch["data"]).to(dev)
        info = torch.tensor([[*RL_CLI_BLOB[1:3], 1.0]] * 2, device=dev)
        calibrated = calibrated_state(det_state, build_config("coco", TRAINVAL_SET),
                                      f"resnet{RL_CLI_LAYERS}", {"data": data, "im_info": info})
        pretrained = save_params(os.path.join(root, "pretrained.pth"), calibrated)
        del calibrated
        torch.cuda.empty_cache()

        save_dir = os.path.join(root, "models")
        common = ["--ann_file", ann, "--dt_file", dt_file, "--data_dir", img_dir,
                  "--save_dir", save_dir, "--layers", str(RL_CLI_LAYERS),
                  "--img_short", str(RL_CLI_SHORT), "--img_size", str(RL_CLI_MAX_SIZE),
                  "--stat_workers", str(RL_CLI_STAT_WORKERS)]
        counters = {"stem": stem_kernel.fused_stem, "layer1": layer1_kernel.fused_layer1,
                    "res_stage": res_stage_kernel.fused_res_stage,
                    "roi_align_avg": roi_align_kernel.roi_align_avg}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in counters.values():
            f.launches = 0
        packs0 = cached_pack.packs
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            result = trainval_rl.main(["--epochs", "2", "--pretrained", pretrained] + common,
                                      num_workers=RL_CLI_WORKERS)
        peak = torch.cuda.max_memory_allocated()
        packs = cached_pack.packs - packs0
        steps = result["step"]
        train_launches = {k: f.launches for k, f in counters.items()}
        losses = [l[2:] for l in result["logged"]]
        check(steps == 2 * (RL_CLI_IMAGES // 2) and len(result["checkpoints"]) == 2,
              f"rl cli: {steps} steps, checkpoints {result['checkpoints']}")
        check(losses and bool(np.isfinite(losses).all()), f"rl cli: logged losses {losses}")
        # one launch a step (stem, RoIAlignAvg), three (layer1), 27 (the stage)
        per_step = {"stem": 1, "layer1": 3, "res_stage": 27, "roi_align_avg": 1}
        check(all(train_launches[k] >= n * steps for k, n in per_step.items()),
              f"rl cli: a kernel launched less than its count a step: {train_launches}")
        check(packs <= len(per_step), f"rl cli: {packs} packs over {steps} steps")
        ck = read_checkpoint(result["checkpoints"][-1])
        check(ck["kind"] == "rl" and ck["epoch"] == 2 and ck["step"] == steps
              and all(torch.isfinite(v).all() for v in ck["model"].values()),
              f"rl cli: checkpoint kind {ck.get('kind')}, epoch {ck['epoch']}, step {ck['step']}")
        print(loop_rates("rl cli train loop batch 2", result["epochs"][1], peak)
              + f"; logged (epoch, iter, loss, noweight) {result['logged']}; kernel packs over "
              f"{steps} steps {packs}; launches {train_launches}", flush=True)

        # the checkpoint: its bytes, and a load into a fresh net, SGD and
        # schedule on the card
        ckpt = result["checkpoints"][-1]
        args = trainval_rl.parse_args(["--layers", str(RL_CLI_LAYERS)])
        model = trainval_rl.build_model(args, action.num_acts, dev)
        opt, sched = make_rl_optimizer(model, cfg, len(loader))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = load_checkpoint(ckpt, model, opt, sched)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        check(meta["step"] == steps and sched.last_epoch == steps,
              f"rl cli checkpoint load: meta step {meta['step']}, schedule {sched.last_epoch}")
        print(f"rl cli checkpoint: {os.path.getsize(ckpt)} bytes (params, frozen-BN "
              f"statistics, momentum), save {result['epochs'][1]['save_ms']:.1f} ms, load into a "
              f"fresh net, SGD and schedule on the card {load_ms:.1f} ms", flush=True)
        del opt, sched

        # eval at both wires: the detections as they are, then moved
        pre = rl_hw_validate.score(ann, dt_file)
        for wire in ("bf16", "f32"):
            before = {k: f.launches for k, f in counters.items()}
            with contextlib.redirect_stdout(io.StringIO()):
                ev = trainval_rl.main(["-e", "--resume", ckpt, "--maxk", "1", "--wire", wire]
                                      + common, num_workers=RL_CLI_WORKERS)
            check(all(f.launches > before[k] for k, f in counters.items()),
                  f"rl cli eval {wire}: a kernel was not launched")
            post = ev["stats"]
            check(len(ev["rows"]) == n_dets and post[0] >= pre[0],
                  f"rl cli eval {wire}: {len(ev['rows'])} rows; mAP {post[0]} after the move "
                  f"against {pre[0]} before")
            print(f"rl cli eval wire {wire}: composed eval {ev['images']} images in "
                  f"{ev['seconds']:.3f} s = {ev['images'] / ev['seconds']:.3f} images/s (loader "
                  f"{ev['loader_s']:.3f} s, step+fetch {ev['step_s']:.3f} s, post "
                  f"{ev['post_s']:.3f} s); Preck precision@1 {ev['preck']:.2f}%; mAP "
                  f"{pre[0]:.4f} -> {post[0]:.4f}, AP50 {pre[1]:.4f} -> {post[1]:.4f}",
                  flush=True)
        launches = {k: f.launches for k, f in counters.items()}

        # the kernels at the CLI's shapes (comparison launches not counted),
        # and the f32 trunk with the stage kernel against cuDNN's layer2-3
        data = torch.from_numpy(batch["data"]).to(dev)
        rois = torch.from_numpy(batch["bboxes"]).to(dev).reshape(-1, 8)[:, :5].contiguous()
        errs = rl_cli_kernel_checks(model, data, rois)
        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
        trunk = {}
        with torch.no_grad():
            for label, fused, ctx in (("stage kernel", 23, contextlib.nullcontext),
                                      ("cuDNN layer2-3", 0, contextlib.nullcontext),
                                      ("cuDNN layer2-3 without TF32", 0, full_f32)):
                model.base.stages_fused = fused
                with ctx():
                    trunk[label] = time_ms(lambda: model.base(data), flush, reps=10)
        model.base.stages_fused = 23
        print(f"rl cli f32 trunk {RL_CLI_BLOB} (stem and layer1 kernels, CUDA events, median of "
              f"10): " + ", ".join(f"{k} {v:.3f} ms" for k, v in trunk.items()), flush=True)
        del model, flush, data
        torch.cuda.empty_cache()

        # resume equality: fresh processes under deterministic algorithms
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            res = rl_resume_validate.main(
                ["--device", "cuda", "--layers", str(RL_CLI_LAYERS), "--batch_size", "2",
                 "--img_short", str(RL_CLI_SHORT), "--img_size", str(RL_CLI_MAX_SIZE),
                 "--ann_file", ann, "--dt_file", dt_file,
                 "--data_dir", img_dir, "--pretrained", pretrained,
                 "--work_dir", os.path.join(root, "resume")])
        print(text.getvalue().strip().splitlines()[-1], flush=True)
        check(res["ok"] and res["max_abs_delta"] == 0.0, f"rl resume: {res}")
        return launches, errs
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    """The train step without its kernels: the plain RoIAlignAvg,
    differentiated by autograd, and the plain stem and layer1 modules
    (ResNet) or VGG block 1's plain version (the kernel's rounding points);
    restored after."""
    from rlobjectdetection_tpu_torch.models import faster_rcnn
    from rlobjectdetection_tpu_torch.models.backbones import vgg
    from rlobjectdetection_tpu_torch.ops import roi_align, vgg_block1_kernel

    saved = faster_rcnn.roi_align_avg, vgg.fused_vgg_block1
    faster_rcnn.roi_align_avg = roi_align.roi_align_avg
    vgg.fused_vgg_block1 = vgg_block1_kernel.vgg_block1_plain
    try:
        with (contextlib.nullcontext() if isinstance(model.base, vgg.VGGBase)
              else plain_modules(model.base)):
            yield
    finally:
        faster_rcnn.roi_align_avg, vgg.fused_vgg_block1 = saved


def one_train_step(model, batch, seed: int, backbone: str = "resnet101",
                   clip_norm: float | None = None):
    """One step from the model's parameters with a fresh optimizer (SGD,
    base_lr 0.01, `clip_norm`), sampling and dropout from one seeded
    generator: (metrics as floats, {trainable name: update})."""
    from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step

    opt, sched, labels = build_optimizer(model, backbone, base_lr=0.01, clip_norm=clip_norm)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if labels[n] != "frozen"}
    metrics = make_train_step(model, opt, sched)(
        batch, torch.Generator(device=batch["data"].device).manual_seed(seed))
    metrics = {k: float(v) for k, v in metrics.items()}
    updates = {n: p.detach() - before[n] for n, p in model.named_parameters() if n in before}
    return metrics, updates


def train_stages(model, batch, seed: int, backbone: str = "resnet101",
                 clip_norm: float | None = None,
                 names=("base (stem, layer1 kernels, layer2-3 cuDNN)",
                        "head (roi_align_avg, layer4, classifiers, R-CNN losses)",
                        "backward (roi_align_avg_bwd kernel, layer2-4, RPN, classifiers)")) -> dict:
    """Where one train step's time goes: the train forward's parts, the
    backward and the optimizer step, host clock around each, each ended by
    a device sync (so they do not overlap as they do in a step). `names`
    labels the base, head and backward stages."""
    from rlobjectdetection_tpu_torch.engine import build_optimizer
    from rlobjectdetection_tpu_torch.models.losses import smooth_l1_loss, softmax_cross_entropy
    from rlobjectdetection_tpu_torch.models.targets import (anchor_target, proposal_target,
                                                            uniform_source)

    c, t = model.cfg, model.cfg.TRAIN
    opt, sched, _ = build_optimizer(model, backbone, base_lr=0.01, clip_norm=clip_norm)
    data, info, gt = batch["data"], batch["im_info"], batch["gt_boxes"]
    lap = Laps()
    for _ in range(2):                          # the second pass is the one kept
        uniform = uniform_source(torch.Generator(device=data.device).manual_seed(seed),
                                 data.device)
        b, a = data.shape[0], model.num_anchors
        lap.start()
        opt.zero_grad(set_to_none=True)
        base_feat = model.base(data)
        lap(names[0])
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
        cls_score, bbox_pred = model._scores(base_feat, pt.rois, uniform)
        labels = pt.labels.reshape(-1)
        sel = F.one_hot(labels.long(), model.num_classes).float()
        bbox_pred = torch.einsum("ncd,nc->nd", bbox_pred.reshape(-1, model.num_classes, 4), sel)
        loss = loss + softmax_cross_entropy(cls_score, labels) + smooth_l1_loss(
            bbox_pred, pt.bbox_targets.reshape(-1, 4), pt.bbox_inside_weights.reshape(-1, 4),
            pt.bbox_outside_weights.reshape(-1, 4))
        lap(names[1])
        loss.backward()
        lap(names[2])
        opt.step()
        sched.step()
        lap("optimizer step (SGD)" + (f", clip {clip_norm}" if clip_norm else ""))
        float(loss.detach())
        lap("copy the loss to the host")
    return lap.stages


def roi_align_bwd_check(label, feat_shape, rois, grad, flush) -> dict:
    """The backward kernel against its plain version on the same inputs: in
    f32 to 1e-5 of the largest gradient (the kernel and the plain version's
    index_add_ sum in other orders); in bf16 both sum in f32 and round once,
    so an element may round to its neighbour: one bf16 step. Two launches
    must give the same bits in both dtypes. Timed as a CUDA graph of the
    launch, its wrapper as called beside."""
    from rlobjectdetection_tpu_torch.ops import roi_align, roi_align_kernel

    grad32 = grad.float()
    got32 = roi_align_kernel.roi_align_avg_bwd(grad32, rois, feat_shape)
    parity(f"roi_align_avg_bwd {label}", torch.float32, got32,
           roi_align.roi_align_avg_backward(grad32, rois, feat_shape, torch.float32),
           BWD_F32_TOL)
    got = roi_align_kernel.roi_align_avg_bwd(grad, rois, feat_shape)
    err = parity(f"roi_align_avg_bwd {label}", torch.bfloat16, got,
                 roi_align.roi_align_avg_backward(grad, rois, feat_shape, torch.bfloat16),
                 ONE_BF16_STEP)
    same = (torch.equal(got32, roi_align_kernel.roi_align_avg_bwd(grad32, rois, feat_shape)),
            torch.equal(got, roi_align_kernel.roi_align_avg_bwd(grad, rois, feat_shape)))
    check(all(same), f"roi_align_avg_bwd {label}: two launches differ (f32, bf16 equal: {same})")
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
          f"{len(torch.unique(rois, dim=0))} distinct rois; gather by destination row (a CTA a "
          f"feature row x 256 channels, entries in roi order, sums in registers, no atomics, "
          f"no scratch): two launches bit-identical in f32 and bf16", flush=True)
    return r


@contextlib.contextmanager
def proposals_taken(model, store: list, replay: bool):
    """The train forward's proposal layer recorded into `store`, or with
    `replay` handed back from it in order; restored after."""
    propose = model._propose
    if replay:
        recorded = iter(store)
        model._propose = lambda *args, **kw: next(recorded)
    else:
        model._propose = lambda *args, **kw: store.append(propose(*args, **kw)) or store[-1]
    try:
        yield
    finally:
        del model._propose


def step_vs_plain(model, batch, state: dict, dtype, backbone: str = "resnet101",
                  clip_norm: float | None = None, same_proposals: bool = False,
                  gates: bool = False, hold: bool = True, nudge: bool = False,
                  exact: bool = False) -> tuple[list[str], dict]:
    """One train step from `state` with the kernels and one with their plain
    versions (same sampling and dropout seed): prints the four losses'
    relative gaps and the largest update gap of a trainable tensor (relative
    to its largest update); returns the bounds they break (none where
    `hold` is false) and the kernel run's metrics. In f32 a VGG-16 plain
    run takes the kernel run's max-pool routes and ReLU gates (`vgg_ties`),
    and with `gates` a ResNet plain run takes its ReLU gates
    (`resnet_ties`), where rounding decides them; each replayed decision
    must lie within TIE_SIZE_TOL of the other side. With `same_proposals`
    the plain run takes the kernel run's proposals (the proposal layer takes
    no gradient; its top-k and NMS over scores that rounding reorders decide
    which rois are sampled, where proposals overlap the gt boxes). With
    `nudge` both runs take the plain versions and the second's input is
    moved by one f32 step (x (1 + 2^-23)): no kernel at all, so the gaps are
    the comparison's own floor at `state`. With `exact` (f32) a third run
    takes the plain versions in f64 (the kernel run's proposals and gates),
    each run's largest update error against it is printed, and the kernel
    run's updates are held to TRAIN_UPDATE_TOL of that exact step instead
    of the plain f32 run's (whose own error is printed beside)."""
    from rlobjectdetection_tpu_torch.models.backbones import resnet_ties, vgg, vgg_ties

    model.dtype = model.base.dtype = dtype
    ties, counts = {}, None
    is_vgg = isinstance(model.base, vgg.VGGBase)
    if dtype == torch.float32 and (is_vgg or gates):
        counts = {}
        record = (vgg_ties.record(model.base, ties) if is_vgg
                  else resnet_ties.record(model, ties))
        replay = lambda c: (vgg_ties.replay(model.base, ties, c) if is_vgg
                            else resnet_ties.replay(model, ties, c))
    else:
        record, replay = contextlib.nullcontext(), lambda c: contextlib.nullcontext()
    proposals = []
    take = (lambda replay_: proposals_taken(model, proposals, replay_)) if same_proposals \
        else (lambda replay_: contextlib.nullcontext())
    with full_f32() if dtype == torch.float32 else contextlib.nullcontext():
        model.load_state_dict(state)
        with plain_train_path(model) if nudge else contextlib.nullcontext(), record, \
                take(False):
            got, got_up = one_train_step(model, batch, 9, backbone, clip_norm)
        model.load_state_dict(state)
        moved = dict(batch, data=batch["data"] * (1 + 2.0 ** -23)) if nudge else batch
        with plain_train_path(model), replay(counts), take(True):
            want, want_up = one_train_step(model, moved, 9, backbone, clip_norm)
        if exact:
            model.load_state_dict(state)
            model.dtype = model.base.dtype = torch.float64
            with plain_train_path(model), replay({}), take(True):
                ref_up = one_train_step(model, batch, 9, backbone, clip_norm)[1]
            model.dtype = model.base.dtype = dtype
    gaps = {k: abs(got[k] - want[k]) / abs(want[k]) for k in
            ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box")}
    gap = lambda ups, to: max((((ups[n] - to[n]).abs().max() / to[n].abs().max()).item(), n)
                              for n in to)
    up_rel, up_leaf = gap(got_up, want_up)
    held_rel, held_leaf = gap(got_up, ref_up) if exact else (up_rel, up_leaf)
    took = []
    if counts is not None and is_vgg:
        took.append(f"routes in {counts['pools']} pools (its own max at most "
                    f"{counts['routed']:.3e} of the layer's largest above the routed value)")
    if counts is not None:
        took.append(f"ReLU gates ({counts['flipped']} inputs' signs flipped, at most "
                    f"{counts['flipped_max']:.3e} of the layer's largest; bound "
                    f"{TIE_SIZE_TOL:.0e})")
    if same_proposals:
        took.append("proposals")
    print(f"train step {str(dtype)[6:]} ("
          f"{'plain vs plain on the input moved one step' if nudge else 'kernels vs plain versions'}"
          f"{'' if hold else '; printed, not held'}): losses "
          f"{[round(got[k], 6) for k in gaps]} vs {[round(want[k], 6) for k in gaps]}, "
          f"relative gaps {gaps} (bound {TRAIN_LOSS_TOL[dtype]:.1e}); fg/bg "
          f"{int(got['fg_cnt'])}/{int(got['bg_cnt'])} vs "
          f"{int(want['fg_cnt'])}/{int(want['bg_cnt'])}; largest update gap "
          f"{up_rel:.3e} of a leaf's max |update| ({up_leaf})"
          + (f"; the {'second run took the first' if nudge else 'plain run took the kernel run'}"
             f"'s {', '.join(took)}" if took else "")
          + (f"; against the f64 step the kernel run's largest update error is "
             f"{held_rel:.3e} ({held_leaf}), the plain run's {gap(want_up, ref_up)[0]:.3e}"
             if exact else ""),
          flush=True)
    failed = []
    if counts is not None and max(counts.get("routed", 0.0), counts["flipped_max"]) \
            > TIE_SIZE_TOL:
        failed.append(f"train step f32: a replayed decision was no tie: {counts}")
    if max(gaps.values()) > TRAIN_LOSS_TOL[dtype]:
        failed.append(f"train step {dtype}: loss gaps {gaps} > {TRAIN_LOSS_TOL[dtype]}")
    if dtype == torch.float32 and held_rel > TRAIN_UPDATE_TOL:
        failed.append(f"train step f32: update gap {held_rel:.3e} ({held_leaf}"
                      f"{', against the f64 step' if exact else ''}) > "
                      f"{TRAIN_UPDATE_TOL}")
    return (failed if hold else []), got


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
    # the rois a step samples after the three (16 fg + 240 bg), for the
    # backward kernel below
    with torch.no_grad():
        steady_rois = model(batch["data"], batch["im_info"], batch["gt_boxes"], train=True,
                            generator=torch.Generator(device=dev).manual_seed(7))["rois"]
    steady_rois = steady_rois.reshape(-1, 5).contiguous()

    model.load_state_dict(state0)
    print(f"train step stages ms: {train_stages(model, batch, seed=11)}", flush=True)

    # the backward kernel at the flagship's train shape, with the rois the
    # first step samples (the random net's: about 16 copies of each gt box)
    # and with those of a steady step, and at a small shape with rois over
    # the border
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
    results = {"roi_align_avg_bwd": roi_align_bwd_check(
                   "first-step R=256 C=1024", feat_shape, rois, grad, flush),
               "roi_align_avg_bwd steady": roi_align_bwd_check(
                   "steady R=256 C=1024", feat_shape, steady_rois, grad, flush)}
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
        failed += step_vs_plain(model, batch, state0, dtype)[0]
    model.dtype = model.base.dtype = torch.bfloat16
    check(not failed, "; ".join(failed))
    return results, launches


def vgg_train_path(vgg_state: dict) -> tuple[dict, dict]:
    """VGG-16's train step (blocks 1-2 frozen, fc6/fc7 dropout, clip 10):
    three bf16 steps at batch 2 with the block-1 and both RoIAlignAvg
    kernels' launches read over them, one step's stages, the block-1 and
    RoIAlignAvg forward kernels and the backward kernel at C=512 against
    their plain versions at the train step's shapes, and one step with the
    kernels against their plain versions in f32 and in bf16."""
    from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step
    from rlobjectdetection_tpu_torch.engine.serve import build_config
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.ops import roi_align_kernel, vgg_block1_kernel

    dev = torch.device("cuda")
    cfg = build_config("coco", ["DTYPE", "bfloat16"])
    check(cfg.CONV1_FUSED and cfg.POOLING_MODE == "align" and cfg.TRAIN.BATCH_SIZE == 128,
          f"vgg16 train config expected, got {cfg}")
    model = FasterRCNN(NUM_CLASSES, "vgg16", cfg, device=dev, seed=3)
    model.load_state_dict(vgg_state)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(dev)
    counters = {"vgg_block1": vgg_block1_kernel.fused_vgg_block1,
                "roi_align_avg": roi_align_kernel.roi_align_avg,
                "roi_align_avg_bwd": roi_align_kernel.roi_align_avg_bwd}
    opt, sched, labels = build_optimizer(model, "vgg16", base_lr=0.01, clip_norm=VGG_CLIP)
    step = make_train_step(model, opt, sched)
    gen = torch.Generator(device=dev).manual_seed(7)
    drop = torch.Generator(device=dev).manual_seed(8)
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"model: vgg16 train step, batch {TRAIN_BATCH} x {BLOB_SHAPE[1]}x{BLOB_SHAPE[2]}, "
          f"{n_train} trained parameters in {sum(v != 'frozen' for v in labels.values())} "
          f"tensors (blocks 1-2 frozen), fc6/fc7 dropout 0.5, SGD base_lr 0.01, clip "
          f"{VGG_CLIP}, compute {cfg.DTYPE}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    step_ms = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = step(batch, gen, drop)
        loss = float(metrics["loss"])                   # ends in a device sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
        parts = {k: float(metrics[k]) for k in ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box")}
        norm = float(opt.grad_norm)
        check(np.isfinite(loss) and all(np.isfinite(v) for v in parts.values())
              and np.isfinite(norm), f"vgg16 train step {i}: loss {loss} {parts}, norm {norm}")
        print(f"vgg16 train step {i}: {step_ms[-1]:.2f} ms, loss {loss:.5f} {parts}, fg_cnt "
              f"{int(metrics['fg_cnt'])}, bg_cnt {int(metrics['bg_cnt'])}, trainable gradients' "
              f"global norm before the clip {norm:.5f} "
              f"({'clipped' if norm > VGG_CLIP else 'not clipped'} at {VGG_CLIP})", flush=True)
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"vgg16 train path: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, step ms "
          f"{[round(v, 3) for v in step_ms]}, peak memory {peak} bytes, launches {launches}",
          flush=True)
    check(all(v == TRAIN_STEPS for v in launches.values()),
          f"vgg16 train: each kernel should launch once a step: {launches}")
    after = model.state_dict()
    frozen_moved = [k for k, v in after.items()
                    if labels.get(k, "frozen") == "frozen" and not torch.equal(v, state0[k])]
    check(not frozen_moved, f"vgg16 train: frozen tensors changed: {frozen_moved[:4]}")
    check(all(labels[k] == "frozen" for k in after if k.startswith(("base.conv1_", "base.conv2_"))),
          "vgg16 train: blocks 1-2 are not frozen")
    still = [k for k in after if k.startswith(("head.fc6", "head.fc7", "base.conv3_",
                                               "base.conv4_", "base.conv5_"))
             and torch.equal(after[k], state0[k])]
    check(not still, f"vgg16 train: trainable tensors did not move: {still[:4]}")
    del opt, sched, step
    with torch.no_grad():
        steady_rois = model(batch["data"], batch["im_info"], batch["gt_boxes"], train=True,
                            generator=torch.Generator(device=dev).manual_seed(7),
                            dropout=torch.Generator(device=dev).manual_seed(8))["rois"]
    steady_rois = steady_rois.reshape(-1, 5).contiguous()

    model.load_state_dict(state0)
    stages = train_stages(model, batch, 11, "vgg16", VGG_CLIP, names=(
        "base (block 1 kernel, blocks 2-5 cuDNN, blocks 1-2 frozen)",
        "head (roi_align_avg C=512, fc6/fc7 with dropout, classifiers, R-CNN losses)",
        "backward (roi_align_avg_bwd kernel C=512, fc6/fc7, conv3-5, RPN, classifiers)"))
    print(f"vgg16 train step stages ms: {stages}", flush=True)

    # the backward kernel at C=512 (two channel chunks a feature row), with
    # the first step's rois and a steady step's; the forward kernels first
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    model.load_state_dict(state0)
    with torch.no_grad():
        feat_shape = tuple(model.base(batch["data"]).shape)
        rois = model(batch["data"], batch["im_info"], batch["gt_boxes"], train=True,
                     generator=torch.Generator(device=dev).manual_seed(7),
                     dropout=torch.Generator(device=dev).manual_seed(8))["rois"]
    rois = rois.reshape(-1, 5).contiguous()
    check(feat_shape == (2, 50, 76, 512) and tuple(rois.shape) == (256, 5),
          f"vgg16 train head inputs {feat_shape} {tuple(rois.shape)}")
    # block 1 and the RoIAlignAvg forward at the shapes the train step gives
    # them: the batch-2 image, and the 256 sampled rois on both images'
    # [2, 50, 76, 512] features
    base = model.base
    w = (base.conv1_1.weight, base.conv1_1.bias, base.conv1_2.weight, base.conv1_2.bias)
    with torch.no_grad():
        data = batch["data"]
        for dtype in (torch.bfloat16, torch.float32):
            with full_f32() if dtype == torch.float32 else contextlib.nullcontext():
                parity(f"vgg_block1 train {tuple(data.shape)}", dtype,
                       vgg_block1_kernel.fused_vgg_block1(data, *w, dtype=dtype),
                       vgg_block1_kernel.vgg_block1_plain(data, *w, dtype=dtype),
                       VGG_BLOCK1_TOL[dtype])
        base_feat = base(data)
        results = {"roi_align_avg C=512 train": roi_align_check(
            "train R=256 C=512 [2,50,76,512]", base_feat, rois, flush,
            BF16_TOL["roi_align_avg C=512"])}
    del base_feat
    g = torch.Generator(device=dev).manual_seed(5)
    grad = torch.randn((256, 7, 7, 512), generator=g, device=dev).to(torch.bfloat16)
    results |= {"roi_align_avg_bwd C=512": roi_align_bwd_check(
                   "first-step R=256 C=512", feat_shape, rois, grad, flush),
               "roi_align_avg_bwd C=512 steady": roi_align_bwd_check(
                   "steady R=256 C=512", feat_shape, steady_rois, grad, flush)}
    del flush

    # the whole step, kernels against plain versions, from the first step's
    # parameters and draws (sampling and dropout from one seeded generator)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        failed += step_vs_plain(model, batch, state0, dtype, "vgg16", VGG_CLIP)[0]
    model.dtype = model.base.dtype = torch.bfloat16
    check(not failed, "; ".join(failed))
    return results, launches


TRAINVAL_IMAGES = 32          # 16 train + 16 valminusminival, flipped: 64 roidb entries
TRAINVAL_MINIVAL = 4
TRAINVAL_IMAGE_SIZE = (480, 640)                    # 800×1088 blobs at TRAIN.SCALES [800]
TRAINVAL_BLOB = (2, 800, 1088, 3)
TRAINVAL_NET = ("res101", "resnet101")
TRAINVAL_SET = ["TRAIN.SCALES", "[800]", "DTYPE", "bfloat16"]
TEST_SET = ["TEST.SCALES", "[800]", "DTYPE", "bfloat16"]
RESIDUAL_SCALE = 0.2
# foreground rois the CLI batch's kernels-vs-plain step must sample (of 256;
# the flagship's own weights sample 131 there): the head's box path and the
# RoIAlignAvg backward's foreground rows take part
CLI_MIN_FG = 64


def loop_rates(label: str, stats: dict, peak: int) -> str:
    n, wall, steady = stats["images"], stats["wall_s"], stats["steady_s"]
    return (f"{label}: epoch {stats['epoch']} {n / wall:.3f} images/s wall ({n} images, "
            f"{stats['steps']} steps, {wall:.3f} s, the loader in it), "
            f"{stats['steady_images'] / steady:.3f} images/s steady (the epoch's first step "
            f"dropped); host assembly {stats['assembly_ms_per_image']:.3f} ms an image (a "
            f"worker thread); the card waits {stats['wait_s']:.4f} s between steps "
            f"({100 * stats['wait_s'] / wall:.2f}% of the wall); checkpoint save "
            f"{stats['save_ms']:.1f} ms; peak memory {peak} bytes")


def calibrated_state(det_state: dict, cfg, backbone: str, batch: dict) -> dict:
    """`det_state` made to train as a pretrained net does: every frozen-BN
    mean and variance set from its input on `batch` (the eval forward of
    the plain modules in f32, each BN's statistics taken just before it
    runs), then each residual branch's last BN (`bn3`) scaled by
    RESIDUAL_SCALE, as a trained ResNet's branches are small against their
    identity path. With unit branches the features grow with each of the
    33 blocks and SGD at lr 0.01 turns the losses to NaN within an epoch
    (on the card, and at 256 px on the CPU within 3 steps); scaled, 16 CPU
    steps at 256 px go from 5.6 to 1.4."""
    from rlobjectdetection_tpu_torch.config import cfg_update
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.models.backbones.resnet import FrozenBatchNorm

    plain = cfg_update(cfg, {"CONV1_FUSED": False, "LAYER1_FUSED": False, "DTYPE": "float32"})
    model = FasterRCNN(NUM_CLASSES, backbone, plain, device=batch["data"].device)
    model.load_state_dict(det_state)

    def set_stats(bn, args):
        x = args[0].double()
        bn.mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.var.copy_(x.var(dim=(0, 2, 3)))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    with full_f32():
        model(batch["data"], batch["im_info"])
    for h in hooks:
        h.remove()
    return {k: v.detach().cpu() * (RESIDUAL_SCALE if k.endswith(("bn3.scale", "bn3.bias"))
                                   else 1.0) for k, v in model.state_dict().items()}


def cli_kernel_checks(model, batch, flush) -> dict:
    """The training CLI's kernels against their plain versions at its
    batch-8 shapes: the stem and layer1 on one of its [8, 800, 1088, 3]
    blobs, the whole C4 base, RoIAlignAvg on its features [8, 50, 68,
    1024] with the 8 x 128 rois the train forward samples, and the backward
    at the same shape and rois. Returns each kernel's largest bf16 (max abs,
    max rel)."""
    data, dev = batch["data"], batch["data"].device
    with torch.no_grad():
        errs = stem_layer1_parity(" (training CLI, 8x800x1088)", model.base, data)[0]
        base_check("training CLI, 8x800x1088", model.base, data, BASE_FEAT_TOL)
        feat = model.base(data)
        rois = model(data, batch["im_info"], batch["gt_boxes"], train=True,
                     generator=torch.Generator(device=dev).manual_seed(7))["rois"]
    rois = rois.reshape(-1, 5).contiguous()
    check(tuple(feat.shape) == (8, 50, 68, 1024) and tuple(rois.shape) == (1024, 5),
          f"training CLI head inputs {tuple(feat.shape)} {tuple(rois.shape)}")
    errs["roi_align_avg"] = roi_align_check("training CLI C=1024 B=8 R=1024", feat, rois, flush,
                                            BF16_TOL["roi_align_avg"])["err"]
    grad = torch.randn((1024, 7, 7, 1024), generator=torch.Generator(device=dev).manual_seed(5),
                       device=dev).to(torch.bfloat16)
    errs["roi_align_avg_bwd"] = roi_align_bwd_check(
        "training CLI B=8 R=1024 C=1024", tuple(feat.shape), rois, grad, flush)["err"]
    return errs


def trainval_path(det_state: dict) -> tuple[dict, dict]:
    """The training CLI (`engine/trainval_net.py`, called in process) on a
    synthetic COCO set made under `output/`: the flagship at batch 2 and at
    batch 8, two epochs each, the stem, layer1 and both RoIAlignAvg
    launch counts read over the batch-2 run; the kernels against their
    plain versions at the batch-8 run's shapes (`cli_kernel_checks`); one
    of the CLI's batch-2 batches, one step with the kernels against the
    same step with their plain versions (f32 and bf16); resume equality
    through `engine/resume_validate.py` (fresh processes under
    deterministic algorithms); `test_net --load_dir` on the epoch-2
    checkpoint against `Detector.detect`; `demo` over 3 images; the
    checkpoint's size and its save and load times. Returns the batch-2
    run's launches and each kernel's largest bf16 error at the batch-8
    shapes."""
    import io
    import os
    import pickle
    import shutil
    import tempfile

    from rlobjectdetection_tpu_torch.data.blob import read_image_bgr
    from rlobjectdetection_tpu_torch.data.imdb import combined_roidb
    from rlobjectdetection_tpu_torch.data.loader import RoiBatchLoader
    from rlobjectdetection_tpu_torch.data.synthetic import make_coco_dataset
    from rlobjectdetection_tpu_torch.engine import (build_optimizer, demo, resume_validate,
                                                    test_net, trainval_net)
    from rlobjectdetection_tpu_torch.engine.checkpoint import (load_checkpoint, read_checkpoint,
                                                               save_params)
    from rlobjectdetection_tpu_torch.engine.detect import detections_to_all_boxes
    from rlobjectdetection_tpu_torch.engine.serve import Detector, build_config
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.ops import layer1_kernel, roi_align_kernel, stem_kernel

    dev = torch.device("cuda")
    net, backbone = TRAINVAL_NET
    repo = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(repo, "output"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="trainval_path_", dir=os.path.join(repo, "output"))
    prev_root, cwd = os.environ.get("RLOD_DATA_DIR"), os.getcwd()
    try:
        classes = tuple(f"category{i:02d}" for i in range(1, NUM_CLASSES))
        splits = {"train": (TRAINVAL_IMAGES // 2, 1000), "valminusminival":
                  (TRAINVAL_IMAGES // 2, 2000), "minival": (TRAINVAL_MINIVAL, 3000)}
        files = {}
        for split, (n, first) in splits.items():
            path = make_coco_dataset(root, num_images=n, split=split,
                                     image_size=TRAINVAL_IMAGE_SIZE,
                                     classes=classes, seed=3, first_id=first)
            with open(path) as f:
                files[split] = {im["file_name"] for im in json.load(f)["images"]}
        check(not files["valminusminival"] & files["minival"],
              "the two val splits' image files collide")
        os.environ["RLOD_DATA_DIR"] = root
        save_dir = os.path.join(root, "models")

        # one of the CLI's own batches at each batch size (epoch 1's first),
        # and the flagship's weights with pretrained-like BN statistics, for
        # --pretrained
        cfg = build_config("coco", TRAINVAL_SET)
        with contextlib.redirect_stdout(io.StringIO()):
            _, roidb, ratio_list, ratio_index = combined_roidb(
                trainval_net.DATASET_MAP["coco"][0], training=True, use_flipped=True)

        def cli_batch(bs: int) -> dict:
            loader = RoiBatchLoader(roidb, ratio_list, ratio_index, bs, scales=cfg.TRAIN.SCALES,
                                    max_num_gt=cfg.MAX_NUM_GT_BOXES, seed=cfg.RNG_SEED)
            loader.set_epoch(1)
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in loader.assemble_job(loader.batch_plan()[0]).items()}
            check(tuple(b["data"].shape) == (bs, *TRAINVAL_BLOB[1:]),
                  f"the CLI's batch is {tuple(b['data'].shape)}")
            return b

        batch = cli_batch(2)
        calibrated = calibrated_state(det_state, cfg, backbone, batch)
        pretrained = save_params(os.path.join(root, "pretrained.pth"), calibrated)
        torch.cuda.empty_cache()
        counters = {"stem": stem_kernel.fused_stem, "layer1": layer1_kernel.fused_layer1,
                    "roi_align_avg": roi_align_kernel.roi_align_avg,
                    "roi_align_avg_bwd": roi_align_kernel.roi_align_avg_bwd}
        runs = {}
        for bs in (2, 8):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for f in counters.values():
                f.launches = 0
            with contextlib.redirect_stdout(io.StringIO()):
                result = trainval_net.main(
                    ["--dataset", "coco", "--net", net, "--bs", str(bs), "--epochs", "2",
                     "--lr", "0.01", "--nw", "4", "--s", str(bs), "--save_dir", save_dir,
                     "--pretrained", pretrained, "--set", *TRAINVAL_SET])
            peak = torch.cuda.max_memory_allocated()
            moved = {k: f.launches for k, f in counters.items()}
            steps = result["step"]
            check(steps == 2 * (2 * TRAINVAL_IMAGES // bs) and len(result["checkpoints"]) == 2,
                  f"trainval batch {bs}: {steps} steps, {result['checkpoints']}")
            check(all(n >= (3 if k == "layer1" else 1) * steps for k, n in moved.items()),
                  f"trainval batch {bs}: a kernel launched less than once a step: {moved}")
            ck = read_checkpoint(result["checkpoints"][-1])
            check(ck["step"] == steps and ck["epoch"] == 2 and ck["pooling_mode"] == "align"
                  and all(torch.isfinite(v).all() for v in ck["model"].values()),
                  f"trainval batch {bs}: checkpoint step {ck['step']}, epoch {ck['epoch']}")
            runs[bs] = result, moved, peak
            print(loop_rates(f"train loop batch {bs}", result["epochs"][1], peak)
                  + f"; launches over {steps} steps {moved}", flush=True)
        ckpt = runs[2][0]["checkpoints"][-1]

        # the kernels at the batch-8 run's shapes, on its epoch-2 weights
        model = FasterRCNN(NUM_CLASSES, backbone, cfg, device=dev)
        load_checkpoint(runs[8][0]["checkpoints"][-1], model)
        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
        errs = cli_kernel_checks(model, cli_batch(8), flush)
        del flush
        for path in runs[8][0]["checkpoints"]:
            os.remove(path)

        # one CLI batch-2 batch, one step with the kernels against the same
        # step with their plain versions (train_path's bounds), from the
        # flagship's own weights: 131 of the 256 rois foreground. Its
        # proposals overlap the gt boxes, so the plain run takes the kernel
        # run's (rounding reorders their scores); printed with that alone,
        # then with the kernel run's ReLU gates too (each replayed gate's
        # input within TIE_SIZE_TOL of 0) and held. In f32 the plain
        # versions' own rounding moves the updates by 1.2e-3 of their
        # largest here (on an H100), the kernels' by 1e-5, so the kernel
        # run's updates are held against the step in f64. Printed too, not
        # held: the comparison's floor with no kernel (the input moved one
        # f32 step) here and at the weights the CLI wrote, where one f32
        # step of a weight is ~2e-3 of its leaf's largest update
        step_vs_plain(model, batch, det_state, torch.float32, backbone, same_proposals=True,
                      hold=False)
        failed = []
        for dtype in (torch.float32, torch.bfloat16):
            broke, metrics = step_vs_plain(model, batch, det_state, dtype, backbone,
                                           same_proposals=True, gates=True,
                                           exact=dtype == torch.float32)
            failed += broke
            if metrics["fg_cnt"] < CLI_MIN_FG:
                failed.append(f"{dtype}: {int(metrics['fg_cnt'])} foreground rois sampled, "
                              f"under {CLI_MIN_FG}")
        trained = read_checkpoint(ckpt)["model"]
        for state, kw in ((det_state, {"nudge": True}), (trained, {"exact": True}),
                          (trained, {"nudge": True})):
            step_vs_plain(model, batch, state, torch.float32, backbone, same_proposals=True,
                          gates=True, hold=False, **kw)
        model.dtype = model.base.dtype = torch.bfloat16
        check(not failed, "CLI batch: " + "; ".join(failed))

        # the checkpoint: its bytes, and a load into fresh objects on the card
        opt, sched, _ = build_optimizer(model, backbone, 0.01)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = load_checkpoint(ckpt, model, opt, sched)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        check(meta["step"] == runs[2][0]["step"] and sched.last_epoch == meta["step"],
              f"checkpoint load: meta {meta}, schedule count {sched.last_epoch}")
        print(f"checkpoint: {os.path.getsize(ckpt)} bytes (params, frozen-BN statistics, "
              f"momentum), save {runs[2][0]['epochs'][1]['save_ms']:.1f} ms, load into a fresh "
              f"model, SGD and schedule on the card {load_ms:.1f} ms", flush=True)
        del model, opt, sched, batch
        torch.cuda.empty_cache()

        # resume equality: fresh processes under deterministic algorithms
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            res = resume_validate.main(
                ["--net", net, "--dataset", "coco", "--images", "8", "--image_size",
                 *map(str, TRAINVAL_IMAGE_SIZE), "--epochs", "2", "--bs", "2",
                 "--pretrained", pretrained,
                 "--work_dir", os.path.join(root, "resume"), "--set", *TRAINVAL_SET])
        print(text.getvalue().strip().splitlines()[-1], flush=True)
        check(res["ok"], f"resume: {res}")

        # test_net --load_dir on the epoch-2 checkpoint, in the data root
        os.chdir(root)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            test_net.main(["--dataset", "coco", "--net", net, "--load_dir", save_dir,
                           "--s", "2", "--checkepoch", "2", "--set", *TEST_SET])
        out = text.getvalue()
        check(f"(pooling_mode {ck['pooling_mode']})" in out, "test_net: pooling_mode not restored")
        table = [l for l in out.splitlines() if "Average Precision" in l or "Average Recall" in l]
        check(len(table) == 12, f"test_net: no COCOeval table in {out[-2000:]}")
        print("test_net --load_dir (epoch 2, batch 2 run):\n" + "\n".join(table), flush=True)
        with open(os.path.join(root, "output", net, "coco_2014_minival",
                               "detections.pkl"), "rb") as f:
            all_boxes = pickle.load(f)
        with contextlib.redirect_stdout(io.StringIO()):
            _, test_roidb, _, _ = combined_roidb("coco_2014_minival", training=False,
                                                 use_flipped=False)
        test_cfg = build_config("coco", TEST_SET)
        model = FasterRCNN(NUM_CLASSES, backbone, test_cfg, device=dev)
        load_checkpoint(ckpt, model)
        want = detections_to_all_boxes(
            [Detector(model, test_cfg, dev).detect(read_image_bgr(test_roidb[0]["image"]))],
            NUM_CLASSES)
        same = all(np.array_equal(all_boxes[j][0], want[j][0]) for j in range(NUM_CLASSES))
        n_det = sum(len(want[j][0]) for j in range(NUM_CLASSES))
        print(f"test_net --load_dir image 0 vs Detector.detect on the checkpoint's weights: "
              f"{'equal to the bit' if same else 'differ'} ({n_det} detections)", flush=True)
        check(same and n_det > 0, "test_net's detections differ from Detector.detect's")
        del model

        # demo over 3 of the minival images
        demo_in, demo_out = os.path.join(root, "demo_in"), os.path.join(root, "demo_out")
        os.makedirs(demo_in)
        for e in test_roidb[:3]:
            shutil.copy(e["image"], demo_in)
        with contextlib.redirect_stdout(io.StringIO()):
            dets = demo.main(["--net", net, "--image_dir", demo_in, "--out_dir", demo_out,
                              "--load_name", ckpt, "--set", "ANCHOR_SCALES", "(4,8,16,32)",
                              *TEST_SET])
        drawn = sorted(os.listdir(demo_out))
        check(len(drawn) == 3 and all(n.endswith("_det.jpg") for n in drawn)
              and all(os.path.getsize(os.path.join(demo_out, n)) > 0 for n in drawn),
              f"demo wrote {drawn}")
        print(f"demo: {drawn}, {[int(d[3].sum()) for d in dets.values()]} valid detections",
              flush=True)
        return runs[2][1], errs
    finally:
        os.chdir(cwd)
        if prev_root is None:
            os.environ.pop("RLOD_DATA_DIR", None)
        else:
            os.environ["RLOD_DATA_DIR"] = prev_root
        shutil.rmtree(root, ignore_errors=True)


def roi_mode_vs_cpu(label, op, feat: torch.Tensor, rois: torch.Tensor) -> None:
    """`op(features, rois)` on the card against the same function on a CPU
    copy, in f32: the output and the features' gradient for a random
    cotangent, 1e-5 of the largest (the gathers' gradients sum in other
    orders on the card)."""
    f = feat.float().detach().requires_grad_(True)
    out = op(f, rois)
    ct = torch.randn(out.shape, generator=torch.Generator(device=f.device).manual_seed(3),
                     device=f.device)
    out.backward(ct)
    fc = f.detach().cpu().requires_grad_(True)
    out_cpu = op(fc, rois.cpu())
    out_cpu.backward(ct.cpu())
    check(float(fc.grad.abs().max()) > 0, f"{label}: zero gradient")
    parity(f"{label} forward (card vs CPU)", torch.float32, out.detach().cpu(), out_cpu.detach(),
           ROI_MODE_TOL)
    parity(f"{label} gradient (card vs CPU)", torch.float32, f.grad.cpu(), fc.grad, ROI_MODE_TOL)


def roi_modes_path(det_state: dict, images) -> dict:
    """The flagship with POOLING_MODE pool, then crop (plain PyTorch on the
    card: XLA in JAX, no TPU kernel): three requests, one request's stages,
    two train steps (the first samples gt rois only, the second mixed
    proposals), the op on the card against the CPU at a request's and at
    the second step's rois, and its times at the request's and the train
    step's shapes. Returns {mode: times}."""
    from rlobjectdetection_tpu_torch.engine import build_optimizer, make_train_step
    from rlobjectdetection_tpu_torch.engine.serve import Detector, build_config
    from rlobjectdetection_tpu_torch.models import FasterRCNN
    from rlobjectdetection_tpu_torch.ops import layer1_kernel, roi_crop, roi_pool, stem_kernel

    dev = torch.device("cuda")
    ops = {"pool": lambda f, r: roi_pool.roi_pool(f, r, 7, 7, 1.0 / 16.0),
           "crop": lambda f, r: roi_crop.roi_crop(f, r, 14, 1.0 / 16.0, max_pool=True)}
    counters = {"stem": stem_kernel.fused_stem, "layer1": layer1_kernel.fused_layer1}
    batch = train_batch(dev)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    times = {}
    for mode, op in ops.items():
        cfg = build_config("coco", ["TEST.SCALES", "[800]", "DTYPE", "bfloat16",
                                    "POOLING_MODE", mode])
        check(cfg.POOLING_MODE == mode and cfg.CROP_RESIZE_WITH_MAX_POOL and cfg.POOLING_SIZE == 7,
              f"{mode} config expected, got {cfg}")
        model = FasterRCNN(NUM_CLASSES, "resnet101", cfg, device=dev, seed=3)
        model.load_state_dict(det_state)
        detector = Detector(model, cfg, dev)
        serve_requests(f"{mode} mode", detector, images, counters)
        data, info = request_stages(f"{mode} mode", detector, images[0], "base (stem, layer1-3)",
                                    f"head (roi_{mode}, layer4, classifiers)")
        with torch.no_grad():
            feat = model.base(data, fwd_only=True)
            rois = model.proposals(feat, info)[0].reshape(-1, 5).contiguous()
        roi_mode_vs_cpu(f"roi_{mode} request R={rois.shape[0]}", op, feat, rois)
        request_ms = time_ms(lambda: op(feat, rois), flush)
        with torch.no_grad():
            request_bytes = nbytes(feat, rois, op(feat, rois))

        state0 = {k: v.clone() for k, v in model.state_dict().items()}
        opt, sched, labels = build_optimizer(model, "resnet101", base_lr=0.01)
        step = make_train_step(model, opt, sched)
        gen = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for i in range(2):
            t0 = time.perf_counter()
            metrics = step(batch, gen)
            loss = float(metrics["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(loss), f"{mode} train step {i}: loss {loss}")
            print(f"{mode} mode train step {i}: {step_ms[-1]:.2f} ms, loss {loss:.5f}, fg_cnt "
                  f"{int(metrics['fg_cnt'])}, bg_cnt {int(metrics['bg_cnt'])}", flush=True)
        peak = torch.cuda.max_memory_allocated()
        after = model.state_dict()
        still = [k for k, v in labels.items() if v != "frozen" and torch.equal(after[k], state0[k])]
        moved = [k for k, v in labels.items() if v == "frozen" and not torch.equal(after[k],
                                                                                 state0[k])]
        check(not still and not moved, f"{mode} train: unmoved {still[:4]}, moved {moved[:4]}")
        print(f"{mode} mode train path: 2 steps at batch {TRAIN_BATCH}, step ms "
              f"{[round(v, 3) for v in step_ms]}, peak memory {peak} bytes", flush=True)
        del opt, sched, step
        # the rois of a step after the two (mixed proposals), on its features
        with torch.no_grad():
            feat = model.base(batch["data"])
            out = model(batch["data"], batch["im_info"], batch["gt_boxes"], train=True,
                        generator=torch.Generator(device=dev).manual_seed(7))
        rois = out["rois"].reshape(-1, 5).contiguous()
        labels_ = out["rois_label"].reshape(-1)
        print(f"{mode} mode steady rois: {int((labels_ > 0).sum())} fg, "
              f"{int((labels_ == 0).sum())} bg", flush=True)
        # pool's CPU copy takes seconds a chunk of 16 rois: 32 of each image's
        sub = torch.cat([rois[:32], rois[128:160]]) if mode == "pool" else rois
        roi_mode_vs_cpu(f"roi_{mode} train R={sub.shape[0]} (steady rois, both images)", op,
                        feat, sub)
        feat_g = feat.detach().requires_grad_(True)
        ct = torch.randn(op(feat, rois).shape, device=dev).to(feat.dtype)
        # bounds in bytes: each input read once, each output written once
        times[mode] = dict(
            request_ms=request_ms, train_fwd_bwd_ms=time_ms(
                lambda: op(feat_g, rois).backward(ct), flush, reps=5),
            request_bound_ms=bound(request_bytes, 0, BF16_TENSOR_FLOPS)[0],
            train_bound_ms=bound(nbytes(feat, rois, ct, ct, feat), 0, BF16_TENSOR_FLOPS)[0])
        print(f"roi_{mode} (plain PyTorch on the card, bf16): request R=300 on "
              f"[1,50,76,1024] forward {request_ms:.4f} ms (bound "
              f"{times[mode]['request_bound_ms']:.4f}, bytes); train R=256 on [2,50,76,1024] "
              f"forward + backward {times[mode]['train_fwd_bwd_ms']:.4f} ms (bound "
              f"{times[mode]['train_bound_ms']:.4f}, bytes)", flush=True)
        del model, detector, feat, feat_g, out, state0
        torch.cuda.empty_cache()
    return times


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
    from rlobjectdetection_tpu_torch.ops import (layer1_kernel, res_stage_kernel,
                                                 roi_align_kernel, stem_kernel,
                                                 vgg_block1_kernel)
    for dtype in (torch.bfloat16, torch.float32):
        print(f"launch resources {str(dtype)[6:]} (registers a thread, shared memory bytes a "
              f"CTA, CTAs an SM, spill bytes a thread, as the runtime reports them; for the "
              f"residual stage also its grid at batch 1, CTAs a cluster and CTAs the card runs "
              f"at once): stem {stem_kernel.stem_info(dtype)}, layer1 "
              f"{layer1_kernel.layer1_info(dtype)}, vgg_block1 "
              f"{vgg_block1_kernel.vgg_block1_info(dtype)}, res_stage "
              f"{res_stage_kernel.res_stage_info(dtype)}, roi_align_avg_bwd "
              f"{roi_align_kernel.roi_align_bwd_info(dtype)}", flush=True)

    # 3. the two served detectors, one after the other (the first freed
    # before the second, so each path's peak memory is its own)
    cfg = build_config("coco", ["TEST.SCALES", "[800]", "DTYPE", "bfloat16"])
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.float32) for h, w in IMAGE_SIZES]
    results, launches, det_state = flagship(cfg, images)
    torch.cuda.empty_cache()
    eval_launches, eval_errs = eval_path(cfg, det_state)
    vgg_results, vgg_launches, vgg_state = vgg16(cfg, images)
    torch.cuda.empty_cache()

    # 4. the RL refinement net, warm-started from the flagship
    rl_results, rl_launches = rl_net(det_state)
    torch.cuda.empty_cache()

    # 4b. the RL CLI: ΔIoU dataset, train, checkpoint, eval at both wires,
    # resume, the kernels at its f32 shapes
    t0 = time.perf_counter()
    rl_cli_launches, rl_cli_errs = rl_cli_path(det_state)
    print(f"rl cli phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # 5. the detector's train step, from the flagship's weights
    train_results, train_launches = train_path(det_state)
    torch.cuda.empty_cache()

    # 6. VGG-16's train step, from the served VGG-16's weights
    vgg_train_results, vgg_train_launches = vgg_train_path(vgg_state)
    del vgg_state
    torch.cuda.empty_cache()

    # 7. the training CLI: train, checkpoint, resume, test_net, demo
    t0 = time.perf_counter()
    cli_launches, cli_errs = trainval_path(det_state)
    print(f"trainval phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # 8. the flagship in the pool and crop modes
    mode_times = roi_modes_path(det_state, images)

    # 9. the kernels line: launches over both detectors' requests, over the
    # RL path's requests and train steps for the residual stage, over both
    # detectors' train steps (block 1, RoIAlignAvg and its backward) and
    # over the training CLI's batch-2 steps
    roi_launches = (launches["roi_align_avg"] + eval_launches["roi_align_avg"]
                    + vgg_launches["roi_align_avg"] + vgg_train_launches["roi_align_avg"]
                    + cli_launches["roi_align_avg"])
    for k, e in eval_errs.items():                # the largest error over both shapes
        results[k]["err"] = tuple(map(max, results[k]["err"], e))
    results["vgg_block1"] = vgg_results["vgg_block1"]
    results["res_stage"] = rl_results["res_stage"]
    roi_rl = rl_results.pop("roi_align_avg C=1024 R=64")
    results["roi_align_avg_bwd"] = train_results["roi_align_avg_bwd"]
    for k, e in cli_errs.items():                 # and at the training CLI's batch 8
        results[k]["err"] = tuple(map(max, results[k]["err"], e))
    for k, e in rl_cli_errs.items():              # and at the RL CLI's f32 shapes
        results[k]["err"] = tuple(map(max, results[k]["err"], e))
    bwd_steady = train_results["roi_align_avg_bwd steady"]
    launches = dict(launches,
                    stem=(launches["stem"] + eval_launches["stem"] + cli_launches["stem"]
                          + rl_cli_launches["stem"]),
                    layer1=(launches["layer1"] + eval_launches["layer1"] + cli_launches["layer1"]
                            + rl_cli_launches["layer1"]),
                    roi_align_avg=roi_launches + rl_cli_launches["roi_align_avg"],
                    res_stage=rl_launches["res_stage"] + rl_cli_launches["res_stage"],
                    vgg_block1=vgg_launches["vgg_block1"] + vgg_train_launches["vgg_block1"],
                    roi_align_avg_bwd=(train_launches["roi_align_avg_bwd"]
                                       + vgg_train_launches["roi_align_avg_bwd"]
                                       + cli_launches["roi_align_avg_bwd"]))
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
    in_eval = f"the eval loop's {EVAL_IMAGES} images at batch 1 and at batch 2"
    in_cli = f"the training CLI's {2 * TRAINVAL_IMAGES} steps at batch 2"
    in_rl_cli = (f"the RL CLI's {RL_CLI_IMAGES} f32 train steps and 2 evals of "
                 f"{RL_CLI_IMAGES} images at batch 2")
    where = {"stem": f"in 3 requests, {in_eval}, {in_cli} and {in_rl_cli}",
             "layer1": f"in 3 requests, {in_eval}, {in_cli} and {in_rl_cli}",
             "roi_align_avg": f"in 6 requests, {in_eval}, {TRAIN_STEPS} vgg16 train steps, "
                              f"{in_cli} and {in_rl_cli}",
             "vgg_block1": f"in 3 vgg16 requests and {TRAIN_STEPS} vgg16 train steps",
             "res_stage": f"in 3 RL requests, 3 RL train steps and {in_rl_cli} (layer2 + "
                          f"layer3)",
             "roi_align_avg_bwd": f"in {TRAIN_STEPS} resnet101 and {TRAIN_STEPS} vgg16 "
                                  f"train steps and {in_cli}"}
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
    report("roi_align_avg_bwd", bwd_steady, f"{train_launches['roi_align_avg_bwd']} in "
           f"{TRAIN_STEPS} resnet101 train steps", "roi_align_avg_bwd steady rois")
    for label, r in vgg_train_results.items():
        name = label.split()[0]
        report(name, r, f"{vgg_train_launches[name]} in {TRAIN_STEPS} vgg16 train steps", label)
    print(f"detector train path launches over {TRAIN_STEPS} steps: {train_launches}; vgg16 "
          f"train path: {vgg_train_launches}; training CLI at batch 2: {cli_launches}; RL CLI: "
          f"{rl_cli_launches}", flush=True)
    print(f"roi modes (plain PyTorch, no kernel; bf16): {mode_times}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
