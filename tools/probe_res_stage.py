"""Where the bf16 residual-stage kernel's time goes, on an H100.

    python tools/probe_res_stage.py

Builds `csrc/res_stage.cu` as it is and three variants of it, each with a
part of the work taken out: `no_products` (the wgmma products replaced by
one register operation on the A fragments), `no_copies` (no weight stage
is copied and no consumer waits for one: the products read whatever the
ring holds), `neither` (both). Each variant runs layer2 (4 blocks,
`[1,100,152,256]`) and 6 blocks of layer3 (`[1,50,76,512]`) with seeded
random weights, timed with CUDA events (median of 20, L2 flushed before
each). Only `full` computes the stage; the others are timings. Prints the
card's name and power limit first and one line per variant and stage.
Needs a CUDA device and nvcc (`_build`'s flags).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rlobjectdetection_tpu_torch.models.backbones.resnet import ResLayer  # noqa: E402
from rlobjectdetection_tpu_torch.ops import _build  # noqa: E402
from rlobjectdetection_tpu_torch.ops import res_stage_kernel as rk  # noqa: E402

PRODUCTS = ("      wg::mma_m64n128k16(acc, cur[kk], wg::desc_sw128(slot[0] + kk * 32));",
            "      wg::mma_m64n64k16(acc[0], cur[kk], wg::desc_sw128(slot[0] + kk * 32));")
NO_PRODUCT = "      acc[0][0] += __uint_as_float(cur[kk].r[0] ^ slot[0]);"
COPIES = (("    for (int c = c0; c < c1; ++c) {", "    for (int c = c0; c < c0; ++c) {"),
          ("      wg::mbar_wait(r.full + 8 * (c % S), (c / S) & 1);\n", ""))


def _patch(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"probe_res_stage: the kernel no longer has {old.strip()!r}")
        src = src.replace(old, new)
    return src


def variants() -> dict[str, str]:
    full = (_build.CSRC / "res_stage.cu").read_text()
    no_products = _patch(full, [(p, NO_PRODUCT) for p in PRODUCTS])
    return {"full": full, "no_products": no_products, "no_copies": _patch(full, COPIES),
            "neither": _patch(no_products, COPIES)}


def build(sources: dict[str, str]) -> dict:
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        (out / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).rlod_res_stage_block_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_res_stage: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    fns = build(variants())
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    torch.manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    for name, cin, width, blocks, shape in (("layer2", 256, 128, 4, (1, 100, 152, 256)),
                                            ("layer3", 512, 256, 6, (1, 50, 76, 512))):
        layer = ResLayer(cin, width, blocks, 1).requires_grad_(False).to(dev)
        packed = rk.packed_res_stage(layer, blocks, width, bf16, dev)
        x = torch.rand(shape, device=dev).to(bf16)
        want = rk.launch_res_stage(x, packed, bf16)
        bufs = [torch.empty(*shape[:3], 4 * width, dtype=bf16, device=dev) for _ in range(2)]
        stream = torch.cuda.current_stream().cuda_stream
        for variant, fn in fns.items():
            def run():
                xi = x
                for i, pk in enumerate(packed):
                    _build.check(fn(xi.data_ptr(), pk["stream"].data_ptr(), pk["b1"].data_ptr(),
                                    pk["b2"].data_ptr(), pk["b3"].data_ptr(),
                                    int(pk["wd"] is not None), bufs[i % 2].data_ptr(),
                                    *xi.shape[:3], xi.shape[-1], width, stream), variant)
                    xi = bufs[i % 2]
                return xi
            for _ in range(3):
                got = run()
            torch.cuda.synchronize()
            times = []
            for _ in range(20):
                flush.zero_()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms = statistics.median(times)
            print(f"{name} {variant}: {ms:.4f} ms for {blocks} blocks, "
                  f"{ms / blocks * 1e3:.1f} us a block"
                  + (f", equal to launch_res_stage {torch.equal(got, want)}"
                     if variant == "full" else ""), flush=True)


if __name__ == "__main__":
    main()
