"""Where the bf16 VGG block-1 kernel's time goes, on an H100.

    python tools/probe_vgg_block1.py

Builds `csrc/vgg_block1.cu` as it is and variants of it:

  * `no_conv12_products`: the consumers' conv1_2 wgmma products replaced by
    one register operation on their A fragments;
  * `no_conv11_products`: the producers' conv1_1 products replaced likewise;
  * `no_patch_loads`: no input patch is copied (conv1_1 reads whatever the
    buffer holds);
  * `phases`: the full kernel with a clock read at each step of a tile;
    after its timing, one launch's cycles are printed as shares, for the
    producer warpgroups (waiting for their patch, waiting for a free conv1_1
    tile buffer, conv1_1) and for the consumers (waiting for a full buffer,
    conv1_2 with its pool epilogue, waiting for the staged tile, stores).

Each runs the main path's shape, `[1, 800, 1216, 3]` f32 → `[1, 400, 608,
64]` bf16, on seeded random weights packed once, timed as a CUDA graph of
one launch with CUDA events (median of 50, the 50 MB L2 flushed before
each). Only `full` computes the block; the others are timings. Prints the
card's name and power limit first and one line per variant. Needs a CUDA
device and nvcc (`_build`'s flags).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rlobjectdetection_tpu_torch.ops import _build  # noqa: E402
from rlobjectdetection_tpu_torch.ops import vgg_block1_kernel as vk  # noqa: E402
from chip_smoke import graph_ms  # noqa: E402

CONV12 = [("        wg::mma_m64n64k16(acc, a[tap & 1][kk],\n"
           "                          wg::desc_sw128(w2_s + tap * wg::STAGE_BYTES + 32 * kk));\n",
           "        acc[0] += __uint_as_float(a[tap & 1][kk].r[0]);\n")]
CONV11 = [("      wg::mma_m64n64k16(acc, a[i & 1][kk], wg::desc_sw128(w1_s + 32 * kk));\n",
           "      acc[0] += __uint_as_float(a[i & 1][kk].r[0]);\n")]
PATCH = [("    cp_async_zfill<static_cast<int>(2 * sizeof(TIn))>(xs + r * ROW + (e - e0), src, ok);"
          "\n", "    (void)src;\n")]
# clock64() at each step of a tile, summed per warpgroup role
PHASES = [("#include \"wgmma.cuh\"\n",
           "#include \"wgmma.cuh\"\n__device__ unsigned long long g_phase[7];\n"),
          ("      const Tile tl(tile, tiles_x, tiles_img);\n      cp_async_wait_all();\n",
           "      const Tile tl(tile, tiles_x, tiles_img);\n      const long long c0 = clock64();\n"
           "      cp_async_wait_all();\n"),
          ("      if (k >= 2) bar_sync(BAR_EMPTY + (k & 1), NTHREADS);\n",
           "      const long long c1 = clock64();\n"
           "      if (k >= 2) bar_sync(BAR_EMPTY + (k & 1), NTHREADS);\n"
           "      const long long c2 = clock64();\n"),
          ("      bar_arrive(BAR_FULL + (k & 1), NTHREADS);\n",
           "      bar_arrive(BAR_FULL + (k & 1), NTHREADS);\n"
           "      if ((threadIdx.x & 127) == 0) {\n"
           "        atomicAdd(&g_phase[0], c1 - c0);\n"
           "        atomicAdd(&g_phase[1], c2 - c1);\n"
           "        atomicAdd(&g_phase[2], clock64() - c2);\n      }\n"),
          ("    bar_sync(BAR_FULL + (k & 1), NTHREADS);   // y1(k) is written\n",
           "    const long long d0 = clock64();\n"
           "    bar_sync(BAR_FULL + (k & 1), NTHREADS);\n    const long long d1 = clock64();\n"),
          ("    bar_sync(BAR_CONS, CONS_THREADS);   // the pooled tile is staged\n",
           "    const long long d2 = clock64();\n    bar_sync(BAR_CONS, CONS_THREADS);\n"
           "    const long long d3 = clock64();\n"),
          ("            *reinterpret_cast<const uint4*>(os + cell * LDO + part * 8);\n    }\n",
           "            *reinterpret_cast<const uint4*>(os + cell * LDO + part * 8);\n    }\n"
           "    if ((threadIdx.x & 127) == 0) {\n"
           "      const long long d[5] = {d0, d1, d2, d3, clock64()};\n"
           "      for (int i = 0; i < 4; ++i) atomicAdd(&g_phase[3 + i], d[i + 1] - d[i]);\n"
           "    }\n"),
          ("// Launch resources of the kernel for dtype",
           "extern \"C\" int probe_phases(unsigned long long* out) {\n"
           "  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n"
           "  const unsigned long long z[7] = {};\n"
           "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n"
           "  return static_cast<int>(e);\n}\n\n// Launch resources of the kernel for dtype")]
PRODUCER_PHASES = ("wait for the patch", "wait for a free conv1_1 buffer", "conv1_1")
CONSUMER_PHASES = ("wait for a full conv1_1 buffer", "conv1_2 and pool", "wait for the staged tile",
                   "stores")

def _patch(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"probe_vgg_block1: the kernel no longer has {old.strip()!r}")
        src = src.replace(old, new)
    return src


def variants() -> dict[str, str]:
    full = (_build.CSRC / "vgg_block1.cu").read_text()
    return {"full": full, "no_conv12_products": _patch(full, CONV12),
            "no_conv11_products": _patch(full, CONV11), "no_patch_loads": _patch(full, PATCH),
            "phases": _patch(full, PHASES)}


def build(sources: dict[str, str]) -> dict:
    out = _build.BUILD_DIR / "probe_vgg"
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
        fn = ctypes.CDLL(str(out / f"{name}.so")).rlod_vgg_block1_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fns[name] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_vgg_block1: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    fns = build(variants())
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    x = t(rng.randn(1, 800, 1216, 3) * 50)
    w = (t(rng.randn(64, 3, 3, 3) * 0.1), t(rng.randn(64) * 0.1),
         t(rng.randn(64, 64, 3, 3) * 0.03), t(rng.randn(64) * 0.1))
    packed = vk.packed_vgg_block1(*w, bf16, dev)
    want = vk.launch_vgg_block1(x, packed, bf16)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    for name, fn in fns.items():
        def run():
            out = torch.empty_like(want)
            _build.check(fn(x.data_ptr(), 0, None, packed["b1"].data_ptr(),
                            packed["w"].data_ptr(), packed["b2"].data_ptr(), out.data_ptr(), 1,
                            1, 800, 1216, torch.cuda.current_stream().cuda_stream), name)
            return out
        got = run()
        torch.cuda.synchronize()
        ms = graph_ms(run, flush, reps=50)
        print(f"vgg_block1 {name}: {ms:.4f} ms"
              + (f", equal to launch_vgg_block1 {torch.equal(got, want)}" if name == "full"
                 else ""), flush=True)
        if name == "phases":   # one launch's cycles, summed over warpgroups and tiles
            read = ctypes.CDLL(str(_build.BUILD_DIR / "probe_vgg" / "phases.so")).probe_phases
            read.restype, read.argtypes = ctypes.c_int, [ctypes.c_void_p]
            cycles = (ctypes.c_ulonglong * 7)()
            _build.check(read(cycles), "probe_phases")   # clears what the timing added
            run()
            torch.cuda.synchronize()
            _build.check(read(cycles), "probe_phases")
            for role, names, c in (("producers", PRODUCER_PHASES, cycles[:3]),
                                   ("consumers", CONSUMER_PHASES, cycles[3:])):
                print(f"vgg_block1 phases, {role} (share of their cycles): " + ", ".join(
                    f"{n} {v / sum(c):.1%}" for n, v in zip(names, c)), flush=True)


if __name__ == "__main__":
    main()
