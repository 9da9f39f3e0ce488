"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into its own
shared library with a plain C interface, and bound with ctypes: pointers and
the stream pass as `c_void_p`, ints as `c_int`. Nothing includes PyTorch's
headers, so a build takes seconds. Libraries go into
`rlobjectdetection_tpu_torch/build/` (ignored by git) at first use, named by
a hash of the sources and flags, so an edited source is rebuilt. A failed
build raises with nvcc's output; every C entry point returns
`cudaGetLastError()` and `check()` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
KERNELS = ("stem", "layer1", "roi_align", "vgg_block1", "res_stage", "nms", "roi_align_levels",
           "frozen_bn_act", "image_blob")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, dict]:
    """Compile the named kernels that are not built yet, one nvcc process per
    source, all started together. Returns {name: seconds} for the ones
    compiled; raises RuntimeError with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, target, t0) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
        report[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def dtype_code(dtype) -> int:
    """The C side's code for a torch dtype (RLOD_F32 / RLOD_BF16 in common.cuh)."""
    return DTYPE_CODES[str(dtype).removeprefix("torch.")]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
