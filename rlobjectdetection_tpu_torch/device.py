"""Device selection shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch

from .utils import tracing


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; without a GPU
    that raises, so a CPU run is always one the caller asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """cfg.DTYPE → torch dtype (the JAX package's `bfloat16` / `float32`)."""
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise ValueError(f"unsupported DTYPE {name!r}")


def pageable_to(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`, copied from pageable memory;
    off the CPU the copy's bytes count to `h2d.pageable_bytes`."""
    t = torch.from_numpy(arr)
    if device.type != "cpu":
        tracing.count("h2d.pageable_bytes", t.nbytes)
    return t.to(device)
