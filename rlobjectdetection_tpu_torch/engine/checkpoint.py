"""Weight bridge from the JAX package's flat param dump to the port.

`rlobjectdetection_tpu/engine/checkpoint.py::save_net_npz` writes one array
per param path, e.g. `base/layer1/block0/conv1/kernel` `[1, 1, 64, 64]`,
`head/layer4/block0/bn3/var`, `rpn/RPN_Conv/bias`, `RCNN_cls_score/kernel`
`[2048, 81]`. The port's modules carry the same names, so a key maps by
`/` → `.` and `kernel` → `weight`; conv kernels go HWIO → OIHW and dense
kernels `[in, out]` → `[out, in]`; BN scale/bias/mean/var are buffers, or
for the RL net's layer4 (`RLPolicyNet`, whose BN affine trains) scale/bias
are parameters under the same keys. The fused and plain stems and stages
share one param tree, so one mapping serves both.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def torch_key(jax_key: str) -> str:
    """`base/conv1/kernel` → `base.conv1.weight`."""
    parts = jax_key.split("/")
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def _torch_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)   # HWIO → OIHW
    if arr.ndim == 2:
        return arr.T                        # [in, out] → [out, in]
    return arr


def state_dict_from_jax(flat: dict[str, np.ndarray],
                        model: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Flat JAX params → a state dict of f32 CPU tensors. With `model`, the
    key set and every shape must match its state dict exactly: a missing or
    an extra key raises KeyError, a wrong shape ValueError."""
    sd = {torch_key(k): torch.from_numpy(np.array(
        _torch_layout(np.asarray(v, dtype=np.float32)), order="C")) for k, v in flat.items()}
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(sd))
        extra = sorted(set(sd) - set(want))
        if missing or extra:
            raise KeyError(f"param keys differ from the model: missing {missing[:8]} "
                           f"({len(missing)}), extra {extra[:8]} ({len(extra)})")
        for k, v in sd.items():
            if tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} vs the model's "
                                 f"{tuple(want[k].shape)}")
    return sd


def load_net_npz(path: str, model: nn.Module) -> nn.Module:
    """Load a `save_net_npz` dump into `model` (every key, exactly)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    model.load_state_dict(state_dict_from_jax(flat, model))
    return model
