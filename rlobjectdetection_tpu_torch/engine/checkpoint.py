"""Torch checkpoints, converted weights, and the weight bridge from the JAX
package's flat param dump to the port.

`save_checkpoint` writes the reference's payload (session, epoch, model,
optimizer, pooling_mode, class_agnostic; `RCNN_bases/trainval_net.py`)
plus the global step and the schedule's count, as one `torch.save` file
renamed into place; `load_checkpoint` restores into whatever it is given
(`weights_only=True`). `save_params` / `load_params` hold a bare state
dict (`engine/convert_torch_weights.py`'s output). Loads copy in place, so
the fused kernels' pack caches (keyed on each weight's version) pack again.

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

import os

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
        check_state_dict(sd, model)
    return sd


def check_state_dict(sd: dict, model: nn.Module) -> None:
    """The key set and every shape of `sd` must be `model`'s: a missing or
    an extra key raises KeyError, a wrong shape ValueError."""
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


def load_net_npz(path: str, model: nn.Module) -> nn.Module:
    """Load a `save_net_npz` dump into `model` (every key, exactly)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    model.load_state_dict(state_dict_from_jax(flat, model))
    return model


def checkpoint_path(save_dir: str, net: str, dataset: str, session: int, epoch: int) -> str:
    """`<save_dir>/<net>/<dataset>/faster_rcnn_<session>_<epoch>.pth`."""
    return os.path.join(save_dir, net, dataset, f"faster_rcnn_{session}_{epoch}.pth")


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _save(obj, path: str) -> None:
    """torch.save to a temporary name, then renamed into place: a killed run
    leaves the old file or none, never half of one."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(path: str, model: nn.Module, opt=None, sched=None, *, session: int = 1,
                    epoch: int = 0, step: int = 0, pooling_mode: str = "align",
                    class_agnostic: bool = False, extra: dict | None = None) -> str:
    """One file: session, epoch, the global optimizer step, the model's state
    dict, the optimizer's (momentum buffers and param groups), the
    schedule's count and base LRs, pooling_mode, class_agnostic, and
    `extra`'s keys; every tensor on the CPU."""
    payload = {"session": int(session), "epoch": int(epoch), "step": int(step),
               "model": _cpu(model.state_dict()), "pooling_mode": pooling_mode,
               "class_agnostic": bool(class_agnostic), **(extra or {})}
    if opt is not None:
        payload["optimizer"] = _cpu(opt.state_dict())
    if sched is not None:
        payload["scheduler"] = {"last_epoch": int(sched.last_epoch),
                                "base_lrs": [float(v) for v in sched.base_lrs]}
    _save(payload, path)
    return path


def _load_optimizer(opt, saved: dict) -> None:
    """`opt.load_state_dict`, after checking that every group holds as many
    tensors as the saved one and every momentum buffer has its tensor's
    shape: the state is keyed by position, so a checkpoint only fits the
    same backbone and frozen prefix."""
    groups = saved["param_groups"]
    have = [len(g["params"]) for g in opt.param_groups]
    want = [len(g["params"]) for g in groups]
    if have != want:
        raise ValueError(f"optimizer groups hold {have} tensors, the checkpoint's {want}: "
                         f"another backbone or RESNET.FIXED_BLOCKS")
    for group, sgroup in zip(opt.param_groups, groups):
        for p, idx in zip(group["params"], sgroup["params"]):
            buf = saved["state"].get(idx, {}).get("momentum_buffer")
            if buf is not None and tuple(buf.shape) != tuple(p.shape):
                raise ValueError(f"momentum buffer {idx}: shape {tuple(buf.shape)} vs its "
                                 f"tensor's {tuple(p.shape)}")
    opt.load_state_dict(saved)


def read_checkpoint(path: str) -> dict:
    """A `save_checkpoint` file's payload, tensors on the CPU
    (`weights_only=True`)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(src, model: nn.Module | None = None, opt=None, sched=None) -> dict:
    """Restore a `save_checkpoint` file (a path, or `read_checkpoint`'s
    payload) into the model, optimizer and schedule given (the model's key
    set and shapes exactly, as `check_state_dict`); returns its other
    entries (session, epoch, step, pooling_mode, class_agnostic, extras).
    The schedule gets its count and base LRs back and each group's LR is
    recomputed from its own lambda, so the first resumed step runs at the
    uninterrupted run's LR."""
    payload = read_checkpoint(src) if isinstance(src, (str, os.PathLike)) else src
    if model is not None:
        check_state_dict(payload["model"], model)
        model.load_state_dict(payload["model"])
    if opt is not None:
        _load_optimizer(opt, payload["optimizer"])
    if sched is not None:
        saved = payload["scheduler"]
        sched.last_epoch, sched.base_lrs = saved["last_epoch"], list(saved["base_lrs"])
        lrs = [base * lam(sched.last_epoch) for base, lam in zip(sched.base_lrs, sched.lr_lambdas)]
        for group, lr in zip(sched.optimizer.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs
    return {k: v for k, v in payload.items() if k not in ("model", "optimizer", "scheduler")}


def save_params(path: str, state_dict: dict) -> str:
    """A bare state dict (converted weights), its tensors on the CPU."""
    _save({k: torch.as_tensor(v).detach().cpu() for k, v in state_dict.items()}, path)
    return path


def load_params(path: str) -> dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)
