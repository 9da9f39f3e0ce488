"""RL refinement steps on a collated batch (the step functions of
`tools/trainval_rl.py`: `eval_step`, `train_step`, the optimizer chain, the
per-batch part of `evaluate`), and `rl_evaluate`, its eval loop over a
loader with the COCO json and rescoring.

    opt, sched = make_rl_optimizer(model, RLConfig(), steps_per_epoch)
    loss, noweight = rl_train_step(model, opt, sched, data, bboxes, targets,
                                   weights, num_dts)
    pred, moved, prec = Refiner(model, action, maxk=1)(batch)
    result = rl_evaluate(model, loader, action, maxk=1, wire="bf16",
                         res_file="rl_results.json", ann_file=gt_json, log=log)
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..config import RLConfig
from ..data.coco_eval import cocoval
from ..data.prefetch import AsyncLoader


def rl_eval_step(model, data: torch.Tensor, bboxes: torch.Tensor) -> torch.Tensor:
    """Action values `[B·N, num_acts]` f32 for a batch, no gradient."""
    with torch.inference_mode():
        return model(data, bboxes)[0]


def make_rl_optimizer(model, cfg: RLConfig, steps_per_epoch: int):
    """SGD with the reference's parameter groups: weights (conv and dense
    kernels, layer4's BN scale) at the learning rate with weight decay,
    biases (dense and layer4 BN) at twice the rate without; momentum as
    optax's `trace` (m = g + μ·m, no dampening); the trunk and every BN
    statistic frozen (not parameters that require grad). The rate drops
    ×0.1 at each epoch of `cfg.train_lr_decay`: step the scheduler once per
    optimizer step. Returns (optimizer, scheduler)."""
    weights, biases = [], []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        (biases if name.endswith(".bias") else weights).append(p)
    opt = torch.optim.SGD(
        [{"params": weights, "lr": cfg.learning_rate, "weight_decay": cfg.weight_decay},
         {"params": biases, "lr": 2.0 * cfg.learning_rate, "weight_decay": 0.0}],
        lr=cfg.learning_rate, momentum=cfg.momentum)
    spe = max(int(steps_per_epoch), 1)
    decay = tuple(cfg.train_lr_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 0.1 ** sum(step // spe >= e for e in decay))
    return opt, sched


def rl_train_step(model, opt, sched, data, bboxes, targets, weights, num_dts):
    """One SGD step on the weighted-MSE loss. Returns (loss, noweight),
    detached."""
    opt.zero_grad(set_to_none=True)
    _, loss, noweight = model(data, bboxes, targets, weights, num_dts)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach(), noweight.detach()


class Refiner:
    """Refine a collated batch's boxes: `refiner(batch)` → (pred `[B, N, A]`
    numpy, moved boxes per image (`[num_dts[i], 4]` xywh in original-image
    coordinates), precision@maxk or None).

    With labels in the batch the top-k moves are teacher-forced
    (`move_from_act`) and precision@k is returned; without, each top-k box
    moves by its own best action (`move_predicted`)."""

    def __init__(self, model, action, maxk: int = 1):
        self.model = model
        self.action = action
        self.maxk = maxk
        self.device = next(model.parameters()).device

    def __call__(self, batch: dict):
        bboxes = batch["bboxes"]
        b, n = bboxes.shape[:2]
        pred = rl_eval_step(self.model, torch.from_numpy(batch["data"]).to(self.device),
                            torch.from_numpy(bboxes).to(self.device))
        pred = pred.cpu().numpy().reshape(b, n, -1)
        xywh = bboxes[..., 1:5].copy()
        xywh[..., 2] -= xywh[..., 0]
        xywh[..., 3] -= xywh[..., 1]
        prec = None
        if batch.get("labels") is not None:
            moved, prec = self.action.move_from_act(xywh, pred, batch["labels"][..., 1],
                                                    self.maxk)
        else:
            moved = self.action.move_predicted(xywh, pred, self.maxk)
        out = [moved[i, : int(batch["num_dts"][i])] / float(batch["im_info"][i][2])
               for i in range(b)]
        return pred, out, prec


def wire_tensor(data: np.ndarray, wire: str) -> torch.Tensor:
    """The image blob as the eval ships it: `bf16` rounds each pixel to
    nearest even on the host (what ml_dtypes' `astype(bfloat16)` gives),
    halving the bytes copied; `f32` ships it as it is."""
    if wire not in ("bf16", "f32"):
        raise ValueError(f"wire must be bf16 or f32, got {wire!r}")
    t = torch.from_numpy(np.ascontiguousarray(data))
    return t.to(torch.bfloat16) if wire == "bf16" else t


def eval_rows(batch: dict, moved_all: np.ndarray) -> list[dict]:
    """COCO result rows of a batch's true detections: moved xywh boxes ÷
    the image's scale, image and category ids from bboxes' columns 7 and
    6, the detector's score from column 5."""
    bboxes, rows = batch["bboxes"], []
    for i in range(bboxes.shape[0]):
        n = int(batch["num_dts"][i])
        if n == 0:
            continue
        moved = moved_all[i, :n] / float(batch["im_info"][i][2])
        for k in range(n):
            rows.append({"image_id": int(bboxes[i, k, 7]), "category_id": int(bboxes[i, k, 6]),
                         "bbox": [float(x) for x in moved[k]],
                         "score": float(bboxes[i, k, 5])})
    return rows


def rl_evaluate(model, loader, action, maxk: int, *, wire: str, res_file: str,
                ann_file: str, log, num_workers: int = 0) -> dict:
    """Teacher-forced eval over `loader`'s next epoch (`tools/trainval_rl.py`'s
    `evaluate`): predict each batch's action values, move the top-`maxk`
    boxes of the full padded batch (`move_from_act`), average precision@k
    over batches, write the true detections' rows to `res_file` and rescore
    them against the gt json `ann_file` with `cocoval`; `log.info` takes
    the eval's lines.

    The pixels cross as `wire` (`wire_tensor`) and the net casts them back
    to f32 on its device. Batches are assembled on `num_workers` threads
    (0: in the loop). The wall time splits into the loader's wait, the
    step with its copies both ways ("step+fetch") and the host's move and
    rows ("post"). Returns {rows, preck, images, seconds, loader_s, step_s,
    post_s, wire, stats (cocoval's 12)}."""
    dev = next(model.parameters()).device
    rows, prec_sum, prec_cnt, n_imgs = [], 0.0, 0, 0
    t_data = t_step = t_post = 0.0
    source = AsyncLoader(loader, num_workers) if num_workers > 0 else iter(loader)
    t0 = end = time.perf_counter()
    for batch in source:
        t_data += time.perf_counter() - end
        s0 = time.perf_counter()
        bboxes = batch["bboxes"]
        b, n = bboxes.shape[:2]
        data = wire_tensor(batch["data"], wire).to(dev).float()
        pred = rl_eval_step(model, data, torch.from_numpy(bboxes).to(dev))
        pred = pred.cpu().numpy().reshape(b, n, -1)
        t_step += time.perf_counter() - s0
        s1 = time.perf_counter()
        # the full padded batch, as the reference's Evaluate moves it:
        # precision@k's denominator is B · maxk, empty rows included
        xywh = bboxes[..., 1:5].copy()
        xywh[..., 2] -= xywh[..., 0]
        xywh[..., 3] -= xywh[..., 1]
        moved_all, prec = action.move_from_act(xywh, pred, batch["labels"][..., 1], maxk)
        prec_sum += prec
        prec_cnt += 1
        rows += eval_rows(batch, moved_all)
        t_post += time.perf_counter() - s1
        n_imgs += b
        end = time.perf_counter()
    total = time.perf_counter() - t0
    preck = prec_sum / max(prec_cnt, 1)
    log.info(f"composed eval: {n_imgs} images in {total:.3f}s = "
             f"{n_imgs / max(total, 1e-9):.2f} img/s (loader {t_data:.3f}s, step+fetch "
             f"{t_step:.3f}s, post {t_post:.3f}s; wire {wire})")
    log.info(f"Preck precision@{maxk}: {preck:.2f}%")
    with open(res_file, "w") as f:
        json.dump(rows, f)
    log.info(f"wrote {res_file}; running COCO eval")
    return dict(rows=rows, preck=preck, images=n_imgs, seconds=total, loader_s=t_data,
                step_s=t_step, post_s=t_post, wire=wire, stats=cocoval(ann_file, res_file))
