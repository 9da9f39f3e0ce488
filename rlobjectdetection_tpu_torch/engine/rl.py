"""RL refinement steps on a collated batch (the step functions of
`tools/trainval_rl.py`: `eval_step`, `train_step`, the optimizer chain, and
the per-batch part of `evaluate` without the COCO json and rescoring).

    opt, sched = make_rl_optimizer(model, RLConfig(), steps_per_epoch)
    loss, noweight = rl_train_step(model, opt, sched, data, bboxes, targets,
                                   weights, num_dts)
    pred, moved, prec = Refiner(model, action, maxk=1)(batch)
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RLConfig


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
