"""The detector's train step and eval forward (counterpart of
`rlobjectdetection_tpu/engine/train.py`).

    opt, sched, _ = build_optimizer(model, "resnet101", base_lr=0.01)
    step = make_train_step(model, opt, sched)
    metrics = step(batch, torch.Generator(device="cuda").manual_seed(7))

One step: zero the gradients, the train forward (proposals, target
sampling from `generator`, the four losses), backward of their sum, the
optimizer and scheduler steps.
"""

from __future__ import annotations

import torch

from ..utils.guards import skip_nonfinite_step


def make_train_step(model, opt, sched, skip_nonfinite: bool = False):
    """Returns `train_step(batch, generator) → metrics`. batch: {data
    `[B, H, W, 3]`, im_info `[B, 3]`, gt_boxes `[B, G, 5]`, num_boxes `[B]`}
    on the model's device; generator: a torch.Generator on that device (or a
    `models.targets.Uniform` source). Metrics are detached device tensors:
    loss (the four-term sum), rpn_cls, rpn_box, rcnn_cls, rcnn_box, fg_cnt,
    bg_cnt, and with `skip_nonfinite` `skipped` (1.0 where a non-finite
    gradient left the parameters, momentum and schedule as they were)."""

    def train_step(batch: dict, generator) -> dict:
        opt.zero_grad(set_to_none=True)
        out = model(batch["data"], batch["im_info"], batch["gt_boxes"], batch.get("num_boxes"),
                    train=True, generator=generator)
        loss = (out["rpn_loss_cls"] + out["rpn_loss_box"]
                + out["rcnn_loss_cls"] + out["rcnn_loss_bbox"])
        loss.backward()
        metrics = {"loss": loss.detach(), "rpn_cls": out["rpn_loss_cls"].detach(),
                   "rpn_box": out["rpn_loss_box"].detach(),
                   "rcnn_cls": out["rcnn_loss_cls"].detach(),
                   "rcnn_box": out["rcnn_loss_bbox"].detach(),
                   "fg_cnt": (out["rois_label"] > 0).sum(),
                   "bg_cnt": (out["rois_label"] == 0).sum()}
        if skip_nonfinite:
            metrics["skipped"] = torch.tensor(float(skip_nonfinite_step(opt, sched)))
        else:
            opt.step()
            sched.step()
        return metrics

    return train_step


def make_forward_fn(model):
    """The eval forward, `forward(data, im_info) → {rois, roi_valid,
    cls_prob, bbox_pred}`, under `torch.inference_mode()`."""

    @torch.inference_mode()
    def forward(data: torch.Tensor, im_info: torch.Tensor) -> dict:
        return model(data, im_info, train=False)

    return forward

