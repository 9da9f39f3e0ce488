"""The detector's train step and eval forward (counterpart of
`rlobjectdetection_tpu/engine/train.py`).

    opt, sched, _ = build_optimizer(model, "resnet101", base_lr=0.01)
    step = make_train_step(model, opt, sched)
    metrics = step(batch, torch.Generator(device="cuda").manual_seed(7))

    # VGG-16, as the reference trains it: clip the global norm at 10
    opt, sched, _ = build_optimizer(model, "vgg16", base_lr=0.01, clip_norm=10.0)

One step: zero the gradients, the train forward (proposals, target
sampling from `generator`, VGG-16's head dropout, the four losses),
backward of their sum, the optimizer (with its clip, over the trainable
gradients only) and scheduler steps. The dropout draws from the optional
`dropout` source of a step, and by default from `generator` itself, after
the step's sampling draws (the JAX step splits one key in two instead).
"""

from __future__ import annotations

import torch

from ..utils import tracing
from ..utils.guards import skip_nonfinite_step


def make_train_step(model, opt, sched, skip_nonfinite: bool = False, global_batch=None):
    """Returns `train_step(batch, generator, dropout=None) → metrics`.
    batch: {data `[B, H, W, 3]`, im_info `[B, 3]`, gt_boxes `[B, G, 5]`,
    num_boxes `[B]`} on the model's device; generator, and dropout where
    given: a torch.Generator on that device (or a `models.targets.Uniform`
    source). Metrics are detached device tensors:
    loss (the four-term sum), rpn_cls, rpn_box, rcnn_cls, rcnn_box, fg_cnt,
    bg_cnt, and with `skip_nonfinite` `skipped` (1.0 where a non-finite
    gradient left the parameters, momentum and schedule as they were).

    Data parallel: `model` is the DDP-wrapped detector
    (`parallel.mesh.replicate`), `batch` this rank's rows and
    `global_batch` the group's `parallel.distributed.GlobalBatch`. The
    step is then the single-process step on the global batch: its draws,
    its RPN normalisation (`FasterRCNN.forward`), DDP's mean of the
    gradients, the clip on their global norm (the optimizer steps after
    the all-reduce), one skip decision for every rank, and the metrics as
    the global batch's means (fg_cnt, bg_cnt: sums).

    Each call runs in the span `train.step` (`utils/tracing.py`), its
    backward in `train.backward` and its optimizer and scheduler steps in
    `train.optimizer`."""

    def train_step(batch: dict, generator, dropout=None) -> dict:
        # the span's step: the scheduler's count of the steps taken, where
        # it keeps one (a resumed run's scheduler goes on from its count)
        with tracing.span("train.step", global_step=getattr(sched, "last_epoch", None)):
            opt.zero_grad(set_to_none=True)
            dp = {} if global_batch is None else {"global_batch": global_batch}
            out = model(batch["data"], batch["im_info"], batch["gt_boxes"],
                        batch.get("num_boxes"), train=True, generator=generator,
                        dropout=dropout, **dp)
            loss = (out["rpn_loss_cls"] + out["rpn_loss_box"]
                    + out["rcnn_loss_cls"] + out["rcnn_loss_bbox"])
            with tracing.span("train.backward"):
                loss.backward()
            metrics = {"loss": loss.detach(), "rpn_cls": out["rpn_loss_cls"].detach(),
                       "rpn_box": out["rpn_loss_box"].detach(),
                       "rcnn_cls": out["rcnn_loss_cls"].detach(),
                       "rcnn_box": out["rcnn_loss_bbox"].detach(),
                       "fg_cnt": (out["rois_label"] > 0).sum(),
                       "bg_cnt": (out["rois_label"] == 0).sum()}
            if global_batch is not None:
                metrics = global_batch.metrics(metrics)
            with tracing.span("train.optimizer"):
                if skip_nonfinite:
                    agree = None if global_batch is None else global_batch.all_true
                    metrics["skipped"] = torch.tensor(
                        float(skip_nonfinite_step(opt, sched, agree)))
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

