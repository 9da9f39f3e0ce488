"""RL action space: 56 discrete box perturbations (numpy copy of
`rlobjectdetection_tpu/models/rl/action.py::Action`).

4 coordinates × len(delta) magnitudes × 2 signs; `actDeltas[num_acts, 4]`
scaled by alpha. `move_from_act` is the teacher-forced greedy top-k move
returning precision@k; `move_predicted` moves each of the top-k boxes by its
own best action.
"""

from __future__ import annotations

import numpy as np


class Action:
    def __init__(self, delta, alpha: float = 1.0, iou_thres: float = 0.0, wtrans=None):
        self.delta = list(delta)
        self.alpha = alpha
        self.iou_thres = iou_thres
        self.num_acts = 4 * len(delta) * 2
        self.wtrans = (lambda x: x) if wtrans is None else wtrans
        # per coordinate, magnitudes interleaved +δ0, -δ0, +δ1, -δ1, ... on
        # that coordinate's column, zeros elsewhere
        mags = np.asarray(self.delta, np.float32) * alpha
        signed = (mags[:, None] * np.array([1.0, -1.0], np.float32)).ravel()
        per_coord = signed[:, None, None] * np.eye(4, dtype=np.float32)[None, :, :]
        self.actDeltas = per_coord.transpose(2, 0, 1).reshape(self.num_acts, 4)

    def move_from_act(self, bboxes: np.ndarray, preds: np.ndarray,
                      targets: np.ndarray, maxk: int):
        """Teacher-forced greedy refinement. bboxes `[B, N, 4]` xywh (moved in
        place); preds/targets `[B, N, num_acts]`. Returns (bboxes,
        precision@maxk · 100).

        The top-maxk boxes ranked by their best action score each move by
        that action where its target is 1. Ties break toward the larger
        flattened index, both in the per-box action choice and in the box
        ranking."""
        b, n, _ = bboxes.shape
        if preds.shape != (b, n, self.num_acts) or targets.shape != preds.shape:
            raise ValueError(f"preds {preds.shape} and targets {targets.shape} must be "
                             f"{(b, n, self.num_acts)}")
        act = self.num_acts - 1 - np.argmax(preds[:, :, ::-1], axis=2)   # [B, N]
        score = np.take_along_axis(preds, act[:, :, None], axis=2)[..., 0]
        flat_pos = np.arange(n)[None, :] * self.num_acts + act
        by_pos = np.argsort(-flat_pos, axis=1, kind="stable")
        by_score = np.argsort(-np.take_along_axis(score, by_pos, axis=1),
                              axis=1, kind="stable")
        order = np.take_along_axis(by_pos, by_score, axis=1)             # [B, N]

        top = order[:, : min(maxk, n)]                                   # [B, K]
        top_act = np.take_along_axis(act, top, axis=1)                   # [B, K]
        tgt = np.take_along_axis(
            np.take_along_axis(targets, top[:, :, None], axis=1),
            top_act[:, :, None], axis=2,
        )[..., 0]
        helped = tgt == 1                                                # [B, K]

        cur = np.take_along_axis(bboxes, top[:, :, None], axis=1)        # [B, K, 4]
        step = self.actDeltas[top_act] * cur[:, :, [2, 3, 2, 3]]
        np.put_along_axis(bboxes, top[:, :, None],
                          cur + np.where(helped[:, :, None], step, 0.0), axis=1)
        return bboxes, int(helped.sum()) * 100.0 / (b * maxk)

    def move_predicted(self, bboxes: np.ndarray, preds: np.ndarray, maxk: int):
        """No teacher forcing: each of the top-k boxes (by best score) moves
        by its own argmax action. Returns a moved copy."""
        out = bboxes.copy()
        for bid in range(bboxes.shape[0]):
            order = np.argsort(-preds[bid].max(axis=1), kind="stable")[:maxk]
            for idx in order:
                act_id = int(np.argmax(preds[bid][idx]))
                _, _, w, h = out[bid][idx]
                out[bid][idx] += self.actDeltas[act_id] * np.array([w, h, w, h])
        return out
