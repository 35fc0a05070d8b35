"""VOC-style AP@IoU evaluation (host-side numpy): the port's copy of
``pytorch_object_detection_tpu/eval/voc_map.py``.

The reference implementation's protocol (its `test.py:15-162`):

  * per class, per image: predictions in descending score order greedily
    match the GT with the *highest IoU*; a prediction is TP iff that best
    IoU >= threshold AND that particular GT is unassigned (the quirk: if the
    best-IoU GT is already taken, the prediction is a FP even when another
    unassigned GT also clears the threshold, reference test.py:130-144);
  * all predictions of a class are then pooled across images, sorted by
    score, and AP is the area under the precision-envelope PR curve with
    [0, .] / [1, 0] sentinels (reference _compute_ap, test.py:56-82).

One difference: the JAX ``_greedy_match`` tries the native matcher and
falls back to numpy on any exception.  Here the caller chooses once:
``native=True`` (the default) matches in the native ops library
(``native/lib.py``, built at first use; a build or load failure raises),
``native=False`` in numpy.  Both give the same flags.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, no +1 convention (reference iou_2d, test.py:23-53)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=-1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=-1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _greedy_match(gt: np.ndarray, preds: np.ndarray, iou_threshold: float, native: bool = True) -> np.ndarray:
    """TP flags for score-sorted predictions of one (image, class)."""
    if len(preds) == 0:
        return np.zeros((0,), bool)
    if len(gt) == 0:
        return np.zeros(len(preds), bool)
    if native:
        from pytorch_object_detection_tpu_torch.native.lib import voc_match_native

        return voc_match_native(gt, preds, iou_threshold)
    assigned = np.zeros(len(gt), bool)
    iou = _iou_matrix(gt, preds)
    tp = np.zeros(len(preds), bool)
    for j in range(len(preds)):
        best = int(np.argmax(iou[:, j]))
        if iou[best, j] >= iou_threshold and not assigned[best]:
            assigned[best] = True
            tp[j] = True
    return tp


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """PR-envelope AP (py-faster-rcnn style, reference test.py:56-82)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    changes = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[changes + 1] - mrec[changes]) * mpre[changes + 1]))


def eval_voc_ap(
    gt_boxes: Sequence[np.ndarray],
    gt_labels: Sequence[np.ndarray],
    pred_boxes: Sequence[np.ndarray],
    pred_labels: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    iou_threshold: float = 0.5,
    num_classes: int = 20,
    native: bool = True,
) -> Dict[int, float]:
    """Per-class AP over a dataset (lists indexed by image).

    Labels are 1-based; class ids 1..num_classes are evaluated.
    ``native``: match in the native ops library (True) or in numpy.
    """
    aps: Dict[int, float] = {}
    for cls in range(1, num_classes + 1):
        scores_all: List[float] = []
        tp_all: List[int] = []
        total_gts = 0
        for g_box, g_lab, p_box, p_lab, p_sc in zip(gt_boxes, gt_labels, pred_boxes, pred_labels, pred_scores):
            g = g_box[g_lab == cls]
            sel = p_lab == cls
            p = p_box[sel]
            s = p_sc[sel]
            total_gts += len(g)
            if len(p) == 0:
                continue
            order = np.argsort(-s)
            p, s = p[order], s[order]
            scores_all.extend(float(v) for v in s)
            tp_all.extend(int(v) for v in _greedy_match(g, p, iou_threshold, native))
        if total_gts == 0 or not scores_all:
            aps[cls] = 0.0
            continue
        order = np.argsort(-np.asarray(scores_all))
        tp = np.asarray(tp_all, np.float64)[order]
        fp = 1.0 - tp
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        recall = tp_cum / total_gts
        precision = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
        aps[cls] = average_precision(recall, precision)
    return aps


def mean_ap(aps: Dict[int, float]) -> float:
    return float(np.mean(list(aps.values()))) if aps else 0.0
