"""COCO-protocol mAP on the host (numpy): the port's copy of
``pytorch_object_detection_tpu/eval/coco_map.py``.

The COCOeval bbox protocol the reference relies on (its
`Test_coco.py:181-190`): 10 IoU thresholds .50:.05:.95, per-category
greedy matching in descending score order (each detection takes the
unmatched GT with the highest IoU above the threshold), 101-point
interpolated precision, area ranges (all/small/medium/large) and maxDets
caps, crowd/ignore GTs that absorb detections without counting as FP or TP.

One difference: the JAX ``_match_image_class`` tries the native matcher and
falls back to the Python loop on any exception.  Here the caller chooses
once: ``COCOEvaluator(native=True)`` (the default) matches in the native
ops library (``native/lib.coco_match_native``, built at first use; a build
or load failure raises), ``native=False`` in the Python loop.  Both give
the same flags.  :func:`evaluate_coco_official` imports pycocotools where it
is called, as the JAX function does.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_GRID = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_matrix(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = np.prod(det[:, 2:] - det[:, :2], axis=-1)
    area_g = np.prod(gt[:, 2:] - gt[:, :2], axis=-1)
    union = area_d[:, None] + area_g[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOEvaluator:
    """Accumulates per-image detections + GT, then computes COCO AP/AR.

    Boxes are xyxy in original image coordinates; labels are contiguous
    1-based category ids (the dataset's remap).  ``native``: match in the
    native ops library (True) or in the Python loop.
    """

    def __init__(self, num_classes: int, max_dets: Tuple[int, ...] = (1, 10, 100), native: bool = True):
        self.num_classes = num_classes
        self.max_dets = max_dets
        self.native = native
        # per (image, class) storage
        self._gt = defaultdict(list)
        self._gt_ignore = defaultdict(list)
        self._gt_crowd = defaultdict(list)
        self._det = defaultdict(list)
        self._images = set()

    def add_image(
        self,
        image_id,
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        det_boxes: np.ndarray,
        det_labels: np.ndarray,
        det_scores: np.ndarray,
        gt_ignore: Optional[np.ndarray] = None,
        gt_crowd: Optional[np.ndarray] = None,
    ) -> None:
        """gt_crowd marks COCO iscrowd regions: always ignore, matched with
        intersection-over-det-area IoU, and re-matchable by several dets
        (COCOeval iscrowd semantics)."""
        self._images.add(image_id)
        if gt_ignore is None:
            gt_ignore = np.zeros(len(gt_boxes), bool)
        if gt_crowd is None:
            gt_crowd = np.zeros(len(gt_boxes), bool)
        gt_ignore = np.asarray(gt_ignore, bool) | np.asarray(gt_crowd, bool)
        for c in np.unique(gt_labels) if len(gt_labels) else []:
            sel = gt_labels == c
            self._gt[(image_id, int(c))] = gt_boxes[sel]
            self._gt_ignore[(image_id, int(c))] = gt_ignore[sel]
            self._gt_crowd[(image_id, int(c))] = np.asarray(gt_crowd, bool)[sel]
        for c in np.unique(det_labels) if len(det_labels) else []:
            sel = det_labels == c
            order = np.argsort(-det_scores[sel], kind="mergesort")  # stable (ties)
            self._det[(image_id, int(c))] = (det_boxes[sel][order], det_scores[sel][order])

    # -- matching ----------------------------------------------------------
    def _match_image_class(self, image_id, cls, area_rng, max_det):
        """Returns (det_scores, det_matched[T, D], det_ignore[T, D], n_gt)."""
        gt = self._gt.get((image_id, cls), np.zeros((0, 4)))
        gt_ig = self._gt_ignore.get((image_id, cls), np.zeros((0,), bool))
        gt_crowd = self._gt_crowd.get((image_id, cls), np.zeros((0,), bool))
        det, scores = self._det.get((image_id, cls), (np.zeros((0, 4)), np.zeros((0,))))
        det, scores = det[:max_det], scores[:max_det]

        lo, hi = area_rng
        gt_area = np.prod(np.clip(gt[:, 2:] - gt[:, :2], 0, None), axis=-1) if len(gt) else np.zeros((0,))
        gt_ignore = gt_ig | (gt_area < lo) | (gt_area > hi)
        n_gt = int((~gt_ignore).sum())

        t = len(IOU_THRS)
        d = len(det)
        matched = np.zeros((t, d), bool)
        ignore_det = np.zeros((t, d), bool)
        if d == 0:
            return scores, matched, ignore_det, n_gt
        if len(gt) == 0:
            # unmatched dets outside the area range are ignored (COCO rule)
            det_area = np.prod(np.clip(det[:, 2:] - det[:, :2], 0, None), axis=-1)
            out = (det_area < lo) | (det_area > hi)
            ignore_det[:] = out[None, :]
            return scores, matched, ignore_det, n_gt

        iou = _iou_matrix(det, gt)
        if gt_crowd.any():
            # crowd GTs: intersection over det area (COCOeval iscrowd IoU)
            lt = np.maximum(det[:, None, :2], gt[None, :, :2])
            rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
            wh = np.clip(rb - lt, 0.0, None)
            inter = wh[..., 0] * wh[..., 1]
            det_area_m = np.prod(np.clip(det[:, 2:] - det[:, :2], 0, None), axis=-1)
            crowd_iou = np.where(det_area_m[:, None] > 0, inter / np.maximum(det_area_m[:, None], 1e-12), 0.0)
            iou = np.where(gt_crowd[None, :], crowd_iou, iou)
        # sort GT: real GTs first, ignored last (COCOeval gtind ordering)
        gt_order = np.argsort(gt_ignore.astype(np.int8), kind="stable")
        iou = iou[:, gt_order]
        gt_ignore_sorted = gt_ignore[gt_order]
        gt_crowd_sorted = gt_crowd[gt_order]
        det_area = np.prod(np.clip(det[:, 2:] - det[:, :2], 0, None), axis=-1)
        det_out = (det_area < lo) | (det_area > hi)

        if self.native:
            from pytorch_object_detection_tpu_torch.native.lib import coco_match_native

            m, ig = coco_match_native(
                gt[gt_order], gt_ignore_sorted, det, det_out,
                IOU_THRS.astype(np.float32), gt_crowd=gt_crowd_sorted,
            )
            return scores, m, ig, n_gt

        for ti, thr in enumerate(IOU_THRS):
            taken = np.zeros(len(gt), bool)
            for di in range(d):
                best, best_iou = -1, min(thr, 1 - 1e-10)
                for gi in range(len(gt)):
                    # only crowd GTs are re-matchable (COCOeval keys on iscrowd)
                    if taken[gi] and not gt_crowd_sorted[gi]:
                        continue
                    # stop probing real GTs once we hold a real match and hit ignores
                    if best > -1 and not gt_ignore_sorted[best] and gt_ignore_sorted[gi]:
                        break
                    if iou[di, gi] < best_iou:
                        continue
                    best_iou = iou[di, gi]
                    best = gi
                if best == -1:
                    ignore_det[ti, di] = det_out[di]  # unmatched & out-of-range -> ignore
                    continue
                taken[best] = True
                if gt_ignore_sorted[best]:
                    ignore_det[ti, di] = True
                else:
                    matched[ti, di] = True
        return scores, matched, ignore_det, n_gt

    # -- accumulation ------------------------------------------------------
    def _accumulate(self, area: str, max_det: int):
        """Per-class precision[T, R] and recall[T]; returns (ap, ar) arrays
        [T, K] with NaN for classes absent from the GT."""
        t = len(IOU_THRS)
        ap = np.full((t, self.num_classes), np.nan)
        ar = np.full((t, self.num_classes), np.nan)
        rng = AREA_RANGES[area]
        for cls in range(1, self.num_classes + 1):
            scores_all, matched_all, ignore_all = [], [], []
            n_gt = 0
            for img in self._images:
                s, m, ig, n = self._match_image_class(img, cls, rng, max_det)
                scores_all.append(s)
                matched_all.append(m)
                ignore_all.append(ig)
                n_gt += n
            if n_gt == 0:
                continue
            scores = np.concatenate(scores_all)
            matched = np.concatenate(matched_all, axis=1)
            ignored = np.concatenate(ignore_all, axis=1)
            order = np.argsort(-scores, kind="mergesort")
            matched = matched[:, order]
            ignored = ignored[:, order]
            for ti in range(t):
                keep = ~ignored[ti]
                tp = np.cumsum(matched[ti][keep])
                fp = np.cumsum(~matched[ti][keep])
                n_det = len(tp)
                if n_det == 0:
                    ap[ti, cls - 1] = 0.0
                    ar[ti, cls - 1] = 0.0
                    continue
                recall = tp / n_gt
                precision = tp / np.maximum(tp + fp, 1e-12)
                # precision envelope
                for i in range(n_det - 1, 0, -1):
                    precision[i - 1] = max(precision[i - 1], precision[i])
                # 101-point interpolation
                idx = np.searchsorted(recall, RECALL_GRID, side="left")
                prec_at = np.where(idx < n_det, precision[np.minimum(idx, n_det - 1)], 0.0)
                ap[ti, cls - 1] = prec_at.mean()
                ar[ti, cls - 1] = recall[-1]
        return ap, ar

    def summarize(self) -> Dict[str, float]:
        """The standard 12-number COCO summary."""
        import warnings

        warnings.filterwarnings("ignore", message="Mean of empty slice")
        ap_all, ar_all = self._accumulate("all", self.max_dets[-1])
        out = {
            "AP": float(np.nanmean(ap_all)),
            "AP50": float(np.nanmean(ap_all[0])),
            "AP75": float(np.nanmean(ap_all[5])),
            "AR@100": float(np.nanmean(ar_all)),
        }
        for area in ("small", "medium", "large"):
            ap_a, ar_a = self._accumulate(area, self.max_dets[-1])
            out[f"AP_{area}"] = float(np.nanmean(ap_a))
            out[f"AR_{area}"] = float(np.nanmean(ar_a))
        for md in self.max_dets[:-1]:
            _, ar_md = self._accumulate("all", md)
            out[f"AR@{md}"] = float(np.nanmean(ar_md))
        # NaN (class never in GT) -> treated as absent from the mean already;
        # an all-NaN result collapses to 0
        return {k: (0.0 if np.isnan(v) else v) for k, v in out.items()}


def evaluate_coco_official(results_json: str, annotation_file: str) -> Dict[str, float]:
    """Official pycocotools path (used when available — metric parity)."""
    from pycocotools.coco import COCO
    from pycocotools.cocoeval import COCOeval

    coco_gt = COCO(annotation_file)
    coco_dt = coco_gt.loadRes(results_json)
    ev = COCOeval(coco_gt, coco_dt, "bbox")
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    keys = ["AP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
            "AR@1", "AR@10", "AR@100", "AR_small", "AR_medium", "AR_large"]
    return dict(zip(keys, [float(x) for x in ev.stats]))
