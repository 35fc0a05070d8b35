"""The comparisons that decide ``correct``, each number beside its limit.

Serving (``detection_gaps``): for each sampled image, the reference's
``top`` best kept detections and the served ones, as COCO scores a
detector on its 100 best.  ``unmatched_pct``: the share of both sides'
that no detection of the other side of the same class overlaps by IoU
``iou`` or more.  A match is looked for among all kept detections of the
other side, so a box that NMS keeps on one side and trades for a
near-identical neighbour on the other still matches.  Both sides count:
a detection the program misses and one it invents weigh the same.

Training (``train_gaps``): the loss of each of the first steps, the first
update direction as the optimizer took it and each trained leaf's change
after the steps, each against the reference; and the same of one step of
the window, drawn from the seed, which the reference replays from the
program's state before it (``window_*``).  A leaf's gap is the gap of the
two norms over the larger of the reference's norm of that leaf and of the
median leaf.  The worst leaf's gap and the 95th percentile of the leaves'
gaps are both read; which are compared is the cell's choice (its
``limits``).  Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone under the optimizer and are left out
of the change.  Across ranks, ``rank_gap``: the largest difference of any
weight from rank 0's, over its leaf's largest magnitude.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench_port.reference.postprocess import iou_matrix


def served_detections(host) -> List[Dict[str, np.ndarray]]:
    """The kept detections of each image of a served batch (``Detections`` on the host)."""
    scores, classes, boxes, valid = (t.numpy() for t in host)
    return [{"scores": scores[i][valid[i]], "classes": classes[i][valid[i]], "boxes": boxes[i][valid[i]]}
            for i in range(len(scores))]


def _unmatched(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray], top: int, iou: float) -> int:
    """How many of ``a``'s ``top`` best have no detection of ``b`` of their class at IoU >= ``iou``."""
    n = min(top, len(a["scores"]))
    if n == 0:
        return 0
    if len(b["scores"]) == 0:
        return n
    overlap = iou_matrix(a["boxes"][:n].astype(np.float64), b["boxes"].astype(np.float64))
    same = a["classes"][:n, None] == b["classes"][None, :]
    return int((~((overlap >= iou) & same).any(1)).sum())


def detection_gaps(served: List[dict], want: List[dict], spec: dict) -> Dict[str, dict]:
    top, iou = spec["top"], spec["iou"]
    unmatched = sum(_unmatched(r, s, top, iou) + _unmatched(s, r, top, iou) for r, s in zip(want, served))
    counted = sum(min(top, len(r["scores"])) + min(top, len(s["scores"])) for r, s in zip(want, served))
    return {"unmatched_pct": {"value": 100.0 * unmatched / max(counted, 1), "limit": spec["limits"]["unmatched_pct"]}}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], names) -> Dict[str, float]:
    """Each leaf's |norm got - norm want| over max(norm want, median leaf's norm want)."""
    if not names:
        return {}
    med = float(np.median([want[n] for n in names]))
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names}


def step_gaps(got: dict, want: dict, prefix: str = "") -> Dict[str, float]:
    """``got``/``want``: ``losses`` (a list), ``dir`` and ``change`` (leaf
    norms), ``grad`` (the reference's gradient norms, which pick the leaves
    of the change).  ``*_gap`` is the worst leaf's, ``*_p95_gap`` the 95th
    percentile's over the leaves."""
    names = sorted(want["dir"])
    med = float(np.median([want["grad"][n] for n in names]))
    moved = [n for n in names if want["grad"][n] >= 1e-3 * med]
    values = {f"{prefix}loss_gap": max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))}
    for key, leaves in (("dir", names), ("change", moved)):
        gaps = list(leaf_gaps(got[key], want[key], leaves).values()) or [0.0]
        values[f"{prefix}{key}_gap"] = max(gaps)
        values[f"{prefix}{key}_p95_gap"] = float(np.percentile(gaps, 95))
    return values


def train_gaps(got: dict, want: dict, limits: dict) -> Dict[str, dict]:
    """The first steps' numbers (:func:`step_gaps`), the window step's
    (``window``, prefixed ``window_``) and ``rank_gap``.  Every number is
    returned; those with a limit in ``limits`` are compared, the others
    only reported."""
    values = step_gaps(got, want)
    if "window" in got:
        values.update(step_gaps(got["window"], want["window"], "window_"))
    if "rank_gap" in got:
        values["rank_gap"] = got["rank_gap"]
    return {k: {"value": v, "limit": limits[k]} if k in limits else {"value": v} for k, v in values.items()}


def compared_only(numbers: Dict[str, dict]) -> Dict[str, dict]:
    """The numbers that have a limit."""
    return {k: v for k, v in numbers.items() if "limit" in v}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Float64 norm of each tensor, read in one copy."""
    names = sorted(tensors)
    norms = torch.stack([tensors[n].detach().double().norm() for n in names]).cpu().tolist()
    return dict(zip(names, norms))


def passes(compared: Dict[str, dict]) -> bool:
    """Every number that has a limit finite and within it."""
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values() if "limit" in c)
