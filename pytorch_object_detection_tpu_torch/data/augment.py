"""Host-side geometric augmentation (the port's copy of the JAX package's ``data/augment.py``).

That module imports no jax; the port keeps its own copy, which returns the
same bytes for the same seed.  Random rotation of +-10 degrees (p=0.5)
with the boxes re-axis-aligned from their rotated corners, and a random
crop keeping at least 0.7 of every box it touches (p=0.5, at most 10
attempts), before the resize onto the canvas.  cv2 is imported where the
rotation uses it.  The photometric jitter and the horizontal flip run on
the device (``data/pipeline.make_device_preprocess``).
"""
from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np


def rotate_image_and_boxes(
    image: np.ndarray, boxes: np.ndarray, degrees: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate about the image center; boxes become the axis-aligned hulls of
    their rotated corners, clamped to the image (vectorized over
    the boxes)."""
    import cv2

    h, w = image.shape[:2]
    cx, cy = w / 2.0, h / 2.0
    m = cv2.getRotationMatrix2D((cx, cy), degrees, 1.0)
    rotated = cv2.warpAffine(image, m, (w, h))
    if boxes.size == 0:
        return rotated, boxes
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    corners = np.stack(
        [np.stack([x1, y1], -1), np.stack([x1, y2], -1), np.stack([x2, y1], -1), np.stack([x2, y2], -1)],
        axis=1,
    )  # [N, 4, 2]
    a = -degrees / 180.0 * math.pi
    cos_a, sin_a = math.cos(a), math.sin(a)
    rx = (corners[..., 0] - cx) * cos_a - (corners[..., 1] - cy) * sin_a + cx
    ry = (corners[..., 0] - cx) * sin_a + (corners[..., 1] - cy) * cos_a + cy
    out = np.stack([rx.min(1), ry.min(1), rx.max(1), ry.max(1)], axis=-1)
    out[:, 0::2] = out[:, 0::2].clip(0, w - 1)
    out[:, 1::2] = out[:, 1::2].clip(0, h - 1)
    return rotated, out.astype(np.float32)


def random_crop(
    image: np.ndarray,
    boxes: np.ndarray,
    rng: random.Random,
    crop_scale_min: float = 0.2,
    aspect_ratio=(3.0 / 4, 4.0 / 3),
    remain_min: float = 0.7,
    attempt_max: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random crop that keeps at least ``remain_min`` of the area of every
    box it touches."""
    h_img, w_img = image.shape[:2]
    area = w_img * h_img
    for _ in range(attempt_max):
        target_area = rng.uniform(crop_scale_min, 1.0) * area
        ar = rng.uniform(*aspect_ratio)
        w = int(round(math.sqrt(target_area * ar)))
        h = int(round(math.sqrt(target_area / ar)))
        if rng.random() < 0.5:
            w, h = h, w
        if w > w_img or h > h_img:
            continue
        x = rng.randint(0, w_img - w)
        y = rng.randint(0, h_img - h)
        if boxes.size:
            ix1 = np.maximum(boxes[:, 0], x)
            iy1 = np.maximum(boxes[:, 1], y)
            ix2 = np.minimum(boxes[:, 2], x + w)
            iy2 = np.minimum(boxes[:, 3], y + h)
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
            box_area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            touched = inter > 1e-4
            if touched.any() and not (inter[touched] / box_area[touched] > remain_min).all():
                continue
        image = image[y : y + h, x : x + w]
        if boxes.size:
            boxes = boxes - np.array([x, y, x, y], np.float32)
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, w - 1)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, h - 1)
        return image, boxes
    return image, boxes


class HostAugment:
    """Train-time geometric augmentation (applied before canvas resize)."""

    def __init__(self, rotation_prob: float = 0.5, crop_prob: float = 0.5, degree: float = 10.0, seed: Optional[int] = None):
        self.rotation_prob = rotation_prob
        self.crop_prob = crop_prob
        self.degree = degree
        self.rng = random.Random(seed)

    def __call__(self, image: np.ndarray, boxes: np.ndarray):
        if self.rng.random() < self.rotation_prob:
            image, boxes = rotate_image_and_boxes(
                image, boxes, self.rng.uniform(-self.degree, self.degree)
            )
        if self.rng.random() < self.crop_prob:
            image, boxes = random_crop(image, boxes, self.rng)
        return image, boxes
