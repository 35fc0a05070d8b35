"""Disk-backed synthetic corpora whose images encode their boxes.

The port's own copy of the repository's two generators,
``scripts/make_synthetic_voc.py`` and ``scripts/make_synthetic_coco.py``:
for the same arguments it writes the same files, byte for byte (JPEG
bytes, XML, JSON).  Each class is a distinct (shape, hue) on a textured
background, so a detector has to read the pixels to place and name a box,
and each corpus has a held-out split:

  * VOC (20 classes: 4 shapes x 5 hues): ``JPEGImages/``, ``Annotations/``
    and ``ImageSets/Main/{trainval,test}.txt``, images 320-500 px a side,
    up to 6 objects of 40-220 px, for ``data/voc.VOCDataset``;
  * COCO (80 classes: 8 shapes x 10 hues): ``train/``, ``val/`` and
    ``instances_{train,val}.json`` (category ids 1..80), images 480-800 x
    640-1280 px, up to 8 objects of 56-320 px, for ``data/coco.COCODataset``.

Usage::

    python -m pytorch_object_detection_tpu_torch.data.synthetic_corpus voc OUTROOT [--train 320] [--val 64] [--seed 0]
    python -m pytorch_object_detection_tpu_torch.data.synthetic_corpus coco OUTROOT [--train 240] [--val 48] [--seed 0]

numpy draws the images; PIL encodes the JPEGs and is imported only by the
writers.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from pytorch_object_detection_tpu_torch.data.voc import VOC_CLASSES

# VOC: class id -> (shape kind, RGB). 4 shapes x 5 hues = 20 distinct looks.
SHAPES = ("box", "disc", "tri", "ring")
HUES = ((220, 40, 40), (40, 200, 40), (50, 80, 230), (230, 200, 40), (200, 60, 220))
# COCO: 8 shapes x 10 hues = 80 distinct looks
SHAPES8 = ("box", "disc", "tri", "ring", "diamond", "cross", "hbar", "vbar")
HUES10 = (
    (220, 40, 40), (40, 200, 40), (50, 80, 230), (230, 200, 40),
    (200, 60, 220), (40, 210, 210), (240, 130, 30), (140, 90, 40),
    (160, 160, 160), (90, 230, 140),
)


def _draw(arr: np.ndarray, cls: int, x1: int, y1: int, x2: int, y2: int, rng) -> None:
    """Blend VOC class ``cls``'s shape into ``arr[y1:y2, x1:x2]``."""
    shape = SHAPES[cls % 4]
    color = np.array(HUES[cls // 4], np.float32) * rng.uniform(0.75, 1.0)
    h, w = y2 - y1, x2 - x1
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    if shape == "box":
        mask = np.ones((h, w), bool)
    elif shape == "disc":
        mask = ((yy - cy) / (h / 2)) ** 2 + ((xx - cx) / (w / 2)) ** 2 <= 1.0
    elif shape == "tri":  # upward triangle spanning the box
        t = yy / max(h - 1, 1)  # 0 at top .. 1 at base
        mask = np.abs(xx - cx) <= t * (w / 2)
    else:  # ring
        r2 = ((yy - cy) / (h / 2)) ** 2 + ((xx - cx) / (w / 2)) ** 2
        mask = (r2 <= 1.0) & (r2 >= 0.36)
    region = arr[y1:y2, x1:x2].astype(np.float32)
    region[mask] = 0.25 * region[mask] + 0.75 * color
    arr[y1:y2, x1:x2] = np.clip(region, 0, 255).astype(np.uint8)


def _draw80(arr: np.ndarray, cls: int, x1: int, y1: int, x2: int, y2: int, rng) -> None:
    """Blend COCO class ``cls``'s shape into ``arr[y1:y2, x1:x2]``."""
    shape = SHAPES8[cls % 8]
    color = np.array(HUES10[cls // 8], np.float32) * rng.uniform(0.75, 1.0)
    h, w = y2 - y1, x2 - x1
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ny = np.abs(yy - cy) / max(h / 2, 1)
    nx = np.abs(xx - cx) / max(w / 2, 1)
    if shape == "box":
        mask = np.ones((h, w), bool)
    elif shape == "disc":
        mask = ny**2 + nx**2 <= 1.0
    elif shape == "tri":
        t = yy / max(h - 1, 1)
        mask = np.abs(xx - cx) <= t * (w / 2)
    elif shape == "ring":
        r2 = ny**2 + nx**2
        mask = (r2 <= 1.0) & (r2 >= 0.36)
    elif shape == "diamond":
        mask = ny + nx <= 1.0
    elif shape == "cross":
        mask = (ny <= 0.34) | (nx <= 0.34)
    elif shape == "hbar":
        mask = ny <= 0.34
    else:  # vbar
        mask = nx <= 0.34
    region = arr[y1:y2, x1:x2].astype(np.float32)
    region[mask] = 0.25 * region[mask] + 0.75 * color
    arr[y1:y2, x1:x2] = np.clip(region, 0, 255).astype(np.uint8)


def _background(h: int, w: int, rng) -> np.ndarray:
    """Low-frequency textured background (upsampled noise + gradient)."""
    coarse = rng.integers(40, 200, (h // 32 + 2, w // 32 + 2, 3), np.uint8)
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    yi, xi = ys.astype(int), xs.astype(int)
    img = coarse[yi][:, xi].astype(np.float32)
    img += rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _place(rng, arr, n_objects, box_lo, box_hi, n_classes, draw):
    """Up to ``n_objects`` boxes of ``box_lo``..``box_hi`` px a side on ``arr``,
    each kept at IoU <= 0.3 with those before it (20 tries a box), drawn
    with a random class; returns (boxes, labels), labels 0-based."""
    h, w = arr.shape[:2]
    boxes, labels = [], []
    for _ in range(n_objects):
        for _attempt in range(20):
            bw = int(rng.integers(box_lo, min(box_hi, w - 2)))
            bh = int(rng.integers(box_lo, min(box_hi, h - 2)))
            x1 = int(rng.integers(0, w - bw))
            y1 = int(rng.integers(0, h - bh))
            box = np.array([x1, y1, x1 + bw, y1 + bh], np.float32)
            # keep pairwise IoU low so shapes stay identifiable
            ok = True
            for b in boxes:
                ix = max(0, min(box[2], b[2]) - max(box[0], b[0]))
                iy = max(0, min(box[3], b[3]) - max(box[1], b[1]))
                inter = ix * iy
                union = bw * bh + (b[2] - b[0]) * (b[3] - b[1]) - inter
                if inter / union > 0.3:
                    ok = False
                    break
            if ok:
                cls = int(rng.integers(0, n_classes))
                draw(arr, cls, x1, y1, x1 + bw, y1 + bh, rng)
                boxes.append(box)
                labels.append(cls)
                break
    return boxes, labels


def make_image(rng, min_side=320, max_side=500, max_objects=6):
    """One VOC image: (uint8 [H, W, 3], boxes, 0-based labels)."""
    h = int(rng.integers(min_side, max_side))
    w = int(rng.integers(min_side, max_side))
    arr = _background(h, w, rng)
    n = int(rng.integers(1, max_objects + 1))
    boxes, labels = _place(rng, arr, n, 40, 220, 20, _draw)
    return arr, boxes, labels


def make_image80(rng, max_objects=8):
    """One COCO image: (uint8 [H, W, 3], boxes, 0-based labels)."""
    h = int(rng.integers(480, 800))
    w = int(rng.integers(640, 1280))
    arr = _background(h, w, rng)
    n = int(rng.integers(1, max_objects + 1))
    boxes, labels = _place(rng, arr, n, 56, 320, 80, _draw80)
    return arr, boxes, labels


def write_voc_split(root: str, ids, rng) -> None:
    """JPEGs and VOC XML (1-based pixel coordinates) for ``ids``."""
    from PIL import Image

    for img_id in ids:
        arr, boxes, labels = make_image(rng)
        Image.fromarray(arr).save(os.path.join(root, "JPEGImages", f"{img_id}.jpg"), quality=92)
        objs = "\n".join(
            f"  <object><name>{VOC_CLASSES[c]}</name><difficult>0</difficult>"
            f"<bndbox><xmin>{int(b[0]) + 1}</xmin><ymin>{int(b[1]) + 1}</ymin>"
            f"<xmax>{int(b[2]) + 1}</xmax><ymax>{int(b[3]) + 1}</ymax></bndbox></object>"
            for b, c in zip(boxes, labels)
        )
        with open(os.path.join(root, "Annotations", f"{img_id}.xml"), "w") as f:
            f.write(f"<annotation>\n{objs}\n</annotation>\n")


def write_coco_split(root: str, split: str, n: int, rng, start_id: int) -> None:
    """``root/split/*.jpg`` and ``root/instances_<split>.json``, image ids
    from ``start_id``, annotation ids from ``1000 * start_id``."""
    from PIL import Image

    img_dir = os.path.join(root, split)
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    ann_id = start_id * 1000
    for k in range(n):
        img_id = start_id + k
        arr, boxes, labels = make_image80(rng)
        fname = f"{img_id:012d}.jpg"
        Image.fromarray(arr).save(os.path.join(img_dir, fname), quality=92)
        images.append({"id": img_id, "file_name": fname,
                       "width": arr.shape[1], "height": arr.shape[0]})
        for b, c in zip(boxes, labels):
            annotations.append({
                "id": ann_id, "image_id": img_id,
                # category ids 1..80 (contiguous remap is identity-shifted)
                "category_id": int(c) + 1,
                "bbox": [float(b[0]), float(b[1]),
                         float(b[2] - b[0]), float(b[3] - b[1])],
                "iscrowd": 0,
                "area": float((b[2] - b[0]) * (b[3] - b[1])),
            })
            ann_id += 1
    cats = [{"id": i + 1, "name": f"{SHAPES8[i % 8]}-{i // 8}"} for i in range(80)]
    with open(os.path.join(root, f"instances_{split}.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": cats}, f)


def write_synthetic_voc(root: str, n_train: int = 320, n_val: int = 64, seed: int = 0) -> None:
    """The synthetic VOC corpus under ``root``: ``tr%05d`` trainval and
    ``va%05d`` test ids, drawn in that order from ``default_rng(seed)``."""
    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rng = np.random.default_rng(seed)
    train_ids = [f"tr{i:05d}" for i in range(n_train)]
    val_ids = [f"va{i:05d}" for i in range(n_val)]
    write_voc_split(root, train_ids, rng)
    write_voc_split(root, val_ids, rng)
    with open(os.path.join(root, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(train_ids) + "\n")
    with open(os.path.join(root, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(val_ids) + "\n")


def write_synthetic_coco(root: str, n_train: int = 240, n_val: int = 48, seed: int = 0) -> None:
    """The synthetic COCO corpus under ``root``: the train split (image ids
    from 1), then the val split (from 100000), from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    write_coco_split(root, "train", n_train, rng, 1)
    write_coco_split(root, "val", n_val, rng, 100000)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write a synthetic VOC or COCO-format corpus")
    ap.add_argument("kind", choices=("voc", "coco"))
    ap.add_argument("outroot")
    ap.add_argument("--train", type=int, default=None, help="train images (voc 320, coco 240)")
    ap.add_argument("--val", type=int, default=None, help="held-out images (voc 64, coco 48)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.kind == "voc":
        n_train, n_val = args.train if args.train is not None else 320, args.val if args.val is not None else 64
        write_synthetic_voc(args.outroot, n_train, n_val, args.seed)
        print(f"wrote {n_train} train + {n_val} val images under {args.outroot}")
    else:
        n_train, n_val = args.train if args.train is not None else 240, args.val if args.val is not None else 48
        write_synthetic_coco(args.outroot, n_train, n_val, args.seed)
        print(f"wrote {n_train} train + {n_val} val COCO-format images under {args.outroot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
