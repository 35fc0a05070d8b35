"""MS-COCO dataset: a pure-JSON index (no pycocotools on the hot path).

The port's copy of ``pytorch_object_detection_tpu/data/coco.py``: crowd and
degenerate filtering, xywh -> xyxy, the contiguous 1-based category remap
(``cat_to_contig``, ``contig_to_cat``), crowd boxes kept apart for the
evaluator (``eval_crowds``), and the aspect-preserving resize onto a fixed
``canvas_hw`` with the ``scale`` carried to un-resize the eval boxes
(``data/voc.resize_to_canvas``, cv2).

``raw_tiles=True`` is the port's addition, in the form of
``VOCDataset(raw_tiles=True)``: the host only decodes into a fixed uint8
tile (``data/decode.decode_image_to_tile``) and the resize runs batched on
the card (``data/pipeline.make_device_resize``), so the path needs no cv2.
``tile_hw`` defaults to the largest ``height`` and ``width`` in the
annotation file, so that one tile holds every image; an image larger than
its tile raises ``ValueError`` naming it (the cv2 path never crops).
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from pytorch_object_detection_tpu_torch.data.voc import Sample, resize_to_canvas


class COCODataset:
    def __init__(
        self,
        image_dir: str,
        annotation_file: str,
        canvas_hw: Tuple[int, int] = (896, 1408),
        filter_empty: bool = True,
        min_size: float = 1.0,
        augment=None,
        raw_tiles: bool = False,
        tile_hw: Optional[Tuple[int, int]] = None,
    ):
        """``raw_tiles=True`` (the evaluation path, no augment): samples
        carry the decoded image in a fixed uint8 tile (edge-replicated, see
        data/pipeline.decode_to_tile) with content_hw = the true (h, w),
        and boxes host-scaled to canvas coordinates; the resize runs on the
        device."""
        if raw_tiles and augment is not None:
            raise ValueError("raw_tiles=True is the evaluation path: it takes no augment")
        self.image_dir = image_dir
        self.canvas_hw = canvas_hw
        self.augment = augment
        self.raw_tiles = raw_tiles
        with open(annotation_file) as f:
            coco = json.load(f)

        # contiguous 1-based category remap (reference coco.py:51-52)
        cat_ids = sorted(c["id"] for c in coco["categories"])
        self.cat_to_contig: Dict[int, int] = {c: i + 1 for i, c in enumerate(cat_ids)}
        self.contig_to_cat: Dict[int, int] = {v: k for k, v in self.cat_to_contig.items()}
        self.class_names = [
            c["name"] for c in sorted(coco["categories"], key=lambda c: c["id"])
        ]

        anns_by_img = defaultdict(list)
        crowds_by_img = defaultdict(list)
        for a in coco.get("annotations", []):
            x, y, w, h = a["bbox"]
            if a.get("iscrowd", 0):
                # crowd regions are excluded from training targets (reference
                # coco.py:123-133) but kept for eval: COCOeval treats them as
                # ignore regions that absorb detections
                crowds_by_img[a["image_id"]].append(
                    (x, y, x + w, y + h, self.cat_to_contig[a["category_id"]])
                )
                continue
            if w < min_size or h < min_size:
                continue
            anns_by_img[a["image_id"]].append((x, y, x + w, y + h, self.cat_to_contig[a["category_id"]]))

        self.images: List[dict] = []
        for img in coco["images"]:
            if filter_empty and not anns_by_img.get(img["id"]):
                continue
            self.images.append(img)
        self.anns_by_img = anns_by_img
        self.crowds_by_img = crowds_by_img
        if tile_hw is None and coco["images"]:
            tile_hw = (max(int(im["height"]) for im in coco["images"]),
                       max(int(im["width"]) for im in coco["images"]))
        self.tile_hw = tuple(tile_hw or canvas_hw)

    def eval_crowds(self, image_id) -> Tuple[np.ndarray, np.ndarray]:
        """Crowd (iscrowd) boxes/labels for one image, original coordinates
        (xyxy, contiguous labels) — feed to COCOEvaluator as gt_crowd rows."""
        rows = self.crowds_by_img.get(int(image_id), [])
        if not rows:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
        arr = np.asarray(rows, np.float32)
        return arr[:, :4], arr[:, 4].astype(np.int32)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int) -> Sample:
        from pytorch_object_detection_tpu_torch.data.decode import decode_image, decode_image_to_tile

        info = self.images[index]
        path = os.path.join(self.image_dir, info["file_name"])
        anns = self.anns_by_img.get(info["id"], [])
        if anns:
            arr = np.asarray(anns, np.float32)
            boxes, labels = arr[:, :4], arr[:, 4].astype(np.int32)
        else:
            boxes = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int32)
        if self.raw_tiles:
            # decode straight into the device tile, no host resize
            tile, (h, w) = decode_image_to_tile(path, self.tile_hw, crop=False)
            scale = min(self.canvas_hw[0] / h, self.canvas_hw[1] / w)
            if boxes.size:
                boxes = boxes * scale
            return Sample(tile, boxes, labels, scale, str(info["id"]), (h, w))
        img = decode_image(path)
        if self.augment is not None:
            img, boxes = self.augment(img, boxes)
        canvas, boxes, scale, content_hw = resize_to_canvas(img, boxes, self.canvas_hw)
        return Sample(canvas, boxes, labels, scale, str(info["id"]), content_hw)
