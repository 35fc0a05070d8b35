"""Pascal VOC dataset: host-side index + decode, fixed-canvas resize.

The port's copy of ``pytorch_object_detection_tpu/data/voc.py``: VOC XML
parsing with 0-based boxes, difficult-object filtering, the
aspect-preserving resize onto a fixed ``canvas_hw`` (content top-left,
zeros right/bottom) with the resize ``scale`` carried per image, and
``raw_tiles=True``, where the host only decodes into a fixed uint8 tile and
the resize runs batched on the card (``data/pipeline.make_device_resize``).

Decoding goes through the port's native JPEG library with no PIL fallback
(``data/decode.py``).  The host resize of ``resize_to_canvas`` needs
``cv2``, imported where it is used, so the raw-tile path never touches it.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


@dataclass
class Sample:
    """One decoded, canvas-resized sample (host side, numpy)."""

    image: np.ndarray  # [H, W, 3] uint8, content at top-left
    boxes: np.ndarray  # [N, 4] float32 xyxy in canvas coords
    labels: np.ndarray  # [N] int32, 1-based
    scale: float  # canvas coords = original coords * scale
    image_id: str
    content_hw: Tuple[int, int] = (0, 0)  # (nh, nw) of real content on the canvas


def resize_to_canvas(
    image: np.ndarray, boxes: Optional[np.ndarray], canvas_hw: Tuple[int, int]
) -> Tuple[np.ndarray, Optional[np.ndarray], float, Tuple[int, int]]:
    """Aspect-preserving resize onto a fixed canvas (content top-left).

    scale = min over axes of canvas/size, i.e. the reference's
    min-side/max-side rule collapsed onto a static canvas.
    Returns (canvas, boxes, scale, (nh, nw)).
    """
    import cv2

    ch, cw = canvas_hw
    h, w = image.shape[:2]
    scale = min(ch / h, cw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = cv2.resize(image, (nw, nh))
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[:nh, :nw] = resized
    if boxes is not None and boxes.size:
        boxes = boxes * scale
    return canvas, boxes, scale, (nh, nw)


def parse_voc_xml(path: str, use_difficult: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Boxes (0-based xyxy) + 1-based labels from a VOC annotation file."""
    name2id = {n: i + 1 for i, n in enumerate(VOC_CLASSES)}
    root = ET.parse(path).getroot()
    boxes, labels = [], []
    for obj in root.iter("object"):
        difficult_node = obj.find("difficult")
        if not use_difficult and difficult_node is not None and int(difficult_node.text) == 1:
            continue
        bb = obj.find("bndbox")
        # VOC boxes are 1-based; shift to 0-based pixel indices
        coords = [float(bb.find(k).text) - 1.0 for k in ("xmin", "ymin", "xmax", "ymax")]
        name = obj.find("name").text.lower().strip()
        if name not in name2id:
            continue
        boxes.append(coords)
        labels.append(name2id[name])
    if not boxes:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
    return np.asarray(boxes, np.float32), np.asarray(labels, np.int32)


class VOCDataset:
    """Index over one or more VOCdevkit roots (07, 07+12, ...)."""

    def __init__(
        self,
        root_dirs,
        split: str = "trainval",
        canvas_hw: Tuple[int, int] = (512, 512),
        use_difficult: bool = False,
        augment=None,
        raw_tiles: bool = False,
        tile_hw: Optional[Tuple[int, int]] = None,
        cache_decoded: bool = False,
    ):
        """``raw_tiles=True``: skip the host cv2 resize — samples carry the
        decoded image in a fixed uint8 tile (edge-replicated, see
        data/pipeline.decode_to_tile) with content_hw = the TRUE (h, w);
        the aspect-preserving resize then runs batched ON DEVICE
        (data/pipeline.make_device_resize).  Boxes are still host-scaled to
        canvas coordinates (the scale is pure arithmetic — no image work).

        ``cache_decoded=True``: keep each decoded image + parsed annotation
        in memory after first access (small-dataset convergence runs on the
        1-core host are decode-bound; the random augment still runs per
        access, so epochs stay stochastic).
        """
        if isinstance(root_dirs, (str, os.PathLike)):
            root_dirs = [root_dirs]
        self.canvas_hw = canvas_hw
        self.use_difficult = use_difficult
        self.augment = augment
        self.raw_tiles = raw_tiles
        self.tile_hw = tile_hw or (canvas_hw[0], canvas_hw[1])
        self._decoded: Optional[dict] = {} if cache_decoded else None
        self.items: List[Tuple[str, str]] = []  # (root, image_id)
        for root in root_dirs:
            listing = os.path.join(root, "ImageSets", "Main", f"{split}.txt")
            with open(listing) as f:
                ids = [line.strip() for line in f if line.strip()]
            self.items.extend((root, i) for i in ids)
        self.class_names = VOC_CLASSES

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> Sample:
        root, img_id = self.items[index]
        img_path = os.path.join(root, "JPEGImages", f"{img_id}.jpg")
        if self._decoded is not None and index in self._decoded:
            img, boxes, labels = self._decoded[index]
            boxes = boxes.copy()  # downstream scales in place of this ref
        elif self.raw_tiles and self.augment is None and self._decoded is None:
            # hot eval path: native decode straight into the device tile (no
            # intermediate full-image array, no host resize)
            from pytorch_object_detection_tpu_torch.data.decode import decode_image_to_tile

            boxes, labels = parse_voc_xml(
                os.path.join(root, "Annotations", f"{img_id}.xml"), self.use_difficult
            )
            tile, (h, w) = decode_image_to_tile(img_path, self.tile_hw)
            scale = min(self.canvas_hw[0] / h, self.canvas_hw[1] / w)
            if boxes.size:
                boxes = boxes * scale
            return Sample(tile, boxes, labels, scale, img_id, (h, w))
        else:
            from pytorch_object_detection_tpu_torch.data.decode import decode_image

            img = decode_image(img_path)
            boxes, labels = parse_voc_xml(
                os.path.join(root, "Annotations", f"{img_id}.xml"), self.use_difficult
            )
            if self._decoded is not None:
                self._decoded[index] = (img, boxes.copy(), labels)
        if self.augment is not None:
            img, boxes = self.augment(img, boxes)
        if self.raw_tiles:
            from pytorch_object_detection_tpu_torch.data.pipeline import decode_to_tile

            tile, (h, w) = decode_to_tile(img, self.tile_hw)
            scale = min(self.canvas_hw[0] / h, self.canvas_hw[1] / w)
            if boxes.size:
                boxes = boxes * scale
            return Sample(tile, boxes, labels, scale, img_id, (h, w))
        canvas, boxes, scale, content_hw = resize_to_canvas(img, boxes, self.canvas_hw)
        return Sample(canvas, boxes, labels, scale, img_id, content_hw)
