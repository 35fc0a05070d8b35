"""Host image decode on the port's native JPEG library (``native/lib.py``).

The port's copy of ``pytorch_object_detection_tpu/data/decode.py`` without
its PIL fallback: libjpeg straight into numpy, or straight into the fixed
uint8 tile the device resize consumes.  A stream the native decoder
declines (CMYK, PNG, corrupt) raises ``ValueError`` naming the file.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _name(path) -> str:
    return f"{len(path)} bytes" if isinstance(path, (bytes, bytearray)) else str(path)


def decode_image(path) -> np.ndarray:
    """RGB uint8 ``[H, W, 3]`` from a JPEG file or its bytes."""
    from pytorch_object_detection_tpu_torch.native.lib import jpeg_decode_native

    out = jpeg_decode_native(path)
    if out is None:
        raise ValueError(f"the native JPEG decoder declines {_name(path)} (not a baseline RGB/gray JPEG?)")
    return out


def decode_image_to_tile(path, tile_hw: Tuple[int, int]):
    """Decode straight into a fixed uint8 tile (``data.pipeline.decode_to_tile``
    semantics).  Returns ``(tile [th, tw, 3] u8, (h, w))``, the content size
    clipped to the tile."""
    from pytorch_object_detection_tpu_torch.native.lib import jpeg_decode_tile_native

    out = jpeg_decode_tile_native(path, tile_hw)
    if out is None:
        raise ValueError(f"the native JPEG decoder declines {_name(path)} (not a baseline RGB/gray JPEG?)")
    return out
