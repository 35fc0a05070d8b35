"""Host image decode on the port's native JPEG library (``native/lib.py``).

The port's copy of ``pytorch_object_detection_tpu/data/decode.py`` without
its PIL fallback: libjpeg straight into numpy, or straight into the fixed
uint8 tile the device resize consumes.  Grayscale, RGB, CMYK and YCCK
JPEGs decode natively (CMYK and YCCK converted to RGB as PIL's
``convert("RGB")`` converts them, which the JAX package reaches through its
PIL fallback); a stream libjpeg cannot read (PNG, corrupt) raises
``ValueError`` naming the file.
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
        raise ValueError(f"the native JPEG decoder declines {_name(path)} (not a JPEG libjpeg reads?)")
    return out


def decode_image_to_tile(path, tile_hw: Tuple[int, int], crop: bool = True):
    """Decode straight into a fixed uint8 tile (``data.pipeline.decode_to_tile``
    semantics).  Returns ``(tile [th, tw, 3] u8, (h, w))``, the content size
    clipped to the tile.  ``crop=False``: an image larger than the tile
    raises ``ValueError`` naming it, where ``decode_to_tile`` would crop it."""
    from pytorch_object_detection_tpu_torch.native.lib import _as_bytes, jpeg_decode_tile_native, jpeg_size_native

    name = _name(path)
    if not crop:
        path = _as_bytes(path)  # read once, for the header and the decode
        size = jpeg_size_native(path)
        if size is not None and (size[0] > tile_hw[0] or size[1] > tile_hw[1]):
            raise ValueError(f"{name} is {size[0]}x{size[1]}, larger than its {tile_hw[0]}x{tile_hw[1]} tile "
                             f"(it would be cropped)")
    out = jpeg_decode_tile_native(path, tile_hw)
    if out is None:
        raise ValueError(f"the native JPEG decoder declines {name} (not a JPEG libjpeg reads?)")
    return out
