"""K1: the exact uint8 ResNet stem with its fused 3x3/2 max pool in CUDA
(``csrc/qstem.cu``), and its plain version.

Replaces ``pytorch_object_detection_tpu/ops/pallas_qstem.py:qstem_conv``
(``pool=True``).  Input: raw uint8 frames ``[B, H, W, 3]`` or RGBX ``[B, H,
W, 4]`` (H, W even); output: the pooled stem ``[B, H/4, W/4, 64]`` int8 (H/4
rounded up).  The stem's parameters are the qtree's ``stem_s2d`` entry
(``nn/resnet_int8.quantize_stem_s2d``): ``w [256, 64]`` int8 (the
space-to-depth taps, (ky, kx, c16) order), ``w7 [64, 7, 7, 4]`` int8 (the
same taps in the direct 7x7 form, each output channel's taps contiguous),
``A``, ``B`` f32 ``[64]``, ``pad [16]``
and ``pad4 [4]`` int8 (the border fill in the v = u - 128 domain) and
``scale``.

The plain version is the JAX oracle ``nn/resnet_int8._stem_s2d_i8_xla``
(``:224-245``) on the space-to-depth of the channel-padded frame: exact
int32 accumulation, the f32 epilogue, the int8 pool.  The kernel computes the
direct 7x7/2 form over ``w7``/``pad4``; the two give the same int32 sums.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.nn.resnet import space_to_depth
from pytorch_object_detection_tpu_torch.ops.qpool import qmaxpool3x3s2_plain
from pytorch_object_detection_tpu_torch.ops.quant import clip8, conv_i8

SOURCE = "qstem.cu"
# no FMA contraction: a fused multiply-add moves values across a requant boundary
NVCC_FLAGS = ("-fmad=false",)
COUT = 64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K1; its C signature is declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.qstem_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.qstem_launch.restype = ctypes.c_int
    return lib


def to_rgbx(images: torch.Tensor) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> ``[B, H, W, 4]`` with a fourth channel of 128
    (v = 0, and its weights are 0); a 4-channel frame passes as it is."""
    if images.shape[-1] == 4:
        return images
    return F.pad(images, (0, 1), value=128)


def qstem_plain(st: Dict, xs_u8: torch.Tensor) -> torch.Tensor:
    """The s2d oracle (``_stem_s2d_i8_xla``): ``xs_u8 [B, Hs, Ws, 16]`` uint8,
    the space-to-depth of the RGBX frame -> pooled int8 ``[B, Hs', Ws', 64]``."""
    xs = (xs_u8.to(torch.int16) - 128).to(torch.int8)
    b, hs, ws, c = xs.shape
    pad = st["pad"].to(xs.device).reshape(1, 1, 1, c)
    prow = pad.expand(b, 1, ws, c)
    xp = torch.cat([prow, prow, xs, prow], dim=1)
    pcol = pad.expand(b, hs + 3, 1, c)
    xp = torch.cat([pcol, pcol, xp, pcol], dim=2)
    w = st["w"].reshape(4, 4, c, -1).permute(3, 0, 1, 2)  # (ky, kx, c16) x O -> O, ky, kx, c16
    acc = conv_i8(xp, w.contiguous(), pad=0)
    x_q = clip8(torch.clamp(acc * st["A"] + st["B"], min=0.0))
    return qmaxpool3x3s2_plain(x_q)


def qstem_conv(images: torch.Tensor, st: Dict, *, plain: bool = False) -> torch.Tensor:
    """Raw uint8 frames ``[B, H, W, 3 or 4]`` (H, W even) -> the pooled stem
    ``[B, (H/2 - 1)//2 + 1, (W/2 - 1)//2 + 1, 64]`` int8.

    On a CPU tensor this is :func:`qstem_plain` on the space-to-depth of
    :func:`to_rgbx` of the frames; on a CUDA tensor it launches K1 or
    raises.  ``plain=True`` runs the plain version on any device, for the
    comparison only.  ``qstem_conv.launches`` counts kernel launches.
    """
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] not in (3, 4):
        raise ValueError(f"images must be uint8 [B, H, W, 3 or 4]; got {images.dtype} {tuple(images.shape)}")
    b, h, w, cin = images.shape
    if h % 2 or w % 2:
        raise ValueError(f"the space-to-depth stem takes even H and W; got {h}x{w}")
    if plain or images.device.type == "cpu":
        return qstem_plain(st, space_to_depth(to_rgbx(images), 2))
    if images.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors; got {images.device}")
    w7, a, bb, pad4 = st["w7"], st["A"], st["B"], st["pad4"]
    want = {"w7": (w7, torch.int8, (COUT, 7, 7, 4)), "A": (a, torch.float32, (COUT,)),
            "B": (bb, torch.float32, (COUT,)), "pad4": (pad4, torch.int8, (4,))}
    for name, (v, dtype, shape) in want.items():
        if v.dtype != dtype or tuple(v.shape) != shape or v.device != images.device or not v.is_contiguous():
            raise ValueError(f"stem_s2d {name} must be {dtype} {list(shape)} on {images.device}; "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")
    if not images.is_contiguous():
        raise ValueError("K1 takes NHWC-contiguous frames")
    hp = ((h - 1) // 2) // 2 + 1
    wp = ((w - 1) // 2) // 2 + 1
    out = torch.empty((b, hp, wp, COUT), dtype=torch.int8, device=images.device)
    if out.numel() == 0:
        return out
    if b > 65535 or -(-hp // 8) > 65535:
        raise ValueError(f"K1 takes at most 65535 frames and {65535 * 32} rows; got {tuple(images.shape)}")
    with torch.cuda.device(images.device):  # the launch goes to the current device
        err = _lib().qstem_launch(images.data_ptr(), w7.data_ptr(), a.data_ptr(), bb.data_ptr(),
                                  pad4.data_ptr(), out.data_ptr(), b, h, w, cin,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    qstem_conv.launches += 1
    return out


qstem_conv.launches = 0
