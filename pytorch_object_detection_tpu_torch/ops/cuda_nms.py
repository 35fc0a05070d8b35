"""Kernel A: greedy NMS keep mask in CUDA (``csrc/nms.cu``).

Replaces ``pytorch_object_detection_tpu/ops/pallas_nms.py``
(``pallas_nms_keep_mask``, via ``pallas_batched_class_nms``).  The source
note in ``csrc/nms.cu`` says what bounds it on the card and how the design
answers.  The plain version is ``ops/nms.nms_keep_mask``: the wrapper takes
it only for a tensor on the CPU; on a CUDA tensor it launches the kernel or
raises.  ``podt::nms_keep_mask`` (``ops/library.py``) is the op a tracer
records: kernel A on CUDA, the plain fixpoint on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.ops.nms import class_offset_boxes, fixpoint_keep_mask

SOURCE = "nms.cu"
# no FMA contraction: exact-threshold IoUs must round as the plain version's
# separate multiply and add do
NVCC_FLAGS = ("-fmad=false",)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load kernel A; the C function's signature is
    declared once here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    fn = lib.nms_keep_mask
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def cuda_nms_keep_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy-NMS keep mask ``[B, K]`` bool.

    boxes ``[B, K, 4]`` float32, score-sorted, class offsets already
    applied; valid ``[B, K]`` bool.  ``cuda_nms_keep_mask.launches`` counts
    kernel launches.
    """
    if library.route(boxes):
        return nms_keep_mask_op(boxes, valid, float(iou_threshold))
    if boxes.device.type == "cpu":
        return fixpoint_keep_mask(boxes, valid, iou_threshold)
    return _launch(boxes, valid, iou_threshold)


def _launch(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Kernel A on CUDA tensors, counted in ``cuda_nms_keep_mask.launches``."""
    if boxes.device.type != "cuda":
        raise ValueError(f"kernel A runs on CUDA tensors; got {boxes.device}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be float32 [B, K, 4]; got {boxes.dtype} {tuple(boxes.shape)}")
    if valid.shape != boxes.shape[:2] or valid.dtype != torch.bool or valid.device != boxes.device:
        raise ValueError(f"valid must be bool {tuple(boxes.shape[:2])} on {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("kernel A takes contiguous boxes and valid")
    b, k = valid.shape
    if b > 65535:
        raise ValueError(f"kernel A takes at most 65535 images per call; got {b}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    words = -(-k // 64)
    mask = torch.empty((b, k, words), dtype=torch.int64, device=boxes.device)
    lib = _lib()
    with torch.cuda.device(boxes.device):  # the launch goes to the current device
        err = lib.nms_keep_mask(boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(), keep.data_ptr(),
                                b, k, float(iou_threshold), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel A launch failed: cudaError {err}")
    cuda_nms_keep_mask.launches += 1
    return keep


cuda_nms_keep_mask.launches = 0

nms_keep_mask_op = library.define(
    "nms_keep_mask", "(Tensor boxes, Tensor valid, float iou_threshold) -> Tensor",
    cpu=fixpoint_keep_mask, cuda=_launch,
    fake=lambda boxes, valid, iou_threshold: library.empty_like_shape(valid, valid.shape, torch.bool))


def cuda_batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                           valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Class-aware keep mask through kernel A; drop-in for
    ``ops/nms.batched_class_nms``.  The class offset is applied here, in
    PyTorch, exactly as the plain version applies it."""
    del scores
    shifted = class_offset_boxes(boxes, classes, valid).contiguous()
    return cuda_nms_keep_mask(shifted, valid.contiguous(), iou_threshold)
