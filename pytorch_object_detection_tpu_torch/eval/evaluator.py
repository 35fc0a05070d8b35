"""Serving pipelines and VOC evaluation: loader -> [device resize ->] forward -> decode -> NMS -> AP.

Counterpart of ``pytorch_object_detection_tpu/eval/evaluator.py``:
``make_eval_pipeline`` (float path, any ported detector) and
``make_eval_pipeline_int8`` (for a HISFCOS or an FCOS by default from raw
uint8 frames through the exact uint8 stem, the int8 backbone, the int8 FPN
and the int8 head; or with the float head behind the int8 FPN,
``int8_head=False``; or the int8 backbone with the float FPN,
``int8_fpn=False``, which is also what an MNFCOS always gets, as in JAX;
an MC_FCOS always gets its one-shot int8 ladder from raw uint8 frames),
and for the anchor families (RetinaNet, SSD300) ``make_eval_pipeline_anchor``
and ``make_eval_pipeline_anchor_int8``, whose decode is the anchor codec
(``ops/anchors.decode_anchor_detections``) with the same ``Detections``.
The JAX versions are one jitted program each; here the pipelines run
eagerly on the model's device, with the kernels (``ops/``) wherever that
device is CUDA.  With ``device_resize=True`` a pipeline takes raw decoded
tiles and their sizes, ``pipeline(tiles_u8, src_hw)``, and resizes them onto
the canvas on that device (``data/pipeline.make_device_resize``).

Data-parallel serving (JAX: the pipeline under ``jax.shard_map`` over the
batch): :class:`DataParallelPipeline` wraps a pipeline for the ranks of a
mesh's data group; every rank takes the global batch, runs its rows on
its own device and all-gathers the fixed-shape detections, so every rank
returns what the pipeline alone returns.  ``make_eval_pipeline_int8``,
``iter_predictions``, ``collect_voc_predictions``, ``evaluate_voc`` and
``evaluate_coco`` take the ``mesh`` to do so.

``evaluate_voc`` and ``evaluate_coco`` run a pipeline over a dataset
through the port's loaders (``iter_predictions``, ``_collect``) and score it
with VOC AP@0.5 (``eval/voc_map.py``) or the COCO protocol
(``eval/coco_map.py``), printing the JAX functions' lines.  The
port's models carry their weights, so these functions take no ``params``
or ``batch_stats``, and a pipeline is called on the frames alone.
"""
from __future__ import annotations

import copy
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pytorch_object_detection_tpu_torch.data.pipeline import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    DetectionLoader,
    make_device_resize,
)
from pytorch_object_detection_tpu_torch.eval.voc_map import eval_voc_ap, mean_ap
from pytorch_object_detection_tpu_torch.models.fcos import FCOS, HISFCOS
from pytorch_object_detection_tpu_torch.models.mcfcos import MC_FCOS
from pytorch_object_detection_tpu_torch.models.mcfcos_int8 import quantize_mcfcos
from pytorch_object_detection_tpu_torch.models.retinanet import STRIDES as RETINA_STRIDES
from pytorch_object_detection_tpu_torch.models.retinanet import RetinaNet
from pytorch_object_detection_tpu_torch.models.retinanet_int8 import quantize_retinanet, retinanet_int8_forward
from pytorch_object_detection_tpu_torch.models.ssd import SSD300, default_boxes
from pytorch_object_detection_tpu_torch.models.ssd_int8 import quantize_ssd300, ssd300_int8_forward
from pytorch_object_detection_tpu_torch.ops.anchors import decode_anchor_detections, generate_anchors
from pytorch_object_detection_tpu_torch.ops.postprocess import Detections, decode_detections, resolve_nms_impl
from pytorch_object_detection_tpu_torch.parallel.collectives import all_gather_rows, broadcast_
from pytorch_object_detection_tpu_torch.parallel.mesh import data_group
from pytorch_object_detection_tpu_torch.train.trainer import (
    fused_head_applies,
    is_efficientnet,
    make_eval_forward_int8,
    quantize_backbone,
    quantize_fpn,
    quantize_head,
)

Levels = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


class _Pipeline:
    """``pipeline(images_u8) -> Detections`` for ``[B, H, W, 3]`` uint8 frames
    on the canvas, or ``pipeline(tiles_u8, src_hw)`` for raw tiles where the
    pipeline was made with ``device_resize=True``.  Tensors or numpy arrays,
    on any device: the pipeline moves them to its own.

    ``forward_levels`` normalizes (``_input``), runs the forward
    (``_forward``, given by the subclass) and returns the per-level f32 NHWC
    maps; ``decode`` turns them into detections (NMS by ``nms_impl``, see
    ``ops/postprocess.resolve_nms_impl``); ``__call__`` does both, after the
    device resize where there is one.
    """

    def __init__(self, device: torch.device, strides: Sequence[int], canvas_hw: Tuple[int, int],
                 score_threshold: float, nms_iou: float, max_detections: int, plain: bool,
                 mean: Sequence[float] = IMAGENET_MEAN, std: Sequence[float] = IMAGENET_STD,
                 device_resize: bool = False, nms_impl: str = "auto"):
        self.device = device
        self.strides = tuple(strides)
        self.canvas_hw = tuple(canvas_hw)
        self.score_threshold, self.nms_iou, self.max_detections = score_threshold, nms_iou, max_detections
        self.mean = torch.tensor(mean, dtype=torch.float32, device=device)
        self.std = torch.tensor(std, dtype=torch.float32, device=device)
        self.plain = plain
        self.nms_plain = plain or resolve_nms_impl(nms_impl, device) == "fixpoint"
        self.resize = make_device_resize(self.canvas_hw) if device_resize else None

    def _forward(self, x: torch.Tensor) -> Levels:
        """Per-level NHWC maps from what ``_input`` makes of the frames."""
        raise NotImplementedError

    def _input(self, images_u8: torch.Tensor) -> torch.Tensor:
        """The frames on the device, normalized to f32 NHWC."""
        return (images_u8.to(self.device, torch.float32) / 255.0 - self.mean) / self.std

    @torch.inference_mode()
    def forward_levels(self, images_u8: torch.Tensor) -> Levels:
        return self._levels(images_u8)

    @torch.inference_mode()
    def decode(self, levels: Levels) -> Detections:
        return self._decode(levels)

    def _levels(self, images_u8: torch.Tensor) -> Levels:
        """``forward_levels`` outside inference mode (``utils/export.py``
        traces it under ``torch.no_grad()``)."""
        if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
            raise ValueError(f"images must be uint8 [B, H, W, 3]; got {images_u8.dtype} {tuple(images_u8.shape)}")
        cls_l, cnt_l, reg_l = self._forward(self._input(images_u8))
        f32 = lambda xs: [t.float() for t in xs]
        return f32(cls_l), f32(cnt_l), f32(reg_l)

    def _decode(self, levels: Levels) -> Detections:
        """``decode`` outside inference mode."""
        cls_l, cnt_l, reg_l = levels
        # decode exactly len(strides) levels: one fewer stride than levels is
        # the reference's documented zip-truncation (test.py:176 decodes 4 of
        # 5 levels); anything else is a config error
        k = len(self.strides)
        if k not in (len(cls_l), len(cls_l) - 1):
            raise ValueError(
                f"{k} strides for a {len(cls_l)}-level model: only the full set "
                f"or the documented ref-compat (levels-1) truncation is allowed")
        return decode_detections(cls_l[:k], cnt_l[:k], reg_l[:k], self.strides, self.score_threshold,
                                 self.nms_iou, self.max_detections, self.canvas_hw, plain=self.nms_plain)

    @torch.inference_mode()
    def canvas(self, images_u8, src_hw=None) -> torch.Tensor:
        """The uint8 canvas frames on the pipeline's device: the frames as
        given, or the device resize of raw tiles to the canvas."""
        images_u8 = torch.as_tensor(images_u8).to(self.device)
        if self.resize is None:
            if src_hw is not None:
                raise ValueError("src_hw is for a pipeline made with device_resize=True")
            return images_u8
        if src_hw is None:
            raise ValueError("a device_resize pipeline takes (tiles_u8, src_hw)")
        return self.resize(images_u8, torch.as_tensor(src_hw))[0]

    def __call__(self, images_u8, src_hw=None) -> Detections:
        return self.decode(self.forward_levels(self.canvas(images_u8, src_hw)))


class EvalPipeline(_Pipeline):
    """The float serving pipeline over a detector module."""

    def __init__(self, model: nn.Module, strides: Sequence[int], canvas_hw: Tuple[int, int],
                 score_threshold: float, nms_iou: float, max_detections: int,
                 compute_dtype: torch.dtype, plain: bool, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD, device_resize: bool = False):
        param = next(model.parameters())
        super().__init__(param.device, strides, canvas_hw, score_threshold, nms_iou, max_detections, plain, mean,
                         std, device_resize)
        # the JAX pipeline casts the f32 params to the compute dtype on each
        # call; here the cast copy is made once (the caller's model is not
        # modified, and later changes to it are not seen)
        self.model = model if param.dtype == compute_dtype else copy.deepcopy(model).to(compute_dtype)
        self.model.eval()
        self.compute_dtype = compute_dtype

    def _forward(self, x: torch.Tensor) -> Levels:
        return self.model(x.to(self.compute_dtype), plain=self.plain)


class Int8EvalPipeline(_Pipeline):
    """The int8 serving pipeline: ``forward(qtree, x)`` from
    ``train/trainer.make_eval_forward_int8`` over a calibrated qtree.  With
    ``u8_input`` the raw uint8 frames go to the device as they are: the
    normalize is folded into the exact uint8 stem."""

    def __init__(self, forward: Callable[[Dict, torch.Tensor], Levels], qtree: Dict, device: torch.device,
                 strides: Sequence[int], canvas_hw: Tuple[int, int], score_threshold: float, nms_iou: float,
                 max_detections: int, plain: bool, mean: Sequence[float], std: Sequence[float],
                 u8_input: bool = False, device_resize: bool = False, nms_impl: str = "auto"):
        super().__init__(device, strides, canvas_hw, score_threshold, nms_iou, max_detections, plain, mean, std,
                         device_resize, nms_impl)
        self.forward, self.qtree, self.u8_input = forward, qtree, u8_input

    def _input(self, images_u8: torch.Tensor) -> torch.Tensor:
        return images_u8.to(self.device).contiguous() if self.u8_input else super()._input(images_u8)

    def _forward(self, x: torch.Tensor) -> Levels:
        return self.forward(self.qtree, x)


class DataParallelPipeline:
    """``pipeline`` served by the ranks of ``mesh``'s data group (the JAX
    pipeline under ``shard_map`` with the batch on the ``data`` axis):
    every rank calls it with the same global batch of B frames (and
    ``src_hw``), runs rows ``[r B / n, (r + 1) B / n)`` through ``pipeline``
    on its own device and all-gathers the fixed-shape ``Detections``, so
    every rank returns what ``pipeline`` alone returns on the whole batch.
    A batch that does not divide by the data size ``n`` raises
    ``ValueError`` (JAX asserts)."""

    def __init__(self, pipeline, mesh):
        self.pipeline = pipeline
        self.group = data_group(mesh)
        self.size, self.rank = torch.distributed.get_world_size(self.group), torch.distributed.get_rank(self.group)

    def __call__(self, images_u8, src_hw=None) -> Detections:
        b = images_u8.shape[0]
        if b % self.size:
            raise ValueError(f"batch {b} does not divide by the data-parallel size {self.size}")
        rows = slice(self.rank * b // self.size, (self.rank + 1) * b // self.size)
        det = self.pipeline(images_u8[rows]) if src_hw is None else self.pipeline(images_u8[rows], src_hw[rows])
        return Detections(*(all_gather_rows(t, self.group) for t in det))


def make_eval_pipeline(
    model: nn.Module,
    strides: Sequence[int],
    canvas_hw: Tuple[int, int],
    score_threshold: float = 0.05,
    nms_iou: float = 0.6,
    max_detections: int = 1000,
    compute_dtype: torch.dtype = torch.bfloat16,
    mean: Sequence[float] = None,
    std: Sequence[float] = None,
    device_resize: bool = False,
    plain: bool = False,
) -> EvalPipeline:
    """Serving pipeline on the model's device: ``(u8/255 - mean) / std``
    (ImageNet statistics by default) in f32, forward in ``compute_dtype``
    (bf16 on the card, f32 on the CPU), per-level outputs cast to f32,
    decode + class-aware NMS (kernel A on CUDA, the plain NMS on the CPU).

    ``device_resize=True``: the pipeline takes raw decoded tiles and their
    sizes, ``(tiles_u8, src_hw)`` (a dataset built with ``raw_tiles=True``),
    and resizes them onto the canvas on the model's device first.
    ``plain=True`` runs every kernel's plain PyTorch version even on CUDA;
    it exists only to compare the kernels with their plain versions.
    """
    return EvalPipeline(model, strides, canvas_hw, score_threshold, nms_iou, max_detections,
                        compute_dtype, plain, IMAGENET_MEAN if mean is None else mean,
                        IMAGENET_STD if std is None else std, device_resize)


def make_eval_pipeline_int8(
    model: nn.Module,
    calib_images: torch.Tensor,
    strides: Sequence[int],
    canvas_hw: Tuple[int, int],
    score_threshold: float = 0.05,
    nms_iou: float = 0.6,
    max_detections: int = 1000,
    mean: Sequence[float] = None,
    std: Sequence[float] = None,
    nms_impl: str = "auto",
    backend: str = "pallas_block",
    int8_fpn: bool = True,
    int8_head: bool = True,
    mesh=None,
    device_resize: bool = False,
    fuse_strided: bool = True,
    direct_stem: bool = False,
    chain_segments: bool = False,
    fused_head: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
    plain: bool = False,
) -> Int8EvalPipeline | DataParallelPipeline:
    """int8-PTQ serving pipeline (the JAX function's signature and defaults;
    the model carries its weights, so there is no ``variables`` argument).

    The defaults (``int8_fpn=True, int8_head=True``) are the JAX package's
    shipped serving path: the pipeline takes the raw uint8 frames with no
    normalize pass; the exact uint8 stem (K1), the int8 ResNet-50 (kernel
    C), the int8 HisFPN (K4, K5, K6), the int8 HISHead (K7; K9 on levels of
    more than 64x64 pixels) on the int8 levels, its ScaleExp, decode and
    NMS (kernel A).  ``int8_head=False``: the int8 HisFPN's levels are
    dequantized to ``compute_dtype`` into the float HISHead (kernel B).
    ``int8_fpn=False``: normalize, int8 ResNet-50, BN-folded float HisFPN,
    float HISHead.  ``backend="pallas_block"`` runs the kernels on CUDA;
    ``"xla"`` the per-op oracles; ``"pallas"`` the backbone's per-conv
    kernels (K4, K11); ``"pallas_stem_tail"`` (with ``int8_fpn=False``, the
    only case with a float stem) the float stem's tail on K17.
    ``fuse_strided``, ``direct_stem`` (the JAX package's
    ``PODT_STEM_XLA7=1``: the u8 stem on K10) and ``chain_segments``
    (``PODT_QCHAIN=1``: the backbone segments on K13) go to
    ``nn/resnet_int8.resnet50_int8_forward``; the JAX function takes the
    first from ``make_eval_forward_int8``'s default and the other two from
    the environment.  ``fused_head`` (the JAX serving bench's
    ``PODT_FUSED_HEAD=1``, with ``int8_fpn=False``): the float HISHead as
    K15, one launch per level (``make_eval_forward_int8``); where the JAX
    switch would be ignored silently (``int8_fpn=True``, ``backend="xla"``
    or a model other than HISFCOS) it raises ``ValueError``.

    An FCOS takes the same defaults and switches: its int8 classic FPN and
    int8 FCOSHead are per-op ladders (``models/fcos_int8.py``: no kernel of
    theirs), so its default path launches K1, kernel C and A, and with
    ``int8_head=False`` also kernel B (the float FCOSHead's 40 GroupNorms).
    An FCOS on EfficientNet takes them too, but its backbone ladder is
    per-op (``nn/efficientnet_int8.py``) and has no uint8 stem: the pipeline
    normalizes the uint8 frames in f32 first (the JAX gate's ``u8_input =
    int8_fpn and backbone == "resnet50"``), so its default path launches A
    alone, and kernel B's 40 with ``int8_head=False``.
    An MC_FCOS gets the JAX function's one-shot ladder whatever
    ``int8_fpn`` and ``int8_head`` say (its evaluator.py:325-336): raw
    uint8 frames, the exact uint8 stem (K1), the int8 ResNet-50 (kernel C on
    ``backend="pallas_block"``, with ``fuse_strided``), then the int8 neck
    and head per-op (``models/mcfcos_int8.py``), calibrated by
    ``quantize_mcfcos``; on the CPU the backbone takes ``backend="xla"``,
    as the JAX function picks there.

    An MNFCOS keeps the JAX gate (its evaluator.py:340): the int8 FPN and
    head are for HISFCOS and FCOS only, so an MNFCOS gets ``int8_fpn=False`` whatever
    is asked: normalized frames, the int8 ResNet-50, then the float
    LightweightFPN and MNHead in ``compute_dtype``.  Its full int8 ladder
    from raw uint8 frames is ``quantize_backbone`` / ``quantize_fpn`` /
    ``quantize_head`` with ``train/trainer.make_eval_forward_int8(int8_fpn=True,
    int8_head=True, u8_input=True)``, as the JAX serving bench builds it.

    ``calib_images``: a representative NORMALIZED NHWC float batch of
    canvas images on the model's device; the backbone's activation scales
    are calibrated on it in ``compute_dtype`` (bf16 on the card, f32 in the
    CPU tests), the HisFPN's and the head's in f32 on the oracles' features
    and levels (``quantize_fpn``, ``quantize_head``).
    ``device_resize=True``: the pipeline takes raw decoded tiles and their
    sizes, ``(tiles_u8, src_hw)``, and resizes them onto the canvas on the
    model's device before the stem (``calib_images`` stay canvas images).
    ``nms_impl``: ``"auto"`` (kernel A on CUDA, the plain NMS on the CPU),
    ``"pallas"`` (kernel A; raises on the CPU) or ``"fixpoint"`` (the plain
    NMS on any device); the JAX ``PODT_NMS`` override is not read
    (``ops/postprocess.resolve_nms_impl``).
    ``plain=True`` runs every kernel's plain version, for comparisons only.
    ``mesh`` (a ``parallel/mesh.create_mesh``): the pipeline is a
    :class:`DataParallelPipeline` over its data group, every rank
    calibrating and then taking rank 0's qtree, so every rank serves the
    same int8 weights.
    """
    is_mc = isinstance(model, MC_FCOS)
    int8_fpn = int8_fpn and isinstance(model, (HISFCOS, FCOS))  # the JAX gate: MNFCOS stays float
    int8_head = int8_head and int8_fpn  # the head is int8 only behind an int8 FPN, as in JAX
    if fused_head and not fused_head_applies(model, backend, int8_fpn):
        raise ValueError(f"fused_head=True runs the float HISHead on K15 behind the float HisFPN: it needs a "
                         f"HISFCOS, int8_fpn=False and a backend other than 'xla' (got {type(model).__name__}, "
                         f"int8_fpn={int8_fpn}, backend={backend!r})")
    device = next(model.parameters()).device
    resolve_nms_impl(nms_impl, device)  # raises on a value the port does not take, before the calibration
    group = data_group(mesh) if mesh is not None else None  # raises on a mesh without a group, before it too
    mean = IMAGENET_MEAN if mean is None else mean
    std = IMAGENET_STD if std is None else std
    if is_mc:  # the one-shot ladder from raw uint8 frames (JAX evaluator.py:325-336)
        u8_input = True
        backend = "xla" if device.type == "cpu" else backend
        qtree = quantize_mcfcos(model, calib_images, compute_dtype, mean, std)
    else:
        # u8 serving input: the normalize affine folds into the exact uint8 stem (ResNet-only, JAX
        # evaluator.py:343-346; the EfficientNet ladder takes normalized floats)
        u8_input = int8_fpn and not is_efficientnet(model)
        qtree = quantize_backbone(model, calib_images, compute_dtype, mean, std)
        if int8_fpn:
            qtree = {"backbone": qtree, "fpn": quantize_fpn(model, qtree, calib_images)}
            if int8_head:
                qtree["head"] = quantize_head(model, qtree["backbone"], qtree["fpn"], calib_images)
    fwd = make_eval_forward_int8(model, compute_dtype, backend=backend, fuse_strided=fuse_strided, int8_fpn=int8_fpn,
                                 int8_head=int8_head, u8_input=u8_input, direct_stem=direct_stem,
                                 chain_segments=chain_segments, fused_head=fused_head, plain=plain)
    pipeline = Int8EvalPipeline(fwd, qtree, device, strides, canvas_hw, score_threshold, nms_iou, max_detections,
                                plain, mean, std, u8_input, device_resize, nms_impl)
    if mesh is None:
        return pipeline
    broadcast_(list(_tensors(qtree)), group)
    return DataParallelPipeline(pipeline, mesh)


def _tensors(tree):
    """The tensors of a nested dict, list or tuple, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class AnchorEvalPipeline(_Pipeline):
    """The serving pipeline of an anchor detector (RetinaNet, SSD300):
    ``forward(qtree, x) -> (loc [B, N, 4], cls [B, N, C])`` on the
    normalized frames (``qtree`` None for the float forward), then the
    anchor decode (``ops/anchors.decode_anchor_detections`` with
    ``activation``) over ``anchors`` on the device.  ``forward_levels``
    returns ``(loc, cls)`` in f32; ``__call__``, ``canvas`` and ``device``
    are those of the FCOS pipelines, and so are the ``Detections``.  No
    device resize: the JAX dispatch refuses it for these families."""

    def __init__(self, forward: Callable[[Optional[Dict], torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
                 qtree: Optional[Dict], anchors: torch.Tensor, activation: str, device: torch.device,
                 canvas_hw: Tuple[int, int], score_threshold: float, nms_iou: float, max_detections: int, plain: bool,
                 mean: Sequence[float], std: Sequence[float]):
        super().__init__(device, (), canvas_hw, score_threshold, nms_iou, max_detections, plain, mean, std)
        self.forward, self.qtree, self.anchors, self.activation = forward, qtree, anchors.to(device), activation

    @torch.inference_mode()
    def forward_levels(self, images_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
            raise ValueError(f"images must be uint8 [B, H, W, 3]; got {images_u8.dtype} {tuple(images_u8.shape)}")
        loc, cls = self.forward(self.qtree, self._input(images_u8))
        return loc.float(), cls.float()

    @torch.inference_mode()
    def decode(self, outputs: Tuple[torch.Tensor, torch.Tensor]) -> Detections:
        loc, cls = outputs
        return decode_anchor_detections(self.anchors, loc, cls, self.activation, self.score_threshold, self.nms_iou,
                                        self.max_detections, self.canvas_hw, plain=self.nms_plain)


def _anchor_layout(model: nn.Module, canvas_hw: Tuple[int, int]) -> Tuple[torch.Tensor, str]:
    """(anchors on the CPU, activation) of an anchor detector at ``canvas_hw``:
    SSD300's default boxes (it is defined at 300x300 only) with the
    background softmax, or RetinaNet's anchors at strides 8..128 with the
    sigmoid."""
    if isinstance(model, SSD300):
        if tuple(canvas_hw) != (300, 300):
            raise ValueError(f"SSD300 is defined at 300x300 (config block: input [300, 300], canvas_align 1); "
                             f"got {tuple(canvas_hw)}")
        return default_boxes(300), "softmax_bg0"
    if not isinstance(model, RetinaNet):
        raise ValueError(f"the anchor pipelines take a RetinaNet or an SSD300; got {type(model).__name__}")
    return generate_anchors(model.level_shapes(canvas_hw), RETINA_STRIDES), "sigmoid"


def make_eval_pipeline_anchor(
    model: nn.Module,
    canvas_hw: Tuple[int, int],
    score_threshold: float = 0.05,
    nms_iou: float = 0.5,
    max_detections: int = 1000,
    compute_dtype: torch.dtype = torch.bfloat16,
    mean: Sequence[float] = None,
    std: Sequence[float] = None,
    plain: bool = False,
) -> AnchorEvalPipeline:
    """Float serving pipeline of a RetinaNet or an SSD300 on the model's
    device: ``(u8/255 - mean) / std`` in f32, the forward in
    ``compute_dtype`` (on a copy of the model cast once, as
    :class:`EvalPipeline` does), loc and cls cast to f32, the anchor decode
    (sigmoid for RetinaNet, the background softmax for SSD300) and
    class-aware NMS: kernel A on CUDA, the plain NMS on the CPU or with
    ``plain=True`` (for the comparison only).  SSD300 takes the 300x300
    canvas only."""
    anchors, activation = _anchor_layout(model, canvas_hw)
    param = next(model.parameters())
    net = model if param.dtype == compute_dtype else copy.deepcopy(model).to(compute_dtype)
    net.eval()
    return AnchorEvalPipeline(lambda _qtree, x: net(x.to(compute_dtype)), None, anchors, activation, param.device,
                              canvas_hw, score_threshold, nms_iou, max_detections, plain,
                              IMAGENET_MEAN if mean is None else mean, IMAGENET_STD if std is None else std)


def make_eval_pipeline_anchor_int8(
    model: nn.Module,
    calib_images: torch.Tensor,
    canvas_hw: Tuple[int, int],
    score_threshold: float = 0.05,
    nms_iou: float = 0.5,
    max_detections: int = 1000,
    mean: Sequence[float] = None,
    std: Sequence[float] = None,
    backend: str = "pallas_block",
    compute_dtype: torch.dtype = torch.bfloat16,
    plain: bool = False,
) -> AnchorEvalPipeline:
    """int8-PTQ serving pipeline of the anchor families (the JAX function's
    signature and defaults less ``variables``: the model carries its weights).

    RetinaNet: the int8 ResNet-50 on the normalized frames in f32 on
    ``backend`` (``"pallas_block"``: kernel C on the 13 stride-1 blocks, the
    three stride-2 blocks per conv on K4, JAX's ``fuse_strided=False``;
    ``"xla"``: the per-op oracle, the JAX CLIs' choice on the CPU), then the
    BN-folded int8 RetinaFPN and int8 subnets per-op
    (``models/retinanet_int8.py``).  SSD300: the whole int8 VGG-16 multibox
    ladder per-op (``models/ssd_int8.py``; ``backend`` unused, as in JAX).
    Then the anchor decode and NMS (kernel A on CUDA).

    ``calib_images``: a representative NORMALIZED NHWC float batch of canvas
    images on the model's device; RetinaNet's backbone calibrates in
    ``compute_dtype`` (the JAX ``quantize_backbone``'s bf16 by default; f32
    in the CPU tests), everything else in f32.  ``plain=True`` runs every
    kernel's plain version, for the comparison only.
    """
    anchors, activation = _anchor_layout(model, canvas_hw)
    device = next(model.parameters()).device
    if isinstance(model, SSD300):
        qtree = quantize_ssd300(model, calib_images)
        forward = lambda qt, x: ssd300_int8_forward(model, qt, x)
    else:
        qtree = quantize_retinanet(model, calib_images, backend, compute_dtype, plain)
        forward = lambda qt, x: retinanet_int8_forward(model, qt, x, backend, plain)
    return AnchorEvalPipeline(forward, qtree, anchors, activation, device, canvas_hw, score_threshold, nms_iou,
                              max_detections, plain, IMAGENET_MEAN if mean is None else mean,
                              IMAGENET_STD if std is None else std)


def make_default_pipeline(model: nn.Module, strides: Sequence[int], canvas_hw: Tuple[int, int],
                          score_threshold: float = 0.05, nms_iou: float = 0.6, max_detections: int = 1000,
                          device_resize: bool = False, compute_dtype: torch.dtype = torch.bfloat16):
    """The JAX ``_default_pipeline``: the anchor codec's float pipeline for a
    RetinaNet or an SSD300 (no device resize: ``ValueError``, where JAX
    asserts), else :func:`make_eval_pipeline`."""
    if isinstance(model, (RetinaNet, SSD300)):
        if device_resize:
            raise ValueError("the device resize is for the FCOS families: the anchor pipelines take canvas frames")
        return make_eval_pipeline_anchor(model, canvas_hw, score_threshold, nms_iou, max_detections, compute_dtype)
    return make_eval_pipeline(model, strides, canvas_hw, score_threshold, nms_iou, max_detections, compute_dtype,
                              device_resize=device_resize)


def _collect(det: Detections, scales, n_valid: int = -1):
    """Fetch detections to the host, unscale them to the original images and
    keep the valid entries: ``[(boxes, classes, scores)]`` per image.

    All ``max_detections`` NMS survivors are kept (the reference carries up
    to 1000 through NMS, test.py:172-174).  ``n_valid`` trims the loader's
    padding rows.
    """
    scores, classes, boxes, valid = (t.cpu().numpy() for t in det)
    n = scores.shape[0] if n_valid < 0 else n_valid
    return [(boxes[i][valid[i]] / scales[i], classes[i][valid[i]], scores[i][valid[i]]) for i in range(n)]


def iter_predictions(
    pipeline,
    dataset,
    batch_size: int = 16,
    num_workers: int = 8,
    mesh=None,
    process_count: Optional[int] = None,
    process_index: Optional[int] = None,
    use_ring_loader: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, str]]:
    """Run ``pipeline`` over this process's shard of ``dataset``, yielding
    ``(gt_boxes, gt_labels, pred_boxes, pred_labels, pred_scores, image_id)``
    per image in original-image coordinates; the union over processes covers
    every image once.  The ground truth is the loader's batch, so at most
    ``max_boxes`` (64) boxes an image, as in the JAX evaluators.  A raw-tile
    dataset (``raw_tiles=True``) feeds ``pipeline(tiles, src_hw)``, which
    must resize on the device.  ``use_ring_loader``: batches from
    ``data/pipeline.RingTileLoader`` (one native batch decode per batch; a
    raw-tile VOC dataset), else ``DetectionLoader``; the same batches.
    ``mesh``: every rank of its data group loads every batch (unless
    ``process_count`` and ``process_index`` say otherwise) and serves it
    through ``pipeline`` as a :class:`DataParallelPipeline`, so every rank
    yields every image; ``batch_size`` must divide by the data size.
    """
    if mesh is not None:
        if not isinstance(pipeline, DataParallelPipeline):
            pipeline = DataParallelPipeline(pipeline, mesh)
        if process_count is None and process_index is None:
            process_count, process_index = 1, 0
    if use_ring_loader:
        from pytorch_object_detection_tpu_torch.data.pipeline import RingTileLoader

        loader = RingTileLoader(dataset, batch_size, shuffle=False, drop_last=False, pad_last=True,
                                decode_threads=num_workers, process_count=process_count,
                                process_index=process_index)
    else:
        loader = DetectionLoader(dataset, batch_size, shuffle=False, drop_last=False, num_workers=num_workers,
                                 pad_last=True, process_count=process_count, process_index=process_index)
    raw_tiles = bool(getattr(dataset, "raw_tiles", False))
    for batch in loader:
        images = torch.from_numpy(batch.images)
        if raw_tiles:
            det = pipeline(images, torch.from_numpy(np.stack([batch.content_h, batch.content_w], 1).astype(np.int32)))
        else:
            det = pipeline(images)
        for i, (b, c, s) in enumerate(_collect(det, batch.scales, batch.n_valid)):
            gt_valid = batch.labels[i] > 0
            yield batch.boxes[i][gt_valid] / batch.scales[i], batch.labels[i][gt_valid], b, c, s, batch.image_ids[i]


def collect_voc_predictions(
    pipeline,
    dataset,
    batch_size: int = 16,
    num_workers: int = 8,
    mesh=None,
    process_count: Optional[int] = None,
    process_index: Optional[int] = None,
    use_ring_loader: bool = False,
):
    """Run ``pipeline`` over this process's shard of ``dataset``.

    Returns per-image lists ``(gt_boxes, gt_labels, pred_boxes, pred_labels,
    pred_scores, image_ids)`` in original-image coordinates
    (:func:`iter_predictions`, whose arguments these are).
    """
    rows = list(iter_predictions(pipeline, dataset, batch_size, num_workers, mesh, process_count, process_index,
                                 use_ring_loader))
    return tuple(list(col) for col in zip(*rows)) if rows else ([], [], [], [], [], [])


def evaluate_voc(
    model,
    dataset,
    strides: Sequence[int] = (8, 16, 32, 64, 128),
    batch_size: int = 16,
    num_classes: int = 20,
    iou_threshold: float = 0.5,
    num_workers: int = 8,
    verbose: bool = True,
    mesh=None,
    score_threshold: float = 0.05,
    nms_iou: float = 0.6,
    max_detections: int = 1000,
    process_count: Optional[int] = None,
    process_index: Optional[int] = None,
    pipeline=None,
    use_ring_loader: bool = False,
) -> Dict:
    """Full VOC eval: per-class AP@0.5, mAP, images/sec (reference test.py).

    The JAX function's arguments less ``params`` and ``batch_stats`` (the
    model carries its weights).  ``pipeline`` injects a pipeline (e.g.
    :func:`make_eval_pipeline_int8`'s); by default the float pipeline of
    ``model`` in bf16 (:func:`make_default_pipeline`: with the device resize
    where the dataset has ``raw_tiles``; the anchor codec's for RetinaNet and
    SSD300).  ``process_count``/``process_index``
    override the loader's shard; ``use_ring_loader``: see
    :func:`collect_voc_predictions`.  The AP matches in the native ops
    library (``eval/voc_map.eval_voc_ap``).  ``mesh``: the ranks of its data
    group serve every batch together (:func:`iter_predictions`), and every
    rank returns the whole result.  ``images_per_sec`` counts the loader, the
    pipeline and the fetch of its detections.
    """
    if pipeline is None:
        pipeline = make_default_pipeline(model, strides, dataset.canvas_hw, score_threshold, nms_iou, max_detections,
                                         device_resize=bool(getattr(dataset, "raw_tiles", False)))
    t0 = time.perf_counter()
    gt_boxes, gt_labels, pred_boxes, pred_labels, pred_scores, _ids = collect_voc_predictions(
        pipeline, dataset, batch_size, num_workers, mesh=mesh, process_count=process_count,
        process_index=process_index, use_ring_loader=use_ring_loader)
    n_images = len(gt_boxes)
    elapsed = time.perf_counter() - t0
    aps = eval_voc_ap(gt_boxes, gt_labels, pred_boxes, pred_labels, pred_scores, iou_threshold, num_classes)
    result = {
        "per_class_ap": aps,
        "mAP": mean_ap(aps),
        "images_per_sec": n_images / elapsed,
        "num_images": n_images,
    }
    if verbose:
        names = getattr(dataset, "class_names", None)
        for cls, ap in sorted(aps.items()):
            label = names[cls - 1] if names else str(cls)
            print(f"ap for {label} is {ap}")
        print(f"mAP=====>{result['mAP']:.3f}  ({result['images_per_sec']:.1f} img/s)")
    return result


def evaluate_coco(
    model,
    dataset,
    strides: Sequence[int] = (8, 16, 32, 64, 128),
    batch_size: int = 16,
    num_workers: int = 8,
    results_json: Optional[str] = None,
    verbose: bool = True,
    mesh=None,
    score_threshold: float = 0.05,
    nms_iou: float = 0.6,
    max_detections: int = 1000,
    process_count: Optional[int] = None,
    process_index: Optional[int] = None,
    pipeline=None,
) -> Dict:
    """COCO-protocol eval: the 12-number summary, images/sec, and optionally
    a results JSON (xyxy -> xywh in original coordinates, the dataset's
    category ids, int image ids: reference Test_coco.py:144-177).

    The JAX function's arguments less ``params`` and ``batch_stats`` (the
    model carries its weights).  ``pipeline`` injects a pipeline (e.g.
    :func:`make_eval_pipeline_int8`'s; made with ``device_resize=True`` for
    a dataset with ``raw_tiles``); by default the float pipeline of
    ``model`` in bf16 (:func:`make_default_pipeline`).  Crowd regions
    (``dataset.eval_crowds``) join each image's GT as ``gt_crowd`` rows.
    The batches come from :func:`iter_predictions` (so the GT is the
    loader's, at most 64 boxes an image, as in JAX); the matching runs in
    the native ops library (``eval/coco_map.COCOEvaluator``).  ``mesh`` as
    :func:`evaluate_voc`'s.  ``images_per_sec``
    counts the loader, the pipeline, the fetch of its detections and the
    evaluator's bookkeeping, not the summary.
    """
    import json

    from pytorch_object_detection_tpu_torch.eval.coco_map import COCOEvaluator

    if mesh is not None:
        data_group(mesh)  # a mesh without a process group raises before anything is built
    if pipeline is None:
        pipeline = make_default_pipeline(model, strides, dataset.canvas_hw, score_threshold, nms_iou, max_detections,
                                         device_resize=bool(getattr(dataset, "raw_tiles", False)))
    evaluator = COCOEvaluator(len(dataset.class_names))
    json_records = []
    n_images = 0
    t0 = time.perf_counter()
    for gt_b, gt_l, b, c, s, image_id in iter_predictions(pipeline, dataset, batch_size, num_workers, mesh,
                                                         process_count, process_index):
        image_id = int(image_id)
        crowd_flags = np.zeros(len(gt_l), bool)
        if hasattr(dataset, "eval_crowds"):
            # crowd regions: ignore GTs with COCOeval iscrowd semantics
            cb, cl = dataset.eval_crowds(image_id)
            if len(cl):
                gt_b = np.concatenate([gt_b, cb])
                gt_l = np.concatenate([gt_l, cl])
                crowd_flags = np.concatenate([crowd_flags, np.ones(len(cl), bool)])
        evaluator.add_image(image_id, gt_b, gt_l, b, c, s, gt_crowd=crowd_flags)
        if results_json is not None:
            for box, cls_id, score in zip(b, c, s):
                x1, y1, x2, y2 = [float(v) for v in box]
                json_records.append({
                    "image_id": image_id,
                    "category_id": int(dataset.contig_to_cat[int(cls_id)]),
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "score": float(score),
                })
        n_images += 1
    elapsed = time.perf_counter() - t0

    if results_json is not None:
        with open(results_json, "w") as f:
            json.dump(json_records, f)

    stats = evaluator.summarize()
    stats["images_per_sec"] = n_images / elapsed
    stats["num_images"] = n_images
    if verbose:
        for k, v in stats.items():
            print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    return stats
