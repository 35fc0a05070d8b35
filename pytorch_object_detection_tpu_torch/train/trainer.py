"""Training, int8 PTQ and the int8 eval forwards (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/train/trainer.py``.

Training (JAX ``:35-270``): the freeze set (:func:`param_labels`),
:func:`make_optimizer`, :class:`TrainState`, :func:`create_train_state`,
:func:`make_train_step` and :func:`make_train_step_scan`.  A step is
forward (under ``torch.autocast`` in bf16 over the f32 master weights, or
in f32), the outputs cast to f32, FCOS targets on the device
(``ops/targets.py``), ``fcos_loss``, backward and the optimizer's update,
with no host sync inside.  Frozen parameters get ``requires_grad=False``
and stay out of the optimizer (optax's ``set_to_zero``); every BatchNorm is
frozen, its affine and statistics being buffers.  The GroupNorms take
``F.group_norm`` while autograd records (``nn/layers.GroupNorm32``), so a
train step launches kernel B no time; an eval forward after it does.  Not
ported: ``bn_train`` (SyncBN) and ``make_shard_map_train_step`` (ROADMAP
queue 1 item 11), ``make_anchor_train_step`` (item 10).

int8 PTQ: ``quantize_backbone``, ``_backbone_int8_feats``,
``quantize_fpn`` and ``quantize_head`` (:412-582, the HISFCOS and MNFCOS
branches), and ``make_eval_forward_int8`` (:596-776) for the two ResNet-50
FCOS families ported so far.  An int8 ResNet-50 (its stem float, or the
exact uint8 stem with ``u8_input=True``), then:

  * HISFCOS: either the BN-folded float HisFPN (``int8_fpn=False``) and the
    float HISHead (its GroupNorms on kernel B), or the int8 HisFPN, whose
    levels go dequantized to the float HISHead (``int8_head=False``) or
    stay int8 into the int8 HISHead (``int8_head=True``, the JAX default
    serving path);
  * MNFCOS: either the float LightweightFPN with its BN and the float
    MNHead (``int8_fpn=False``), or the int8 LightweightFPN
    (``models/mnfcos_int8.py``), whose levels go dequantized to the float
    MNHead or stay int8 into the int8 MNHead.

Every int8 backbone backend of the JAX function is ported
(``nn/resnet_int8.resnet50_int8_forward``), and ``fused_head=True``: the
whole-level bf16 HISHead on K15 (``ops/head.py``) behind the float HisFPN.
Not ported yet, raising ``NotImplementedError`` with its ROADMAP item: the
other model families.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pytorch_object_detection_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from pytorch_object_detection_tpu_torch.models.fcos import HISFCOS, MNFCOS
from pytorch_object_detection_tpu_torch.models.head_int8 import calibrate_hishead, hishead_int8_forward, quantize_hishead
from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import (
    calibrate_lwfpn,
    calibrate_mnhead,
    lwfpn_int8_forward,
    mnhead_int8_forward,
    quantize_lwfpn,
    quantize_mnhead,
)
from pytorch_object_detection_tpu_torch.nn.fpn_int8 import calibrate_hisfpn, hisfpn_int8_forward, quantize_hisfpn
from pytorch_object_detection_tpu_torch.nn.fused_fpn import fold_hisfpn, hisfpn_folded_forward
from pytorch_object_detection_tpu_torch.nn.layers import BatchNorm
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import (
    calibrate_resnet50,
    quantize_resnet50,
    resnet50_int8_forward,
)
from pytorch_object_detection_tpu_torch.ops.head import hishead_level_fused, hishead_params_pack
from pytorch_object_detection_tpu_torch.ops.losses import fcos_loss, flatten_level_preds
from pytorch_object_detection_tpu_torch.ops.targets import generate_targets
from pytorch_object_detection_tpu_torch.train.schedules import warmup_step_decay

Levels = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def param_labels(model: nn.Module, freeze_bn: bool = True, frozen_stages: int = 0) -> Dict[str, str]:
    """``name -> "train" | "freeze"`` for every tensor the JAX package keeps
    under ``params``: the parameters and the BatchNorm affines (buffers
    here).  The JAX ``param_labels``: with ``freeze_bn`` every BatchNorm;
    the backbone's ``conv1``/``bn1`` (even at ``frozen_stages=0``) and
    ``layer1..k`` at ``frozen_stages=k``.  :func:`make_optimizer` applies
    the labels only where ``freeze_bn`` or ``frozen_stages > 0`` (JAX
    ``:112``); ``conv1_s2d`` trains, as in JAX."""
    names = [n for n, _ in model.named_parameters()]
    bn_names = {f"{m}.{leaf}" for m, mod in model.named_modules() if isinstance(mod, BatchNorm)
                for leaf in ("weight", "bias")}

    def label(name: str) -> str:
        keys = name.split(".")
        if freeze_bn and name in bn_names:
            return "freeze"
        if frozen_stages >= 0 and len(keys) >= 2 and keys[0] == "backbone":
            if keys[1] in ("conv1", "bn1"):
                return "freeze"
            if any(keys[1].startswith(f"layer{s}_") for s in range(1, frozen_stages + 1)):
                return "freeze"
        return "train"

    return {n: label(n) for n in names + sorted(bn_names)}


class RAdam(torch.optim.Optimizer):
    """RAdam as optax's ``scale_by_radam``: the rectified Adam update
    ``r * mu_hat / (sqrt(nu_hat) + eps)`` where ``rho >= threshold``, else the
    bias-corrected momentum alone (``torch.optim.RAdam`` rectifies where
    ``rho > 5`` and puts ``eps`` inside the bias correction)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                t, mu, nu = state["step"], state["mu"], state["nu"]
                mu.mul_(b1).add_(p.grad, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
                b2t = b2 ** t
                ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
                mu_hat = mu / (1.0 - b1 ** t)
                if ro >= group["threshold"]:
                    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                    mu_hat = r * mu_hat / ((nu / (1.0 - b2t)).sqrt() + group["eps"])
                p.add_(mu_hat, alpha=-group["lr"])


def make_optimizer(name: str, params, lr: float = 1e-2, momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """The JAX ``make_optimizer``'s chains over ``params`` (the trainable
    ones): SGD is ``add_decayed_weights -> trace -> scale_by_learning_rate``
    (torch's SGD: decay before momentum, no dampening, no Nesterov); Adam
    and RAdam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, RAdam's
    threshold 5) and no decay; AdamW with decoupled decay.  The train step
    sets each group's ``lr`` from the schedule before the update."""
    params = list(params)
    key = name.upper()
    if key == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay, dampening=0.0,
                               nesterov=False)
    if key == "ADAM":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    if key == "ADAMW":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    if key == "RADAM":
        return RAdam(params, lr=lr)
    raise NotImplementedError(f"optimizer {name}")


class TrainState:
    """The model (its trainable parameters the f32 master weights), the
    optimizer over those, the ``step -> lr`` schedule and the step count
    (on the host: the count of updates taken)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                 step: int = 0):
        self.model, self.optimizer, self.schedule, self.step = model, optimizer, schedule, step

    def trainable_names(self) -> List[str]:
        return [n for n, p in self.model.named_parameters() if p.requires_grad]

    def state_dict(self) -> Dict[str, Any]:
        """Weights, buffers, optimizer state and step; ``trainable`` names the
        optimizer's parameters in order."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": self.step,
                "trainable": self.trainable_names()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load :meth:`state_dict`'s output.  The weights must match the
        model; an optimizer state saved over other trainable parameters
        (other freeze masks) is not loaded, and the optimizer stays as it is."""
        self.model.load_state_dict(state["model"])
        if list(state.get("trainable", [])) == self.trainable_names():
            self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def create_train_state(model: nn.Module, optimizer_cfg: Optional[Dict] = None, freeze_bn: bool = True,
                       frozen_stages: int = 1) -> TrainState:
    """The JAX ``create_train_state`` for a built model (its weights are
    the initial state): the schedule from ``optimizer_cfg`` (``lr``,
    ``warmup_steps``, ``warmup_factor``, ``milestones``, ``gamma``, and
    ``swa_lr`` from ``swa_start_step`` on), the freeze set applied
    (``requires_grad=False``), and the optimizer (``name``, ``momentum``,
    ``weight_decay``) over the parameters left trainable."""
    if not freeze_bn:
        raise NotImplementedError("freeze_bn=False (trainable BatchNorm affines) is not ported: the port's "
                                  "BatchNorms are frozen buffers; ROADMAP.md queue 1 item 11 (bn_train, SyncBN)")
    cfg = optimizer_cfg or {}
    schedule = warmup_step_decay(cfg.get("lr", 1e-2), cfg.get("warmup_steps", 500),
                                 cfg.get("warmup_factor", 1.0 / 3.0), cfg.get("milestones", (120000, 160000)),
                                 cfg.get("gamma", 0.1))
    if cfg.get("swa_lr"):
        base, swa_v, start = schedule, float(cfg["swa_lr"]), int(cfg.get("swa_start_step", 0))
        schedule = lambda step: base(step) if step < start else float(np.float32(swa_v))
    labels = param_labels(model, freeze_bn, frozen_stages)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
    trainable = [p for p in model.parameters() if p.requires_grad]
    optimizer = make_optimizer(cfg.get("name", "SGD"), trainable, schedule(0), cfg.get("momentum", 0.9),
                               cfg.get("weight_decay", 1e-4))
    return TrainState(model, optimizer, schedule)


def make_train_step(model: nn.Module, level_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                    limit_ranges: Sequence[Tuple[float, float]], reg_mode: str = "giou",
                    compute_dtype: torch.dtype = torch.bfloat16, bn_train: bool = False, remat: bool = False,
                    cnt_mode: str = "bce"):
    """The train step: ``step(state, images [B, H, W, 3] normalized f32,
    boxes [B, M, 4], labels [B, M], record=None) -> {"cls", "cnt", "reg",
    "total"}``, 0-d f32 tensors on the device, detached.  It sets the lr to
    ``state.schedule(state.step)``, runs the forward (under
    ``torch.autocast`` on the images' device for ``compute_dtype=bf16``, in
    f32 otherwise; ``remat=True`` recomputes it in the backward by
    non-reentrant ``torch.utils.checkpoint``), casts the per-level outputs
    to f32, builds the targets, the loss, the backward and the update, and
    adds one to ``state.step``.  ``record(phase)``, where given, is called
    after each of ``"forward"``, ``"loss"`` (targets and loss),
    ``"backward"`` and ``"optimizer"`` (for timing the phases apart).
    ``model`` must be ``state.model``."""
    if bn_train:
        raise NotImplementedError("bn_train=True (BatchNorm statistics in training, SyncBN) is not ported: "
                                  "ROADMAP.md queue 1 item 11")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype must be bfloat16 or float32; got {compute_dtype}")

    def forward(images):
        return model(images)

    def step(state: TrainState, images: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
             record: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the train step was made for another model than state.model")
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=compute_dtype == torch.bfloat16):
            if remat:
                out = torch.utils.checkpoint.checkpoint(forward, images, use_reentrant=False)
            else:
                out = forward(images)
        if record:
            record("forward")
        cls_p, cnt_p, reg_p = (flatten_level_preds([t.float() for t in branch]) for branch in out)
        tgt = generate_targets(level_shapes, strides, limit_ranges, boxes, labels)
        losses = fcos_loss(cls_p, cnt_p, reg_p, tgt.cls, tgt.cnt, tgt.reg, reg_mode, cnt_mode)
        if record:
            record("loss")
        losses["total"].backward()
        if record:
            record("backward")
        state.optimizer.step()
        state.step += 1
        if record:
            record("optimizer")
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_train_step_scan(model: nn.Module, level_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                         limit_ranges: Sequence[Tuple[float, float]], reg_mode: str = "giou",
                         compute_dtype: torch.dtype = torch.bfloat16, bn_train: bool = False, remat: bool = False,
                         cnt_mode: str = "bce"):
    """K train steps in one call: ``steps(state, images [K, B, ...], boxes
    [K, B, M, 4], labels [K, B, M]) -> {name: [K] tensor}``, numerically the
    K calls of :func:`make_train_step`'s step."""
    single = make_train_step(model, level_shapes, strides, limit_ranges, reg_mode, compute_dtype, bn_train, remat,
                             cnt_mode)

    def steps(state: TrainState, images: torch.Tensor, boxes: torch.Tensor,
              labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        per_step = [single(state, images[k], boxes[k], labels[k]) for k in range(images.shape[0])]
        return {name: torch.stack([m[name] for m in per_step]) for name in per_step[0]}

    return steps


# ---------------------------------------------------------------------------
# int8 PTQ and the int8 eval forwards
# ---------------------------------------------------------------------------


def _require_ported(model: nn.Module) -> None:
    if not isinstance(model, (HISFCOS, MNFCOS)):
        raise NotImplementedError(
            f"the int8 ladder is ported for the ResNet-50 FCOS families HISFCOS and MNFCOS; got "
            f"{type(model).__name__}: ROADMAP.md queue 1 item 10 (the other families)")


def quantize_backbone(model: nn.Module, calib_images: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16, mean=None, std=None) -> Dict:
    """PTQ of the detector's ResNet-50: calibrate activation scales on
    ``calib_images`` (a representative NORMALIZED NHWC batch, on the
    model's device) in ``compute_dtype`` and return the int8 qtree for
    :func:`make_eval_forward_int8`.  ``mean``/``std`` (the input-normalize
    constants, ImageNet's by default) make the exact uint8 stem's
    ``stem_s2d`` entry."""
    _require_ported(model)
    taps = calibrate_resnet50(model.backbone, calib_images, compute_dtype)
    return quantize_resnet50(model.backbone, taps, IMAGENET_MEAN if mean is None else mean,
                             IMAGENET_STD if std is None else std)


def _backbone_int8_feats(qtree_bb: Dict, images: torch.Tensor, **kw):
    """(C3..C5) int8 NHWC + scales through the int8 ResNet-50 ladder (the
    per-op oracle unless ``backend`` says otherwise)."""
    kw.setdefault("backend", "xla")
    return resnet50_int8_forward(qtree_bb, images, torch.float32, dequant=False, **kw)


def quantize_fpn(model: nn.Module, qtree_bb: Dict, calib_images: torch.Tensor) -> Dict:
    """PTQ of the FPN (extends :func:`quantize_backbone`; the HisFPN of a
    HISFCOS, the LightweightFPN of an MNFCOS): calibrate its activation
    scales on the int8 backbone's dequantized C3..C5, the distribution the
    int8 FPN sees when serving, and return the FPN qtree for
    ``make_eval_forward_int8(int8_fpn=True)``.

    As the JAX function does, the features come from the per-op oracle with
    the float stem, in f32, on the NORMALIZED ``calib_images`` (not from the
    uint8 stem), whatever compute dtype the pipeline serves in.
    """
    _require_ported(model)
    feats_q, scales = _backbone_int8_feats(qtree_bb, calib_images)
    feats = [q.float() * s for q, s in zip(feats_q, scales)]
    if isinstance(model, MNFCOS):
        return quantize_lwfpn(model.fpn, calibrate_lwfpn(model.fpn, feats), scales)
    return quantize_hisfpn(model.fpn, calibrate_hisfpn(model.fpn, feats), scales)


def quantize_head(model: nn.Module, qtree_bb: Dict, qtree_fpn: Dict, calib_images: torch.Tensor) -> Dict:
    """PTQ of the head (extends :func:`quantize_fpn` through the whole
    detector; the HISHead or the MNHead): calibrate its per-level
    activation scales on the int8 FPN's dequantized levels and return the
    head qtree for ``make_eval_forward_int8(int8_fpn=True, int8_head=True)``.

    As the JAX function does, the levels come from the per-op oracles, in
    f32: the backbone with the float stem on the NORMALIZED
    ``calib_images``, then the int8 FPN with ``dequant=False``.
    """
    _require_ported(model)
    feats_q, _ = _backbone_int8_feats(qtree_bb, calib_images)
    if isinstance(model, MNFCOS):
        levels_q, level_scales = lwfpn_int8_forward(qtree_fpn, feats_q, dequant=False, backend="xla")
        levels = [q.float() * s for q, s in zip(levels_q, level_scales)]
        return quantize_mnhead(model.head, calibrate_mnhead(model.head, levels), level_scales, model.num_classes)
    levels_q, level_scales = hisfpn_int8_forward(qtree_fpn, feats_q, torch.float32, backend="xla", dequant=False)
    levels = [q.float() * s for q, s in zip(levels_q, level_scales)]
    return quantize_hishead(model.head, calibrate_hishead(model.head, levels), level_scales, model.num_classes)


def fused_head_applies(model: nn.Module, backend: str, int8_fpn: bool) -> bool:
    """Whether ``fused_head=True`` puts the head on K15: only for a HISFCOS,
    behind the float HisFPN and an int8 backbone backend other than the
    oracle, as the JAX ``make_eval_forward_int8`` decides (its
    trainer.py:752)."""
    return isinstance(model, HISFCOS) and not int8_fpn and backend != "xla"


def make_eval_forward_int8(model: nn.Module, compute_dtype: torch.dtype = torch.bfloat16,
                           backend: str = "pallas_block", use_pallas_gn: bool = False, fused_head: bool = False,
                           fuse_strided: bool = True, int8_fpn: bool = False, int8_head: bool = False,
                           u8_input: bool = False, direct_stem: bool = False, chain_segments: bool = False,
                           plain: bool = False) -> Callable[[Dict, torch.Tensor], Levels]:
    """Inference forward with an int8-PTQ backbone: ``fwd(qtree, images) ->
    per-level f32 NHWC (cls, cnt, reg)``; ``images`` normalized NHWC
    floats, or raw uint8 frames with ``u8_input=True`` (the exact uint8
    stem).  ``model`` is a HISFCOS or an MNFCOS.

    ``int8_fpn=False``: the int8 C3..C5 are dequantized to
    ``compute_dtype`` and turned NCHW there, once; a HISFCOS's HisFPN runs
    BN-folded (its kernels folded here, once, from the model's f32
    weights), an MNFCOS's LightweightFPN as a ``compute_dtype`` copy of
    ``model.fpn`` with its BatchNorms (JAX folds the BN for HISFCOS only).
    ``int8_fpn=True``: ``qtree`` is ``{"backbone": ..., "fpn": ...}``
    (:func:`quantize_backbone` + :func:`quantize_fpn`); the int8 C3..C5 go
    straight into the int8 FPN, whose levels are dequantized to
    ``compute_dtype``.  The float head runs on a copy of ``model.head`` in
    ``compute_dtype``; later changes to ``model`` are not seen.
    ``int8_fpn=True, int8_head=True``: ``qtree`` also has ``"head"``
    (:func:`quantize_head`); the int8 levels go straight into the int8
    head, which returns f32 maps, with no float seam.

    The int8 FPN and head follow ``backend`` as the JAX function maps it:
    ``"xla"`` (or ``plain=True``) their per-op oracles; any other backend
    their kernels: the HisFPN on K4, K5, K6 and the HISHead on K7 and K9;
    the MNFCOS's fifteen MNBlocks on K12 (the JAX package's ``PODT_QMN=1``;
    its default ``PODT_QMN=0`` is ``backend="xla"``).

    ``fused_head=True`` (the JAX serving bench's ``PODT_FUSED_HEAD=1``):
    for a HISFCOS with ``int8_fpn=False`` and ``backend != "xla"`` each level goes to K15
    (``ops/head.hishead_level_fused``) in bf16, whatever ``compute_dtype``
    (the weights packed here, once, from the model's f32 weights), with
    ScaleExp after it: ``exp(reg * scale_i)`` in f32, cls and cnt cast to
    f32.  Elsewhere it is ignored, as in JAX.

    ``use_pallas_gn`` is the JAX switch between XLA's GroupNorm and the
    Pallas kernel in the float head.  It is accepted, so that callers
    written for the JAX function keep working, and changes nothing: on the
    card the float head's GroupNorms always run on kernel B, since a plain
    version never stands on a path where a card is present.

    ``backend``, ``fuse_strided``, ``direct_stem`` (the JAX package's
    ``PODT_STEM_XLA7=1``) and ``chain_segments`` (``PODT_QCHAIN=1``) go to
    ``resnet50_int8_forward``, which says what each selects.  ``plain=True``
    runs every kernel's plain version, K15's included, for the comparison
    only.
    """
    del use_pallas_gn  # kernel B on the card either way (docstring)
    _require_ported(model)
    int8_head = int8_head and int8_fpn  # the head is int8 only behind an int8 FPN, as in JAX
    fused_head = fused_head and fused_head_applies(model, backend, int8_fpn)
    is_mn = isinstance(model, MNFCOS)
    fpn_int8_forward = lwfpn_int8_forward if is_mn else hisfpn_int8_forward
    head_int8_forward = mnhead_int8_forward if is_mn else hishead_int8_forward
    fpn = model.fpn
    folded = None if int8_fpn or is_mn else fold_hisfpn(fpn, compute_dtype)
    fpn_copy = copy.deepcopy(fpn).to(compute_dtype).eval() if is_mn and not int8_fpn else None
    head = None if int8_head or fused_head else copy.deepcopy(model.head).to(compute_dtype).eval()
    packed = hishead_params_pack(model.head, model.num_classes) if fused_head else None
    scales = [getattr(model.head, f"scale{i}").scale.detach().float() for i in range(5)] if fused_head else None
    sub = "xla" if backend == "xla" or plain else "pallas"  # the JAX mapping, trainer.py:640

    @torch.inference_mode()
    def fwd(qtree: Dict, images: torch.Tensor) -> Levels:
        bb_kw = dict(backend=backend, fuse_strided=fuse_strided, u8_stem=u8_input, direct_stem=direct_stem,
                     chain_segments=chain_segments, plain=plain)
        if int8_head:
            feats_q, _ = resnet50_int8_forward(qtree["backbone"], images, compute_dtype, dequant=False, **bb_kw)
            levels_q, _ = fpn_int8_forward(qtree["fpn"], feats_q, compute_dtype, backend=sub, dequant=False)
            return head_int8_forward(qtree["head"], levels_q, backend=sub, num_classes=model.num_classes)
        if int8_fpn:
            feats_q, _ = resnet50_int8_forward(qtree["backbone"], images, compute_dtype, dequant=False, **bb_kw)
            levels = fpn_int8_forward(qtree["fpn"], feats_q, compute_dtype, backend=sub)
            levels = [lv.permute(0, 3, 1, 2).contiguous() for lv in levels]  # the dequant seam: NHWC -> NCHW
        else:
            feats = resnet50_int8_forward(qtree, images, compute_dtype, **bb_kw)
            feats = [f.permute(0, 3, 1, 2).contiguous() for f in feats]  # the dequant seam: NHWC -> NCHW
            levels = fpn_copy(feats) if is_mn else hisfpn_folded_forward(fpn, feats, compute_dtype, folded=folded)
        if fused_head:
            nc = model.num_classes
            outs = ([], [], [])
            for lv, scale in zip(levels, scales):
                out = hishead_level_fused(lv.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous(), packed, nc,
                                          plain=plain)
                outs[0].append(out[..., :nc].float())
                outs[1].append(out[..., nc:nc + 1].float())
                outs[2].append(torch.exp(out[..., nc + 1:].float() * scale))
            return outs
        outs = head(levels, plain)
        return tuple([o.permute(0, 2, 3, 1).float() for o in branch] for branch in outs)

    return fwd
