"""Training, int8 PTQ and the int8 eval forwards (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/train/trainer.py``.

Training (JAX ``:35-270``): the freeze set (:func:`param_labels`),
:func:`make_optimizer`, :class:`TrainState`, :func:`create_train_state`,
:func:`make_train_step` and :func:`make_train_step_scan`.  A step is
forward (under ``torch.autocast`` in bf16 over the f32 master weights, or
in f32), the outputs cast to f32, FCOS targets on the device
(``ops/targets.py``), ``fcos_loss``, backward and the optimizer's update,
with no host sync inside.  Frozen parameters get ``requires_grad=False``
and stay out of the optimizer (optax's ``set_to_zero``).  A BatchNorm is
frozen (its affine and statistics buffers) unless the model was built with
``freeze_bn=False`` (``nn/layers.BatchNorm``: batch statistics in the
step, the running ones updated as flax does, the step's ``bn_train``) or
the state with ``freeze_bn=False`` (the affines train).  The GroupNorms take
``F.group_norm`` while autograd records (``nn/layers.GroupNorm32``), so a
train step launches kernel B no time; an eval forward after it does.  The anchor
families (RetinaNet, SSD300) train through :func:`make_anchor_train_step`
(JAX ``:358-408``): the same step with the anchor codec's targets
(``ops/anchors.encode_targets``) and its focal or MultiBox loss.

Data parallelism (JAX: the same step under a mesh; ``parallel/``): in a
process group every step averages the gradients and the metrics over the
data group after the backward, and with ``bn_train`` its BatchNorms take
the statistics of the whole batch (SyncBatchNorm), so two ranks at B equal
one process at 2B.  :func:`make_shard_map_train_step` (JAX ``:272-355``) is
the reference's DDP instead: local statistics in the forward, the updated
running ones averaged after it.  Under a ``(data, model)`` mesh with a
model dimension above 1 (``mesh=``, or the state that
``parallel/tp.shard_state_tp`` sharded) the same steps run tensor-parallel
(the state channel-sharded) or spatially partitioned (the images in row
bands, ``parallel/sp.shard_batch_spatial``); see :func:`make_train_step`.

The float inference forward: :func:`make_eval_forward` (JAX ``:779-790``).

int8 PTQ: ``quantize_backbone``, ``_backbone_int8_feats``,
``quantize_fpn`` and ``quantize_head`` (:412-593, the HISFCOS, MNFCOS and
classic-FCOS branches), and ``make_eval_forward_int8`` (:596-776) for the
FCOS families; ``quantize_backbone`` also takes a RetinaNet (the first step
of ``models/retinanet_int8.quantize_retinanet``).  The backbone ladder
follows the model's backbone, as the JAX functions dispatch on it: an int8
ResNet-50 (its stem float, or the exact uint8 stem with ``u8_input=True``),
or for an FCOS on EfficientNet-B0 the per-op EfficientNet ladder
(``nn/efficientnet_int8.py``: the stem float, normalized float frames
only), then:

  * HISFCOS: either the BN-folded float HisFPN (``int8_fpn=False``) and the
    float HISHead (its GroupNorms on kernel B), or the int8 HisFPN, whose
    levels go dequantized to the float HISHead (``int8_head=False``) or
    stay int8 into the int8 HISHead (``int8_head=True``, the JAX default
    serving path);
  * MNFCOS: either the float LightweightFPN with its BN and the float
    MNHead (``int8_fpn=False``), or the int8 LightweightFPN
    (``models/mnfcos_int8.py``), whose levels go dequantized to the float
    MNHead or stay int8 into the int8 MNHead;
  * FCOS (either backbone): either the float classic FPN and the float
    FCOSHead (its 40 GroupNorms on kernel B), or the int8 classic FPN
    (``models/fcos_int8.py``), whose levels go dequantized to the float
    FCOSHead or stay int8 into the int8 FCOSHead;
  * MC_FCOS: the one-shot ladder of ``models/mcfcos_int8.py`` (backbone,
    neck and head int8, ``models/mcfcos_int8.quantize_mcfcos``), whatever ``int8_fpn``
    and ``int8_head`` say, as the JAX serving pipeline builds it.

Every int8 backbone backend of the JAX function is ported
(``nn/resnet_int8.resnet50_int8_forward``), and ``fused_head=True``: the
whole-level bf16 HISHead on K15 (``ops/head.py``) behind the float HisFPN.
The anchor families' int8 ladders are ``models/retinanet_int8.py`` and
``models/ssd_int8.py``, served by ``eval/evaluator.make_eval_pipeline_anchor_int8``;
the FCOS-family functions here refuse them.
"""
from __future__ import annotations

import contextlib
import copy
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from pytorch_object_detection_tpu_torch.models.fcos import FCOS, HISFCOS, MNFCOS
from pytorch_object_detection_tpu_torch.models.fcos_int8 import (
    calibrate_fcoshead,
    calibrate_fpn_classic,
    fcoshead_int8_forward,
    fpn_classic_int8_forward,
    quantize_fcoshead,
    quantize_fpn_classic,
)
from pytorch_object_detection_tpu_torch.models.head_int8 import calibrate_hishead, hishead_int8_forward, quantize_hishead
from pytorch_object_detection_tpu_torch.models.mcfcos import MC_FCOS
from pytorch_object_detection_tpu_torch.models.mcfcos_int8 import mcfcos_int8_forward
from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import (
    calibrate_lwfpn,
    calibrate_mnhead,
    lwfpn_int8_forward,
    mnhead_int8_forward,
    quantize_lwfpn,
    quantize_mnhead,
)
from pytorch_object_detection_tpu_torch.nn.fpn_int8 import calibrate_hisfpn, hisfpn_int8_forward, quantize_hisfpn
from pytorch_object_detection_tpu_torch.nn.efficientnet_int8 import (
    calibrate_efficientnet,
    efficientnet_int8_forward,
    quantize_efficientnet,
)
from pytorch_object_detection_tpu_torch.nn.fused_fpn import fold_hisfpn, hisfpn_folded_forward
from pytorch_object_detection_tpu_torch.nn.layers import BatchNorm, batch_statistics, batchnorms, frozen_running_stats
from pytorch_object_detection_tpu_torch.models.retinanet import RetinaNet
from pytorch_object_detection_tpu_torch.models.ssd import SSD300
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import (
    calibrate_resnet50,
    quantize_resnet50,
    resnet50_int8_forward,
)
from pytorch_object_detection_tpu_torch.ops.anchors import encode_targets, multibox_loss, retinanet_loss
from pytorch_object_detection_tpu_torch.ops.head import hishead_level_fused, hishead_params_pack
from pytorch_object_detection_tpu_torch.ops.losses import fcos_loss, flatten_level_preds
from pytorch_object_detection_tpu_torch.ops.targets import generate_targets
from pytorch_object_detection_tpu_torch.parallel import sp, tp
from pytorch_object_detection_tpu_torch.parallel.collectives import all_reduce_, model_axis, pmean_grads, pmean_metrics
from pytorch_object_detection_tpu_torch.parallel.mesh import data_group, mesh_group, model_group, model_parallel_size
from pytorch_object_detection_tpu_torch.train.swa import swa_lr
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
    ``:112``); ``conv1_s2d`` trains, as in JAX.  An EfficientNet backbone
    has no ``conv1`` or ``layer*``: only its BatchNorms freeze, whatever
    ``frozen_stages`` says, as in JAX."""
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
    (on the host: the count of updates taken).  A tensor-parallel state
    (``parallel/tp.shard_state_tp``) also holds its mesh and ``sharded``,
    the whole shapes of its sharded tensors by name."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                 step: int = 0):
        self.model, self.optimizer, self.schedule, self.step = model, optimizer, schedule, step
        self.mesh, self.sharded = None, {}

    def trainable_names(self) -> List[str]:
        return [n for n, p in self.model.named_parameters() if p.requires_grad]

    def state_dict(self) -> Dict[str, Any]:
        """Weights, buffers, optimizer state and step; ``trainable`` names the
        optimizer's parameters in order.  A tensor-parallel state gives the
        whole tensors (a collective: every rank calls it)."""
        if self.sharded:
            return tp.gather_state_dict(self)
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": self.step,
                "trainable": self.trainable_names()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load :meth:`state_dict`'s output (a tensor-parallel state takes
        its slices of the whole tensors).  The weights must match the
        model; an optimizer state saved over other trainable parameters
        (other freeze masks) is not loaded, and the optimizer stays as it is."""
        if self.sharded:
            state = tp.shard_state_dict(self, state)
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
    ``weight_decay``) over the parameters left trainable.  ``freeze_bn=False``
    makes every BatchNorm's affine a parameter and leaves it trainable (the
    statistics stay as the model was built: batch statistics in the step
    where it was built with ``freeze_bn=False``); as JAX's
    ``make_optimizer``, the freeze set applies only where ``freeze_bn`` or
    ``frozen_stages > 0``, so ``freeze_bn=False, frozen_stages=0`` trains
    every parameter, the stem too."""
    cfg = optimizer_cfg or {}
    schedule = warmup_step_decay(cfg.get("lr", 1e-2), cfg.get("warmup_steps", 500),
                                 cfg.get("warmup_factor", 1.0 / 3.0), cfg.get("milestones", (120000, 160000)),
                                 cfg.get("gamma", 0.1))
    if cfg.get("swa_lr"):
        schedule = swa_lr(schedule, float(cfg["swa_lr"]), int(cfg.get("swa_start_step", 0)))
    if not freeze_bn:
        for bn in batchnorms(model):
            bn.affine_parameters()
    masked = freeze_bn or frozen_stages > 0
    labels = param_labels(model, freeze_bn, frozen_stages)
    for name, p in model.named_parameters():
        p.requires_grad_(not masked or labels[name] == "train")
    trainable = [p for p in model.parameters() if p.requires_grad]
    optimizer = make_optimizer(cfg.get("name", "SGD"), trainable, schedule(0), cfg.get("momentum", 0.9),
                               cfg.get("weight_decay", 1e-4))
    return TrainState(model, optimizer, schedule)


def make_train_step(model: nn.Module, level_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                    limit_ranges: Sequence[Tuple[float, float]], reg_mode: str = "giou",
                    compute_dtype: torch.dtype = torch.bfloat16, bn_train: bool = False, remat: bool = False,
                    cnt_mode: str = "bce", mesh=None):
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
    ``model`` must be ``state.model``.

    ``bn_train=True`` (JAX: ``mutable=["batch_stats"]``) lets the
    BatchNorms of a model built with ``freeze_bn=False`` normalize with the
    batch's statistics and update their running ones (in the module's
    buffers, in f32); a frozen model's stay as they are.  Such a model
    without ``bn_train`` raises ``ValueError`` (flax refuses to update
    immutable statistics).

    In a process group (the default group: the data group of
    ``parallel/mesh.create_mesh``'s mesh, whose model dimension is 1) each
    rank passes its shard of the global batch; the group is the one this
    process has when the step is made.  The gradients and the returned
    metrics are averaged over the group, and
    with ``bn_train`` the statistics are those of the whole batch (the JAX
    step under a mesh, where GSPMD's mean over the sharded batch is global).
    Every loss is a batch mean of per-image terms, so ranks with equal
    shards take the single-process step on the whole batch.

    Under ``mesh`` (``parallel/mesh.create_mesh``), or the mesh of a state
    that ``parallel/tp.shard_state_tp`` sharded, with a model dimension
    above 1: the ranks of a model group share one data shard, tensor-
    parallel (the state sharded) or spatially partitioned (``images`` the
    rank's row band, ``parallel/sp.shard_batch_spatial``; the head's
    outputs are gathered before the loss, so every rank of the group has
    the same loss).  The forward and the backward run in the model group
    (``collectives.model_axis``); then a sharded parameter's gradient is
    divided by the model group's size and averaged over the data group, a
    replicated one's averaged over the whole mesh (each collective's
    backward is its adjoint, so each is the gradient of the model group's
    summed losses, a replicated one split across its ranks); the metrics
    are averaged over the mesh, and with ``bn_train`` the statistics span
    the data group as well.  ``remat`` and ``bn_train`` act as without it."""
    group = data_group(mesh) if mesh is not None and model_parallel_size(mesh) == 1 else data_group()
    return _step(model, _fcos_losses(level_shapes, strides, limit_ranges, reg_mode, cnt_mode), compute_dtype, remat,
                 bn_train, group, sync_bn=bn_train and group is not None, mesh=mesh)


def make_shard_map_train_step(model: nn.Module, level_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                              limit_ranges: Sequence[Tuple[float, float]], mesh, reg_mode: str = "giou",
                              compute_dtype: torch.dtype = torch.bfloat16, bn_train: bool = False,
                              cnt_mode: str = "bce"):
    """The reference's DDP step (JAX ``make_shard_map_train_step``, the
    step of ``jax.shard_map`` with explicit collectives): each rank's
    forward on its shard with LOCAL BatchNorm statistics, its loss
    normalized over its own images, then the mean of the gradients over
    ``mesh``'s data group (``parallel/collectives.pmean_grads``), the
    update, the mean of the metrics (``pmean_metrics``), and with
    ``bn_train`` the mean of each BatchNorm's updated running mean and
    variance (``sync_batch_stats``, the JAX ``sync_stats_tree``), so every
    rank holds the same statistics.  The step's signature is
    :func:`make_train_step`'s."""
    return _step(model, _fcos_losses(level_shapes, strides, limit_ranges, reg_mode, cnt_mode), compute_dtype, False,
                 bn_train, data_group(mesh), sync_bn=False, sync_stats=bn_train)


def _fcos_losses(level_shapes, strides, limit_ranges, reg_mode: str, cnt_mode: str) -> Callable:
    """``losses_of(out, boxes, labels)`` of the FCOS families: the per-level
    outputs cast to f32 and flattened, the targets, ``fcos_loss``."""
    def losses_of(out, boxes, labels):
        cls_p, cnt_p, reg_p = (flatten_level_preds([t.float() for t in branch]) for branch in out)
        tgt = generate_targets(level_shapes, strides, limit_ranges, boxes, labels)
        return fcos_loss(cls_p, cnt_p, reg_p, tgt.cls, tgt.cnt, tgt.reg, reg_mode, cnt_mode)

    return losses_of


def _step(model: nn.Module, losses_of: Callable, compute_dtype: torch.dtype, remat: bool = False,
          bn_train: bool = False, group=None, sync_bn: bool = False, sync_stats: bool = False, mesh=None):
    """The step every train-step maker returns: the lr from the schedule,
    the forward under autocast with the BatchNorms that train their
    statistics in training mode (``remat``: recomputed in the backward, the
    running statistics updated once), then
    ``losses_of(out, boxes, labels)`` (targets and loss, in f32, on the
    outputs gathered where they are row bands), the backward, the update,
    ``record`` after each phase.  With ``group``: the gradients averaged
    over it before the update and the metrics after it; ``sync_bn`` the
    BatchNorms' statistics over it in the forward, ``sync_stats`` their
    running statistics averaged after the update.  Under a mesh with a
    model dimension (``mesh``, else the state's): :func:`make_train_step`'s
    rule replaces ``group``'s."""
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype must be bfloat16 or float32; got {compute_dtype}")
    bns = batchnorms(model)
    if not bn_train and any(bn.batch_stats for bn in bns):
        raise ValueError("the model's BatchNorms train their statistics (built with freeze_bn=False): pass "
                         "bn_train=True")
    recompute = lambda: (contextlib.nullcontext(), frozen_running_stats(model))

    def step(state: TrainState, images: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
             record: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the train step was made for another model than state.model")
        layout = mesh if mesh is not None else getattr(state, "mesh", None)
        if layout is not None and model_parallel_size(layout) > 1:
            if sync_stats:
                raise ValueError("make_shard_map_train_step takes a mesh whose model dimension is 1")
            data, everyone = data_group(layout), mesh_group(layout)
            axis = model_axis(model_group(layout))
        else:
            data, everyone, axis = group, group, contextlib.nullcontext()
        lr = state.schedule(state.step)
        for g in state.optimizer.param_groups:
            g["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        # the backward too: a recomputed forward takes the same statistics and model group
        with axis, batch_statistics(bns, data if sync_bn else None):
            with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=compute_dtype == torch.bfloat16):
                if remat:
                    out = torch.utils.checkpoint.checkpoint(model, images, use_reentrant=False, context_fn=recompute)
                else:
                    out = model(images)
            out = sp.gather_tree(out)
            if record:
                record("forward")
            losses = losses_of(out, boxes, labels)
            if record:
                record("loss")
            losses["total"].backward()
        if everyone is not data:
            named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
            sharded = getattr(state, "sharded", {})
            all_reduce_([g for n, g in named if n not in sharded], everyone)
            all_reduce_([g for n, g in named if n in sharded], data)
            torch._foreach_div_([g for _, g in named], float(torch.distributed.get_world_size(everyone)))
        elif group is not None:
            pmean_grads([p.grad for p in model.parameters() if p.grad is not None], group)
        if record:
            record("backward")
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        if everyone is not None:
            metrics = pmean_metrics(metrics, everyone)
            if sync_stats:
                all_reduce_([t for bn in bns for t in (bn.running_mean, bn.running_var)], group, mean=True)
        if record:
            record("optimizer")
        return metrics

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


def make_anchor_train_step(model: nn.Module, anchors: torch.Tensor, num_classes: int,
                           compute_dtype: torch.dtype = torch.bfloat16, pos_iou: float = 0.5, neg_iou: float = 0.4,
                           loss: str = "focal", bn_train: bool = False, mesh=None):
    """The train step of the anchor detectors (RetinaNet, SSD300):
    ``step(state, images, boxes, labels, record=None) -> {"cls", "reg",
    "total"}``, as :func:`make_train_step`'s (the lr from the schedule, the
    forward under bf16 autocast over the f32 master weights or in f32, the
    backward and the update, ``record`` after each phase) with the anchor
    codec: ``loc`` and ``cls`` cast to f32, ``encode_targets`` over
    ``anchors`` (``[N, 4]``, on the images' device) at ``pos_iou`` /
    ``neg_iou``, then ``loss``: ``"focal"`` (RetinaNet: focal with the
    ignore band + smooth-L1 1/9, ``num_classes`` foreground classes) or
    ``"multibox"`` (SSD: softmax CE with 3:1 hard-negative mining +
    smooth-L1 1; pass ``neg_iou=pos_iou``).  ``model`` must be
    ``state.model``.  In a process group the gradients and metrics are
    averaged over it, and ``bn_train`` and ``mesh`` act, as in
    :func:`make_train_step`.  SSD300 has no BatchNorm."""
    if loss not in ("focal", "multibox"):
        raise ValueError(f"loss must be 'focal' or 'multibox'; got {loss!r}")

    def losses_of(out, boxes, labels):
        loc, cls = out
        loc_t, cls_t = encode_targets(anchors, boxes, labels, pos_iou, neg_iou)
        if loss == "multibox":
            return multibox_loss(cls.float(), loc.float(), cls_t, loc_t)
        return retinanet_loss(cls.float(), loc.float(), cls_t, loc_t, num_classes)

    group = data_group(mesh) if mesh is not None and model_parallel_size(mesh) == 1 else data_group()
    return _step(model, losses_of, compute_dtype, False, bn_train, group, sync_bn=bn_train and group is not None,
                 mesh=mesh)


# ---------------------------------------------------------------------------
# int8 PTQ and the int8 eval forwards
# ---------------------------------------------------------------------------


def _require_ported(model: nn.Module) -> None:
    """The FCOS-family int8 ladders take FCOS (on either backbone), HISFCOS,
    MNFCOS and MC_FCOS; the anchor families have their own (``ValueError``)."""
    if isinstance(model, (RetinaNet, SSD300)):
        raise ValueError(f"{type(model).__name__} quantizes through its own ladder: eval/evaluator."
                         f"make_eval_pipeline_anchor_int8 (models/retinanet_int8.py, models/ssd_int8.py)")
    if not isinstance(model, (FCOS, HISFCOS, MNFCOS, MC_FCOS)):
        raise NotImplementedError(
            f"the int8 ladder is ported for the FCOS families FCOS, HISFCOS and MNFCOS, and MC_FCOS; got "
            f"{type(model).__name__}")


def is_efficientnet(model: nn.Module) -> bool:
    """Whether ``model`` is an FCOS on the EfficientNet backbone (the JAX
    functions' ``model.backbone.startswith("efficientnet")``)."""
    return isinstance(model, FCOS) and model.backbone_name.startswith("efficientnet")


def _require_pyramid(model: nn.Module) -> None:
    """MC_FCOS has no separate pyramid and head ladders: its neck and head
    quantize together (``models/mcfcos_int8.quantize_mcfcos``)."""
    _require_ported(model)
    if isinstance(model, MC_FCOS):
        raise ValueError("MC_FCOS quantizes its neck and head together: models/mcfcos_int8.quantize_mcfcos")


def quantize_backbone(model: nn.Module, calib_images: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16, mean=None, std=None) -> Dict:
    """PTQ of the detector's backbone: calibrate activation scales on
    ``calib_images`` (a representative NORMALIZED NHWC batch, on the
    model's device) and return the int8 qtree for
    :func:`make_eval_forward_int8`.  A ResNet-50 calibrates in
    ``compute_dtype``; ``mean``/``std`` (the input-normalize constants,
    ImageNet's by default) make the exact uint8 stem's ``stem_s2d`` entry.
    An EfficientNet calibrates in f32 (the JAX function's
    ``calibrate_efficientnet`` has no compute dtype) and has no uint8 stem.
    A RetinaNet's ResNet-50 quantizes here too (the JAX
    ``quantize_retinanet`` calls this function)."""
    if not isinstance(model, RetinaNet):
        _require_ported(model)
    if is_efficientnet(model):
        return quantize_efficientnet(model.backbone, calibrate_efficientnet(model.backbone, calib_images))
    taps = calibrate_resnet50(model.backbone, calib_images, compute_dtype)
    return quantize_resnet50(model.backbone, taps, IMAGENET_MEAN if mean is None else mean,
                             IMAGENET_STD if std is None else std)


def _backbone_int8_feats(qtree_bb: Dict, images: torch.Tensor, model: Optional[nn.Module] = None, **kw):
    """(C3..C5) int8 NHWC + scales through ``model``'s int8 backbone ladder:
    the EfficientNet's for an FCOS on it, else the ResNet-50's (the per-op
    oracle unless ``backend`` says otherwise)."""
    if model is not None and is_efficientnet(model):
        return efficientnet_int8_forward(qtree_bb, images, torch.float32, dequant=False)
    kw.setdefault("backend", "xla")
    return resnet50_int8_forward(qtree_bb, images, torch.float32, dequant=False, **kw)


def quantize_fpn(model: nn.Module, qtree_bb: Dict, calib_images: torch.Tensor) -> Dict:
    """PTQ of the FPN (extends :func:`quantize_backbone`; the HisFPN of a
    HISFCOS, the LightweightFPN of an MNFCOS, the classic FPN of an FCOS):
    calibrate its activation
    scales on the int8 backbone's dequantized C3..C5, the distribution the
    int8 FPN sees when serving, and return the FPN qtree for
    ``make_eval_forward_int8(int8_fpn=True)``.

    As the JAX function does, the features come from the per-op oracle with
    the float stem, in f32, on the NORMALIZED ``calib_images`` (not from the
    uint8 stem), whatever compute dtype the pipeline serves in.
    """
    _require_pyramid(model)
    feats_q, scales = _backbone_int8_feats(qtree_bb, calib_images, model)
    feats = [q.float() * s for q, s in zip(feats_q, scales)]
    if isinstance(model, MNFCOS):
        return quantize_lwfpn(model.fpn, calibrate_lwfpn(model.fpn, feats), scales)
    if isinstance(model, FCOS):
        return quantize_fpn_classic(model.fpn, calibrate_fpn_classic(model.fpn, feats), scales)
    return quantize_hisfpn(model.fpn, calibrate_hisfpn(model.fpn, feats), scales)


def quantize_head(model: nn.Module, qtree_bb: Dict, qtree_fpn: Dict, calib_images: torch.Tensor) -> Dict:
    """PTQ of the head (extends :func:`quantize_fpn` through the whole
    detector; the HISHead, the MNHead or the FCOSHead): calibrate its per-level
    activation scales on the int8 FPN's dequantized levels and return the
    head qtree for ``make_eval_forward_int8(int8_fpn=True, int8_head=True)``.

    As the JAX function does, the levels come from the per-op oracles, in
    f32: the backbone with the float stem on the NORMALIZED
    ``calib_images``, then the int8 FPN with ``dequant=False``.
    """
    _require_pyramid(model)
    feats_q, _ = _backbone_int8_feats(qtree_bb, calib_images, model)
    if isinstance(model, FCOS):
        levels_q, level_scales = fpn_classic_int8_forward(qtree_fpn, feats_q, dequant=False)
        levels = [q.float() * s for q, s in zip(levels_q, level_scales)]
        return quantize_fcoshead(model.head, calibrate_fcoshead(model.head, levels), level_scales, model.num_classes)
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


def make_eval_forward(model: nn.Module, compute_dtype: torch.dtype = torch.bfloat16) -> Callable[[torch.Tensor], Levels]:
    """Inference forward of an FCOS-family detector: ``fwd(images) ->
    per-level f32 NHWC (cls, cnt, reg)`` from normalized NHWC images, run
    in ``compute_dtype`` (JAX ``train/trainer.py:779-790``).  The model
    carries its weights, so ``fwd`` takes no variables.  As in the float
    serving pipeline, a model in another dtype is copied to
    ``compute_dtype`` here, once (later changes to ``model`` are not seen);
    the module that runs is put in eval mode."""
    param = next(model.parameters())
    net = model if param.dtype == compute_dtype else copy.deepcopy(model).to(compute_dtype)
    net.eval()

    def fwd(images: torch.Tensor) -> Levels:
        with torch.no_grad():
            outs = net(images.to(compute_dtype))
        return tuple([x.float() for x in branch] for branch in outs)

    return fwd


def make_eval_forward_int8(model: nn.Module, compute_dtype: torch.dtype = torch.bfloat16,
                           backend: str = "pallas_block", use_pallas_gn: bool = False, fused_head: bool = False,
                           fuse_strided: bool = True, int8_fpn: bool = False, int8_head: bool = False,
                           u8_input: bool = False, direct_stem: bool = False, chain_segments: bool = False,
                           plain: bool = False) -> Callable[[Dict, torch.Tensor], Levels]:
    """Inference forward with an int8-PTQ backbone: ``fwd(qtree, images) ->
    per-level f32 NHWC (cls, cnt, reg)``; ``images`` normalized NHWC
    floats, or raw uint8 frames with ``u8_input=True`` (the exact uint8
    stem).  ``model`` is an FCOS (on either backbone), a HISFCOS, an MNFCOS
    or an MC_FCOS.

    ``int8_fpn=False``: the int8 C3..C5 are dequantized to
    ``compute_dtype`` and turned NCHW there, once; a HISFCOS's HisFPN runs
    BN-folded (its kernels folded here, once, from the model's f32
    weights), an MNFCOS's LightweightFPN (with its BatchNorms) and an
    FCOS's classic FPN as a ``compute_dtype`` copy of ``model.fpn`` (JAX
    folds the BN for HISFCOS only).
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
    its default ``PODT_QMN=0`` is ``backend="xla"``).  The FCOS's classic
    FPN and FCOSHead are per-op ladders on any backend (no kernel: XLA int8
    convs in JAX).

    An MC_FCOS gets the one-shot ladder (``models/mcfcos_int8.py``):
    ``qtree`` is ``models/mcfcos_int8.quantize_mcfcos``'s ``{"backbone", "neck_head"}``,
    the backbone on ``backend`` (``fuse_strided``, ``u8_input``), the neck
    and head per-op; ``int8_fpn``, ``int8_head`` and ``fused_head`` are
    ignored, ``direct_stem`` and ``chain_segments`` raise ``ValueError``.

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

    An FCOS on EfficientNet runs the per-op EfficientNet ladder
    (``nn/efficientnet_int8.efficientnet_int8_forward``, no kernel; the JAX
    function passes it no backend) on normalized float frames:
    ``u8_input=True`` raises ``ValueError``, as JAX asserts, and so do the
    ResNet-only ``direct_stem`` and ``chain_segments``.
    """
    del use_pallas_gn  # kernel B on the card either way (docstring)
    _require_ported(model)
    effnet = is_efficientnet(model)
    if effnet and (u8_input or direct_stem or chain_segments):
        raise ValueError("the exact uint8 stem, direct_stem and chain_segments are ResNet-only; the EfficientNet "
                         "ladder takes normalized float images")
    if isinstance(model, MC_FCOS):
        if direct_stem or chain_segments:
            raise ValueError("MC_FCOS's one-shot ladder takes no direct_stem or chain_segments")

        @torch.inference_mode()
        def fwd_mc(qtree: Dict, images: torch.Tensor) -> Levels:
            return mcfcos_int8_forward(qtree, images, backend=backend, u8_stem=u8_input, fuse_strided=fuse_strided,
                                       plain=plain)

        return fwd_mc
    int8_head = int8_head and int8_fpn  # the head is int8 only behind an int8 FPN, as in JAX
    fused_head = fused_head and fused_head_applies(model, backend, int8_fpn)
    is_mn, is_fcos = isinstance(model, MNFCOS), isinstance(model, FCOS)
    fpn_int8_forward = fpn_classic_int8_forward if is_fcos else lwfpn_int8_forward if is_mn else hisfpn_int8_forward
    head_int8_forward = fcoshead_int8_forward if is_fcos else mnhead_int8_forward if is_mn else hishead_int8_forward
    fpn = model.fpn
    float_fpn = (is_mn or is_fcos) and not int8_fpn  # the module in compute_dtype (JAX folds the HisFPN only)
    folded = None if int8_fpn or float_fpn else fold_hisfpn(fpn, compute_dtype)
    fpn_copy = copy.deepcopy(fpn).to(compute_dtype).eval() if float_fpn else None
    head = None if int8_head or fused_head else copy.deepcopy(model.head).to(compute_dtype).eval()
    packed = hishead_params_pack(model.head, model.num_classes) if fused_head else None
    scales = [getattr(model.head, f"scale{i}").scale.detach().float() for i in range(5)] if fused_head else None
    sub = "xla" if backend == "xla" or plain else "pallas"  # the JAX mapping, trainer.py:640

    def backbone_int8(qtree_bb: Dict, images: torch.Tensor, dequant: bool = True):
        if effnet:
            return efficientnet_int8_forward(qtree_bb, images, compute_dtype, dequant=dequant)
        return resnet50_int8_forward(qtree_bb, images, compute_dtype, dequant=dequant, backend=backend,
                                     fuse_strided=fuse_strided, u8_stem=u8_input, direct_stem=direct_stem,
                                     chain_segments=chain_segments, plain=plain)

    @torch.inference_mode()
    def fwd(qtree: Dict, images: torch.Tensor) -> Levels:
        if int8_head:
            feats_q, _ = backbone_int8(qtree["backbone"], images, dequant=False)
            levels_q, _ = fpn_int8_forward(qtree["fpn"], feats_q, compute_dtype, backend=sub, dequant=False)
            return head_int8_forward(qtree["head"], levels_q, backend=sub, num_classes=model.num_classes)
        if int8_fpn:
            feats_q, _ = backbone_int8(qtree["backbone"], images, dequant=False)
            levels = fpn_int8_forward(qtree["fpn"], feats_q, compute_dtype, backend=sub)
            levels = [lv.permute(0, 3, 1, 2).contiguous() for lv in levels]  # the dequant seam: NHWC -> NCHW
        else:
            feats = backbone_int8(qtree, images)
            feats = [f.permute(0, 3, 1, 2).contiguous() for f in feats]  # the dequant seam: NHWC -> NCHW
            levels = fpn_copy(feats) if float_fpn else hisfpn_folded_forward(fpn, feats, compute_dtype, folded=folded)
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
