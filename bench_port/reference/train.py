"""Plain FCOS training steps: targets, losses and SGD, in float32.

A frozen copy of the FCOS recipe (Tian et al., ICCV 2019) as the
configuration's training block states it: centre sampling of radius 1.5
strides, each location to its smallest box within the level's range,
sigmoid focal loss (alpha 0.25, gamma 2) over every location, BCE
centerness and GIoU regression on positives, each a per-image sum over the
image's positives and then the batch mean; SGD with momentum and
weight decay added to the gradient (``g + wd p``), the learning rate from
a linear warm-up.  Works on the flat weight dict of ``models.py``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference import models


def level_targets(hw, stride, limit, boxes, labels, radius=1.5):
    h, w = hw
    dev = boxes.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    x = (xs.reshape(-1) * stride + stride // 2)[None, :, None]
    y = (ys.reshape(-1) * stride + stride // 2)[None, :, None]
    x1, y1, x2, y2 = (boxes[..., i][:, None, :] for i in range(4))
    off = torch.stack([x - x1, y - y1, x2 - x, y2 - y], -1)  # [B, HW, M, 4]
    area = (off[..., 0] + off[..., 2]) * (off[..., 1] + off[..., 3])
    inside = off.amin(-1) > 0
    in_range = (off.amax(-1) > limit[0]) & (off.amax(-1) <= limit[1])
    centre = torch.maximum((x - (x1 + x2) / 2).abs(), (y - (y1 + y2) / 2).abs()) < stride * radius
    pos = inside & in_range & centre
    assign = torch.where(pos, area, torch.full_like(area, 99999999.0)).argmin(-1)
    reg = off.gather(2, assign[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    cls = labels.gather(1, assign)
    lr_min, lr_max = torch.minimum(reg[..., 0], reg[..., 2]), torch.maximum(reg[..., 0], reg[..., 2])
    tb_min, tb_max = torch.minimum(reg[..., 1], reg[..., 3]), torch.maximum(reg[..., 1], reg[..., 3])
    cnt = torch.sqrt((lr_min * tb_min).clamp(min=0) / (lr_max * tb_max + 1e-10))
    has = pos.any(-1)
    return (torch.where(has, cls, torch.zeros_like(cls)), torch.where(has, cnt, torch.full_like(cnt, -1.0)),
            torch.where(has[..., None], reg, torch.full_like(reg, -1.0)))


def targets(level_shapes, strides, ranges, boxes, labels):
    parts = [level_targets(hw, s, r, boxes, labels) for hw, s, r in zip(level_shapes, strides, ranges)]
    return tuple(torch.cat([p[i] for p in parts], 1) for i in range(3))


def giou(p, t):
    """GIoU of ltrb offsets measured from one point."""
    wh = (torch.minimum(p[..., :2], t[..., :2]) + torch.minimum(p[..., 2:], t[..., 2:])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_p = (p[..., 0] + p[..., 2]) * (p[..., 1] + p[..., 3])
    union = area_p + (t[..., 0] + t[..., 2]) * (t[..., 1] + t[..., 3]) - inter
    iou = inter / torch.where(union != 0, union, torch.full_like(union, 1e-10))
    hull = (torch.maximum(p[..., :2], t[..., :2]) + torch.maximum(p[..., 2:], t[..., 2:])).clamp(min=0)
    g = hull[..., 0] * hull[..., 1]
    return iou - (g - union) / g.clamp(min=1e-10)


def loss(maps, level_shapes, strides, ranges, boxes, labels) -> torch.Tensor:
    """The total FCOS loss of one batch (focal + centerness + GIoU)."""
    b = boxes.shape[0]
    cls_p = torch.cat([t.reshape(b, -1, t.shape[-1]) for t in maps[0]], 1).float()
    cnt_p = torch.cat([t.reshape(b, -1) for t in maps[1]], 1).float()
    reg_p = torch.cat([t.reshape(b, -1, 4) for t in maps[2]], 1).float()
    cls_t, cnt_t, reg_t = targets(level_shapes, strides, ranges, boxes, labels)
    mask = cnt_t > -1
    npos = mask.sum(1).clamp(min=1).float()
    onehot = (torch.arange(1, cls_p.shape[-1] + 1, device=boxes.device)[None, None] == cls_t[..., None]).float()
    log_pt = (F.logsigmoid(cls_p) * onehot + F.logsigmoid(-cls_p) * (1 - onehot)).clamp(
        float(np.log(np.float32(5e-6))), -5e-11)
    one_m_pt = (torch.sigmoid(-cls_p) * onehot + torch.sigmoid(cls_p) * (1 - onehot)).clamp(5e-11, 1 - 5e-6)
    focal = -(0.25 * onehot + 0.75 * (1 - onehot)) * one_m_pt ** 2 * log_pt
    cls_loss = (focal.sum((1, 2)) / npos).mean()
    zero = torch.zeros((), device=boxes.device)
    t = torch.where(mask, cnt_t, zero)
    bce = cnt_p.clamp(min=0) - cnt_p * t + torch.log1p(torch.exp(-cnt_p.abs()))
    cnt_loss = (torch.where(mask, bce, zero).sum(1) / npos).mean()
    one = torch.ones((), device=boxes.device)
    g = 1 - giou(torch.where(mask[..., None], reg_p, one), torch.where(mask[..., None], reg_t, one))
    reg_loss = (torch.where(mask, g, zero).sum(1) / npos).mean()
    return cls_loss + cnt_loss + reg_loss


def warmup_lr(step: int, lr: float, warmup_steps: int, warmup_factor: float) -> float:
    """Linear warm-up from ``warmup_factor * lr`` to ``lr`` (float32 arithmetic)."""
    f32 = np.float32
    if step >= warmup_steps:
        return float(f32(lr))
    a = f32(step) / f32(max(warmup_steps, 1))
    return float(f32(lr) * (f32(warmup_factor) * (f32(1) - a) + a))


def trainable(names: Sequence[str], frozen_prefixes: Sequence[str]) -> List[str]:
    """The names a recipe trains: every weight but the BatchNorms' and those under ``frozen_prefixes``."""
    bn_leaf = (".running_mean", ".running_var")
    bns = {n.rsplit(".", 1)[0] for n in names if n.endswith(bn_leaf)}
    return [n for n in names if n.rsplit(".", 1)[0] not in bns and not any(n.startswith(p) for p in frozen_prefixes)]


def batch_grads(family: str, w: Dict[str, torch.Tensor], names: Sequence[str], batch, level_shapes, strides,
                ranges, recipe: dict, chunk: int, quant=None) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The loss of one ``(images, boxes, labels)`` batch at weights ``w`` and
    the gradient of each of ``names``, in chunks of ``chunk`` images whose
    gradients add up to the batch mean's."""
    images, boxes, labels = batch
    w = dict(w, **{n: w[n].detach().requires_grad_(True) for n in names})
    grads = {n: torch.zeros_like(w[n]) for n in names}
    total = 0.0
    b = images.shape[0]
    for s in range(0, b, chunk):
        maps = models.forward(family, w, images[s:s + chunk], quant, recipe["barrier_after"])
        part = loss(maps, level_shapes, strides, ranges, boxes[s:s + chunk], labels[s:s + chunk])
        part = part * (min(chunk, b - s) / b)
        gs = torch.autograd.grad(part, [w[n] for n in names], allow_unused=True)
        for n, g in zip(names, gs):
            if g is not None:
                grads[n] += g
        total += float(part.detach())
    return total, grads


def sgd_steps(family: str, w0: Dict[str, torch.Tensor], batches, level_shapes, strides, ranges, recipe: dict,
              steps: int, chunk: int, quant=None) -> Dict[str, object]:
    """``steps`` SGD steps from ``w0`` over ``batches`` (one ``(images,
    boxes, labels)`` a step).  Returns the loss of each step, the first
    update direction as the optimizer takes it (``g + wd p``), the gradient
    before decay, and each trained leaf's change after the steps."""
    names = trainable(list(w0), recipe["frozen_prefixes"])
    w = {k: v.detach().clone() for k, v in w0.items()}
    buf: Dict[str, torch.Tensor] = {}
    losses, first_dir, first_grad = [], None, None
    for i in range(steps):
        total, grads = batch_grads(family, w, names, batches[i], level_shapes, strides, ranges, recipe, chunk, quant)
        losses.append(total)
        lr = warmup_lr(i, recipe["lr"], recipe["warmup_steps"], recipe["warmup_factor"])
        with torch.no_grad():
            for n in names:
                d = grads[n] + recipe["weight_decay"] * w[n]
                buf[n] = d.clone() if i == 0 else recipe["momentum"] * buf[n] + d
                w[n] = w[n] - lr * buf[n]
        if i == 0:
            first_dir = {n: buf[n].clone() for n in names}
            first_grad = grads
    change = {n: w[n] - w0[n] for n in names}
    return {"losses": losses, "first_dir": first_dir, "first_grad": first_grad, "change": change, "names": names}


def sgd_step_from(family: str, w0: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
                  momentum: Dict[str, torch.Tensor], batch, step: int, level_shapes, strides, ranges, recipe: dict,
                  chunk: int, quant=None) -> Dict[str, object]:
    """One SGD step at step count ``step`` from the trained leaves
    ``params`` and their momentum ``momentum`` (every other weight
    ``w0``'s).  Returns the loss, the step's update direction (``g + wd
    p``), the gradient before decay and each trained leaf's change."""
    names = trainable(list(w0), recipe["frozen_prefixes"])
    w = dict(w0, **{n: params[n] for n in names})
    total, grads = batch_grads(family, w, names, batch, level_shapes, strides, ranges, recipe, chunk, quant)
    lr = warmup_lr(step, recipe["lr"], recipe["warmup_steps"], recipe["warmup_factor"])
    with torch.no_grad():
        d = {n: grads[n] + recipe["weight_decay"] * w[n] for n in names}
        change = {n: -lr * (recipe["momentum"] * momentum[n] + d[n]) for n in names}
    return {"loss": total, "dir": d, "grad": grads, "change": change, "names": names}
