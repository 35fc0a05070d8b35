"""Learning-rate schedules (the port's copy of ``pytorch_object_detection_tpu/train/schedules.py``).

Each is a plain ``step -> lr`` function, evaluated on the host in float32
as the JAX functions evaluate it, so that an optimizer step uses the same
f32 learning rate as the JAX chain:

  * :func:`warmup_step_decay`: linear warm-up from ``warmup_factor * lr``
    to ``lr`` over ``warmup_steps``, then times ``gamma`` at each milestone;
  * :func:`poly_lr`: ``lr * (1 - step / max_iter) ** power``, floored at
    ``min_lr``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

f32 = np.float32


def warmup_step_decay(lr_init: float, warmup_steps: int = 500, warmup_factor: float = 1.0 / 3.0,
                      milestones: Sequence[int] = (120000, 160000), gamma: float = 0.1) -> Callable[[int], float]:
    miles = np.asarray(list(milestones), np.float32)

    def schedule(step: int) -> float:
        s = f32(step)
        alpha = np.clip(s / f32(max(warmup_steps, 1)), f32(0.0), f32(1.0))
        warm = f32(warmup_factor) * (f32(1.0) - alpha) + alpha
        decay = np.power(f32(gamma), f32(np.sum(s >= miles)))
        return float(f32(lr_init) * warm if s < warmup_steps else f32(lr_init) * decay)

    return schedule


def poly_lr(lr_init: float, max_iter: int, power: float = 0.9, min_lr: float = 1e-6) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        s = f32(step)
        lr = f32(lr_init) * np.power(np.maximum(f32(1.0) - s / f32(max_iter), f32(0.0)), f32(power))
        return float(np.maximum(lr, f32(min_lr)))

    return schedule
