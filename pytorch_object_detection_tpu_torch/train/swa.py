"""Stochastic weight averaging (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/train/swa.py``: a running
uniform or EMA average of the weights (:func:`swa_init`,
:func:`swa_update`) and the SWALR-style step rule (:func:`swa_lr`), which
``train/trainer.create_train_state`` applies where its config has
``swa_lr``.  The averaged tensors are those the JAX package keeps under
``params`` (:func:`swa_params`: the parameters and the BatchNorm affines;
the running statistics are not averaged, as the frozen BatchNorms never
move them).  Under tensor parallelism the average is kept on each rank's
shards and gathered where it is saved (:func:`averaged`, then
``train/checkpoints.save_checkpoint``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn


class SWAState(NamedTuple):
    params: Dict[str, torch.Tensor]
    count: int  # number of averaged snapshots


def swa_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s tensors that the JAX package keeps under ``params``, by
    state-dict name: the parameters and every BatchNorm's weight and bias
    (buffers where frozen)."""
    from pytorch_object_detection_tpu_torch.nn.layers import batchnorms

    bn_affine = {id(t) for bn in batchnorms(model) for t in (bn.weight, bn.bias)}
    named = dict(model.named_parameters())
    named.update((n, b) for n, b in model.named_buffers() if id(b) in bn_affine)
    return named


def swa_init(params: Dict[str, torch.Tensor]) -> SWAState:
    """The average's start: a copy of ``params`` (its own memory: the live
    weights go on training in place), no snapshot counted."""
    return SWAState({k: v.detach().clone() for k, v in params.items()}, 0)


@torch.no_grad()
def swa_update(state: SWAState, params: Dict[str, torch.Tensor], decay: Optional[float] = None) -> SWAState:
    """One snapshot of ``params`` into the average: the uniform running
    average (``decay=None``, torch ``AveragedModel``'s default) or the EMA
    (``decay`` in (0, 1)), ``a + w * (p - a)`` in each tensor's dtype."""
    w = 1.0 / (float(state.count) + 1.0) if decay is None else 1.0 - decay
    new = {k: a + w * (params[k].detach() - a) for k, a in state.params.items()}
    return SWAState(new, state.count + 1)


def swa_lr(base_lr: Union[float, Callable[[int], float]], swa_lr_value: float,
           swa_start_step: int) -> Callable[[int], float]:
    """SWALR-style step rule: ``base_lr`` (a constant or a ``step -> lr``
    schedule) before ``swa_start_step``, the constant ``swa_lr_value`` (in
    f32, as JAX's) from it on."""
    base = base_lr if callable(base_lr) else (lambda step, v=float(np.float32(base_lr)): v)
    swa_v = float(np.float32(swa_lr_value))
    return lambda step: base(step) if step < swa_start_step else swa_v


@contextlib.contextmanager
def averaged(model: nn.Module, state: SWAState):
    """Within the block, ``model`` holds the averaged tensors of ``state``
    (to save or evaluate them); its own come back after it."""
    live = swa_params(model)
    kept = {k: live[k].detach().clone() for k in state.params}
    with torch.no_grad():
        for k, v in state.params.items():
            live[k].copy_(v)
    try:
        yield model
    finally:
        with torch.no_grad():
            for k, v in kept.items():
                live[k].copy_(v)
