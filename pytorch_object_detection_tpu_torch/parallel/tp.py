"""Tensor parallelism over the mesh's ``model`` dimension (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/parallel/tp.py``.  The JAX
package gives every leaf of the train state a ``PartitionSpec`` that shards
its channel dimension over ``model`` and lets GSPMD place the collectives;
PyTorch has no such propagation for convolutions, so here the layers do it
by hand over ``torch.distributed``, one process a device:

* :func:`tp_spec` is JAX's shape rule on the port's layouts: a conv weight
  ``[O, I, kh, kw]`` (JAX ``[kh, kw, I, O]``) and a depthwise one ``[C, 1,
  kh, kw]`` shard dim 0, a per-channel vector ``[C]`` shards dim 0, where
  that dimension is at least ``min_dim`` and divides by the model group's
  size; everything else (the predictors' small outputs, ``ScaleExp``'s
  scale, the step) stays replicated.
* :func:`shard_state_tp` keeps on each rank of a model group its contiguous
  slice of every sharded leaf: the weights, the BatchNorm buffers and the
  optimizer's state (momenta, Adam's and RAdam's moments).
* The forward becomes channel-parallel.  ``nn/layers.Conv`` with a sharded
  weight computes this rank's output channels only (a depthwise conv on
  this rank's input channels) and all-gathers them along C
  (:func:`sharded_conv2d`); the stem's functional conv does the same
  (:func:`conv2d`).  A norm layer whose affine or statistics are sharded
  runs after that gather on its all-gathered vectors (:func:`full`), and a
  BatchNorm that trains its statistics writes back only this rank's slice
  of the new running ones (:func:`local`).  Contiguous shards keep a
  GroupNorm's groups whole on a rank (JAX ``tp.py:23-25``), but the gather
  comes first here, so no norm depends on that.
* The train step (``train/trainer.py``) enters the model group
  (``collectives.model_axis``) around the forward and the backward.  Each
  collective's backward is its adjoint, and every rank of a model group
  computes the same loss, so a sharded parameter's gradient comes out
  ``tp`` times the gradient of the loss and a replicated one's is split
  across the ranks: the step divides the first by ``tp`` and averages it
  over the data group, and averages the second over the whole mesh.
* Checkpoints hold the whole state (:func:`gather_state_dict`, world rank 0
  writes) and restore into a sharded state by slicing
  (:func:`shard_state_dict`), so a tp checkpoint resumes in one process
  and a one-process checkpoint under tp.

The rule is shape-based, as in JAX, so it reaches every family of the
train CLI (HISFCOS, FCOS on ResNet-50 or EfficientNet-B0, MNFCOS, MC_FCOS,
RetinaNet, SSD300) with no code of their own.  Parameter and optimizer
memory per rank scales about 1/tp; every conv output is all-gathered, so
for the detection models the repo ships data parallelism stays the faster
layout (PERF.md).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.parallel.collectives import (
    all_gather_autograd,
    current_model_group,
    group_index,
)


def tp_spec(shape, tp: int, min_dim: int = 16) -> Optional[int]:
    """The dimension of a leaf of ``shape`` that tensor parallelism over
    ``tp`` ranks shards (0: the output channels of a conv weight ``[O, I,
    kh, kw]`` or depthwise ``[C, 1, kh, kw]``, or a per-channel vector
    ``[C]``), or ``None`` where it stays replicated: JAX ``tp_spec``'s rule."""
    shape = tuple(shape)
    if tp > 1 and len(shape) in (1, 4) and shape[0] >= min_dim and shape[0] % tp == 0:
        return 0
    return None


def _group():
    group = current_model_group()
    if group is None:
        raise RuntimeError("a tensor-parallel shard is used outside its model group: run it in the train step, "
                           "or within parallel.collectives.model_axis(model_group(mesh))")
    return group


def sharded_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride, padding, dilation,
                   groups: int, out_channels: int) -> torch.Tensor:
    """A conv whose ``weight`` (and ``bias``) hold this rank's slice of the
    ``out_channels`` output channels: this rank's channels (a depthwise
    conv on its slice of the input channels), all-gathered along C."""
    group = _group()
    index, _ = group_index(group)
    n = weight.shape[0]
    if groups == 1:
        y = F.conv2d(x, weight, bias, stride, padding, dilation, 1)
    elif groups == out_channels == x.shape[1]:
        y = F.conv2d(x.narrow(1, index * n, n), weight, bias, stride, padding, dilation, n)
    else:
        raise NotImplementedError(f"a tensor-parallel conv with groups={groups} (plain or depthwise only)")
    return all_gather_autograd(y, 1, group)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1, groups: int = 1, out_channels: Optional[int] = None) -> torch.Tensor:
    """``F.conv2d``, or :func:`sharded_conv2d` where ``weight`` holds fewer
    than ``out_channels`` output channels (a functional use of a sharded
    conv's weight: the ResNet-50 stem)."""
    if out_channels is not None and weight.shape[0] != out_channels:
        return sharded_conv2d(x, weight, bias, stride, padding, dilation, groups, out_channels)
    return F.conv2d(x, weight, bias, stride, padding, dilation, groups)


def full(vectors: Sequence[Optional[torch.Tensor]], channels: int) -> List[Optional[torch.Tensor]]:
    """Each of the per-channel ``vectors`` whole: as it is where it holds
    ``channels`` values, else all-gathered (differentiably) from this
    rank's slice; the sharded ones of one dtype go in one collective.  A
    slice that takes no gradient (a frozen BatchNorm's affine and
    statistics) keeps its whole on itself until it changes (its version),
    so a frozen layer gathers once, not once a forward."""
    out = list(vectors)
    pending: Dict[torch.dtype, List[int]] = {}
    for i, v in enumerate(vectors):
        if v is None or v.shape[0] == channels:
            continue
        kept = None if v.requires_grad else getattr(v, "_tp_whole", None)
        if kept is not None and kept[0] == v._version:
            out[i] = kept[1]
        else:
            pending.setdefault(v.dtype, []).append(i)
    for idx in pending.values():
        whole = all_gather_autograd(torch.stack([vectors[i] for i in idx], 1), 0, _group())
        for i, col in zip(idx, whole.unbind(1)):
            out[i] = col.contiguous()  # a strided running_var gives F.batch_norm's CPU backward NaNs
            if not vectors[i].requires_grad:
                vectors[i]._tp_whole = (vectors[i]._version, out[i])
    return out


def local(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``whole`` where ``like`` holds a shard of it, else ``whole``."""
    if whole.shape[0] == like.shape[0]:
        return whole
    index, _ = group_index(_group())
    return whole.narrow(0, index * like.shape[0], like.shape[0])


def _slice(t: torch.Tensor, index: int, tp: int) -> torch.Tensor:
    n = t.shape[0] // tp
    return t.narrow(0, index * n, n).clone()


def shard_state_tp(mesh, state):
    """Shard a replicated ``TrainState`` over ``mesh``'s model dimension, in
    place, and return it: every weight and buffer that :func:`tp_spec`
    shards keeps this rank's contiguous slice along dim 0, and so does the
    optimizer state of each sharded parameter.  Records the whole shapes
    in ``state.sharded`` (state-dict name -> shape) and the mesh in
    ``state.mesh``; the train steps, :func:`gather_state_dict` and
    ``train/checkpoints`` read them.  Pass a state whose ranks agree
    (``parallel/mesh.replicate_state`` first)."""
    from pytorch_object_detection_tpu_torch.parallel.mesh import model_group

    if getattr(state, "sharded", None):
        raise ValueError("the state is sharded already")
    index, tp = group_index(model_group(mesh))
    model = state.model
    sharded = {}
    for prefix, module in model.named_modules():
        for slot in ("_parameters", "_buffers"):
            for name, t in getattr(module, slot).items():
                if t is None or tp_spec(t.shape, tp) is None:
                    continue
                sharded[f"{prefix}.{name}" if prefix else name] = tuple(t.shape)
                if slot == "_parameters":
                    t.data = _slice(t.data, index, tp)
                else:
                    module._buffers[name] = _slice(t, index, tp)
    by_param = {id(p): n for n, p in model.named_parameters()}
    for p, st in state.optimizer.state.items():
        whole = sharded.get(by_param.get(id(p)))
        for key, v in list(st.items()):
            if whole is not None and torch.is_tensor(v) and tuple(v.shape) == whole:
                st[key] = _slice(v, index, tp)
    state.sharded, state.mesh = sharded, mesh
    return state


def _gather_shards(shards: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each of this rank's ``shards`` whole (the ranks' slices concatenated
    along dim 0), in one all-gather a dtype and device."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    buckets: Dict = {}
    for i, t in enumerate(shards):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    with torch.no_grad():
        for idx in buckets.values():
            flat = torch.cat([shards[i].detach().reshape(-1) for i in idx])
            parts = all_gather_autograd(flat, 0, group).chunk(group_index(group)[1])
            start = 0
            for i in idx:
                n = shards[i].numel()
                out[i] = torch.cat([p[start:start + n].view(shards[i].shape) for p in parts])
                start += n
    return out


def gather_state_dict(state) -> Dict:
    """The whole ``TrainState.state_dict()`` of a sharded state: every
    sharded weight, buffer and optimizer-state tensor all-gathered over the
    model group (one collective a dtype), so it has the names and shapes of
    a one-process state.  A collective: every rank of the mesh calls it."""
    from pytorch_object_detection_tpu_torch.parallel.mesh import model_group

    model = state.model.state_dict()
    optimizer = state.optimizer.state_dict()
    names = state.trainable_names()
    slots = [("model", k, None) for k in model if k in state.sharded]
    for i, st in optimizer["state"].items():
        whole = state.sharded.get(names[i])
        slots += [("optimizer", i, k) for k, v in st.items() if whole is not None and torch.is_tensor(v)
                  and v.dim() == len(whole) and v.shape[0] != whole[0]]
    local = [model[k] if where == "model" else optimizer["state"][k][key] for where, k, key in slots]
    model = dict(model)
    gathered = {i: dict(st) for i, st in optimizer["state"].items()}  # the optimizer's own dicts stay as they are
    for (where, k, key), whole in zip(slots, _gather_shards(local, model_group(state.mesh))):
        if where == "model":
            model[k] = whole
        else:
            gathered[k][key] = whole
    return {"model": model, "optimizer": {**optimizer, "state": gathered}, "step": state.step, "trainable": names}


def shard_state_dict(state, whole: Dict) -> Dict:
    """A whole state dict (:func:`gather_state_dict`, or a one-process
    checkpoint) cut to this rank's slices of ``state``'s sharded tensors,
    for ``TrainState.load_state_dict``."""
    from pytorch_object_detection_tpu_torch.parallel.mesh import model_group

    index, tp = group_index(model_group(state.mesh))
    out = dict(whole)
    out["model"] = {k: (_slice(v, index, tp) if k in state.sharded else v) for k, v in whole["model"].items()}
    if "optimizer" in whole:
        optimizer = {**whole["optimizer"], "state": {}}
        names = list(whole.get("trainable", []))
        for i, st in whole["optimizer"]["state"].items():
            shape = state.sharded.get(names[i]) if i < len(names) else None
            optimizer["state"][i] = {k: (_slice(v, index, tp) if shape is not None and torch.is_tensor(v)
                                         and tuple(v.shape) == shape else v) for k, v in st.items()}
        out["optimizer"] = optimizer
    return out
