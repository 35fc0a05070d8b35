"""Model summaries: parameter counts, output shapes, FLOP estimates.

Counterpart of ``pytorch_object_detection_tpu/utils/model_info.py``.  The
model is built on the ``meta`` device, the counterpart of JAX's
``jax.eval_shape``: shapes only, no memory allocated and no weights drawn,
so a summary of a full-size model at a full-size input is instant.  The
kernel wrappers take their ops' fake implementations on meta tensors
(``ops/library.py``).

Counts follow the flax trees the JAX function counts, under the names
``train/checkpoints.flax_to_torch_name`` maps: ``params`` are the weights
and biases and every GroupNorm and BatchNorm affine (the port's frozen
BatchNorm keeps its affine as buffers), ``batch_stats`` the BatchNorms'
running means and variances.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import torch
from torch import nn

_STATS = ("running_mean", "running_var")


def _entries(model: nn.Module) -> Iterable[Tuple[str, torch.Tensor]]:
    """The model's state (parameters and buffers) by ``state_dict`` name."""
    return model.state_dict(keep_vars=True).items()


def count_params(tensors: Dict[str, torch.Tensor]) -> int:
    """Total number of scalars in a dict of tensors."""
    return int(sum(t.numel() for t in tensors.values()))


def params_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``params`` of ``model``: every state entry but the BatchNorm statistics."""
    return {k: v for k, v in _entries(model) if not k.endswith(_STATS)}


def batch_stats_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``batch_stats``: the BatchNorms' running means and variances."""
    return {k: v for k, v in _entries(model) if k.endswith(_STATS)}


def count_by_top_level(params: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Param count per top-level module (backbone / fpn / head / ...), in the model's order."""
    out: Dict[str, int] = {}
    for name, t in params.items():
        top = name.split(".", 1)[0]
        out[top] = out.get(top, 0) + t.numel()
    return out


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes(t) for t in tree)
    return tree


def model_info(model_or_name, input_shape=(1, 512, 512, 3), train: bool = False, num_classes: int = 20,
               features: int = 256, **build_kw) -> Dict[str, Any]:
    """Params, their split by top-level module, ``batch_stats``, output shapes
    and FLOPs of one forward at ``input_shape`` (NHWC, as the models take it).

    ``model_or_name`` is a registry name (``build_model(name, num_classes,
    features, **build_kw)`` runs on the ``meta`` device) or a built module,
    whose structure is copied onto the ``meta`` device (a module already
    there is used as it is).  ``train`` runs the forward in training mode
    (the JAX ``train`` flag).  The JAX ``seed`` has no counterpart: meta
    tensors hold no values.
    """
    from pytorch_object_detection_tpu_torch.models.registry import build_model

    if isinstance(model_or_name, str):
        with torch.device("meta"):
            model = build_model(model_or_name, num_classes, features, device="meta", **build_kw)
    elif next(model_or_name.parameters()).is_meta:
        model = model_or_name
    else:
        model = _meta_copy(model_or_name)
    model.train(train)
    params = params_of(model)
    info: Dict[str, Any] = {"params": count_params(params), "params_by_module": count_by_top_level(params)}
    stats = batch_stats_of(model)
    if stats:
        info["batch_stats"] = count_params(stats)
    flops, out = estimate_flops(model, input_shape)
    info["output_shapes"] = _shapes(out)
    info["flops"] = flops
    return info


def _meta_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model`` whose parameters and buffers live on the ``meta``
    device (the model itself is not touched)."""
    import copy

    memo = {id(t): torch.empty_like(t, device="meta") for t in model.state_dict(keep_vars=True).values()}
    for name, p in model.named_parameters():
        memo[id(p)] = nn.Parameter(memo[id(p)], requires_grad=p.requires_grad)
    return copy.deepcopy(model, memo)


def estimate_flops(model: nn.Module, input_shape) -> Tuple[float, Any]:
    """(FLOPs, outputs) of one forward of ``model`` (on the ``meta`` device)
    on a ``meta`` input of ``input_shape``, counted by
    ``torch.utils.flop_counter.FlopCounterMode``: 2 per multiply-add of the
    convolutions and matrix products, nothing for elementwise work,
    normalizations or pools (XLA's cost analysis, which the JAX function
    reads, counts those too, and the two differ by a few per cent)."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.empty(tuple(input_shape), dtype=torch.float32, device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        out = model(x)
    return float(counter.get_total_flops()), out
