"""The explicit collectives of data parallelism (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/parallel/collectives.py``
(``psum_grads``, ``pmean_grads``, ``pmean_metrics``, ``sync_batch_stats``),
where ``jax.lax.psum``/``pmean`` over the mesh's ``data`` axis become
``torch.distributed.all_reduce`` over its process group; here also the
all-gather of data-parallel serving, the broadcast that replicates a state,
and the all-reduce through which autograd runs (SyncBatchNorm's
statistics).  ``group`` is a process group, a ``DeviceMesh`` (its ``data``
dimension's group) or ``None`` (the default group).

Tensors of one call are flattened into one buffer per dtype and device, so
a call is one collective a dtype whatever the number of tensors.  Gloo runs on host
memory: where the group is gloo's and a tensor lies on the card (several
ranks sharing one card), the buffer goes through a host copy; NCCL takes
only card memory, so host tensors go through the card.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def group_of(group):
    """The process group of ``group``: itself, a ``DeviceMesh``'s ``data``
    dimension's, or the default group for ``None``."""
    if group is not None and hasattr(group, "get_group"):
        return group.get_group("data")
    return group if group is not None else dist.group.WORLD


def _backend_device(group, tensor: torch.Tensor) -> torch.device:
    """Where ``group``'s backend takes ``tensor``: the host for gloo, the card for NCCL."""
    if dist.get_backend(group) == "nccl":
        return tensor.device if tensor.is_cuda else torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _collective_(tensors: Sequence[torch.Tensor], group, fn) -> None:
    """``fn(buffer, group)`` on one flat buffer a (dtype, device) of
    ``tensors``, the result copied back into them: one concatenation, one
    host or card copy where the backend needs it, one fused copy back (the
    flatten and unflatten DDP's buckets use)."""
    group = group_of(group)
    buckets: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for parts in buckets.values():
            parts = [p.detach() for p in parts]
            flat = _flatten_dense_tensors(parts)
            buf = flat.to(_backend_device(group, flat))
            fn(buf, group)
            torch._foreach_copy_(parts, _unflatten_dense_tensors(buf.to(flat.device), parts))


def all_reduce_(tensors: Sequence[torch.Tensor], group=None, mean: bool = False) -> None:
    """Sum (or with ``mean`` average) each of ``tensors`` over ``group``, in place."""
    size = dist.get_world_size(group_of(group))

    def reduce(buf, g):
        dist.all_reduce(buf, group=g)
        if mean:
            buf.div_(size)

    _collective_(tensors, group, reduce)


def broadcast_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Overwrite ``tensors`` with those of ``group``'s rank 0, in place."""
    _collective_(tensors, group, lambda buf, grp: dist.broadcast(buf, dist.get_global_rank(grp, 0), group=grp))


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group``; its gradient is the sum of the ranks' output
    gradients (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_autograd(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``tensor`` over ``group``, differentiable: the gradient
    of each rank's input is the sum of every rank's output gradient, so
    the ranks' backwards meet in one all-reduce a call too."""
    group = group_of(group)
    return _AllReduceSum.apply(tensor.to(_backend_device(group, tensor)), group).to(tensor.device)


def all_gather_rows(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``tensor`` (one shape on all ranks) concatenated along
    dim 0 in rank order; bool goes as uint8."""
    group = group_of(group)
    where = _backend_device(group, tensor)
    src = tensor.to(where, torch.uint8 if tensor.dtype == torch.bool else tensor.dtype).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(tensor.device, tensor.dtype)


def psum_grads(grads, group=None):
    """Sum gradients across the data-parallel ranks (DDP's all-reduce), in
    place: a list of tensors or a dict of them, returned."""
    all_reduce_(list(grads.values()) if isinstance(grads, dict) else list(grads), group)
    return grads


def pmean_grads(grads, group=None):
    """Average gradients across the ranks (DDP: the mean over the global
    batch), in place: a list of tensors or a dict of them, returned."""
    all_reduce_(list(grads.values()) if isinstance(grads, dict) else list(grads), group, mean=True)
    return grads


def pmean_metrics(metrics: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """Scalar metrics (0-d tensors of one dtype and device) averaged across
    the ranks (the reference's all-gather and host mean of each rank's
    losses), as new tensors: one all-reduce."""
    group = group_of(group)
    flat = torch.stack([v.detach() for v in metrics.values()])
    buf = flat.to(_backend_device(group, flat))
    dist.all_reduce(buf, group=group)
    return dict(zip(metrics, (buf.to(flat.device) / dist.get_world_size(group)).unbind()))


def sync_batch_stats(mean: torch.Tensor, var: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-replica BatchNorm statistics: the mean of ``mean`` and of
    ``var`` over the ranks, as new tensors (what ``make_shard_map_train_step``
    applies to the updated running statistics)."""
    mean, var = mean.detach().clone(), var.detach().clone()
    all_reduce_([mean, var], group, mean=True)
    return mean, var
