"""The explicit collectives of data parallelism (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/parallel/collectives.py``
(``psum_grads``, ``pmean_grads``, ``pmean_metrics``, ``sync_batch_stats``),
where ``jax.lax.psum``/``pmean`` over the mesh's ``data`` axis become
``torch.distributed.all_reduce`` over its process group; here also the
all-gather of data-parallel serving, the broadcast that replicates a state,
and the collectives through which autograd runs: the all-reduce of
SyncBatchNorm's statistics and of spatial partitioning's, the all-gather of
tensor parallelism's channel shards and of spatial partitioning's row
bands, and the halo exchange of the row bands (``parallel/tp.py``,
``parallel/sp.py``).  Each of those has its adjoint as its backward: the
gradient of every rank's input sums what every rank's output gradient
says of it.  ``group`` is a process group, a ``DeviceMesh`` (its ``data``
dimension's group, or the one ``group_of`` names) or ``None`` (the default
group).

Tensors of one call are flattened into one buffer per dtype and device, so
a call is one collective a dtype whatever the number of tensors.  Gloo runs on host
memory: where the group is gloo's and a tensor lies on the card (several
ranks sharing one card), the buffer goes through a host copy; NCCL takes
only card memory, so host tensors go through the card.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def group_of(group, dim: str = "data"):
    """The process group of ``group``: itself, a ``DeviceMesh``'s dimension
    ``dim`` (``"data"`` or ``"model"``), or the default group for ``None``."""
    if group is not None and hasattr(group, "get_group"):
        own = getattr(group, "_podt_dims", None)  # a (data, model) mesh's own groups (mesh.create_mesh)
        return own[dim] if own else group.get_group(dim)
    return group if group is not None else dist.group.WORLD


_MODEL_GROUPS: List = []


@contextlib.contextmanager
def model_axis(group):
    """Within the block, ``group`` is the model group that tensor-parallel
    layers gather their channel shards over (:func:`current_model_group`);
    the train steps enter it around the forward and the backward."""
    _MODEL_GROUPS.append(group)
    try:
        yield group
    finally:
        _MODEL_GROUPS.pop()


def current_model_group():
    """The model group of the innermost :func:`model_axis` block, else ``None``."""
    return _MODEL_GROUPS[-1] if _MODEL_GROUPS else None


def group_index(group) -> Tuple[int, int]:
    """(this rank's index in ``group``, the group's size)."""
    return dist.get_group_rank(group, dist.get_rank()), dist.get_world_size(group)


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
    gradients (every rank's loss depends on every rank's input).  The host
    copies for gloo happen inside, so the node runs on the tensor's device:
    autograd runs a card's nodes on one thread of their own, and every
    rank's collectives must come in one order."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.to(_backend_device(group, tensor), copy=True)
        dist.all_reduce(out, group=group)
        return out.to(tensor.device)

    @staticmethod
    def backward(ctx, grad):
        out = grad.to(_backend_device(ctx.group, grad), copy=True)
        dist.all_reduce(out, group=ctx.group)
        return out.to(grad.device), None


def all_reduce_autograd(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``tensor`` over ``group``, differentiable: the gradient
    of each rank's input is the sum of every rank's output gradient, so
    the ranks' backwards meet in one all-reduce a call too."""
    return _AllReduceSum.apply(tensor, group_of(group))


class _AllGather(torch.autograd.Function):
    """Every rank's ``tensor`` concatenated along ``dim`` in group order; the
    backward is the reduce-scatter: each rank's slice of the sum of every
    rank's output gradient (gloo has no reduce-scatter: an all-reduce, then
    the slice)."""

    @staticmethod
    def forward(ctx, tensor, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.index, size = group_index(group)
        src = tensor.to(_backend_device(group, tensor)).contiguous()
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim).to(tensor.device)

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(_backend_device(ctx.group, grad), copy=True).contiguous()
        size = dist.get_world_size(ctx.group)
        if dist.get_backend(ctx.group) == "nccl":
            chunks = [c.contiguous() for c in g.chunk(size, ctx.dim)]
            out = torch.empty_like(chunks[ctx.index])
            dist.reduce_scatter(out, chunks, group=ctx.group)
        else:
            dist.all_reduce(g, group=ctx.group)
            out = g.chunk(size, ctx.dim)[ctx.index].contiguous()
        return out.to(grad.device), None, None


def all_gather_autograd(tensor: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``tensor`` (one shape on all ranks of ``group``)
    concatenated along ``dim`` in group order, differentiable: the gradient
    of each rank's input is its slice of the sum of the ranks' output
    gradients (tensor parallelism's channel gather, spatial
    partitioning's row gather)."""
    return _AllGather.apply(tensor, dim, group)


def _edges(t: torch.Tensor, dim: int, first: int, last: int) -> torch.Tensor:
    """``t``'s first ``first`` and last ``last`` slices along ``dim``, flat."""
    n = t.shape[dim]
    return torch.cat([t.narrow(dim, 0, first).reshape(-1), t.narrow(dim, n - last, last).reshape(-1)])


class _Halo(torch.autograd.Function):
    """The halo exchange of a row band: ``tensor`` with the ``top`` rows
    before it that the previous rank of ``group`` holds last and the
    ``bottom`` rows after it that the next rank holds first, ``fill`` where
    the image ends.  The backward sends each halo's gradient back to the
    rank that owns those rows and adds it there.  Both directions are one
    all-gather of every rank's edge rows."""

    @staticmethod
    def forward(ctx, tensor, top, bottom, dim, group, fill):
        ctx.top, ctx.bottom, ctx.dim, ctx.group = top, bottom, dim, group
        index, size = group_index(group)
        ctx.index, ctx.size = index, size
        h = tensor.shape[dim]
        src = _edges(tensor, dim, bottom, top).to(_backend_device(group, tensor))
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        shape = list(tensor.shape)
        step = tensor.numel() // h  # elements a row
        pieces = []
        if top:
            shape[dim] = top
            pieces.append(parts[index - 1][bottom * step:].reshape(shape).to(tensor.device) if index > 0 else
                          torch.full(shape, fill, dtype=tensor.dtype, device=tensor.device))
        pieces.append(tensor)
        if bottom:
            shape[dim] = bottom
            pieces.append(parts[index + 1][:bottom * step].reshape(shape).to(tensor.device) if index < size - 1 else
                          torch.full(shape, fill, dtype=tensor.dtype, device=tensor.device))
        return torch.cat(pieces, dim)

    @staticmethod
    def backward(ctx, grad):
        top, bottom, dim = ctx.top, ctx.bottom, ctx.dim
        h = grad.shape[dim] - top - bottom
        step = grad.numel() // grad.shape[dim]
        src = _edges(grad, dim, top, bottom).to(_backend_device(ctx.group, grad))
        parts = [torch.empty_like(src) for _ in range(ctx.size)]
        dist.all_gather(parts, src, group=ctx.group)
        out = grad.narrow(dim, top, h).clone()
        shape = list(out.shape)
        if top and ctx.index < ctx.size - 1:  # the next rank's top halo is this rank's last rows
            shape[dim] = top
            out.narrow(dim, h - top, top).add_(parts[ctx.index + 1][:top * step].reshape(shape).to(grad.device))
        if bottom and ctx.index > 0:  # the previous rank's bottom halo is this rank's first rows
            shape[dim] = bottom
            out.narrow(dim, 0, bottom).add_(parts[ctx.index - 1][top * step:].reshape(shape).to(grad.device))
        return out, None, None, None, None, None


def halo_exchange(tensor: torch.Tensor, top: int, bottom: int, dim: int, group, fill: float = 0.0) -> torch.Tensor:
    """``tensor`` (this rank's band of rows along ``dim``) with ``top`` rows
    of the previous rank of ``group`` before it and ``bottom`` rows of the
    next after it, ``fill`` beyond the image's first and last rows;
    differentiable (the halos' gradients go back to their owners).  Every
    rank's band must be at least ``max(top, bottom)`` rows."""
    if not top and not bottom:
        return tensor
    return _Halo.apply(tensor, top, bottom, dim, group, fill)


def all_gather_rows(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``tensor`` (one shape on all ranks) concatenated along
    dim 0 in rank order; bool goes as uint8."""
    src = tensor.to(torch.uint8) if tensor.dtype == torch.bool else tensor
    return all_gather_autograd(src, 0, group_of(group)).to(tensor.dtype)


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
