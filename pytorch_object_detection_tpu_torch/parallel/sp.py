"""Spatial partitioning: the image rows over the mesh's ``model`` dimension (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/parallel/sp.py``.  The JAX
package annotates the batch ``P('data', 'model')`` and lets GSPMD partition
every conv spatially, exchange the halos and gather where the deep levels
need it; PyTorch has no such propagation for convolutions, so here it is
written by hand over ``torch.distributed``, one process a device.

:func:`shard_batch_spatial` gives each rank of a model group its band of
rows of its data shard's images as a :class:`Band`: a tensor that knows
the map's whole height, which dimension holds the rows and its model
group.  The model's own code runs unchanged on it; ``Band``'s
``__torch_function__`` gives each operation its spatial meaning:

* a conv or a max pool (``F.conv2d``: ``nn/layers.Conv``, ``DepthwiseConv``
  and the ResNet-50 stem; ``F.max_pool2d``: the stem's pool,
  ``nn/layers.maxpool2x2``, VGG's ceil-mode and 'same' pools) takes from
  its neighbours the halo rows its kernel, stride, dilation and padding
  need (``collectives.halo_exchange``: zeros, or -inf for a pool, beyond
  the image's first and last rows), pads only the columns, and returns the
  band of its output; the space-to-depth stem pads its rows (2, 1) the same
  way (:func:`conv2d`);
* sums and means over the rows (the SE blocks' global mean, a BatchNorm's
  statistics) are the band's, all-reduced over the model group through
  autograd; a GroupNorm takes its per-group sums of x and x^2 the same way
  (flax's ``E[x^2] - E[x]^2``), and a trained BatchNorm with SyncBN counts
  the whole image (:func:`global_numel`);
* pointwise operations, concatenations over channels, nearest 2x
  upsampling, column padding and permutes keep the band; a whole tensor
  meeting a band (a level computed whole, added to one still in bands) is
  cut to this rank's rows, which costs nothing;
* where bands stop dividing, the map is all-gathered along its rows
  (``collectives.all_gather_autograd``) and computed whole on every rank
  of the group from there on: where a conv's or pool's input height is
  not ``stride`` times an output height that the group's size divides, or
  where a halo is taller than a band (the P6/P7 levels at 128x128,
  SSD300's maps from 75 rows down).  Any operation without a spatial rule
  here (a reshape, an index) gathers too, so the result is always the
  whole model's; ``Band.gathers`` counts the gathers by operation.

The train step gathers the head's outputs (:func:`gather`), so the targets
and the losses run unchanged.  Each collective's backward is its adjoint
and every rank of a model group computes the same loss, so a parameter's
gradient is split across the group's ranks: the step averages it over the
whole mesh (``train/trainer.py``).  Activation memory per rank scales
about 1/sp on the trunk, where the big maps live; the parameters stay
replicated.
"""
from __future__ import annotations

import collections
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from pytorch_object_detection_tpu_torch.parallel.collectives import (
    all_gather_autograd,
    all_reduce_autograd,
    group_index,
    halo_exchange,
)

# the elementwise operations of the six families' forwards (frozen BatchNorm among them), and the queries that
# read a band's own tensor; anything else gathers the band first
_POINTWISE = frozenset("""add sub mul div neg relu silu sigmoid exp sqrt rsqrt clamp to float double detach
contiguous clone batch_norm __add__ __radd__ __sub__ __rsub__ __mul__ __rmul__ __truediv__ __rtruediv__
__neg__""".split())
_LOCAL = frozenset("""__get__ __set__ dim size numel element_size is_floating_point is_contiguous data_ptr
stride __len__ __repr__ __format__ __hash__""".split())


class Band(torch.Tensor):
    """This rank's band of rows of a map: rows ``[i * h, (i + 1) * h)`` of
    ``rows`` along dimension ``row_dim``, ``i = band_index`` this rank's
    index in the model group ``group`` of ``band_count`` ranks and ``h =
    rows / band_count``.
    ``.shape`` is the band's.  Made by :func:`shard_batch_spatial`."""

    rows: int
    row_dim: int
    group: Any
    band_index: int
    band_count: int
    gathers: collections.Counter = collections.Counter()

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _LOCAL:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        rule = _RULES.get(name)
        if rule is not None:
            out = rule(*args, **kwargs)
            if out is not NotImplemented:
                return out
        elif name in _POINTWISE:
            out = _pointwise(func, args, kwargs)
            if out is not NotImplemented:
                return out
        if name.endswith("_") and not name.endswith("__"):
            raise NotImplementedError(f"in-place {name} on a row band (parallel/sp.py)")
        cls.gathers[name] += 1
        return func(*_map(gather, args), **{k: _map(gather, v) for k, v in kwargs.items()})


def _plain(t: torch.Tensor) -> torch.Tensor:
    """The band's local rows as a plain tensor (an alias, through autograd)."""
    with torch._C.DisableTorchFunctionSubclass():
        return t.as_subclass(torch.Tensor)


def _band(t: torch.Tensor, rows: int, row_dim: int, like: Band) -> Band:
    b = t.as_subclass(Band)
    b.rows, b.row_dim, b.group = rows, row_dim, like.group
    b.band_index, b.band_count = like.band_index, like.band_count
    return b


def _map(fn, obj):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(fn, o) for o in obj)
    return fn(obj)


def is_band(x) -> bool:
    return isinstance(x, Band)


def gather(x):
    """``x`` whole: a :class:`Band` all-gathered along its rows over its
    model group (differentiably); anything else as it is."""
    if not isinstance(x, Band):
        return x
    return all_gather_autograd(_plain(x), x.row_dim, x.group)


def gather_tree(obj):
    """Every band in a nest of lists, tuples and dicts gathered (the head's outputs, for the loss)."""
    if isinstance(obj, dict):
        return {k: gather_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(gather_tree(o) for o in obj)
    return gather(obj)


def global_numel(x: torch.Tensor) -> int:
    """The element count of the whole map of which ``x`` is a band (``x.numel()`` otherwise)."""
    n = x.numel()
    return n * x.band_count if isinstance(x, Band) else n


def rowwise(fn, x: Band, rows: int) -> Band:
    """``fn`` of the band's local rows, as the band of ``rows`` rows of the
    result: for maps where ``fn`` of a band is the band of ``fn`` of the
    whole (the stem's space-to-depth on bands of even height)."""
    return _band(fn(_plain(x)), rows, x.row_dim, x)


def _right(t: torch.Tensor, band: Band) -> Optional[int]:
    """The dimension of ``t`` that broadcasts against ``band``'s rows, if any."""
    i = t.dim() - (band.dim() - band.row_dim)
    return i if i >= 0 else None


def _to_local(t, ref: Band):
    """A band as its rows, a whole tensor cut to ``ref``'s rows, anything
    else as it is; ``NotImplemented`` where it does not line up."""
    if isinstance(t, Band):
        if t.rows != ref.rows or t.dim() - t.row_dim != ref.dim() - ref.row_dim:
            return NotImplemented
        return _plain(t)
    if isinstance(t, torch.Tensor):
        i = _right(t, ref)
        if i is None or t.shape[i] == 1:
            return t
        if t.shape[i] == ref.rows:
            h = ref.rows // ref.band_count
            return t.narrow(i, ref.band_index * h, h)
        return NotImplemented
    return t


def _first_band(args, kwargs) -> Band:
    for a in list(args) + list(kwargs.values()):
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, Band):
                return t
    raise AssertionError("no band among the arguments")


def _rewrap(out, ref: Band):
    if isinstance(out, torch.Tensor) and not isinstance(out, Band) and out.dim() >= ref.dim() - ref.row_dim:
        row = out.dim() - (ref.dim() - ref.row_dim)
        if out.shape[row] == ref.rows // ref.band_count:
            return _band(out, ref.rows, row, ref)
    return out


def _pointwise(func, args, kwargs):
    ref = _first_band(args, kwargs)
    if getattr(func, "__name__", "") == "batch_norm" and (kwargs.get("training") or (len(args) > 5 and args[5])):
        return NotImplemented
    local_args = []
    for a in args:
        la = _map(lambda t: _to_local(t, ref), a) if isinstance(a, (list, tuple)) else _to_local(a, ref)
        if la is NotImplemented or (isinstance(la, (list, tuple)) and any(x is NotImplemented for x in la)):
            return NotImplemented
        local_args.append(la)
    local_kwargs = {}
    for k, v in kwargs.items():
        lv = _to_local(v, ref)
        if lv is NotImplemented:
            return NotImplemented
        local_kwargs[k] = lv
    return _rewrap(func(*local_args, **local_kwargs), ref)


def _pair(v) -> Tuple[int, int]:
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _halo(x: Band, kernel: int, stride: int, dilation: int, pad_top: int, pad_bottom: int,
          ceil_mode: bool = False) -> Optional[Tuple[int, int]]:
    """(top, bottom) halo rows a window op needs on ``x``'s bands, or
    ``None`` where the bands stop dividing: the output height must be the
    input's over ``stride`` and divide by the group's size, and each halo
    must come from one neighbour's band.  ``bottom < 0`` drops rows."""
    rows, h = x.rows, x.rows // x.band_count
    span = rows + pad_top + pad_bottom - dilation * (kernel - 1) - 1
    out = (-(-span // stride) if ceil_mode else span // stride) + 1
    if ceil_mode and (out - 1) * stride >= rows + pad_top:
        out -= 1
    if span < 0 or out * stride != rows or out % x.band_count:
        return None
    top, bottom = pad_top, dilation * (kernel - 1) - pad_top - stride + 1
    if top > h or bottom > h:
        return None
    return top, bottom


def _with_halo(x: Band, top: int, bottom: int, fill: float) -> torch.Tensor:
    local = _plain(x)
    local = halo_exchange(local, top, max(bottom, 0), x.row_dim, x.group, fill)
    if bottom < 0:
        local = local.narrow(x.row_dim, 0, local.shape[x.row_dim] + bottom)
    return local


def conv2d(x: Band, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, stride=1, padding=0, dilation=1,
           groups: int = 1):
    """``F.conv2d`` of a band of an NCHW map: ``padding`` an int, a pair,
    or ``((top, bottom), (left, right))``.  The band of the output, or the
    whole output where the bands stop dividing."""
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    if isinstance(padding, str):
        if padding != "valid":
            return NotImplemented
        padding = 0
    if isinstance(padding, (tuple, list)) and isinstance(padding[0], (tuple, list)):
        (pt, pb), (pl, pr) = padding
    else:
        (pt, pl), (pb, pr) = _pair(padding), _pair(padding)
    halo = _halo(x, weight.shape[2], sh, dh, pt, pb) if x.row_dim == 2 else None
    if halo is None:
        Band.gathers["conv2d"] += 1
        whole = F.pad(gather(x), (pl, pr, pt, pb))
        return F.conv2d(whole, weight, bias, (sh, sw), 0, (dh, dw), groups)
    local = _with_halo(x, *halo, 0.0)
    if pl == pr:
        y = F.conv2d(local, weight, bias, (sh, sw), (0, pl), (dh, dw), groups)
    else:
        y = F.conv2d(F.pad(local, (pl, pr, 0, 0)), weight, bias, (sh, sw), 0, (dh, dw), groups)
    return _band(y, x.rows // sh, 2, x)


def _conv2d_rule(input, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    if not isinstance(input, Band) or isinstance(weight, Band) or isinstance(bias, Band):
        return NotImplemented
    return conv2d(input, weight, bias, stride, padding, dilation, groups)


def _max_pool2d_rule(input, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                     return_indices=False):
    if return_indices or input.row_dim != 2:
        return NotImplemented
    (kh, kw), (dh, dw), (ph, pw) = _pair(kernel_size), _pair(dilation), _pair(padding)
    sh, sw = _pair(stride if stride is not None and stride != [] else kernel_size)
    halo = _halo(input, kh, sh, dh, ph, ph, ceil_mode)
    if halo is None:
        return NotImplemented
    local = _with_halo(input, *halo, float("-inf"))
    y = F.max_pool2d(local, (kh, kw), (sh, sw), (0, pw), (dh, dw), ceil_mode)
    return _band(y, input.rows // sh, 2, input)


def _interpolate_rule(input, size=None, scale_factor=None, mode="nearest", align_corners=None,
                      recompute_scale_factor=None, antialias=False):
    if size is not None or mode != "nearest" or input.row_dim != 2 or scale_factor is None:
        return NotImplemented
    sh, _ = (tuple(scale_factor) if isinstance(scale_factor, (tuple, list)) else (scale_factor, scale_factor))
    if float(sh) != int(sh):
        return NotImplemented
    y = F.interpolate(_plain(input), scale_factor=scale_factor, mode="nearest")
    return _band(y, input.rows * int(sh), 2, input)


def _pad_rule(input, pad, mode="constant", value=None):
    pad = list(pad)
    row_pads = pad[2 * (input.dim() - 1 - input.row_dim): 2 * (input.dim() - input.row_dim)]
    if any(pad[2 * (input.dim() - 1 - input.row_dim):]) and any(row_pads):
        return NotImplemented
    if any(row_pads):
        return NotImplemented
    return _band(F.pad(_plain(input), pad, mode, value), input.rows, input.row_dim, input)


def _reduce_rule(op):
    def rule(input, dim=None, keepdim=False, *, dtype=None):
        if not isinstance(input, Band):
            return NotImplemented
        nd = input.dim()
        dims = tuple(range(nd)) if dim is None or dim == [] else tuple(
            d % nd for d in (dim if isinstance(dim, (tuple, list)) else (dim,)))
        local = _plain(input)
        kw = {} if dtype is None else {"dtype": dtype}
        if input.row_dim not in dims:
            out = getattr(torch, op)(local, dims, keepdim, **kw)
            row = input.row_dim - (0 if keepdim else sum(d < input.row_dim for d in dims))
            return _band(out, input.rows, row, input)
        total = all_reduce_autograd(torch.sum(local, dims, keepdim, **kw), input.group)
        if op == "mean":
            count = 1
            for d in dims:
                count *= input.rows if d == input.row_dim else local.shape[d]
            total = total / count
        return total
    return rule


def _cat_rule(tensors, dim=0):
    ref = _first_band((tensors,), {})
    if dim % ref.dim() == ref.row_dim:
        return NotImplemented
    parts = [_to_local(t, ref) for t in tensors]
    if any(p is NotImplemented for p in parts):
        return NotImplemented
    return _band(torch.cat(parts, dim), ref.rows, ref.row_dim, ref)


def _permute_rule(input, *dims):
    dims = tuple(dims[0]) if len(dims) == 1 and isinstance(dims[0], (tuple, list)) else dims
    dims = tuple(d % input.dim() for d in dims)
    return _band(_plain(input).permute(dims), input.rows, dims.index(input.row_dim), input)


def _autocast_f32(device_type: str) -> bool:
    try:
        return torch.is_autocast_enabled(device_type)
    except TypeError:  # an older torch: one flag for the card
        return torch.is_autocast_enabled() if device_type == "cuda" else torch.is_autocast_cpu_enabled()


def _group_norm_rule(input, num_groups, weight=None, bias=None, eps=1e-5):
    """GroupNorm of a band: per (image, group) sums of x and x^2 over the
    band, all-reduced over the model group through autograd."""
    if not isinstance(input, Band) or input.row_dim != 2:
        return NotImplemented
    local = _plain(input)
    xf = local.to(torch.promote_types(local.dtype, torch.float32))
    b, c = xf.shape[:2]
    g = xf.reshape(b, num_groups, -1)
    sums = all_reduce_autograd(torch.cat([g.sum(-1), (g * g).sum(-1)], 1), input.group)
    n = (c // num_groups) * input.rows * xf.shape[3]
    mean = sums[:, :num_groups] / n
    var = torch.clamp(sums[:, num_groups:] / n - mean * mean, min=0.0)
    y = ((g - mean[..., None]) * torch.rsqrt(var + eps)[..., None]).reshape(xf.shape)
    if weight is not None:
        y = y * weight.to(y.dtype)[:, None, None]
    if bias is not None:
        y = y + bias.to(y.dtype)[:, None, None]
    if not _autocast_f32(local.device.type):
        y = y.to(local.dtype)
    return _band(y, input.rows, 2, input)


_RULES = {"conv2d": _conv2d_rule, "max_pool2d": _max_pool2d_rule, "_max_pool2d": _max_pool2d_rule,
          "interpolate": _interpolate_rule, "pad": _pad_rule, "mean": _reduce_rule("mean"),
          "sum": _reduce_rule("sum"), "cat": _cat_rule, "concat": _cat_rule, "permute": _permute_rule,
          "group_norm": _group_norm_rule}


def shard_batch_spatial(mesh, images, *aux):
    """(images, boxes, labels, ...) for this rank of ``mesh``: its band of
    rows of its data shard's NHWC ``images`` (a :class:`Band` over the
    mesh's model group), and the per-image ``aux`` tensors whole; all on
    the rank's device.  As in :func:`parallel/mesh.shard_batch`, each
    rank's local batch is its data shard."""
    from pytorch_object_detection_tpu_torch.parallel.mesh import model_group, rank_device

    device = rank_device(mesh.device_type)
    group = model_group(mesh)
    index, size = group_index(group)
    rows = images.shape[1]
    if rows % size:
        raise ValueError(f"{rows} rows do not divide into {size} bands")
    h = rows // size
    band = torch.as_tensor(images).to(device, non_blocking=True).narrow(1, index * h, h).contiguous().as_subclass(Band)
    band.rows, band.row_dim, band.group, band.band_index, band.band_count = rows, 1, group, index, size
    return (band,) + tuple(torch.as_tensor(a).to(device, non_blocking=True) for a in aux)
