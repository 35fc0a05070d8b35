"""The kernels of the serving pipelines as ``torch.library`` ops (namespace ``podt``).

Every wrapper that ``eval/evaluator.make_eval_pipeline`` or
``make_eval_pipeline_int8`` can reach defines one op here through
:func:`define`: its CUDA implementation is the wrapper's launch, with the
wrapper's launch counter; its CPU implementation is the plain version; its
fake implementation returns empty outputs of the right shape, dtype and
strides, so that ``torch.export`` (``utils/export.py``) records the op as one
node of the graph.  Dicts of weights reach an op as a ``Tensor[]`` in a fixed
key order, and tile choices as an ``int[]?`` that the wrapper fills on the
host from the card's chooser, so an exported graph keeps the tile of the card
it was exported on (``None`` lets the launch choose).

The eager wrappers launch their kernels directly and take the op only while
a tracer runs (:func:`route`): the dispatcher's round trip into Python costs
more host time than the shortest launches take (PERF.md §6).
``EAGER_OPS = True`` sends eager calls through the ops too; both routes give
the same bits.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

NAMESPACE = "podt"
LIB = torch.library.Library(NAMESPACE, "FRAGMENT")
# eager calls through the ops as well (the route phase 5y (b) of chip_smoke.py times)
EAGER_OPS = False

# the modules whose import defines ops, in the order of the main path
OP_MODULES = ("cuda_nms", "nms", "gn", "qstem", "qblock", "qconv", "qhis", "qpool", "qhead", "stem", "qchain", "head")


def _own(out, inputs):
    """``out`` with every tensor that shares storage with an input copied
    (an op's output may not alias its inputs) and made contiguous."""
    def fix(t):
        if not isinstance(t, torch.Tensor):
            return t
        if any(isinstance(i, torch.Tensor) and i.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
               and t.numel() for i in inputs):
            return t.clone(memory_format=torch.contiguous_format)
        return t.contiguous()

    return tuple(fix(t) for t in out) if isinstance(out, tuple) else fix(out)


def _flat_inputs(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))
        elif isinstance(a, torch.Tensor):
            yield a


def define(name: str, schema: str, *, cpu: Callable, cuda: Optional[Callable], fake: Callable):
    """Define ``podt::<name><schema>`` with the three implementations and
    return the op.  The CPU one's outputs are copied where they alias an
    input (a plain version may return its input) and made contiguous, as
    the fake one's are.  ``cuda=None`` (an op that is no kernel, such as
    the plain NMS) runs the CPU implementation on the card too."""
    LIB.define(name + schema)

    def cpu_impl(*args):
        return _own(cpu(*args), list(_flat_inputs(args)))

    LIB.impl(name, cpu_impl, "CPU")
    LIB.impl(name, cpu_impl if cuda is None else cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name)


def tracing(t: torch.Tensor) -> bool:
    """Whether a tracer (``torch.export``, ``torch.compile``) runs or ``t``
    holds no data: the compiler says so, or ``t`` is a fake tensor or on
    the ``meta`` device (``utils/model_info.py``'s shape-only forward)."""
    if torch.compiler.is_compiling() or t.is_meta:
        return True
    if type(t) is torch.Tensor or isinstance(t, torch.nn.Parameter):
        return False
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def route(t: torch.Tensor) -> bool:
    """Whether a wrapper called on ``t`` goes through its op (while tracing,
    or everywhere with ``EAGER_OPS``) rather than launching directly."""
    return EAGER_OPS or tracing(t)


def tile_ints(tile) -> Optional[list]:
    """A tile choice as the op's ``int[]?``: nested tuples flattened in order."""
    if tile is None:
        return None
    out = []
    for v in tile:
        if isinstance(v, (tuple, list)):
            out.extend(int(u) for u in v)
        else:
            out.append(int(v))
    return out


def tile_tuple(ints: Optional[Sequence[int]]):
    """The inverse of :func:`tile_ints` for a flat tile: a tuple, or None."""
    return None if ints is None else tuple(ints)


def pairs(ints: Optional[Sequence[int]], keys: Sequence[str], width: int = 2):
    """The inverse of :func:`tile_ints` for a dict tile: ``{key: (ints...)}``."""
    if ints is None:
        return None
    return {k: tuple(ints[width * i:width * i + width]) for i, k in enumerate(keys)}


def empty_like_shape(t: torch.Tensor, shape, dtype=None) -> torch.Tensor:
    """A contiguous empty tensor of ``shape`` on ``t``'s device (a fake
    implementation's output)."""
    return t.new_empty(tuple(shape), dtype=t.dtype if dtype is None else dtype)


def load_ops() -> None:
    """Import every module that defines ops, so that ``torch.ops.podt`` holds
    all of them (``utils/export.load_exported`` calls it before
    ``torch.export.load``)."""
    import importlib

    for mod in OP_MODULES:
        importlib.import_module(f"pytorch_object_detection_tpu_torch.ops.{mod}")
