"""Load a flax variable tree from the JAX package into the port's modules.

The inverse direction of the JAX package's
``train/checkpoints.torchvision_resnet50_to_pytree``.  The tree comes in as
nested dicts of numpy arrays (``params`` and ``batch_stats``), so nothing
here imports JAX.  The mapping:

  * the JAX wrappers' inner scopes (``conv``, ``dw``, ``bn``, ``gn``) are
    dropped: ``head/stem_dw/dw/conv/kernel`` -> ``head.stem_dw.weight``;
  * conv kernels HWIO -> OIHW (a depthwise ``[3,3,1,C]`` becomes
    ``[C,1,3,3]`` by the same transpose);
  * BN ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``;
    GN ``scale/bias`` -> ``weight/bias``; ``ScaleExp`` ``scale[1]`` stays.

A missing key, an unused key or a shape that does not match raises.

``load_backbone_qtree`` carries the JAX package's int8 backbone qtree
(``nn/resnet_int8.quantize_resnet50``) across in the same way.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_INNER_SCOPES = {"conv", "dw", "bn", "gn"}
_NORM_SCOPES = {"bn", "gn"}
_LEAF_NAMES = {"kernel": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], path: Tuple[Any, ...] = ()) -> Iterator[Tuple[Tuple[Any, ...], Any]]:
    """(path, leaf) of nested dicts; tuples and lists count as nodes keyed
    by position (the qtree's ``stem/bn`` pair)."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for key, value in items:
        if isinstance(value, (Mapping, tuple, list)):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def flax_to_torch_name(path: Tuple[str, ...]) -> str:
    """``('head', 'stem_gn1', 'gn', 'scale')`` -> ``'head.stem_gn1.weight'``."""
    *scopes, leaf = path
    if leaf == "scale":
        name = "weight" if scopes and scopes[-1] in _NORM_SCOPES else "scale"
    elif leaf in _LEAF_NAMES:
        name = _LEAF_NAMES[leaf]
    else:
        raise KeyError(f"unknown flax leaf {'/'.join(path)}")
    return ".".join([s for s in scopes if s not in _INNER_SCOPES] + [name])


def flax_to_state_dict(params: Mapping[str, Any],
                       batch_stats: Optional[Mapping[str, Any]] = None) -> Dict[str, np.ndarray]:
    """Flatten a flax ``params`` (+ ``batch_stats``) tree to torch names and layouts."""
    out: Dict[str, np.ndarray] = {}
    for tree in (params, batch_stats or {}):
        for path, value in _leaves(tree):
            name = flax_to_torch_name(path)
            if name in out:
                raise KeyError(f"two flax leaves map to {name!r} (second: {'/'.join(path)})")
            arr = np.asarray(value)
            if path[-1] == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"{'/'.join(path)}: expected a 4-D HWIO kernel, got {arr.shape}")
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            out[name] = arr
    return out


def load_flax_variables(model: nn.Module, params: Mapping[str, Any],
                        batch_stats: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """Fill ``model``'s parameters and buffers from a flax variable tree.

    Values are copied into the existing tensors, so they keep the model's
    device and dtype.  Raises ``KeyError`` on a missing or unused key and
    ``ValueError`` on a shape mismatch, before anything is written.
    """
    src = flax_to_state_dict(params, batch_stats)
    dst = model.state_dict(keep_vars=True)
    missing = sorted(set(dst) - set(src))
    unused = sorted(set(src) - set(dst))
    if missing or unused:
        raise KeyError(f"flax tree does not match the model: missing {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''} ({len(missing)}), "
                       f"unused {unused[:8]}{'...' if len(unused) > 8 else ''} ({len(unused)})")
    for name, arr in src.items():
        if tuple(dst[name].shape) != arr.shape:
            raise ValueError(f"{name}: model has shape {tuple(dst[name].shape)}, flax tree {arr.shape}")
    with torch.no_grad():
        for name, arr in src.items():
            dst[name].copy_(torch.tensor(arr))
    return model


def _backbone_qtree_shapes() -> Dict[Tuple[Any, ...], Tuple[int, ...]]:
    """Leaf path -> shape of the JAX ResNet-50 qtree (HWIO int8 kernels)."""
    from pytorch_object_detection_tpu_torch.nn.resnet_int8 import block_scopes

    shapes = {("stem", "kernel"): (7, 7, 3, 64), ("stem_scale",): ()}
    for i, names in enumerate((("scale", "bias"), ("mean", "var"))):
        shapes.update({("stem", "bn", i, "bn", n): (64,) for n in names})
    cin = 64
    for scope, stage, b in block_scopes():
        cw = (64, 128, 256, 512)[stage]
        cout = 4 * cw
        blk = {"w1": (1, 1, cin, cw), "w2": (3, 3, cw, cw), "w3": (1, 1, cw, cout), "out_scale": ()}
        blk.update({k: (cw,) for k in ("A1", "B1", "A2", "B2")})
        blk.update({k: (cout,) for k in ("A3", "B3")})
        if b == 0:
            blk.update(wd=(1, 1, cin, cout), Ad=(cout,), Bd=(cout,))
        else:
            blk["short_mul"] = ()
        shapes.update({(scope, k): v for k, v in blk.items()})
        cin = cout
    return shapes


def load_backbone_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cpu") -> Dict:
    """The JAX ``quantize_resnet50`` qtree, as numpy, in the port's form.

    int8 HWIO kernels become the kernel layout of ``ops/qblock.py``
    (``w1/w3/wd [O, I]``, ``w2 [O, 3, 3, I]``); epilogue vectors and scales
    become f32 tensors; the float stem kernel becomes OIHW and its BN pair
    a dict of ``scale/bias/mean/var``.  The ``stem_s2d`` entry (the u8
    space-to-depth stem, not ported) is dropped.  Raises ``KeyError`` on a
    missing or unused key and ``ValueError`` on a shape or dtype that does
    not match, before anything is converted.
    """
    src = {path: np.asarray(v) for path, v in _leaves(qtree_np) if path[0] != "stem_s2d"}
    want = _backbone_qtree_shapes()
    missing, unused = sorted(map(str, set(want) - set(src))), sorted(map(str, set(src) - set(want)))
    if missing or unused:
        raise KeyError(f"qtree does not match the ResNet-50 ladder: missing {missing[:8]} ({len(missing)}), "
                       f"unused {unused[:8]} ({len(unused)})")
    for path, shape in want.items():
        int8 = path[-1] in ("w1", "w2", "w3", "wd")
        if src[path].shape != shape or (src[path].dtype == np.int8) != int8:
            raise ValueError(f"{'/'.join(map(str, path))}: expected {'int8' if int8 else 'float'} {shape}, "
                             f"got {src[path].dtype} {src[path].shape}")

    def tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)  # a copy, 0-d kept

    out: Dict[str, Any] = {
        "stem": {"kernel": tensor(src[("stem", "kernel")].transpose(3, 2, 0, 1), torch.float32),
                 "bn": {n: tensor(src[("stem", "bn", i, "bn", n)], torch.float32)
                        for i, names in enumerate((("scale", "bias"), ("mean", "var"))) for n in names}},
        "stem_scale": tensor(src[("stem_scale",)], torch.float32),
    }
    for (scope, *rest), arr in src.items():
        if not scope.startswith("layer"):
            continue
        key = rest[0]
        if arr.dtype == np.int8:  # HWIO -> O, H, W, I; a 1x1 as [O, I]
            w = arr.transpose(3, 0, 1, 2)
            out.setdefault(scope, {})[key] = tensor(w.reshape(w.shape[0], -1) if w.shape[1] == 1 else w,
                                                    torch.int8)
        else:
            out.setdefault(scope, {})[key] = tensor(arr, torch.float32)
    return out
