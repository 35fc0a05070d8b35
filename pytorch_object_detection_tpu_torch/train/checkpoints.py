"""Checkpoints of the port's training, and weights from elsewhere.

The port's own checkpoints (the JAX ``save_checkpoint`` /
``restore_checkpoint`` semantics, in ``torch.save`` files): the full train
state, weights and buffers, optimizer state and step, one file
``step_XXXXXXXX.pt`` a save, written to a temporary file and
``os.replace``d, the last ``keep`` kept; the restore loads into a
template :class:`~pytorch_object_detection_tpu_torch.train.trainer.TrainState`;
:func:`load_model_checkpoint` takes a model's weights from one (the eval
CLIs' ``--checkpoint``).

Reference ``.pth`` files: :func:`load_torch_state_dict` (``module.``
stripped, ``torch.load(weights_only=True)``) and
:func:`load_pretrained_backbone` (torchvision ResNet-50 names onto the
backbone's: ``layer1.0.conv1.weight`` -> ``backbone.layer1_0.conv1.weight``,
``downsample.0``/``.1`` -> ``downsample_conv``/``downsample_bn``, the BN
statistics into the buffers).

A flax variable tree from the JAX package, loaded into the port's modules.

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

``load_backbone_qtree``, ``load_fpn_qtree``, ``load_head_qtree``,
``load_lwfpn_qtree`` and ``load_mnhead_qtree`` carry the JAX package's int8
backbone, HisFPN, HISHead, LightweightFPN and MNHead qtrees
(``nn/resnet_int8.quantize_resnet50``, ``nn/fpn_int8.quantize_hisfpn``,
``models/head_int8.quantize_hishead``, ``models/mnfcos_int8.quantize_lwfpn``
and ``quantize_mnhead``) across in the same way, to the card unless
``device`` says otherwise.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_CKPT_RE = re.compile(r"^step_(\d{8})\.pt$")


def _checkpoints(directory: str):
    """The ``step_XXXXXXXX.pt`` files under ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(f for f in os.listdir(directory) if _CKPT_RE.match(f))


def _newest(directory_or_path: str) -> str:
    """The file named, or the newest checkpoint under a directory."""
    if not os.path.isdir(directory_or_path):
        return directory_or_path
    found = _checkpoints(directory_or_path)
    if not found:
        raise FileNotFoundError(f"no checkpoints under {directory_or_path}")
    return os.path.join(directory_or_path, found[-1])


def save_checkpoint(directory: str, state, step: Optional[int] = None, keep: int = 5) -> str:
    """Save ``state`` (a ``TrainState``) as ``directory/step_XXXXXXXX.pt``
    (the state's step unless ``step`` is given): written to a temporary
    file in ``directory`` and renamed over the target, so a reader never
    sees half a file.  Then all but the newest ``keep`` checkpoints are
    removed.  Returns the path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    step = state.step if step is None else int(step)
    path = os.path.join(directory, f"step_{step:08d}.pt")
    fd, tmp = tempfile.mkstemp(prefix=".step_", suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(state.state_dict(), f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    for old in _checkpoints(directory)[:-keep]:
        os.remove(os.path.join(directory, old))
    return path


def restore_checkpoint(directory_or_path: str, state):
    """Load the newest checkpoint under a directory, or the file named,
    into the template ``state`` (weights, buffers, step; the optimizer's
    state only where it was saved over the same trainable parameters: a
    checkpoint saved with other freeze masks keeps the template's fresh
    optimizer).  Tensors go to the model's device.  Returns ``state``."""
    path = _newest(directory_or_path)
    device = next(state.model.parameters()).device
    state.load_state_dict(torch.load(path, map_location=device, weights_only=True))
    return state


def load_model_checkpoint(model, path: str):
    """Load ``model``'s weights and buffers from a training checkpoint (a
    ``step_XXXXXXXX.pt`` file, or the newest under a directory: its
    ``model`` entry) or from a file holding a plain state dict
    (``torch.save(model.state_dict())``), onto the model's device.  Returns
    ``model``."""
    sd = torch.load(_newest(path), map_location=next(model.parameters()).device, weights_only=True)
    model.load_state_dict(sd["model"] if "model" in sd and "step" in sd else sd)
    return model


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict (or a dict holding one under ``state_dict``) on
    the CPU, DDP's ``module.`` prefix stripped; ``weights_only=True``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def _torchvision_names(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, str]:
    """``port name -> torchvision name`` for the backbone of a detector,
    over the keys of a torchvision ResNet-50 state dict (``prefix`` selects
    a nested one, e.g. ``"backbone."``); ``fc`` and ``num_batches_tracked``
    are not mapped."""
    out = {}
    for key in sd:
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        m = re.match(r"^(conv1|bn1)\.(weight|bias|running_mean|running_var)$", name)
        if m:
            out[f"backbone.{name}"] = key
            continue
        m = re.match(r"^layer(\d)\.(\d+)\.(conv\d|bn\d|downsample\.[01])\.(weight|bias|running_mean|running_var)$",
                     name)
        if m:
            stage, block, mod, leaf = m.groups()
            mod = {"downsample.0": "downsample_conv", "downsample.1": "downsample_bn"}.get(mod, mod)
            out[f"backbone.layer{stage}_{block}.{mod}.{leaf}"] = key
    return out


def load_pretrained_backbone(state_or_model, pth_path: str, prefix: str = ""):
    """Graft torchvision ResNet-50 weights (a ``.pth`` file) into the
    backbone of a ``TrainState``'s model, or of a model: convs, BN affines
    and statistics, in place on the model's device.  A model with the s2d
    stem gets ``conv1`` rewritten as its 4x4 kernel.  Raises ``KeyError``
    where a backbone tensor has no source, ``ValueError`` on a shape that
    does not match.  Returns its argument."""
    from pytorch_object_detection_tpu_torch.nn.resnet import s2d_stem_kernel

    model = getattr(state_or_model, "model", state_or_model)
    sd = load_torch_state_dict(pth_path)
    names = _torchvision_names(sd, prefix)
    dst = {k: v for k, v in model.state_dict(keep_vars=True).items() if k.startswith("backbone.")}
    if "backbone.conv1_s2d.weight" in dst and "backbone.conv1.weight" in names:
        k7 = sd[names.pop("backbone.conv1.weight")].permute(2, 3, 1, 0)  # OIHW -> HWIO
        sd = dict(sd, _conv1_s2d=s2d_stem_kernel(k7).permute(3, 2, 0, 1))
        names["backbone.conv1_s2d.weight"] = "_conv1_s2d"
    missing = sorted(set(dst) - set(names))
    if missing:
        raise KeyError(f"the state dict has no source for {missing[:8]} ({len(missing)})")
    for name, key in names.items():
        if tuple(dst[name].shape) != tuple(sd[key].shape):
            raise ValueError(f"{name}: model has shape {tuple(dst[name].shape)}, {key} {tuple(sd[key].shape)}")
    with torch.no_grad():
        for name, key in names.items():
            dst[name].copy_(sd[key])
    return state_or_model


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


# the uint8 stem's entry (JAX quantize_stem_s2d): leaf -> shape; the int8 leaves
_STEM_S2D = {"w": (256, 64), "w7": (7, 7, 4, 64), "A": (64,), "B": (64,), "pad": (16,), "pad4": (4,), "scale": ()}
_STEM_S2D_INT8 = {"w", "w7", "pad", "pad4"}


def _backbone_qtree_shapes(with_stem_s2d: bool) -> Dict[Tuple[Any, ...], Tuple[int, ...]]:
    """Leaf path -> shape of the JAX ResNet-50 qtree (HWIO int8 kernels)."""
    from pytorch_object_detection_tpu_torch.nn.resnet_int8 import block_scopes

    shapes = {("stem", "kernel"): (7, 7, 3, 64), ("stem_scale",): ()}
    for i, names in enumerate((("scale", "bias"), ("mean", "var"))):
        shapes.update({("stem", "bn", i, "bn", n): (64,) for n in names})
    if with_stem_s2d:
        shapes.update({("stem_s2d", k): v for k, v in _STEM_S2D.items()})
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


def _check_tree(src: Dict, want: Dict, is_int8, what: str) -> None:
    """Raise on a missing or unused leaf, or a shape or dtype that does not match."""
    missing, unused = sorted(map(str, set(want) - set(src))), sorted(map(str, set(src) - set(want)))
    if missing or unused:
        raise KeyError(f"qtree does not match {what}: missing {missing[:8]} ({len(missing)}), "
                       f"unused {unused[:8]} ({len(unused)})")
    for path, shape in want.items():
        int8 = is_int8(path)
        if src[path].shape != shape or (src[path].dtype == np.int8) != int8:
            raise ValueError(f"{'/'.join(map(str, path))}: expected {'int8' if int8 else 'float'} {shape}, "
                             f"got {src[path].dtype} {src[path].shape}")


def _to_tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)  # a copy, 0-d kept


def _port_kernel(arr: np.ndarray) -> np.ndarray:
    """int8 HWIO -> [O, H, W, I] (each output channel's K-vector contiguous); a 1x1 as [O, I]."""
    w = arr.transpose(3, 0, 1, 2)
    return w.reshape(w.shape[0], -1) if w.shape[1:3] == (1, 1) else w


def load_backbone_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_resnet50`` qtree, as numpy, in the port's form.

    int8 HWIO kernels become the kernel layout of ``ops/qblock.py``
    (``w1/w3/wd [O, I]``, ``w2 [O, 3, 3, I]``); epilogue vectors and scales
    become f32 tensors; the float stem kernel becomes OIHW and its BN pair
    a dict of ``scale/bias/mean/var``.  The uint8 stem's ``stem_s2d`` entry,
    where the tree has one, keeps ``w [256, 64]`` and its border fills,
    adds ``wt``, ``w`` transposed to ``[64, 256]``, and turns ``w7`` from
    HWIO ``[7, 7, 4, 64]`` into ``[64, 7, 7, 4]`` (``ops/qstem.py``).  Raises ``KeyError`` on a missing or unused key and
    ``ValueError`` on a shape or dtype that does not match, before anything
    is converted.
    """
    src = {path: np.asarray(v) for path, v in _leaves(qtree_np)}
    with_s2d = "stem_s2d" in qtree_np
    _check_tree(src, _backbone_qtree_shapes(with_s2d),
                lambda p: p[-1] in ("w1", "w2", "w3", "wd") or (p[0] == "stem_s2d" and p[-1] in _STEM_S2D_INT8),
                "the ResNet-50 ladder")
    tensor = lambda arr, dtype: _to_tensor(arr, dtype, device)
    out: Dict[str, Any] = {
        "stem": {"kernel": tensor(src[("stem", "kernel")].transpose(3, 2, 0, 1), torch.float32),
                 "bn": {n: tensor(src[("stem", "bn", i, "bn", n)], torch.float32)
                        for i, names in enumerate((("scale", "bias"), ("mean", "var"))) for n in names}},
        "stem_scale": tensor(src[("stem_scale",)], torch.float32),
    }
    if with_s2d:
        st = {k: src[("stem_s2d", k)] for k in _STEM_S2D}
        st["w7"] = st["w7"].transpose(3, 0, 1, 2)
        st["wt"] = np.ascontiguousarray(st["w"].T)
        out["stem_s2d"] = {k: tensor(v, torch.int8 if k in _STEM_S2D_INT8 | {"wt"} else torch.float32)
                           for k, v in st.items()}
    for (scope, *rest), arr in src.items():
        if not scope.startswith("layer"):
            continue
        key = rest[0]
        if arr.dtype == np.int8:
            out.setdefault(scope, {})[key] = tensor(_port_kernel(arr), torch.int8)
        else:
            out.setdefault(scope, {})[key] = tensor(arr, torch.float32)
    return out


_HIS_SCALARS = ("inv_x1", "se_premul", "inv_out", "s_out", "s_in")


def _fpn_qtree_shapes(features: int) -> Dict[Tuple[str, str], Tuple[int, ...]]:
    """Leaf path -> shape of the JAX HisFPN qtree for ``features`` channels."""
    f, half, r = features, features // 2, features // 8
    shapes = {}
    for name, cin in (("tf1", 2048), ("tf2", 1024), ("tf3", 512)):
        shapes.update({(name, "w"): (1, 1, cin, f), (name, "A"): (f,), (name, "B"): (f,), (name, "s"): ()})
    blk = {"w1": (1, 1, f, half), "w2": (1, 1, f, half), "wdw": (3, 3, 1, half), "se_w1": (half, r),
           "se_b1": (r,), "se_w2": (r, half), "se_b2": (half,), "w3": (3, 3, f, half), "w4": (3, 3, f, f)}
    blk.update({k: (half,) for k in ("A1", "B1", "A2", "B2", "Adw", "Bdw", "A3", "B3")})
    blk.update({k: (f,) for k in ("A4", "B4")})
    blk.update({k: () for k in _HIS_SCALARS})
    for i in range(1, 8):
        shapes.update({(f"his{i}", k): v for k, v in blk.items()})
    return shapes


def load_fpn_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_hisfpn`` qtree, as numpy, in the port's form
    (``nn/fpn_int8.py``): int8 HWIO kernels become ``[O, I]`` (1x1) and
    ``[O, 3, 3, I]``, the depthwise ``[3, 3, 1, half]`` becomes ``[3, 3,
    half]``; the rest becomes f32 tensors.  The width comes from ``tf1/w``.
    Raises ``KeyError`` on a missing or unused key and ``ValueError`` on a
    shape or dtype that does not match, before anything is converted.
    """
    src = {path: np.asarray(v) for path, v in _leaves(qtree_np)}
    tf1 = src.get(("tf1", "w"))
    if tf1 is None or tf1.ndim != 4:
        raise KeyError("qtree does not match the HisFPN: tf1/w [1, 1, 2048, F] is missing")
    _check_tree(src, _fpn_qtree_shapes(tf1.shape[-1]), lambda p: p[-1] in ("w", "w1", "w2", "wdw", "w3", "w4"),
                "the HisFPN")
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for (scope, key), arr in src.items():
        if key == "wdw":
            arr = arr[:, :, 0]
        elif arr.dtype == np.int8:
            arr = _port_kernel(arr)
        out.setdefault(scope, {})[key] = _to_tensor(arr, torch.int8 if arr.dtype == np.int8 else torch.float32,
                                                    device)
    return out


_HEAD_INT8 = ("w1", "wdw", "w2", "wc", "wr", "wpc", "wcr")
_HEAD_GNS = ("gn1", "gn2", "gnc", "gnr")


def _head_qtree_shapes(c: int, nc: int, n_levels: int) -> Dict[Tuple[Any, ...], Tuple[int, ...]]:
    """Leaf path -> shape of the JAX HISHead qtree (width ``c``, ``nc`` classes)."""
    c2 = 2 * c
    shapes = {("w1",): (1, 1, c, c2), ("wdw",): (3, 3, 1, c2), ("w2",): (1, 1, c2, c), ("wc",): (3, 3, c, c),
              ("wr",): (3, 3, c, c), ("wpc",): (3, 3, c, nc), ("wcr",): (3, 3, c, 5), ("b2",): (c,),
              ("bpc",): (nc,), ("bcr",): (5,), ("scale_exp",): (n_levels,)}
    for name, n in zip(_HEAD_GNS, (c2, c2, c, c)):
        shapes.update({(name, 0): (n,), (name, 1): (n,)})
    lv = {"A1": (c2,), "Adw": (c2,), "A2": (c,), "B2": (c,), "Ac": (c,), "Ar": (c,), "Apc": (nc,), "Acr": (5,)}
    lv.update({k: () for k in ("inv_x1", "inv_x2", "res_mul", "inv_c", "inv_r")})
    for i in range(n_levels):
        shapes.update({("levels", i, k): v for k, v in lv.items()})
    return shapes


def load_head_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_hishead`` qtree, as numpy, in the port's form
    (``models/head_int8.py``): int8 HWIO kernels become ``[O, I]`` (1x1) and
    ``[O, 3, 3, I]``, the depthwise ``[3, 3, 1, 2C]`` becomes ``[3, 3, 2C]``;
    the GroupNorm pairs stay (gamma, beta) tuples and ``levels`` a list of
    dicts, of f32 tensors (0-d for the scalars); ``num_classes`` stays an
    int.  The width comes from ``w1``, the class count from
    ``num_classes``.  Raises ``KeyError`` on a missing or unused key and
    ``ValueError`` on a shape or dtype that does not match, before anything
    is converted.
    """
    if "num_classes" not in qtree_np or "w1" not in qtree_np or not isinstance(qtree_np.get("levels"), (list, tuple)):
        raise KeyError("qtree does not match the HISHead: num_classes, w1 or the levels list is missing")
    nc = np.asarray(qtree_np["num_classes"])
    if nc.ndim or nc.dtype.kind not in "iu" or int(nc) < 1:
        raise ValueError(f"num_classes: expected a positive int, got {nc!r}")
    w1 = np.asarray(qtree_np["w1"])
    if w1.ndim != 4:
        raise ValueError(f"w1: expected int8 [1, 1, C, 2C], got {w1.dtype} {w1.shape}")
    src = {path: np.asarray(v) for path, v in _leaves({k: v for k, v in qtree_np.items() if k != "num_classes"})}
    _check_tree(src, _head_qtree_shapes(w1.shape[2], int(nc), len(qtree_np["levels"])),
                lambda p: p[0] in _HEAD_INT8, "the HISHead")
    tensor = lambda arr: _to_tensor(arr, torch.int8 if arr.dtype == np.int8 else torch.float32, device)
    out: Dict[str, Any] = {"num_classes": int(nc), "levels": [{} for _ in qtree_np["levels"]]}
    for path, arr in src.items():
        if path[0] == "levels":
            out["levels"][path[1]][path[2]] = tensor(arr)
        elif path[0] in _HEAD_GNS:
            out.setdefault(path[0], [None, None])[path[1]] = tensor(arr)
        elif path[0] == "wdw":
            out["wdw"] = tensor(arr[:, :, 0])
        else:
            out[path[0]] = tensor(_port_kernel(arr) if arr.dtype == np.int8 else arr)
    out.update({name: tuple(out[name]) for name in _HEAD_GNS})
    return out


_MN_INT8 = ("wdw", "w1", "w2")
_MN_SCALES = ("s_in", "s_a1", "s_a2", "s_out")


def _mnblock_shapes(c: int, cmid: int, kernel: int) -> Dict[str, Tuple[int, ...]]:
    """Leaf -> shape of one JAX MNBlock entry (``_quantize_mnblock``)."""
    shapes = {"wdw": (kernel, kernel, 1, c), "w1": (1, 1, c, cmid), "w2": (1, 1, cmid, c)}
    shapes.update({k: (c,) for k in ("swdw", "bdw", "sw2", "b2")})
    shapes.update({k: (cmid,) for k in ("sw1", "b1")})
    return shapes


def _mn_width(qtree_np: Mapping[str, Any], block: str, what: str) -> Tuple[int, int]:
    """(C, cmid) from ``block/w1`` [1, 1, C, cmid]."""
    blk = qtree_np.get(block)
    w1 = np.asarray(blk["w1"]) if isinstance(blk, Mapping) and "w1" in blk else None
    if w1 is None or w1.ndim != 4:
        raise KeyError(f"qtree does not match {what}: {block}/w1 [1, 1, C, cmid] is missing")
    return w1.shape[2], w1.shape[3]


def _mn_tensor(path: Tuple[Any, ...], arr: np.ndarray, device) -> torch.Tensor:
    """A leaf of an MNFCOS qtree in the port's form: the depthwise ``[k, k,
    1, C]`` becomes ``[k, k, C]``, other int8 HWIO kernels ``[O, I]`` (1x1)
    or ``[O, 3, 3, I]``, the rest f32."""
    if path[-1] == "wdw":
        arr = arr[:, :, 0]
    elif arr.dtype == np.int8:
        arr = _port_kernel(arr)
    return _to_tensor(arr, torch.int8 if arr.dtype == np.int8 else torch.float32, device)


def _mn_tree(src: Dict[Tuple[Any, ...], np.ndarray], device) -> Dict:
    """Nested dicts (lists where the key is an index) of :func:`_mn_tensor` leaves."""
    out: Dict[Any, Any] = {}
    for path, arr in src.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _mn_tensor(path, arr, device)
    if "levels" in out:
        out["levels"] = [out["levels"][i] for i in range(len(out["levels"]))]
    return out


def load_lwfpn_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_lwfpn`` qtree, as numpy, in the port's form
    (``models/mnfcos_int8.py``): the laterals' ``w`` become ``[F, Cin]``, each
    MNBlock's depthwise ``[k, k, 1, F]`` becomes ``[k, k, F]`` and its 1x1
    kernels ``[O, I]``; the rest (``sc``'s scales, ``p5_to_m4``,
    ``p4_to_m3``) becomes f32 tensors, 0-d for the scalars.  The widths come
    from ``mnb5/w1``.  Raises ``KeyError`` on a missing or unused key and
    ``ValueError`` on a shape or dtype that does not match, before anything
    is converted.
    """
    from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import FPN_BLOCKS

    f, cmid = _mn_width(qtree_np, "mnb5", "the LightweightFPN")
    want = {("p5_to_m4",): (), ("p4_to_m3",): ()}
    for name, cin in (("lateral5", 2048), ("lateral4", 1024), ("lateral3", 512)):
        want.update({(name, "w"): (1, 1, cin, f), (name, "A"): (f,), (name, "B"): (f,)})
    for name, kernel, _ in FPN_BLOCKS:
        want.update({(name, k): v for k, v in _mnblock_shapes(f, cmid, kernel).items()})
        want.update({("sc", name, k): () for k in _MN_SCALES})
    src = {path: np.asarray(v) for path, v in _leaves(qtree_np)}
    _check_tree(src, want, lambda p: p[-1] in ("w",) + _MN_INT8, "the LightweightFPN")
    return _mn_tree(src, device)


def load_mnhead_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_mnhead`` qtree, as numpy, in the port's form
    (``models/mnfcos_int8.py``): the blocks as in :func:`load_lwfpn_qtree`,
    the towers ``wc``/``wr`` ``[C, 3, 3, C]``, the predictions ``wpc [nc,
    C]`` and ``wcr [5, C]``; the GroupNorm pairs stay (gamma, beta) tuples
    and ``levels`` a list of dicts (each with its two blocks' scales), of
    f32 tensors (0-d for the scalars); ``num_classes`` stays an int.  The
    widths come from ``block1/w1``, the class count from ``num_classes``.
    Raises ``KeyError`` on a missing or unused key and ``ValueError`` on a
    shape or dtype that does not match, before anything is converted.
    """
    from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import HEAD_BLOCKS

    if "num_classes" not in qtree_np or not isinstance(qtree_np.get("levels"), (list, tuple)):
        raise KeyError("qtree does not match the MNHead: num_classes or the levels list is missing")
    nc = np.asarray(qtree_np["num_classes"])
    if nc.ndim or nc.dtype.kind not in "iu" or int(nc) < 1:
        raise ValueError(f"num_classes: expected a positive int, got {nc!r}")
    nc = int(nc)
    c, cmid = _mn_width(qtree_np, "block1", "the MNHead")
    n_levels = len(qtree_np["levels"])
    want = {("wc",): (3, 3, c, c), ("wr",): (3, 3, c, c), ("wpc",): (1, 1, c, nc), ("wcr",): (1, 1, c, 5),
            ("bpc",): (nc,), ("bcr",): (5,), ("scale_exp",): (n_levels,)}
    for name in ("gnc", "gnr"):
        want.update({(name, 0): (c,), (name, 1): (c,)})
    for name, kernel, _ in HEAD_BLOCKS:
        want.update({(name, k): v for k, v in _mnblock_shapes(c, cmid, kernel).items()})
    lv = {"Ac": (c,), "Ar": (c,), "Apc": (nc,), "Acr": (5,), "inv_c": (), "inv_r": ()}
    for i in range(n_levels):
        want.update({("levels", i, k): v for k, v in lv.items()})
        want.update({("levels", i, name, k): () for name, _, _ in HEAD_BLOCKS for k in _MN_SCALES})
    src = {path: np.asarray(v) for path, v in _leaves({k: v for k, v in qtree_np.items() if k != "num_classes"})}
    _check_tree(src, want, lambda p: p[-1] in ("wc", "wr", "wpc", "wcr") + _MN_INT8, "the MNHead")
    out = _mn_tree(src, device)
    out.update(num_classes=nc, gnc=(out["gnc"][0], out["gnc"][1]), gnr=(out["gnr"][0], out["gnr"][1]))
    return out
