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

  * the JAX wrappers' inner scopes at the end of a path (``conv``, ``bn``,
    ``gn``, and a ``DepthwiseConv``'s ``dw/conv``) are dropped:
    ``head/stem_dw/dw/conv/kernel`` -> ``head.stem_dw.weight``,
    ``mb_top/dw/dw/conv/kernel`` -> ``mb_top.dw.weight`` (an MCBlock's
    depthwise conv is itself named ``dw``);
  * conv kernels HWIO -> OIHW (a depthwise ``[3,3,1,C]`` becomes
    ``[C,1,3,3]`` by the same transpose); a ``DeformableConv``'s (DCNv2)
    offset and modulator convs are bare flax ``nn.Conv``s with no inner
    scope (``dcn/offset_conv/kernel`` -> ``dcn.offset_conv.weight``), and
    its own ``[k*k, C, F]`` ``kernel`` becomes ``weight`` as it is;
  * BN ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``;
    GN ``scale/bias`` -> ``weight/bias``; ``ScaleExp`` ``scale[1]`` stays.

A missing key, an unused key or a shape that does not match raises.

``load_backbone_qtree``, ``load_fpn_qtree``, ``load_head_qtree``,
``load_lwfpn_qtree``, ``load_mnhead_qtree``, ``load_fpn_classic_qtree``,
``load_fcoshead_qtree``, ``load_mcfcos_qtree``, ``load_retinanet_qtree``,
``load_ssd300_qtree`` and ``load_efficientnet_qtree`` carry the JAX
package's int8 backbone, HisFPN, HISHead, LightweightFPN, MNHead, classic
FPN, FCOSHead, MC-FCOS neck/head, RetinaNet, SSD300 and EfficientNet
qtrees (``nn/resnet_int8.quantize_resnet50``,
``nn/fpn_int8.quantize_hisfpn``, ``models/head_int8.quantize_hishead``,
``models/mnfcos_int8.quantize_lwfpn`` and ``quantize_mnhead``,
``models/fcos_int8.quantize_fpn_classic`` and ``quantize_fcoshead``,
``models/mcfcos_int8.quantize_mcfcos_neck_head``,
``models/retinanet_int8.quantize_retinanet``,
``models/ssd_int8.quantize_ssd300``,
``nn/efficientnet_int8.quantize_efficientnet``) across in the same way, to the card
unless ``device`` says otherwise.  The flax trees of RetinaNet and SSD300
need nothing more than the rules above: RetinaFPN's ``p5_1_bn/bn`` scopes
are norm scopes (``scale`` -> ``weight``, the statistics -> the running
buffers), SSD's ``l2norm/scale`` stays ``scale``, and ``ExtraLayer``'s
bare ``conv2`` has no inner scope to drop.  Nor do EfficientNet's
(``stem_conv/conv``, ``stem_bn/bn``, ``block{i}/{expand,project}/conv``,
``block{i}/dw/dw/conv``, ``block{i}/se/fc{1,2}/conv``,
``block{i}/bn{0,1,2}/bn``) and MobileNetV2's (``stem/conv``,
``block{i}/{expand,dw,project}``).
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
    removed.  Returns the path.  A tensor-parallel state
    (``parallel/tp.shard_state_tp``) is gathered whole first, so every rank
    of its mesh calls this; world rank 0 alone writes it, with the names
    and shapes of a one-process checkpoint."""
    directory = os.path.abspath(directory)
    step = state.step if step is None else int(step)
    path = os.path.join(directory, f"step_{step:08d}.pt")
    whole = state.state_dict()
    if getattr(state, "sharded", None) and torch.distributed.is_initialized() and torch.distributed.get_rank():
        return path
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".step_", suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(whole, f)
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
    optimizer).  Tensors go to the model's device; a tensor-parallel state
    takes its slices of them (a one-process checkpoint resumes under tp,
    and a tp checkpoint in one process).  Returns ``state``."""
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


_INNER_SCOPES = {"conv", "bn", "gn"}
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
    if scopes and scopes[-1] in _INNER_SCOPES:
        inner = scopes.pop()
        if inner == "conv" and len(scopes) >= 2 and scopes[-1] == "dw":  # DepthwiseConv's dw/conv
            scopes.pop()
    return ".".join(scopes + [name])


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
            if path[-1] == "kernel" and arr.ndim != 3:  # 3-D: a DeformableConv's own [k*k, C, F], kept as it is
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


def _port_leaf(path: Tuple[Any, ...], arr: np.ndarray) -> np.ndarray:
    """A qtree leaf in the port's form: a depthwise ``[k, k, 1, C]`` (an
    MNBlock's ``wdw``, an MCBlock's ``dw/w``) becomes ``[k, k, C]``, an SE's
    1x1 kernels ``k1``/``k2`` matmul operands ``[Cin, Cout]``, any other int8
    HWIO kernel ``[O, I]`` (1x1) or ``[O, k, k, I]``; the rest stays."""
    if path[-1] == "wdw" or path[-2:] == ("dw", "w"):
        return arr[:, :, 0]
    if path[-1] in ("k1", "k2"):
        return arr[0, 0]
    return _port_kernel(arr) if arr.dtype == np.int8 else arr


def _port_qtree(src: Dict[Tuple[Any, ...], np.ndarray], device) -> Dict:
    """Nested dicts of :func:`_port_leaf` tensors on ``device``; a node whose
    keys are 0..n-1 becomes a list (a tuple for a GroupNorm pair, ``gn*``)."""
    out: Dict[Any, Any] = {}
    for path, arr in src.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        arr = _port_leaf(path, arr)
        node[path[-1]] = _to_tensor(arr, torch.int8 if arr.dtype == np.int8 else torch.float32, device)

    def seq(node, key=""):
        if not isinstance(node, dict):
            return node
        node = {k: seq(v, k) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            items = [node[i] for i in range(len(node))]
            return tuple(items) if str(key).startswith("gn") else items
        return node

    return seq(out)


def _num_classes(qtree_np: Mapping[str, Any], what: str) -> int:
    if "num_classes" not in qtree_np or not isinstance(qtree_np.get("levels"), (list, tuple)):
        raise KeyError(f"qtree does not match {what}: num_classes or the levels list is missing")
    nc = np.asarray(qtree_np["num_classes"])
    if nc.ndim or nc.dtype.kind not in "iu" or int(nc) < 1:
        raise ValueError(f"num_classes: expected a positive int, got {nc!r}")
    return int(nc)


def _width(qtree_np: Mapping[str, Any], scope: str, leaf: str, what: str) -> int:
    """The output width of the int8 HWIO kernel ``scope/leaf`` (``scope`` may be None: a top-level leaf)."""
    node = qtree_np if scope is None else qtree_np.get(scope)
    w = np.asarray(node[leaf]) if isinstance(node, Mapping) and leaf in node else None
    if w is None or w.ndim != 4:
        raise KeyError(f"qtree does not match {what}: {'/'.join(filter(None, (scope, leaf)))} (an HWIO kernel) "
                       f"is missing")
    return w.shape[-1]


def _in_width(qtree_np: Mapping[str, Any], scope: str) -> int:
    """The input width of the HWIO kernel ``scope/w``, or -1 where there is
    none (the shape check then refuses the tree)."""
    node = qtree_np.get(scope)
    w = np.asarray(node["w"]) if isinstance(node, Mapping) and "w" in node else None
    return w.shape[2] if w is not None and w.ndim == 4 else -1


def _load_port_qtree(qtree_np: Mapping[str, Any], want: Dict, is_int8, what: str, device) -> Dict:
    """Check ``qtree_np`` (less ``num_classes``) against ``want`` (path ->
    shape), then convert it by :func:`_port_qtree`."""
    src = {path: np.asarray(v) for path, v in _leaves({k: v for k, v in qtree_np.items() if k != "num_classes"})}
    _check_tree(src, want, is_int8, what)
    return _port_qtree(src, device)


_MN_INT8 = ("wdw", "w1", "w2")
_MN_SCALES = ("s_in", "s_a1", "s_a2", "s_out")


def _mnblock_shapes(c: int, cmid: int, kernel: int) -> Dict[str, Tuple[int, ...]]:
    """Leaf -> shape of one JAX MNBlock entry (``_quantize_mnblock``)."""
    shapes = {"wdw": (kernel, kernel, 1, c), "w1": (1, 1, c, cmid), "w2": (1, 1, cmid, c)}
    shapes.update({k: (c,) for k in ("swdw", "bdw", "sw2", "b2")})
    shapes.update({k: (cmid,) for k in ("sw1", "b1")})
    return shapes


def load_lwfpn_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_lwfpn`` qtree, as numpy, in the port's form
    (``models/mnfcos_int8.py``): the laterals' ``w`` become ``[F, Cin]``, each
    MNBlock's depthwise ``[k, k, 1, F]`` becomes ``[k, k, F]`` and its 1x1
    kernels ``[O, I]``; the rest (``sc``'s scales, ``p5_to_m4``,
    ``p4_to_m3``) becomes f32 tensors, 0-d for the scalars.  The widths come
    from ``lateral5/w`` and ``mnb5/w1``.  Raises ``KeyError`` on a missing or
    unused key and ``ValueError`` on a shape or dtype that does not match,
    before anything is converted.
    """
    from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import FPN_BLOCKS

    what = "the LightweightFPN"
    f, cmid = _width(qtree_np, "lateral5", "w", what), _width(qtree_np, "mnb5", "w1", what)
    want = {("p5_to_m4",): (), ("p4_to_m3",): ()}
    for name, cin in (("lateral5", 2048), ("lateral4", 1024), ("lateral3", 512)):
        want.update({(name, "w"): (1, 1, cin, f), (name, "A"): (f,), (name, "B"): (f,)})
    for name, kernel, _ in FPN_BLOCKS:
        want.update({(name, k): v for k, v in _mnblock_shapes(f, cmid, kernel).items()})
        want.update({("sc", name, k): () for k in _MN_SCALES})
    return _load_port_qtree(qtree_np, want, lambda p: p[-1] in ("w",) + _MN_INT8, what, device)


def load_mnhead_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_mnhead`` qtree, as numpy, in the port's form
    (``models/mnfcos_int8.py``): the blocks as in :func:`load_lwfpn_qtree`,
    the towers ``wc``/``wr`` ``[C, 3, 3, C]``, the predictions ``wpc [nc,
    C]`` and ``wcr [5, C]``; the GroupNorm pairs stay (gamma, beta) tuples
    and ``levels`` a list of dicts (each with its two blocks' scales), of
    f32 tensors (0-d for the scalars); ``num_classes`` stays an int.  The
    widths come from ``wc`` and ``block1/w1``, the class count from
    ``num_classes``.  Raises ``KeyError`` on a missing or unused key and
    ``ValueError`` on a shape or dtype that does not match, before anything
    is converted.
    """
    from pytorch_object_detection_tpu_torch.models.mnfcos_int8 import HEAD_BLOCKS

    nc = _num_classes(qtree_np, "the MNHead")
    c, cmid = _width(qtree_np, None, "wc", "the MNHead"), _width(qtree_np, "block1", "w1", "the MNHead")
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
    out = _load_port_qtree(qtree_np, want, lambda p: p[-1] in ("wc", "wr", "wpc", "wcr") + _MN_INT8, "the MNHead",
                           device)
    out["num_classes"] = nc
    return out


def load_fpn_classic_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_fpn_classic`` qtree, as numpy, in the port's form
    (``models/fcos_int8.py``): the int8 HWIO kernels become ``[F, Cin]``
    (1x1) and ``[F, 3, 3, F]``; the rest f32 tensors, 0-d for the scalars.
    The width comes from ``lateral5/w``, the widths of C3..C5 from the
    laterals' input axis (ResNet-50's 512, 1024, 2048; EfficientNet-B0's
    40, 112, 320).  Raises ``KeyError`` on a missing or unused key and
    ``ValueError`` on a shape or dtype that does not match, before anything
    is converted."""
    from pytorch_object_detection_tpu_torch.models.fcos_int8 import FPN_TAPS

    f = _width(qtree_np, "lateral5", "w", "the classic FPN")
    c3, c4, c5 = (_in_width(qtree_np, f"lateral{i}") for i in (3, 4, 5))
    want = {("t5_to_m4",): (), ("p4_to_m3",): ()}
    want.update({("scales", t): () for t in FPN_TAPS})
    for name, cin, k in (("lateral5", c5, 1), ("lateral4", c4, 1), ("lateral3", c3, 1), ("smooth4", f, 3),
                         ("smooth3", f, 3), ("smooth5", f, 3), ("down6", f, 3), ("down7", f, 3)):
        want.update({(name, "w"): (k, k, cin, f), (name, "A"): (f,), (name, "B"): (f,)})
    return _load_port_qtree(qtree_np, want, lambda p: p[-1] == "w", "the classic FPN", device)


def load_fcoshead_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_fcoshead`` qtree, as numpy, in the port's form
    (``models/fcos_int8.py``): the towers ``wc0..3``/``wr0..3`` become ``[F,
    3, 3, F]``, the predictions ``wpc [nc, 3, 3, F]`` and ``wcr [5, 3, 3,
    F]``; the GroupNorm pairs stay (gamma, beta) tuples and ``levels`` a list
    of dicts, of f32 tensors (0-d for the scalars); ``num_classes`` stays an
    int.  The width comes from ``wc0``, the class count from
    ``num_classes``.  Raises as :func:`load_fpn_classic_qtree`."""
    from pytorch_object_detection_tpu_torch.models.heads import FCOS_TOWER

    nc = _num_classes(qtree_np, "the FCOSHead")
    f = _width(qtree_np, None, "wc0", "the FCOSHead")
    n_levels = len(qtree_np["levels"])
    want = {("wpc",): (3, 3, f, nc), ("wcr",): (3, 3, f, 5), ("bpc",): (nc,), ("bcr",): (5,),
            ("scale_exp",): (n_levels,)}
    lv = {"Apc": (nc,), "Acr": (5,)}
    for j in range(FCOS_TOWER):
        want.update({(f"wc{j}",): (3, 3, f, f), (f"wr{j}",): (3, 3, f, f)})
        want.update({(f"gn{b}{j}", i): (f,) for b in "cr" for i in (0, 1)})
        lv.update({f"Ac{j}": (f,), f"Ar{j}": (f,), f"inv_c{j}": (), f"inv_r{j}": ()})
    for i in range(n_levels):
        want.update({("levels", i, k): v for k, v in lv.items()})
    out = _load_port_qtree(qtree_np, want, lambda p: p[0][0] == "w", "the FCOSHead", device)
    out["num_classes"] = nc
    return out


def _mcblock_qtree_shapes(cin: int, features: int, parts: int) -> Dict[Tuple[Any, ...], Tuple[int, ...]]:
    """Leaf path -> shape of one JAX MCBlock entry (``_quantize_mcblock``) on
    ``cin`` input channels in ``parts`` concat parts."""
    half = cin // 2
    r = half // 6
    shapes = {("s_out",): (), ("pw1", "w"): (1, 1, cin, half), ("pw1", "B"): (half,), ("pw1", "inv"): (),
              ("dw", "w"): (3, 3, 1, half), ("dw", "A"): (half,), ("dw", "B"): (half,), ("dw", "inv"): (),
              ("se", "k1"): (1, 1, half, r), ("se", "b1"): (r,), ("se", "k2"): (1, 1, r, half),
              ("se", "b2"): (half,), ("se", "s_a2"): ()}
    shapes.update({("pw1", "A", i): (half,) for i in range(parts)})
    for name, c_in, c_out in (("pw3", half, half), ("pw4", half, half), ("pw5", 2 * half, features)):
        shapes.update({(name, "w"): (1, 1, c_in, c_out), (name, "A"): (c_out,), (name, "B"): (c_out,),
                       (name, "inv"): ()})
    return shapes


def load_mcfcos_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_mcfcos_neck_head`` qtree (``quantize_mcfcos``'s
    ``neck_head``), as numpy, in the port's form (``models/mcfcos_int8.py``):
    each MCBlock's 1x1 kernels ``[O, I]``, its depthwise ``[3, 3, C/2]``, the
    SE's kernels ``k1 [C/2, r]`` and ``k2 [r, C/2]``, ``pw1``'s per-part
    ``A`` a list; ``h2/w`` and the head's ``wt0..3 [F, 3, 3, F]``, ``wpc
    [nc, 3, 3, F]``, ``wcr [5, 3, 3, F]``; ``levels`` a list of dicts; f32
    tensors, 0-d for the scalars; ``num_classes`` an int.  The width comes
    from ``tf1/w``, the class count from ``num_classes``.  Raises as
    :func:`load_fpn_classic_qtree`."""
    from pytorch_object_detection_tpu_torch.models.mcfcos import MC_TOWER

    nc = _num_classes(qtree_np, "the MC-FCOS neck and head")
    f = _width(qtree_np, "tf1", "w", "the MC-FCOS neck and head")
    want: Dict[Tuple[Any, ...], Tuple[int, ...]] = {}
    for block, cin, parts in (("mb_top", 2048, 1), ("ffm_mb1", f, 1), ("ffm_mb2", f, 1), ("fpn_mb1", f, 1),
                              ("fpn_mb2", f, 1), ("fpn_mb3", f, 1), ("refine_mb1", 2 * f, 2),
                              ("refine_mb2", 2 * f, 2)):
        want.update({(block,) + k: v for k, v in _mcblock_qtree_shapes(cin, f, parts).items()})
    for name, cin in (("ffm_pw1", 1024 + 2048), ("ffm_pw2", 512 + 1024)):
        want.update({(name, "w"): (1, 1, cin, f), (name, "A", 0): (f,), (name, "A", 1): (f,), (name, "B"): (f,),
                     (name, "inv"): ()})
    want.update({("tf1", "w"): (1, 1, 2048, f), ("tf1", "A"): (f,), ("tf1", "B"): (f,), ("tf1", "inv"): (),
                 ("h2", "w"): (3, 3, f, f), ("h2", "A"): (f,), ("h2", "m2"): ()})
    want.update({(name, m): () for name in ("p2in", "p3in", "h1", "h3", "h4") for m in ("m1", "m2")})
    want.update({("wpc",): (3, 3, f, nc), ("wcr",): (3, 3, f, 5)})
    lv = {"Apc": (nc,), "Acr": (5,)}
    for j in range(MC_TOWER):
        want.update({(f"wt{j}",): (3, 3, f, f), (f"bt{j}",): (f,)})
        lv.update({f"A{j}": (f,), f"inv{j}": ()})
    for i in range(len(qtree_np["levels"])):
        want.update({("levels", i, k): v for k, v in lv.items()})
    is_int8 = lambda p: p[-1] == "w" and p[-2] != "se" or p[0] in ("wpc", "wcr") or str(p[0]).startswith("wt")
    out = _load_port_qtree(qtree_np, want, is_int8, "the MC-FCOS neck and head", device)
    out["num_classes"] = nc
    return out


def load_retinanet_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_retinanet`` qtree ``{"backbone", "fpn", "head"}``,
    as numpy, in the port's form (``models/retinanet_int8.py``): the
    backbone by :func:`load_backbone_qtree`; the FPN's and subnets' int8
    HWIO kernels ``[O, I]`` (1x1) and ``[O, 3, 3, I]``, the rest f32 tensors
    (0-d for the scalars), the subnets' ``levels`` a list of dicts.  The
    width comes from ``fpn/p5_1/w``, the prediction widths (anchors times
    classes, anchors times 4) from ``head/wpc`` and ``head/wpr``.  Raises as
    :func:`load_fpn_classic_qtree`."""
    from pytorch_object_detection_tpu_torch.models.retinanet import FPN_BLOCKS, NUM_TOWER
    from pytorch_object_detection_tpu_torch.models.retinanet_int8 import FPN_TAPS

    if sorted(qtree_np) != ["backbone", "fpn", "head"]:
        raise KeyError(f"qtree does not match RetinaNet: keys {sorted(qtree_np)}, want backbone, fpn, head")
    fpn_np, head_np = qtree_np["fpn"], qtree_np["head"]
    f = _width(fpn_np, "p5_1", "w", "the RetinaFPN")
    cin = {"c3": 512, "c4": 1024, "c5": 2048, "f": f}
    want = {("t5_to_m4",): (), ("m4_to_m3",): ()}
    want.update({("scales", t): () for t in FPN_TAPS})
    for name, src, k, _ in FPN_BLOCKS:
        want.update({(name, "w"): (k, k, cin[src], f), (name, "A"): (f,), (name, "B"): (f,)})
    fpn = _load_port_qtree(fpn_np, want, lambda p: p[-1] == "w", "the RetinaFPN", device)

    if not isinstance(head_np.get("levels"), (list, tuple)):
        raise KeyError("qtree does not match the RetinaNet subnets: the levels list is missing")
    nc_a, n4_a = _width(head_np, None, "wpc", "the subnets"), _width(head_np, None, "wpr", "the subnets")
    want = {("wpc",): (3, 3, f, nc_a), ("wpr",): (3, 3, f, n4_a), ("spc",): (nc_a,), ("spr",): (n4_a,),
            ("bpc",): (nc_a,), ("bpr",): (n4_a,)}
    lv = {"Apc": (nc_a,), "Apr": (n4_a,)}
    for j in range(NUM_TOWER):
        for b in "cr":
            want.update({(f"w{b}{j}",): (3, 3, f, f), (f"b{b}{j}",): (f,)})
            lv.update({f"A{b}{j}": (f,), f"B{b}{j}": (f,)})
    for i in range(len(head_np["levels"])):
        want.update({("levels", i, k): v for k, v in lv.items()})
    head = _load_port_qtree(head_np, want, lambda p: p[0][0] == "w", "the RetinaNet subnets", device)
    return {"backbone": load_backbone_qtree(qtree_np["backbone"], device), "fpn": fpn, "head": head}


def load_ssd300_qtree(qtree_np: Mapping[str, Any], device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_ssd300`` qtree, as numpy, in the port's form
    (``models/ssd_int8.py``): every int8 HWIO kernel ``[O, I]`` (1x1) or
    ``[O, k, k, I]``, the rest f32 tensors (0-d for the scalars); the keys
    stay the JAX ones (``conv1_1``, ``extra1.c1``, ``loc0``).  The class
    count comes from ``conf0/w``.  Raises as :func:`load_fpn_classic_qtree`."""
    from pytorch_object_detection_tpu_torch.models.ssd import EXTRAS, LEVEL_CHANNELS, NUM_ANCHORS
    from pytorch_object_detection_tpu_torch.models.ssd_int8 import VGG_CONVS
    from pytorch_object_detection_tpu_torch.nn.vgg import STAGES

    nc = _width(qtree_np, "conf0", "w", "SSD300") // NUM_ANCHORS[0]
    want = {("s_input",): (), ("l2_gamma",): (512,), ("s_f1",): ()}

    def conv(name, k, cin, cout):
        want.update({(name, "w"): (k, k, cin, cout), (name, "A"): (cout,), (name, "B"): (cout,)})

    cin = 3
    widths = [ch for ch, n in STAGES for _ in range(n)] + [1024, 1024]  # conv1_1 .. conv5_3, conv6, conv7
    for (name, *_), cout in zip(VGG_CONVS, widths):
        conv(name, 1 if name == "conv7" else 3, cin, cout)
        cin = cout
    for i, (c_in, mid, out, _, _) in enumerate(EXTRAS):
        conv(f"extra{i + 1}.c1", 1, c_in, mid)
        conv(f"extra{i + 1}.c2", 3, mid, out)
    for i, (ch, na) in enumerate(zip(LEVEL_CHANNELS, NUM_ANCHORS)):
        conv(f"loc{i}", 3, ch, na * 4)
        conv(f"conf{i}", 3, ch, na * nc)
    return _load_port_qtree(qtree_np, want, lambda p: p[-1] == "w", "SSD300", device)


def load_efficientnet_qtree(qtree_np: Mapping[str, Any], width_mult: float = 1.0, depth_mult: float = 1.0,
                            device: torch.device | str = "cuda") -> Dict:
    """The JAX ``quantize_efficientnet`` qtree at ``width_mult`` x
    ``depth_mult``, as numpy, in the port's form
    (``nn/efficientnet_int8.py``): the f32 stem kernel HWIO -> OIHW, its
    ``bn`` pair a (mult, shift) tuple; per block the int8 1x1 ``expand``
    and ``project`` kernels ``[O, I]``, the depthwise ``[k, k, 1, C]`` ->
    ``[k, k, C]``, the SE's raw flax convs as matmul operands ``w1 [C,
    r]``, ``b1``, ``w2 [r, C]``, ``b2``; the rest f32 tensors, 0-d for the
    scalars; ``blocks`` a list.  Raises as :func:`load_fpn_classic_qtree`."""
    from pytorch_object_detection_tpu_torch.nn.efficientnet import block_specs, se_reduction

    specs = block_specs(width_mult, depth_mult)
    stem = specs[0][0]
    want: Dict[Tuple[Any, ...], Tuple[int, ...]] = {("stem", "kernel"): (3, 3, 3, stem), ("stem", "bn", 0): (stem,),
                                                   ("stem", "bn", 1): (stem,), ("stem", "inv"): ()}
    for i, (cin, cout, expand, k, _) in enumerate(specs):
        mid = cin * expand
        r = mid // se_reduction(cin, expand)
        convs = ([("expand", (1, 1, cin, mid))] if expand != 1 else []) + [("dw", (k, k, 1, mid)),
                                                                           ("project", (1, 1, mid, cout))]
        for name, shape in convs:
            want.update({("blocks", i, name, "w"): shape, ("blocks", i, name, "A"): (shape[-1],),
                         ("blocks", i, name, "B"): (shape[-1],), ("blocks", i, name, "inv"): ()})
        for fc, (a, b) in (("fc1", (mid, r)), ("fc2", (r, mid))):
            want.update({("blocks", i, "se", fc, "conv", "kernel"): (1, 1, a, b),
                         ("blocks", i, "se", fc, "conv", "bias"): (b,)})
        want.update({("blocks", i, "res_mul"): (), ("blocks", i, "s_out"): ()})
    src = {path: np.asarray(v) for path, v in _leaves(qtree_np)}
    _check_tree(src, want, lambda p: p[-1] == "w", "the EfficientNet ladder")
    f32 = lambda arr: _to_tensor(arr, torch.float32, device)
    out: Dict[str, Any] = {"stem": {"kernel": f32(src[("stem", "kernel")].transpose(3, 2, 0, 1)),
                                    "bn": (f32(src[("stem", "bn", 0)]), f32(src[("stem", "bn", 1)])),
                                    "inv": f32(src[("stem", "inv")])},
                           "blocks": [{"se": {}} for _ in specs]}
    for path, arr in src.items():
        if path[0] != "blocks":
            continue
        blk, key = out["blocks"][path[1]], path[2]
        if key == "se":
            name = ("w" if path[-1] == "kernel" else "b") + path[3][-1]
            blk["se"][name] = f32(arr[0, 0] if path[-1] == "kernel" else arr)
        elif len(path) == 3:
            blk[key] = f32(arr)
        elif path[-1] == "w":
            w = arr[:, :, 0] if key == "dw" else _port_kernel(arr)
            blk.setdefault(key, {})["w"] = _to_tensor(w, torch.int8, device)
        else:
            blk.setdefault(key, {})[path[-1]] = f32(arr)
    return out
