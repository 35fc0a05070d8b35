"""Shared set-up for the PyTorch port's CPU tests (tests/test_torch_port_*.py).

One small JAX detector (HISFCOS, MNFCOS, FCOS, MC_FCOS or RETINANET: 20 classes, 64 features, 128x128
canvas; or SSD300 at its 300x300) gets a variable tree whose BN statistics and affines, GN affines,
ScaleExp scales and L2Norm scale sit away from their init values, so that a graft that drops or
misplaces one of them shows in the outputs.  Inputs come from numpy seeds
and reach both frameworks as numpy arrays.

JAX is imported inside the functions that need it, so the kernel tests
(tests/test_torch_port_kernels.py), which run on a machine without JAX,
can import the NMS cases from here.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

NUM_CLASSES = 20
FEATURES = 64
BATCH = 2
CANVAS = 128
STRIDES = (8, 16, 32, 64, 128)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_TREE = os.path.join(REPO, "tests", "fixtures", "port_eval", "voc")  # the committed eight-image tree


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for a test module (import it into the
    module: it is autouse).  Under pytest-xdist every worker would
    otherwise start a thread a core, and the ops then wait on each other's
    spinning threads: with six workers on eight cores a 3 s train-step case
    took 546 s, a 28 s pipeline case 455 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_model(name: str = "HISFCOS", num_classes: int = NUM_CLASSES, **kw):
    """The small JAX detector ``name`` (HISFCOS, MNFCOS, FCOS, MC_FCOS or
    RETINANET; SSD300 has no width), 20 classes unless ``num_classes`` says
    otherwise (SSD300: that many and the background), 64 features; ``kw`` to
    its constructor."""
    if name in ("RETINANET", "SSD300"):
        from pytorch_object_detection_tpu.models.registry import build_model

        return build_model(name, num_classes, FEATURES, **kw)
    from pytorch_object_detection_tpu.models import fcos, mcfcos

    return getattr(mcfcos if name == "MC_FCOS" else fcos, name)(num_classes=num_classes, features=FEATURES, **kw)


def perturbed_variables(seed: int = 0, model: str = "HISFCOS", num_classes: int = NUM_CLASSES, **model_kw):
    """(params, batch_stats) for the small JAX detector ``model`` (``model_kw``
    to its constructor, e.g. ``backbone="efficientnet-b0"``) as nested numpy
    dicts; :func:`perturbed_module_variables` draws the values."""
    canvas = 300 if model == "SSD300" else CANVAS
    return perturbed_module_variables(jax_model(model, num_classes, **model_kw), (1, canvas, canvas, 3), seed)


def perturbed_module_variables(module, input_shape, seed: int = 0, *call_args):
    """(params, batch_stats) of the flax ``module`` applied to an f32 input of
    ``input_shape`` (and ``call_args``, e.g. ``train=False``) as nested
    numpy dicts.

    The tree's structure comes from ``jax.eval_shape`` of the flax init (no
    compile); its values are numpy draws: He-normal conv kernels, small conv
    biases, the cls prior bias, and BN statistics/affines, GN affines and
    ScaleExp scales spread around their init values.
    """
    import jax
    import jax.numpy as jnp

    args = call_args or (False,)
    shapes = jax.eval_shape(lambda key, x: module.init(key, x, *args),
                            jax.random.PRNGKey(seed), jnp.zeros(input_shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(tree, path=()):
        out = {}
        for key, value in tree.items():
            if not hasattr(value, "shape"):
                out[key] = fill(value, path + (key,))
                continue
            n, parent = value.shape, path[-1]
            if key == "kernel" and path[0] in ("classification", "regression"):
                v = rng.normal(0.0, 0.01, n)  # RetinaNet's subnets: their head init (no norm layer to rescale)
            elif key == "kernel":
                fan_in = int(np.prod(n[:3]))
                v = rng.normal(0.0, np.sqrt(2.0 / fan_in), n)
            elif key == "bias" and ("cls_pred" in path or path[:2] == ("classification", "out")):
                v = -np.log(99.0) + rng.normal(0.0, 0.1, n)
            elif key == "bias" and parent == "conv":
                v = rng.normal(0.0, 0.05, n)
            elif key in ("bias", "mean"):
                v = rng.normal(0.0, 0.1, n)
            elif key == "var":
                v = rng.uniform(0.5, 1.5, n)
            elif key == "scale" and parent in ("bn", "gn"):
                v = rng.uniform(0.7, 1.3, n)
            elif key == "scale" and parent == "l2norm":
                v = 20.0 * rng.uniform(0.8, 1.2, n)
            elif key == "scale":  # ScaleExp
                v = 1.2 * rng.uniform(0.8, 1.2, n)
            else:
                raise KeyError("/".join(path + (key,)))
            out[key] = v.astype(np.float32)
        return out

    return fill(shapes["params"]), fill(shapes.get("batch_stats", {}))


def jax_native():
    """The JAX package's native library module, loaded.  Its build step
    writes the library straight to its path (ROADMAP "tests/test_native.py
    may skip itself"), so a load that found a library another process was
    still writing is tried again."""
    import time

    import pytest

    from pytorch_object_detection_tpu.native import lib

    for _ in range(10):
        if lib.native_available():
            return lib
        lib._tried = False
        time.sleep(1.0)
    pytest.fail("the JAX package's native library did not build")


def assert_close_to_ref(got, want, what: str = "", ref_scale=None) -> None:
    """max |got - want| <= 1e-4 * max|ref| + 1e-5.

    Both sides run the same f32 operations; they differ only in summation
    order (oneDNN vs XLA:CPU convolutions, K up to 4608).  Each sum carries
    a relative rounding error of order 1e-6 of the activations it sums, and
    frozen BN/GN layers rescale but do not amplify it much over the
    network's depth, so 1e-4 of the range leaves two orders of margin while
    a graft or layout error (a wrong transpose, a missed BN statistic)
    shows at 1e-2 or more.  ``max|ref|`` is that of ``want`` unless
    ``ref_scale`` (all levels of one head output) is given: the five levels
    share one head, so their rounding error follows the head's activations,
    not the range of the smallest level's output.
    """
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    scale = float(np.max(np.abs(want))) if ref_scale is None else float(ref_scale)
    tol = 1e-4 * scale + 1e-5
    assert err <= tol, f"{what}: max abs err {err:.3g} > tol {tol:.3g}"


def cosine(a, b) -> float:
    """Cosine of two tensors or arrays, in float64."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def flat_qtree(q, prefix=""):
    """A port qtree's tensors by dotted name."""
    out = {}
    items = enumerate(q) if isinstance(q, (list, tuple)) else q.items()
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flat_qtree(v, name + "."))
        elif isinstance(v, torch.Tensor):
            out[name] = v
    return out


def assert_same_qtree(got, want, int8_flip_share: float = 0.0):
    """The same leaves; int8 weights identical (or, with ``int8_flip_share``,
    at most one step apart on at most that share of a tensor's elements),
    every scale and shift within rtol 1e-5 plus 1e-6 of its vector's range
    (a BN shift near 0 keeps only the absolute precision of its terms, and
    JAX's jitted quantize computes it as one fused multiply-add)."""
    got, want = flat_qtree(got), flat_qtree(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == torch.int8:
            d = (g.int() - w.int()).abs()
            if int((d > 0).sum()):
                print(f"{name}: {int((d > 0).sum())} of {d.numel()} int8 weights differ, max {int(d.max())} step")
            assert int(d.max()) <= (1 if int8_flip_share else 0) and float((d > 0).float().mean()) <= int8_flip_share
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()), msg=lambda m: f"{name}: {m}")


def assert_taps(got, want, rtol=1e-5):
    """Calibration taps (abs-maxes) within ``rtol`` of JAX's; the worst printed."""
    assert sorted(got) == sorted(want)
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    worst = max(rel, key=rel.get)
    print(f"worst tap {worst}: relative difference {rel[worst]:.3g} ({len(want)} taps)")
    assert rel[worst] <= rtol, worst


def branch_scales(outputs):
    """max|x| over all levels of each of (cls, cnt, reg)."""
    return [max(float(np.max(np.abs(np.asarray(x)))) for x in branch) for branch in outputs]


def nchw(a) -> torch.Tensor:
    """NHWC numpy/JAX array -> NCHW torch tensor."""
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2), order="C"))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def nms_case(name):
    """(boxes [B,K,4] f32, classes [B,K] i32, valid [B,K] bool, iou threshold)
    for the three cases of tests/test_pallas_nms.py:10-82."""
    if name == "random":
        rng = np.random.default_rng(7)
        b, k = 4, 200
        xy = rng.uniform(0, 300, (b, k, 2)).astype(np.float32)
        wh = rng.uniform(10, 80, (b, k, 2)).astype(np.float32)
        return (np.concatenate([xy, xy + wh], -1), rng.integers(1, 6, (b, k)).astype(np.int32),
                rng.uniform(size=(b, k)) > 0.15, 0.6)
    if name == "padding":
        rng = np.random.default_rng(1)
        b, k = 3, 130
        xy = rng.uniform(0, 100, (b, k, 2)).astype(np.float32)
        wh = rng.uniform(5, 30, (b, k, 2)).astype(np.float32)
        return np.concatenate([xy, xy + wh], -1), np.ones((b, k), np.int32), np.ones((b, k), bool), 0.5
    if name != "adversarial":
        raise KeyError(name)
    boxes = np.array([
        [0, 0, 10, 10], [0, 0, 10, 10], [0, 0, 10, 10],  # duplicates: 0 kept, 1-2 suppressed
        [5, 5, 5, 5], [5, 5, 5, 5],  # zero area: IoU 0 (0/0 -> 0), both kept
        [20, 0, 24, 3],  # kept
        [20, 0, 22, 3],  # IoU vs 5 = 0.5 == thr exactly: kept (strict >)
        [20, 0, 23, 3],  # IoU vs 5 = 0.75: suppressed
        [50, 50, 60, 60],  # invalid
    ], np.float32)[None]
    valid = np.ones((1, 9), bool)
    valid[0, 8] = False
    return boxes, np.ones((1, 9), np.int32), valid, 0.5


ADVERSARIAL_KEEP = np.array([[1, 0, 0, 1, 1, 1, 1, 0, 0]], bool)


def resnet50_block_shapes(canvas=(512, 512)):
    """(scope, H, W, Cin, Cw, Cout, stride) of the 16 ResNet-50 bottlenecks
    at ``canvas``: H, W are the block's INPUT size (the stem divides by 4)."""
    h, w = (canvas[0] - 1) // 2 + 1, (canvas[1] - 1) // 2 + 1  # 7x7/2 conv
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # 3x3/2 pool
    shapes, cin = [], 64
    for stage, (blocks, cw) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            shapes.append((f"layer{stage + 1}_{b}", h, w, cin, cw, 4 * cw, stride))
            h, w, cin = (h - 1) // stride + 1, (w - 1) // stride + 1, 4 * cw
    return shapes


def rand_qblock(rng, cin, cw, cout, projection):
    """Random int8 bottleneck in the JAX package's layout (HWIO kernels,
    f32 epilogue vectors), scaled so that each requant lands mostly inside
    +-127: an int8 x int8 sum over K terms has a standard deviation of
    about 670 * sqrt(K) here, so A is drawn around 0.06 / sqrt(K); B shifts
    values by a few steps.  Without a projection the block has
    ``short_mul``."""
    def w(*shape):
        return rng.integers(-16, 16, shape).astype(np.int8)

    def a(n, k):
        return (np.abs(rng.normal(size=n)) * 0.06 / np.sqrt(k) + 1e-4).astype(np.float32)

    def b(n):
        return rng.normal(0.0, 5.0, n).astype(np.float32)

    blk = {"w1": w(1, 1, cin, cw), "A1": a(cw, cin), "B1": b(cw),
           "w2": w(3, 3, cw, cw), "A2": a(cw, 9 * cw), "B2": b(cw),
           "w3": w(1, 1, cw, cout), "A3": a(cout, cw), "B3": b(cout)}
    if projection:
        blk.update(wd=w(1, 1, cin, cout), Ad=a(cout, cin), Bd=b(cout))
    else:
        blk["short_mul"] = np.float32(rng.uniform(0.3, 1.2))
    return blk


def port_block(blk, device="cpu"):
    """A :func:`rand_qblock` dict as the port's tensors: int8 HWIO kernels
    to ``[O, I]`` / ``[O, 3, 3, I]`` (the layout of ``ops/qblock.py``)."""
    out = {}
    for key, arr in blk.items():
        arr = np.asarray(arr)
        if arr.dtype == np.int8:
            arr = arr.transpose(3, 0, 1, 2)
            arr = arr.reshape(arr.shape[0], -1) if arr.shape[1] == 1 else arr
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def run_port_block(blk, x, stride, **kw):
    """``ops/qblock.qbottleneck`` / ``qbottleneck_s2`` on a :func:`port_block`."""
    from pytorch_object_detection_tpu_torch.ops.qblock import qbottleneck, qbottleneck_s2

    vecs = [blk[k] for k in ("A1", "B1", "A2", "B2", "A3", "B3")]
    common = (x, blk["w1"], blk["w2"], blk["w3"])
    if stride == 2:
        return qbottleneck_s2(*common, blk["wd"], *vecs, blk["Ad"], blk["Bd"], **kw)
    if "wd" in blk:
        return qbottleneck(*common, *vecs, wd=blk["wd"], ad=blk["Ad"], bd=blk["Bd"], **kw)
    return qbottleneck(*common, *vecs, short_mul=blk["short_mul"], **kw)


def port_stem_s2d(seed: int = 0):
    """A uint8 stem entry (``stem_s2d``) of a random ResNet-50, made by the
    port alone (``nn/resnet_int8.quantize_stem_s2d``), its scale calibrated
    on two random 64x64 frames."""
    from pytorch_object_detection_tpu_torch.eval.evaluator import IMAGENET_MEAN, IMAGENET_STD
    from pytorch_object_detection_tpu_torch.nn.resnet import ResNet50
    from pytorch_object_detection_tpu_torch.nn.resnet_int8 import calibrate_resnet50, quantize_stem_s2d

    g = torch.Generator().manual_seed(seed)
    backbone = ResNet50(generator=g).eval()
    frames = torch.randint(0, 256, (2, 64, 64, 3), generator=g).float()
    norm = (frames / 255.0 - torch.tensor(IMAGENET_MEAN)) / torch.tensor(IMAGENET_STD)
    absmax = calibrate_resnet50(backbone, norm, torch.float32)["stem_out"]
    return quantize_stem_s2d(backbone, IMAGENET_MEAN, IMAGENET_STD, absmax)


def port_head_qtree(features: int, num_classes: int, sizes, batch: int = 2, seed: int = 0):
    """An int8 HISHead qtree of a random HISHead made by the port alone
    (``models/head_int8``), calibrated on random levels of ``sizes`` ((H, W)
    per level), and those levels quantized: ``(qtree, levels_q)``."""
    from pytorch_object_detection_tpu_torch.models.head_int8 import calibrate_hishead, quantize_hishead
    from pytorch_object_detection_tpu_torch.models.heads import HISHead

    g = torch.Generator().manual_seed(seed)
    head = HISHead(num_classes, features, generator=g).eval()
    levels = [torch.randn(batch, h, w, features, generator=g) for h, w in sizes]
    scales = [lv.abs().max() / 127.0 for lv in levels]
    levels_q = [torch.clamp(torch.round(lv / s), -127, 127).to(torch.int8) for lv, s in zip(levels, scales)]
    return quantize_hishead(head, calibrate_hishead(head, levels), scales, num_classes), levels_q


def jax_head_form(q):
    """A port HISHead qtree as the JAX ``quantize_hishead`` tree of numpy
    arrays (HWIO kernels, the depthwise ``[3, 3, 1, 2C]``): the inverse of
    ``train/checkpoints.load_head_qtree``."""
    def arr(t):
        return t.detach().cpu().numpy()

    def hwio(t):
        a = arr(t)
        return a.T.reshape(1, 1, a.shape[1], a.shape[0]) if a.ndim == 2 else a.transpose(1, 2, 3, 0)

    out = {k: hwio(q[k]) for k in ("w1", "w2", "wc", "wr", "wpc", "wcr")}
    out["wdw"] = arr(q["wdw"])[:, :, None, :]
    out.update({k: arr(q[k]) for k in ("b2", "bpc", "bcr", "scale_exp")})
    out.update({k: tuple(arr(t) for t in q[k]) for k in ("gn1", "gn2", "gnc", "gnr")})
    out["num_classes"] = q["num_classes"]
    out["levels"] = [{k: arr(v) for k, v in lv.items()} for lv in q["levels"]]
    return out


def jax_fpn_form(q):
    """A port HisFPN qtree as the JAX ``quantize_hisfpn`` tree of numpy
    arrays (HWIO kernels, the depthwise ``[3, 3, 1, half]``): the inverse of
    ``train/checkpoints.load_fpn_qtree``."""
    out = {}
    for scope, blk in q.items():
        out[scope] = {}
        for k, t in blk.items():
            a = t.detach().cpu().numpy()
            if k == "wdw":
                a = a[:, :, None, :]
            elif a.dtype == np.int8:
                a = a.T.reshape(1, 1, a.shape[1], a.shape[0]) if a.ndim == 2 else a.transpose(1, 2, 3, 0)
            out[scope][k] = a
    return out


def port_hisfpn_qtree(features: int, seed: int = 0):
    """An int8 HisFPN qtree of a random HisFPN of ``features`` channels,
    made by the port alone (``nn/fpn_int8``), calibrated on random C3..C5
    at 16x16, 8x8 and 4x4."""
    from pytorch_object_detection_tpu_torch.nn.fpn import HisFPN
    from pytorch_object_detection_tpu_torch.nn.fpn_int8 import calibrate_hisfpn, quantize_hisfpn

    g = torch.Generator().manual_seed(seed)
    fpn = HisFPN((512, 1024, 2048), features, generator=g).eval()
    feats = [torch.randn(2, s, s, c, generator=g).abs() for s, c in ((16, 512), (8, 1024), (4, 2048))]
    scales = [f.abs().max() / 127.0 for f in feats]
    return quantize_hisfpn(fpn, calibrate_hisfpn(fpn, feats), scales)


def tiny_voc_config(tmp_path, model: str, strides, ranges) -> str:
    """A main config under ``tmp_path`` for ``model`` (64 features, 128x128,
    B=2, SGD) over the committed VOC tree's test split; returns its path."""
    data = tmp_path / f"{model}_data.yaml"
    data.write_text(f"dataset_setting:\n  class_num : 20\n  train_07 : '{VOC_TREE}'\n  test_07 : '{VOC_TREE}'\n"
                    f"  type : 'test'\n  input : [128, 128]\n  num_workers : 2\n  max_boxes : 16\n"
                    f"{model}:\n  channel: {FEATURES}\n  Epoch: 1\n  batch_size: 2\n"
                    f"  optimizer: {{name : SGD, lr : 0.01}}\n  schedule: {{warmup_steps : 10}}\n"
                    f"  criterion : giou\n  stride : {list(strides)}\n  range : {[list(r) for r in ranges]}\n")
    main = tmp_path / f"{model}.yaml"
    main.write_text(f"dataset : VOC\nmodel : {model}\nVOC : {data}\nsavename : {model.lower()}\n")
    return str(main)


def run_cli(tmp_path, module: str, *args):
    """``python -m pytorch_object_detection_tpu_torch.cli.<module> *args`` in ``tmp_path``."""
    cmd = [sys.executable, "-m", f"pytorch_object_detection_tpu_torch.cli.{module}", *args]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # one torch thread, as in-process
    return subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def check_family_clis(tmp_path, model: str, strides, ranges, eval_flags) -> None:
    """``podt-torch-train --synthetic`` for two steps, then ``eval_voc`` of its
    checkpoint over the committed VOC tree (eight images)."""
    cfg = tiny_voc_config(tmp_path, model, strides, ranges)
    run = run_cli(tmp_path, "train", "--config", cfg, "--device", "cpu", "--synthetic", "--steps", "2",
                  "--log-every", "1000")  # no TensorBoard writer: it would import TensorFlow
    assert run.returncode == 0, run.stdout + run.stderr
    assert f"training {model} on cpu" in run.stdout and "training done: step 2" in run.stdout
    ckpt = str(tmp_path / "checkpoint" / model.lower())
    run = run_cli(tmp_path, "eval_voc", "--config", cfg, "--split", "test", "--batch-size", "4", "--device", "cpu",
                  "--checkpoint", ckpt, *eval_flags)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    assert lines[-1].startswith("mAP=====>") and "img/s" in lines[-1], run.stdout[-2000:]
    assert sum(line.startswith("ap for ") for line in lines) == 20
