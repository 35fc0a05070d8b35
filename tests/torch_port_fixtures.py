"""Shared set-up for the PyTorch port's CPU tests (tests/test_torch_port_*.py).

One small JAX HISFCOS or MNFCOS (20 classes, 64 features, 128x128 canvas) gets a
variable tree whose BN statistics and affines, GN affines and ScaleExp
scales sit away from their init values, so that a graft that drops or
misplaces one of them shows in the outputs.  Inputs come from numpy seeds
and reach both frameworks as numpy arrays.

JAX is imported inside the functions that need it, so the kernel tests
(tests/test_torch_port_kernels.py), which run on a machine without JAX,
can import the NMS cases from here.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

NUM_CLASSES = 20
FEATURES = 64
BATCH = 2
CANVAS = 128
STRIDES = (8, 16, 32, 64, 128)


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
    """The small JAX detector ``name`` (HISFCOS or MNFCOS), 20 classes unless
    ``num_classes`` says otherwise, 64 features; ``kw`` to its constructor."""
    from pytorch_object_detection_tpu.models import fcos

    return getattr(fcos, name)(num_classes=num_classes, features=FEATURES, **kw)


def perturbed_variables(seed: int = 0, model: str = "HISFCOS", num_classes: int = NUM_CLASSES):
    """(params, batch_stats) for the small JAX detector ``model`` as nested numpy dicts.

    The tree's structure comes from ``jax.eval_shape`` of the flax init (no
    compile); its values are numpy draws: He-normal conv kernels, small conv
    biases, the cls prior bias, and BN statistics/affines, GN affines and
    ScaleExp scales spread around their init values.
    """
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda key, x: jax_model(model, num_classes).init(key, x, False),
                            jax.random.PRNGKey(seed), jnp.zeros((1, CANVAS, CANVAS, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(tree, path=()):
        out = {}
        for key, value in tree.items():
            if not hasattr(value, "shape"):
                out[key] = fill(value, path + (key,))
                continue
            n, parent = value.shape, path[-1]
            if key == "kernel":
                fan_in = int(np.prod(n[:3]))
                v = rng.normal(0.0, np.sqrt(2.0 / fan_in), n)
            elif key == "bias" and "cls_pred" in path:
                v = -np.log(99.0) + rng.normal(0.0, 0.1, n)
            elif key == "bias" and parent == "conv":
                v = rng.normal(0.0, 0.05, n)
            elif key in ("bias", "mean"):
                v = rng.normal(0.0, 0.1, n)
            elif key == "var":
                v = rng.uniform(0.5, 1.5, n)
            elif key == "scale" and parent in ("bn", "gn"):
                v = rng.uniform(0.7, 1.3, n)
            elif key == "scale":  # ScaleExp
                v = 1.2 * rng.uniform(0.8, 1.2, n)
            else:
                raise KeyError("/".join(path + (key,)))
            out[key] = v.astype(np.float32)
        return out

    return fill(shapes["params"]), fill(shapes["batch_stats"])


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
