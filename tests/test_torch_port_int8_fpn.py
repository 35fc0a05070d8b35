"""The int8 HisFPN serving slice of the port against the JAX package (CPU, f32).

Raw uint8 frames -> the exact uint8 stem (K1) -> the int8 ResNet-50 ->
the int8 HisFPN (K4 laterals, K5 HisBlocks, K6 pools) -> dequant -> the
float HISHead -> decode.  On the CPU every kernel wrapper runs its plain
version, so this holds the plain versions against the JAX XLA oracles:

  (a) ``space_to_depth`` / ``s2d_stem_kernel`` and the uint8 stem's
      quantization;
  (b) the plain K1, K4, K6 (and its seeds) bit-exact, the plain K5 within
      one int8 step (also with the level pool in its glue, ``pool_add``);
  (c) the HisFPN's calibration, quantization and int8 forward;
  (d) the whole slice from uint8 frames;
  (e) the loaders and the entry points' default device (the card).

The JAX qtrees reach the port through ``train/checkpoints``, so both sides
run on the same int8 weights.  Inputs come from numpy seeds.  The JAX
forwards run op by op, not under ``jax.jit``: compiled, XLA fuses the f32
epilogues and contracts a multiply and an add into one fused multiply-add,
which moves an int8 value by a step now and then (0.2-2 % of the C3..C5
values at the 256 canvas, each flip then spreading), so the jitted program
is not its own oracle.  Op by op, the port's int8 stem, ladder and HisFPN
equal the JAX ones bit for bit on these inputs.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu_torch.eval.evaluator import IMAGENET_MEAN, IMAGENET_STD, make_eval_pipeline_int8
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.nn import fpn_int8, resnet_int8
from pytorch_object_detection_tpu_torch.nn.resnet import s2d_stem_kernel, space_to_depth
from pytorch_object_detection_tpu_torch.ops.boxes import pairwise_iou
from pytorch_object_detection_tpu_torch.ops.qconv import qconv1x1, qmatmul
from pytorch_object_detection_tpu_torch.ops.qhis import qhisblock
from pytorch_object_detection_tpu_torch.ops.qpool import qmaxpool2x2, qmaxpool2x2_seeds
from pytorch_object_detection_tpu_torch.ops.qstem import qstem_conv
from pytorch_object_detection_tpu_torch.train.checkpoints import (
    load_backbone_qtree,
    load_flax_variables,
    load_fpn_qtree,
    load_head_qtree,
)
from torch_port_fixtures import (
    BATCH,
    FEATURES,
    NUM_CLASSES,
    STRIDES,
    jax_head_form,
    jax_model,
    perturbed_variables,
    port_head_qtree,
)

CANVAS = 256  # the head's 1x1 stride-128 level at 128 makes its GroupNorm ill-conditioned (test_torch_port_pipeline)
INT8_EPS = 4 * float(np.finfo(np.float32).eps)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tensors(tree):
    """The tensors of a nested dict, in key order."""
    for k in sorted(tree):
        yield from _tensors(tree[k]) if isinstance(tree[k], dict) else (tree[k],)


def _lsb(got, want):
    """(max |diff|, share of elements that differ) of two int8 arrays."""
    d = np.abs(_np(got).astype(np.int32) - _np(want).astype(np.int32))
    return int(d.max()) if d.size else 0, float((d > 0).mean()) if d.size else 0.0


@pytest.fixture(scope="module")
def slice_setup():
    """Both packages' int8 slices of one perturbed HISFCOS: the JAX qtrees
    (backbone with the uint8 stem, HisFPN), the JAX function's levels from
    uint8 frames, and the port's model with the same weights."""
    import jax
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.nn import fpn_int8 as jf
    from pytorch_object_detection_tpu.train import trainer as jt

    params, stats = perturbed_variables(seed=8)
    variables = {"params": params, "batch_stats": stats}
    frames = np.random.default_rng(9).integers(0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)
    norm = ((frames.astype(np.float32) / np.float32(255.0) - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    jq_bb = jt.quantize_backbone(jax_model(), variables, jnp.asarray(norm), compute_dtype=jnp.float32)
    # jt.quantize_fpn, step by step, to keep its features and taps
    feats_q, scales = jax.jit(lambda im: jt._backbone_int8_feats(jax_model(), jq_bb, im))(jnp.asarray(norm))
    feats = [np.asarray(q.astype(jnp.float32) * s) for q, s in zip(feats_q, scales)]
    jtaps = jax.jit(jf.calibrate_hisfpn)(params["fpn"], stats["fpn"], feats)
    jtaps = {k: float(v) for k, v in jtaps.items()}
    jq_fpn = jax.jit(jf.quantize_hisfpn)(params["fpn"], stats["fpn"], jtaps, scales)
    jfwd = jt.make_eval_forward_int8(jax_model(), compute_dtype=jnp.float32, backend="xla", int8_fpn=True,
                                     int8_head=False, u8_input=True)
    jlevels = jfwd({"backbone": jq_bb, "fpn": jq_fpn}, params, stats, jnp.asarray(frames))  # op by op
    jlevels_q, _ = jf.hisfpn_int8_forward(jq_fpn, feats_q, backend="xla", dequant=False)

    model = build_model("HISFCOS", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(params=params, stats=stats, frames=frames, norm=norm, model=model,
                jq_bb=tree(jq_bb), jq_fpn=tree(jq_fpn), jtaps=jtaps, feats=feats,
                feats_q=[np.asarray(q) for q in feats_q], scales=[np.asarray(s) for s in scales],
                jlevels=tuple([np.asarray(t) for t in branch] for branch in jlevels),
                jlevels_q=[np.asarray(q) for q in jlevels_q])


# ---------------------------------------------------------------- (a)

def test_space_to_depth_and_s2d_stem_kernel_exact():
    from pytorch_object_detection_tpu.nn import resnet as jr

    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, 12, 10, 4), dtype=np.uint8)
    np.testing.assert_array_equal(_np(space_to_depth(torch.from_numpy(x), 2)), np.asarray(jr.space_to_depth(x, 2)))
    k = rng.normal(0, 1, (7, 7, 4, 64)).astype(np.float32)
    got = s2d_stem_kernel(torch.from_numpy(k))
    assert got.shape == (4, 4, 16, 64)
    np.testing.assert_array_equal(_np(got), np.asarray(jr.s2d_stem_kernel(k)))


def test_quantize_stem_s2d_matches_jax(slice_setup):
    """From the same stem tap: ``scale`` and the border fills exact, ``A``
    within rtol 1e-6 (the BN fold's rsqrt rounds differently in the two
    packages, as test_torch_port_int8's ``test_quantize_resnet50_matches_jax``
    argues); int8 weights identical but for a bounded count (an ulp of the
    fold moves a weight only within about 1e-7 of a half step; 0 of the
    16,384 + 12,544 differ here).  ``B`` folds the normalize's offset:
    ``128 * sum(w / (255 std))`` and ``sum(w * -mean / std)`` are sums of
    147 products each, about ten times ``B`` and of opposite sign, taken in
    another order by each package, so ``B`` keeps an f32 rounding error of
    those sums: measured 20.7 ulps of max|B| (2.5e-6 of it); bound 1e-5."""
    import jax
    from pytorch_object_detection_tpu.nn import resnet_int8 as jr

    bb = slice_setup["params"]["backbone"], slice_setup["stats"]["backbone"]
    jst = jax.tree_util.tree_map(np.asarray, jr.quantize_stem_s2d(*bb, IMAGENET_MEAN, IMAGENET_STD, 7.25))
    want = load_backbone_qtree(dict(slice_setup["jq_bb"], stem_s2d=jst), "cpu")["stem_s2d"]
    got = resnet_int8.quantize_stem_s2d(slice_setup["model"].backbone, IMAGENET_MEAN, IMAGENET_STD, 7.25)
    assert sorted(got) == sorted(want)
    n_diff = 0
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k in ("w", "w7"):
            n_diff += int((got[k] != v).sum())
        elif k in ("pad", "pad4", "scale"):
            assert torch.equal(got[k], v), k
        elif k == "B":
            torch.testing.assert_close(got[k], v, rtol=0, atol=1e-5 * float(v.abs().max()), msg=k)
        else:
            torch.testing.assert_close(got[k], v, rtol=1e-6, atol=0, msg=k)
    assert n_diff <= 3, n_diff
    assert _np(want["pad4"]).tolist() == [round(255 * m - 128) for m in IMAGENET_MEAN] + [0]


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("hw", [(64, 64), (96, 80), (2, 6)], ids=["64x64", "96x80", "2x6"])
def test_plain_k1_bit_exact_vs_jax_oracle(slice_setup, hw):
    """``_stem_s2d_i8_xla`` on the space-to-depth of the 128-padded RGBX
    frame against K1's wrapper (its plain version here, which is also the
    port's ``backend="xla"`` stem) on RGB and on RGBX frames: 0 differing
    elements, also on canvases that are not powers of two and on a 2x6
    frame, whose border fill reaches every tap."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.nn import resnet_int8 as jr
    from pytorch_object_detection_tpu.nn.resnet import space_to_depth as jax_space_to_depth

    st_j = {k: jnp.asarray(v) for k, v in slice_setup["jq_bb"]["stem_s2d"].items()}
    rng = np.random.default_rng(hw[0] + hw[1])
    u8 = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    u4 = np.concatenate([u8, np.full((2, *hw, 1), 128, np.uint8)], axis=-1)
    want = np.asarray(jr._stem_s2d_i8_xla(st_j, jax_space_to_depth(jnp.asarray(u4), 2)))
    qtree = load_backbone_qtree(slice_setup["jq_bb"], "cpu")
    assert want.shape == (2, (hw[0] // 2 - 1) // 2 + 1, (hw[1] // 2 - 1) // 2 + 1, 64)
    for got in (qstem_conv(torch.from_numpy(u8), qtree["stem_s2d"]),
                qstem_conv(torch.from_numpy(u4), qtree["stem_s2d"])):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(_np(got), want)
    assert 0.05 < (want > 0).mean()  # the case is not degenerate


def test_u8_stem_within_one_step_of_the_float_stem(slice_setup):
    """The exact uint8 stem against the port's float stem on the normalized
    frames (f32 conv, BN, ReLU, 3x3/2 pool, quantize): the contract of
    tests/test_quant.py:711-714, at most one int8 step apart (the float
    stem rounds the normalize; the uint8 stem folds it exactly)."""
    qtree = load_backbone_qtree(slice_setup["jq_bb"], "cpu")
    frames = torch.from_numpy(slice_setup["frames"])
    got = qstem_conv(frames, qtree["stem_s2d"])
    want = resnet_int8.resnet50_int8_stem(qtree, torch.from_numpy(slice_setup["norm"]), torch.float32, "xla")
    worst, share = _lsb(got, want)
    print(f"u8 stem vs float stem: max {worst} step(s), {share:.4%} of elements differ")
    assert worst <= 1


# (M, K, N): the laterals tf1..tf3 of the 256 canvas at B=2, and a ragged case
K4_SHAPES = [(128, 2048, 64), (512, 1024, 64), (2048, 512, 64), (37, 48, 24)]


@pytest.mark.parametrize("shape", K4_SHAPES, ids=["tf1", "tf2", "tf3", "ragged"])
def test_plain_k4_bit_exact_vs_jax_oracle(shape):
    """The plain K4 (``torch._int_mm`` + the epilogue) against the JAX
    oracle's epilogue (``ops/pallas_qconv._epilogue``) over an XLA int32
    dot, with and without the residual and ReLU: 0 differing elements.
    |acc| exceeds 2**24 at K=2048, where both round it to f32 alike."""
    import jax
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.ops.pallas_qconv import _epilogue

    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w = rng.integers(-127, 128, (n, k), dtype=np.int8)
    a = (np.abs(rng.normal(size=n)) * 0.005 / np.sqrt(k)).astype(np.float32)
    b = rng.normal(0, 5, n).astype(np.float32)
    res = rng.integers(-127, 128, (m, n), dtype=np.int8)
    rs = np.float32(0.37)
    acc = jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w.T), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    t = lambda v: torch.from_numpy(v)
    for relu in (True, False):
        for r in (None, res):
            want = np.asarray(_epilogue(acc, a, b, relu, None if r is None else jnp.asarray(r), rs))
            got = qmatmul(t(x), t(w), t(a), t(b), relu=relu, res=None if r is None else t(r), res_scale=rs)
            np.testing.assert_array_equal(_np(got), want)
            assert 0.05 < (want > 0).mean() and (np.abs(want) == 127).mean() < 0.2
    got = qconv1x1(t(x).reshape(1, m, 1, k), t(w), t(a), t(b))
    np.testing.assert_array_equal(_np(got).reshape(m, n), np.asarray(_epilogue(acc, a, b, True)))


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 7, 5, 48), (1, 3, 3, 16), (2, 1, 1, 16)],
                         ids=["8x8", "odd7x5", "3x3", "1x1"])
def test_plain_k6_bit_exact_vs_jax_oracle(shape):
    """The plain K6 against ``_maxpool2x2_i8`` (VALID: odd sizes floor): 0 differing elements."""
    from pytorch_object_detection_tpu.nn.fpn_int8 import _maxpool2x2_i8

    x = np.random.default_rng(shape[1] * shape[2]).integers(-128, 128, shape, dtype=np.int8)
    want = np.asarray(_maxpool2x2_i8(x))
    got = qmaxpool2x2(torch.from_numpy(x))
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("hw", [(16, 16), (7, 11), (3, 5), (1, 1)], ids=["16x16", "7x11", "3x5", "1x1"])
def test_plain_k6_seeds_bit_exact_vs_jax_oracle(hw):
    """The plain seeds (``qmaxpool2x2_seeds``: seed6 = pool(t5), seed7 =
    pool(seed6), the HisFPN's extra levels) against two ``_maxpool2x2_i8``
    calls: 0 differing elements, empty maps where VALID floors a side to 0."""
    from pytorch_object_detection_tpu.nn.fpn_int8 import _maxpool2x2_i8

    x = np.random.default_rng(hw[0] * 31 + hw[1]).integers(-128, 128, (2, *hw, 32), dtype=np.int8)
    want6 = np.asarray(_maxpool2x2_i8(x))
    want7 = np.asarray(_maxpool2x2_i8(want6))
    got6, got7 = qmaxpool2x2_seeds(torch.from_numpy(x))
    for got, want in ((got6, want6), (got7, want7)):
        assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_np(got), want)
    assert want7.shape[1:3] == (hw[0] // 4, hw[1] // 4)


# (name, block, combine, H, W, scale of xa, scale of xb): his1 takes its
# input as it is, his2/his3 upsample-add, his4..his7 pool-add, each with
# the scales of the maps the forward feeds it; the last case is a 1x1
# level, where every shift of the 3x3 and dilated 3x3 convs reads the zero fill
K5_CASES = [("none", "his1", None, 8, 8, None, None),
            ("up_add", "his2", "up_add", 16, 16, ("his1", "s_out"), ("tf2", "s")),
            ("add", "his4", "add", 12, 10, ("his3", "s_out"), ("his2", "s_out")),
            ("1x1", "his7", "add", 1, 1, ("his6", "s_out"), ("tf1", "s"))]


@pytest.mark.parametrize("case", K5_CASES, ids=[c[0] for c in K5_CASES])
def test_plain_k5_vs_jax_oracle(slice_setup, case):
    """The plain K5 (glue + ``qhisblock_plain``) against the JAX glue
    (``_upsample2x_i8``, ``_add_requant``) + ``_hisblock_i8_xla``, the
    calibrated block on random int8 maps: at most one int8 step, under 5 %
    of elements differing (the contract of tests/test_quant.py:438-459;
    torch's and XLA's sigmoid may differ in the last f32 bit).  Observed
    here: 0 elements differ."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.nn import fpn_int8 as jf

    _, name, combine, h, w, sa_key, sb_key = case
    jq = slice_setup["jq_fpn"]
    blk_j = {k: jnp.asarray(v) for k, v in jq[name].items()}
    blk = load_fpn_qtree(jq, "cpu")[name]
    rng = np.random.default_rng(h * 100 + w)
    c = 2 * blk["w1"].shape[0]
    draw = lambda *shape: np.clip(np.round(rng.normal(0, 40, shape)), -127, 127).astype(np.int8)
    xb = draw(2, h, w, c)
    xa = draw(2, h // 2, w // 2, c) if combine == "up_add" else draw(2, h, w, c)
    if combine is None:
        want = jf._hisblock_i8_xla(blk_j, jnp.asarray(xa))
        got = qhisblock(blk, torch.from_numpy(xa))
    else:
        sa, sb = jq[sa_key[0]][sa_key[1]], jq[sb_key[0]][sb_key[1]]
        up = jf._upsample2x_i8(jnp.asarray(xa)) if combine == "up_add" else jnp.asarray(xa)
        want = jf._hisblock_i8_xla(blk_j, jf._add_requant(up, sa, jnp.asarray(xb), sb, blk_j["s_in"]))
        s_in = blk["s_in"]
        got = qhisblock(blk, torch.from_numpy(xa), xb_q=torch.from_numpy(xb), combine=combine,
                        ca=torch.tensor(sa) / s_in, cb=torch.tensor(sb) / s_in)
    want = np.asarray(want)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape == (2, h, w, c)
    worst, share = _lsb(got, want)
    print(f"K5 {case[0]}: max {worst} step(s), {share:.4%} of {want.size} elements differ")
    assert worst <= 1 and share < 0.05
    assert 0.05 < (np.abs(want) > 0).mean()


# (block, finer H', W', xa's scale, xb's scale): his4 and his6's pool-add
# on an even and an odd finer level (VALID drops the odd row and column)
K5_POOL_CASES = [("his4", 16, 22, ("his3", "s_out"), ("his2", "s_out")),
                 ("his6", 15, 23, ("his5", "s_out"), ("tf1", "s"))]


@pytest.mark.parametrize("case", K5_POOL_CASES, ids=["16x22", "15x23"])
def test_plain_k5_pool_add_vs_jax_oracle(slice_setup, case):
    """K5 with the level pool in its glue (``combine="pool_add"``, its plain
    version) against the JAX ``_maxpool2x2_i8``, ``_add_requant`` and
    ``_hisblock_i8_xla``: at most one int8 step, under 5 % of elements
    differing (the contract of the other K5 cases).  Observed here: 0."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.nn import fpn_int8 as jf

    name, hf, wf, sa_key, sb_key = case
    jq = slice_setup["jq_fpn"]
    blk_j = {k: jnp.asarray(v) for k, v in jq[name].items()}
    blk = load_fpn_qtree(jq, "cpu")[name]
    c = 2 * blk["w1"].shape[0]
    rng = np.random.default_rng(hf * 100 + wf)
    draw = lambda *shape: np.clip(np.round(rng.normal(0, 40, shape)), -127, 127).astype(np.int8)
    xa, xb = draw(2, hf, wf, c), draw(2, hf // 2, wf // 2, c)
    sa, sb = jq[sa_key[0]][sa_key[1]], jq[sb_key[0]][sb_key[1]]
    want = np.asarray(jf._hisblock_i8_xla(blk_j, jf._add_requant(jf._maxpool2x2_i8(jnp.asarray(xa)), sa,
                                                                  jnp.asarray(xb), sb, blk_j["s_in"])))
    s_in = blk["s_in"]
    got = qhisblock(blk, torch.from_numpy(xa), xb_q=torch.from_numpy(xb), combine="pool_add",
                    ca=torch.tensor(sa) / s_in, cb=torch.tensor(sb) / s_in, plain=True)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape == (2, hf // 2, wf // 2, c)
    worst, share = _lsb(got, want)
    print(f"K5 pool_add {hf}x{wf}: max {worst} step(s), {share:.4%} of {want.size} elements differ")
    assert worst <= 1 and share < 0.05
    assert 0.05 < (np.abs(want) > 0).mean()


# ---------------------------------------------------------------- (c)

def test_calibrate_and_quantize_hisfpn_match_jax(slice_setup):
    """Taps within rtol 1e-5 (f32 convs in another summation order, as
    test_torch_port_int8's taps); from the JAX taps, the qtree with the
    tolerance form of ``test_quantize_resnet50_matches_jax``: scalars and
    ``A`` within rtol 1e-6, ``B`` within 4 ulps of its largest value, int8
    weights identical but for at most 0.01 % of them."""
    fpn = slice_setup["model"].fpn
    ttaps = fpn_int8.calibrate_hisfpn(fpn, [torch.tensor(f) for f in slice_setup["feats"]])
    jtaps = slice_setup["jtaps"]
    assert sorted(ttaps) == sorted(jtaps) and len(jtaps) == 3 + 6 + 7 * 5
    rel = {k: abs(ttaps[k] - jtaps[k]) / abs(jtaps[k]) for k in jtaps}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 1e-5, f"{worst}: relative difference {rel[worst]:.3g}"

    got = fpn_int8.quantize_hisfpn(fpn, jtaps, [torch.from_numpy(s) for s in slice_setup["scales"]])
    want = load_fpn_qtree(slice_setup["jq_fpn"], "cpu")
    assert sorted(got) == sorted(want)
    n_diff = n_all = 0
    for scope, blk in want.items():
        assert sorted(got[scope]) == sorted(blk), scope
        for k, v in blk.items():
            g = got[scope][k]
            assert g.dtype == v.dtype and g.shape == v.shape, (scope, k)
            if v.dtype == torch.int8:
                n_diff += int((g != v).sum())
                n_all += v.numel()
            elif k.startswith("B"):
                torch.testing.assert_close(g, v, rtol=0, atol=INT8_EPS * float(v.abs().max()), msg=f"{scope}.{k}")
            else:
                torch.testing.assert_close(g, v, rtol=1e-6, atol=0, msg=f"{scope}.{k}")
    assert n_diff <= n_all // 10000, (n_diff, n_all)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_hisfpn_int8_forward_matches_jax(slice_setup, backend):
    """P3..P7 int8 from the same int8 C3..C5 and qtree: at most one step,
    under 5 % of elements differing per level (the contract of
    tests/test_quant.py:438-459; a flip in one block would feed the next).
    Observed here: 0 elements differ on either backend.  The dequantized
    levels keep cosine > 0.99 against the BN-folded float HisFPN on the
    dequantized features (test_quant.py:416-435)."""
    from pytorch_object_detection_tpu_torch.nn.fused_fpn import hisfpn_folded_forward

    qtree = load_fpn_qtree(slice_setup["jq_fpn"], "cpu")
    feats_q = [torch.from_numpy(q) for q in slice_setup["feats_q"]]
    levels_q, scales = fpn_int8.hisfpn_int8_forward(qtree, feats_q, backend=backend, dequant=False)
    assert len(levels_q) == 5
    for i, (g, w) in enumerate(zip(levels_q, slice_setup["jlevels_q"])):
        assert g.dtype == torch.int8 and tuple(g.shape) == w.shape
        worst, share = _lsb(g, w)
        print(f"P{i + 3} {backend}: max {worst} step(s), {share:.4%} of {w.size} elements differ")
        assert worst <= 1 and share < 0.05, (i, worst, share)
    levels = fpn_int8.hisfpn_int8_forward(qtree, feats_q, torch.float32, backend=backend)
    with torch.no_grad():
        ref = hisfpn_folded_forward(slice_setup["model"].fpn, [torch.from_numpy(f).permute(0, 3, 1, 2)
                                                               for f in slice_setup["feats"]], torch.float32)
    for i, (g, r) in enumerate(zip(levels, ref)):
        r = r.permute(0, 2, 3, 1)
        cos = float((g * r).sum() / (g.norm() * r.norm()))
        assert g.dtype == torch.float32 and cos > 0.99, (i, cos)


# ---------------------------------------------------------------- (d)

# On the same qtrees the int8 stages agree exactly (above), so the levels
# differ only by the float head's f32 summation order: measured on an
# x86-64 CPU, at most 3.1e-6 of a level's range, and all top-100
# detections matched.  Tolerance: test_torch_port_pipeline's, 1e-4 of the
# range.  With the port's own calibration, whose scales differ from JAX's
# by f32 ulps and so move requant boundaries all through the ladder
# (test_torch_port_int8's slice): at most 0.185 of the range, cosine at
# least 0.99180; tolerances 0.25 and 0.99, that file's.
SAME_QTREE = (1e-4, 0.9999)
OWN_QTREE = (0.25, 0.99)


@pytest.fixture(scope="module")
def slice_runs(slice_setup):
    from pytorch_object_detection_tpu.ops.postprocess import decode_detections

    args = (slice_setup["model"], torch.from_numpy(slice_setup["norm"]), STRIDES, (CANVAS, CANVAS))
    pipe = make_eval_pipeline_int8(*args, int8_fpn=True, int8_head=False, compute_dtype=torch.float32)
    frames = torch.from_numpy(slice_setup["frames"])
    own = pipe.forward_levels(frames)
    same = copy.copy(pipe)
    same.qtree = {"backbone": load_backbone_qtree(slice_setup["jq_bb"], "cpu"),
                  "fpn": load_fpn_qtree(slice_setup["jq_fpn"], "cpu")}
    levels = same.forward_levels(frames)
    jdets = decode_detections(*slice_setup["jlevels"], STRIDES, 0.05, 0.6, 1000, (CANVAS, CANVAS))
    return dict(pipe=pipe, own=own, levels=levels, dets=same.decode(levels),
                jdets=[np.asarray(a) for a in jdets], args=args)


@pytest.mark.parametrize("branch", [0, 1, 2], ids=["cls", "cnt", "reg"])
def test_int8_fpn_slice_levels_match_jax(slice_setup, slice_runs, branch):
    for which, (tol, min_cos) in (("levels", SAME_QTREE), ("own", OWN_QTREE)):
        for i, (got, want) in enumerate(zip(slice_runs[which][branch], slice_setup["jlevels"][branch])):
            got = _np(got)
            assert got.shape == want.shape and np.isfinite(got).all()
            err = float(np.abs(got - want).max())
            rng = float(np.abs(want).max())
            cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
            print(f"{which} branch {branch} level {i}: err/range {err / rng:.4g}, cosine {cos:.8f}")
            assert err <= tol * rng and cos >= min_cos, \
                f"{which} branch {branch} level {i}: max abs err {err:.4g} (range {rng:.4g}), cosine {cos:.8f}"


def test_int8_fpn_slice_detections_match_jax(slice_runs):
    """On the same qtree, at least 95 of each image's top-100 JAX detections
    have a port detection of the same class at IoU > 0.9 (measured: 100
    and 100; a near-tie in the scores may swap two of the top 100)."""
    scores, classes, boxes, valid = slice_runs["jdets"]
    dets = slice_runs["dets"]
    for b in range(BATCH):
        want_idx = np.nonzero(valid[b])[0][:100]
        assert len(want_idx) == 100
        got_v = dets.valid[b]
        assert torch.isfinite(dets.scores[b]).all() and torch.isfinite(dets.boxes[b]).all()
        iou = pairwise_iou(torch.from_numpy(boxes[b][want_idx]), dets.boxes[b][got_v])
        same_class = torch.from_numpy(classes[b][want_idx])[:, None] == dets.classes[b][got_v][None, :]
        matched = int(((iou > 0.9) & same_class).any(dim=1).sum())
        print(f"image {b}: {matched} of 100 matched")
        assert matched >= 95


def test_int8_fpn_pipeline_takes_raw_frames_and_backends_agree(slice_setup, slice_runs):
    """The pipeline skips the normalize (the uint8 frames reach the stem);
    ``backend="xla"`` (the per-op oracles) gives what the kernels' plain
    versions give; so does the JAX default ``int8_head=True`` (the int8
    head on the same backbone and HisFPN qtrees)."""
    pipe, args = slice_runs["pipe"], slice_runs["args"]
    frames = torch.from_numpy(slice_setup["frames"])
    assert pipe.u8_input and torch.equal(pipe._input(frames), frames)
    xla = make_eval_pipeline_int8(*args, int8_fpn=True, int8_head=False, compute_dtype=torch.float32,
                                  backend="xla")
    xla.qtree = pipe.qtree
    for a_b, b_b in zip(xla.forward_levels(frames), slice_runs["own"]):
        assert all(torch.equal(a, b) for a, b in zip(a_b, b_b))
    default = make_eval_pipeline_int8(*args, compute_dtype=torch.float32)
    default_xla = make_eval_pipeline_int8(*args, compute_dtype=torch.float32, backend="xla")
    assert sorted(default.qtree) == ["backbone", "fpn", "head"] and default.u8_input
    assert all(torch.equal(a, b) for k in ("backbone", "fpn") for a, b in
               zip(_tensors(default.qtree[k]), _tensors(pipe.qtree[k])))
    default_xla.qtree = default.qtree
    for a_b, b_b in zip(default.forward_levels(frames), default_xla.forward_levels(frames)):
        assert all(torch.equal(a, b) and bool(torch.isfinite(a).all()) for a, b in zip(a_b, b_b))


# ---------------------------------------------------------------- (e)

def test_load_fpn_qtree_rejects_bad_trees(slice_setup):
    jq = slice_setup["jq_fpn"]
    bad = copy.deepcopy(jq)
    del bad["his3"]["A3"]
    with pytest.raises(KeyError, match="missing"):
        load_fpn_qtree(bad, "cpu")
    bad = copy.deepcopy(jq)
    bad["tf2"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unused"):
        load_fpn_qtree(bad, "cpu")
    bad = copy.deepcopy(jq)
    bad["his5"]["w4"] = bad["his5"]["w4"][:, :, :8]
    with pytest.raises(ValueError, match="his5/w4"):
        load_fpn_qtree(bad, "cpu")
    bad = copy.deepcopy(slice_setup["jq_bb"])
    bad["stem_s2d"]["w7"] = bad["stem_s2d"]["w7"].astype(np.float32)
    with pytest.raises(ValueError, match="stem_s2d/w7"):
        load_backbone_qtree(bad, "cpu")


def test_entry_points_default_to_the_card(slice_setup):
    """With no ``device`` the model and the qtrees go to CUDA; without a
    card PyTorch refuses (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    refused = (AssertionError, RuntimeError)  # CPU-only builds assert; others raise
    with pytest.raises(refused):
        build_model("HISFCOS", NUM_CLASSES, FEATURES)
    with pytest.raises(refused):  # the space-to-depth stem's model too
        build_model("HISFCOS", NUM_CLASSES, FEATURES, stem_mode="s2d")
    with pytest.raises(refused):
        load_backbone_qtree(slice_setup["jq_bb"])
    with pytest.raises(refused):
        load_fpn_qtree(slice_setup["jq_fpn"])
    with pytest.raises(refused):
        load_head_qtree(jax_head_form(port_head_qtree(32, NUM_CLASSES, [(2, 2)])[0]))
