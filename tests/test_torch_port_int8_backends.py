"""The int8 ResNet-50's other serving backends of the port against the JAX package (CPU, f32).

``nn/resnet_int8.resnet50_int8_forward`` takes every backend and switch of
the JAX function: the per-conv kernels (``backend="pallas"``: K4 and K11),
``fuse_strided=False``, the direct uint8 stem (``direct_stem``, the JAX
``PODT_STEM_XLA7=1``: K10), the bf16 stem tail (``"pallas_stem_tail"``:
K17) and the chained segments (``chain_segments``, ``PODT_QCHAIN=1``:
K13).  On the CPU every wrapper runs its plain version, so this holds the
plain versions against the JAX package:

  (a) the plain K11, K10, K17 and K13 against the Pallas kernels in
      interpret mode and the XLA oracles;
  (b) the direct stem against ``_stem_direct_i8_xla`` and against K1;
  (c) the per-conv ladder (and ``fuse_strided=False``) against a JAX ladder
      assembled from the Pallas kernels as ``resnet_int8.py:532-545`` does;
  (d) the whole per-conv serving path against that ladder followed by the
      JAX int8 HisFPN and HISHead run op by op.

The backbone qtree is JAX-built (``train/trainer.quantize_backbone``) and
reaches the port through ``load_backbone_qtree``; the HisFPN and HISHead
qtrees are the port's, calibrated on that backbone, and reach JAX through
``jax_fpn_form``/``jax_head_form``.  The JAX functions run op by op, not
under ``jax.jit`` (XLA fuses the f32 epilogues under jit; see
test_torch_port_int8_fpn).  About 85 s serially on one x86-64 core, most of
it the JAX set-up and the interpret-mode Pallas calls.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu_torch.eval.evaluator import IMAGENET_MEAN, IMAGENET_STD
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.nn import resnet_int8
from pytorch_object_detection_tpu_torch.ops.qchain import qchain
from pytorch_object_detection_tpu_torch.ops.qconv import qconv3x3
from pytorch_object_detection_tpu_torch.ops.qpool import qmaxpool3x3s2
from pytorch_object_detection_tpu_torch.ops.qstem import qstem_conv, to_rgbx
from pytorch_object_detection_tpu_torch.ops.stem import stem_bn_pool_quant
from pytorch_object_detection_tpu_torch.train.checkpoints import load_backbone_qtree, load_flax_variables
from pytorch_object_detection_tpu_torch.train.trainer import make_eval_forward_int8, quantize_fpn, quantize_head
from torch_port_fixtures import (
    FEATURES,
    NUM_CLASSES,
    jax_fpn_form,
    jax_head_form,
    jax_model,
    perturbed_variables,
    port_block,
    rand_qblock,
)

# stages 32x32 .. 4x4, levels 16x16 .. 1x1: the smallest frame whose float
# HisFPN (the calibration of the int8 one) keeps a 1x1 P7
FRAME = 128


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cos(a, b):
    a, b = _np(a).astype(np.float64).ravel(), _np(b).astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (2, 6, 10, 32)], ids=["8x8", "6x10"])
def test_plain_k11_bit_exact_vs_jax(shape):
    """The plain K11 (``conv_i8`` + the epilogue) against the JAX Pallas
    ``qconv3x3`` in interpret mode and against ``requantize(_qconv(...))``:
    0 differing int8 elements, also on a map that is not square."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.nn.resnet_int8 import _qconv, requantize
    from pytorch_object_detection_tpu.ops.pallas_qconv import qconv3x3 as jax_qconv3x3

    b, h, w, c = shape
    rng = np.random.default_rng(h * w)
    x = rng.integers(-127, 128, shape, dtype=np.int8)
    wk = rng.integers(-8, 8, (3, 3, c, c), dtype=np.int8)  # HWIO
    a = (np.abs(rng.normal(size=c)) * 1e-2).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    oracle = np.asarray(requantize(_qconv(jnp.asarray(x), jnp.asarray(wk)), a, bias))
    pallas = np.asarray(jax_qconv3x3(jnp.asarray(x), jnp.asarray(wk), a, bias, tile_h=h // 2, interpret=True))
    np.testing.assert_array_equal(pallas, oracle)
    t = torch.from_numpy
    got = qconv3x3(t(x), t(np.ascontiguousarray(wk.transpose(3, 0, 1, 2))), t(a), t(bias))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(_np(got), oracle)
    assert 0.05 < (oracle > 0).mean() and (oracle == 127).mean() < 0.2  # not degenerate


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 32, 64, 128), (1, 15, 21, 64)],
                         ids=["16x16", "32x64", "odd_fallback"])
def test_plain_k10_bit_exact_vs_jax(shape):
    """The plain K10 against the JAX ``qmaxpool3x3s2`` in interpret mode (on
    the odd shape the JAX wrapper falls back to ``reduce_window``): 0
    differing elements."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.ops.pallas_pool import qmaxpool3x3s2 as jax_pool

    x = np.random.default_rng(shape[1]).integers(-128, 128, shape, dtype=np.int8)
    want = np.asarray(jax_pool(jnp.asarray(x), interpret=True))
    got = qmaxpool3x3s2(torch.from_numpy(x))
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), want)


def test_plain_k17_within_one_step_of_jax():
    """The plain K17 against the JAX ``stem_bn_pool_quant`` in interpret mode
    on a bf16 [2, 32, 32, 64] map: at most one int8 step, and the count of
    differing values asserted.  XLA on the CPU may carry the bf16 BN
    product into the add in f32, where the port rounds each op to bf16 as
    the kernel on the card does; measured here: 0 values differ."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.ops.pallas_stem import stem_bn_pool_quant as jax_tail

    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(0, 3, (2, 32, 32, 64)).astype(np.float32)).to(torch.bfloat16)
    mult = (rng.uniform(0.3, 1.3, 64)).astype(np.float32)
    shift = rng.normal(0, 0.5, 64).astype(np.float32)
    scale = np.float32(float(x.float().abs().max()) / 127.0 * 0.8)  # a few values clip
    want = np.asarray(jax_tail(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), mult, shift, scale,
                               row_chunk=4, interpret=True))
    got = stem_bn_pool_quant(x, torch.from_numpy(mult), torch.from_numpy(shift), torch.tensor(scale))
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape == (2, 16, 16, 64)
    d = np.abs(_np(got).astype(np.int32) - want.astype(np.int32))
    print(f"K17 plain vs JAX interpret: {int((d > 0).sum())} of {d.size} differ, max {int(d.max())} step")
    assert int(d.max()) <= 1 and int((d > 0).sum()) == 0
    assert (want > 0).mean() > 0.05 and (want == 127).any()


def _jax_chain_block(blk, kind):
    import jax.numpy as jnp

    cin, cw = blk["w1"].shape[2:]
    out = dict(kind=kind, merged=False, w1=jnp.asarray(blk["w1"].reshape(cin, cw)), w2=jnp.asarray(blk["w2"]),
               w3=jnp.asarray(blk["w3"].reshape(cw, -1)))
    out.update({k: jnp.asarray(blk[k]) for k in ("A1", "B1", "A2", "B2", "A3", "B3")})
    if "wd" in blk:
        out.update(wd=jnp.asarray(blk["wd"].reshape(cin, -1)), Ad=jnp.asarray(blk["Ad"]), Bd=jnp.asarray(blk["Bd"]))
    else:
        out["short_mul"] = float(blk["short_mul"])
    return out


# (input B, H, W, C; blocks as (Cin, Cw, Cout, stride)): the s2-led chain of
# tests/test_quant.py:337-345, and an s1, s1, s2, s1 chain
QCHAIN_CASES = {
    "s2_led": ((2, 8, 16, 96), [(96, 32, 128, 2), (128, 32, 128, 1), (128, 32, 128, 1)]),
    "s1_s1_s2_s1": ((2, 16, 32, 64), [(64, 16, 64, 1), (64, 16, 64, 1), (64, 32, 96, 2), (96, 32, 96, 1)]),
}


@pytest.mark.parametrize("case", list(QCHAIN_CASES))
def test_plain_k13_bit_exact_vs_jax(case):
    """The plain K13 chain (kernel C's plain version block after block)
    against the JAX ``qchain`` in interpret mode on canonical (not
    row-pair-merged) chains: 0 differing int8 elements.  The JAX chain adds
    a projection as ((acc3 A3 + B3) + accd Ad) + Bd, the port as the oracle's
    (acc3 A3 + B3) + (accd Ad + Bd) (ROADMAP queue 3); no value lands on the
    rounding boundary between them here."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.ops.pallas_qchain import qchain as jax_qchain

    shape, specs = QCHAIN_CASES[case]
    rng = np.random.default_rng(len(case))
    blocks = [(rand_qblock(rng, cin, cw, cout, s == 2 or cin != cout), s) for cin, cw, cout, s in specs]
    blocks[1][0]["short_mul"] = np.float32(0.5)  # the value test_quant.py gives its identity blocks
    x = rng.integers(-127, 128, shape, dtype=np.int8)
    want = np.asarray(jax_qchain(jnp.asarray(x), [_jax_chain_block(b, f"s{s}") for b, s in blocks],
                                 rc_s1=4, rc_s2=2, interpret=True))
    got = qchain(torch.from_numpy(x), [(port_block(b), s) for b, s in blocks])
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    n_diff = int((_np(got) != want).sum())
    assert n_diff == 0, f"{case}: {n_diff} of {want.size} int8 elements differ"
    assert 0.05 < (want > 0).mean()


# ---------------------------------------------------------------- shared set-up

@pytest.fixture(scope="module")
def setup():
    """A perturbed HISFCOS in both packages; the JAX-built backbone qtree
    (with the uint8 stem) in both forms; the port's HisFPN and HISHead
    qtrees on it, in both forms; a 128x128 uint8 frame."""
    import jax
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.train import trainer as jt

    params, stats = perturbed_variables(seed=12)
    frames = np.random.default_rng(13).integers(0, 256, (1, FRAME, FRAME, 3), dtype=np.uint8)
    norm = ((frames.astype(np.float32) / np.float32(255.0) - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    jq_bb = jt.quantize_backbone(jax_model(), {"params": params, "batch_stats": stats}, jnp.asarray(norm),
                                 compute_dtype=jnp.float32)
    jq_bb = jax.tree_util.tree_map(np.asarray, jq_bb)
    model = build_model("HISFCOS", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    qbb = load_backbone_qtree(jq_bb, "cpu")
    q_fpn = quantize_fpn(model, qbb, torch.from_numpy(norm))
    q_head = quantize_head(model, qbb, q_fpn, torch.from_numpy(norm))
    return dict(frames=frames, model=model, jq_bb=jq_bb, qbb=qbb, q_fpn=q_fpn, q_head=q_head,
                jq_fpn=jax_fpn_form(q_fpn), jq_head=jax_head_form(q_head))


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("hw", [(FRAME, FRAME), (2, 6)], ids=["128x128", "2x6"])
def test_direct_stem_bit_exact_vs_jax_and_k1(setup, hw):
    """``stem_direct_i8`` + the plain K10 against ``_stem_direct_i8_xla(...,
    pool=True)`` run op by op, and against K1's plain version, on the
    JAX-built qtree: 0 differing elements (the s2d rewrite only rearranges
    the same quantized taps; ``tests/test_quant.py:1043``).  On a 2x6 frame
    the border fill reaches every tap."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.nn.resnet_int8 import _stem_direct_i8_xla

    u8 = np.random.default_rng(hw[1]).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    u4 = np.concatenate([u8, np.full((2, *hw, 1), 128, np.uint8)], axis=-1)
    st_j = {k: jnp.asarray(v) for k, v in setup["jq_bb"]["stem_s2d"].items()}
    want = np.asarray(_stem_direct_i8_xla(st_j, jnp.asarray(u4), pool=True))
    st = setup["qbb"]["stem_s2d"]
    conv = resnet_int8.stem_direct_i8(st, to_rgbx(torch.from_numpy(u8)))
    got = qmaxpool3x3s2(conv)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(qstem_conv(torch.from_numpy(u8), st)), want)
    np.testing.assert_array_equal(_np(conv), np.asarray(_stem_direct_i8_xla(st_j, jnp.asarray(u4), pool=False)))
    assert 0.05 < (want > 0).mean()


# ---------------------------------------------------------------- (c)

def _jax_ladder(jq, frames, fuse_strided_false=False):
    """C3..C5 int8 of the JAX per-conv backend (``resnet_int8.py:532-545``)
    line by line, the Pallas kernels in interpret mode, from the JAX u8
    stem's oracle.  With ``fuse_strided_false`` the stride-1 blocks run the
    XLA oracle's block math (``:547-555``) op by op, which is what the
    port's kernel C computes: ``backend="pallas_block", fuse_strided=False``
    runs them on kernel C.  The JAX Pallas ``qbottleneck`` in interpret mode
    is not that reference: XLA compiles its body and fuses the f32
    epilogue, as under ``jax.jit``, which moves a few int8 values by one
    step on this qtree (ROADMAP queue 3)."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.nn.resnet import space_to_depth
    from pytorch_object_detection_tpu.nn.resnet_int8 import (
        INT8_MAX,
        STAGE_SIZES,
        _qconv,
        _stem_s2d_i8_xla,
        requantize,
    )
    from pytorch_object_detection_tpu.ops.pallas_qconv import qconv1x1, qconv3x3

    jq = {k: {n: jnp.asarray(v) for n, v in jq[k].items()} for k in jq if k.startswith("layer") or k == "stem_s2d"}
    u4 = jnp.pad(jnp.asarray(frames), ((0, 0), (0, 0), (0, 0), (0, 1)), constant_values=jnp.uint8(128))
    x_q = _stem_s2d_i8_xla(jq["stem_s2d"], space_to_depth(u4, 2))
    outputs = []
    for stage, blocks in enumerate(STAGE_SIZES):
        for b in range(blocks):
            blk = jq[f"layer{stage + 1}_{b}"]
            stride = 2 if (b == 0 and stage > 0) else 1
            if fuse_strided_false and stride == 1:
                a1 = requantize(_qconv(x_q, blk["w1"]), blk["A1"], blk["B1"])
                a2 = requantize(_qconv(a1, blk["w2"]), blk["A2"], blk["B2"])
                pre = _qconv(a2, blk["w3"]) * blk["A3"] + blk["B3"]
                short = (_qconv(x_q, blk["wd"]) * blk["Ad"] + blk["Bd"] if "wd" in blk
                         else x_q.astype(jnp.float32) * blk["short_mul"])
                x_q = jnp.clip(jnp.round(jnp.maximum(pre + short, 0.0)), -INT8_MAX, INT8_MAX).astype(jnp.int8)
                continue
            a1 = qconv1x1(x_q, blk["w1"], blk["A1"], blk["B1"], interpret=True)
            if stride == 1:
                a2 = qconv3x3(a1, blk["w2"], blk["A2"], blk["B2"], interpret=True)
            else:
                a2 = requantize(_qconv(a1, blk["w2"], stride), blk["A2"], blk["B2"])
            if "wd" in blk:
                x_sub = x_q[:, ::stride, ::stride, :] if stride > 1 else x_q
                short_q = qconv1x1(x_sub, blk["wd"], blk["Ad"], blk["Bd"], relu=False, interpret=True)
                x_q = qconv1x1(a2, blk["w3"], blk["A3"], blk["B3"], res_nhwc=short_q, res_scale=1.0, interpret=True)
            else:
                x_q = qconv1x1(a2, blk["w3"], blk["A3"], blk["B3"], res_nhwc=x_q, res_scale=blk["short_mul"],
                               interpret=True)
        outputs.append(x_q)
    return outputs[-3:]


@pytest.fixture(scope="module")
def per_conv(setup):
    return [np.asarray(q) for q in _jax_ladder(setup["jq_bb"], setup["frames"])]


@pytest.mark.parametrize("form", ["pallas", "fuse_strided_false"])
def test_per_conv_ladder_bit_exact_vs_jax(setup, per_conv, form):
    """C3..C5 int8 of ``backend="pallas"`` (and of ``"pallas_block",
    fuse_strided=False``) from raw uint8 frames against the JAX ladder
    assembled from the Pallas kernels: 0 differing elements.  The per-conv
    form requantizes the projection shortcut to int8, so on projection
    blocks it is another function than the oracle and kernel C (the share
    of C5 values that differ from ``"pallas_block"`` is printed)."""
    kw = dict(backend="pallas") if form == "pallas" else dict(backend="pallas_block", fuse_strided=False)
    want = per_conv if form == "pallas" else [np.asarray(q) for q in _jax_ladder(setup["jq_bb"], setup["frames"],
                                                                                  fuse_strided_false=True)]
    frames = torch.from_numpy(setup["frames"])
    got, scales = resnet_int8.resnet50_int8_forward(setup["qbb"], frames, torch.float32, dequant=False, u8_stem=True,
                                                    **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int8 and tuple(g.shape) == w.shape
        n_diff = int((_np(g) != w).sum())
        assert n_diff == 0, f"C{i + 3} {form}: {n_diff} of {w.size} int8 elements differ"
        assert 0.02 < (w > 0).mean()
    block, _ = resnet_int8.resnet50_int8_forward(setup["qbb"], frames, torch.float32, backend="pallas_block",
                                                 fuse_strided=True, dequant=False, u8_stem=True)
    share = float((got[-1] != block[-1]).float().mean())
    print(f"{form} vs pallas_block: {share:.2%} of C5 int8 values differ, dequantized cosine "
          f"{_cos(got[-1].float() * scales[-1], block[-1].float() * scales[-1]):.6f}")


# ---------------------------------------------------------------- (d)

def test_per_conv_serving_path_matches_jax(setup, per_conv):
    """``make_eval_forward_int8(backend="pallas", int8_fpn=True,
    int8_head=True, u8_input=True)`` from raw uint8 frames against the JAX
    per-conv ladder, ``hisfpn_int8_forward`` and ``hishead_int8_forward``
    (``backend="xla"``) run op by op on the same qtrees: cosine >= 0.9999
    per level (the int8 HISHead's contract, test_torch_port_int8_head; up
    to the head the stages are bit-exact)."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.models.head_int8 import hishead_int8_forward
    from pytorch_object_detection_tpu.nn.fpn_int8 import hisfpn_int8_forward

    jq_fpn = {s: {k: jnp.asarray(v) for k, v in b.items()} for s, b in setup["jq_fpn"].items()}
    levels_q, _ = hisfpn_int8_forward(jq_fpn, [jnp.asarray(q) for q in per_conv], backend="xla", dequant=False)
    want = hishead_int8_forward(setup["jq_head"], levels_q, backend="xla", num_classes=NUM_CLASSES)
    fwd = make_eval_forward_int8(setup["model"], torch.float32, backend="pallas", int8_fpn=True, int8_head=True,
                                 u8_input=True)
    got = fwd({"backbone": setup["qbb"], "fpn": setup["q_fpn"], "head": setup["q_head"]},
              torch.from_numpy(setup["frames"]))
    for name, g_b, w_b in zip(("cls", "cnt", "reg"), got, want):
        assert len(g_b) == 5
        for i, (g, w) in enumerate(zip(g_b, w_b)):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape and bool(torch.isfinite(g).all())
            cos = _cos(g, w)
            print(f"{name} P{i + 3} {tuple(g.shape)}: cosine {cos:.9f}")
            assert cos >= 0.9999, (name, i, cos)
