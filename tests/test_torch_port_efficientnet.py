"""FCOS on EfficientNet-B0 in the port against the JAX package (CPU, f32).

FCOS(20, 64, backbone="efficientnet-b0") at the 128x128 canvas (C5 at 4x4),
B=2, with a perturbed variable tree (``torch_port_fixtures.perturbed_variables``):

  (a) the five EfficientNet-B0 endpoints and the whole forward (cls, cnt,
      reg) against the flax modules on the same weights, within 1e-4 of the
      range (``assert_close_to_ref``);
  (b) ``calibrate_efficientnet`` / ``quantize_efficientnet`` against JAX's:
      taps within rtol 1e-5, the quantized weights identical but for
      BN-fold flips (``FOLD_FLIP_SHARE``), the qtree carried across by
      ``train/checkpoints.load_efficientnet_qtree``;
  (c) the ladder on JAX's own qtree: each block fed JAX's int8 input, its
      three requant points (``.e``, ``.d``, ``.out``) each from JAX's
      previous point: ``.e`` and ``.out`` equal, ``.d`` within one step on
      at most ``SE_FLIP_SHARE`` (the f32 SE sums in another order); the
      whole ladder's C3..C5 and scales; the classic FPN bit-exact on JAX's
      C3..C5 and the FCOSHead's int8 stages equal op by op;
  (d) ``make_eval_forward_int8`` on its three branches and its ``u8_input``
      refusal; ``make_eval_pipeline_int8`` (its gate: the uint8 frames
      normalized in f32 before the ladder) against JAX's pipeline body run op
      by op on the JAX qtrees: the maps and the detections;
  (e) ``param_labels`` against JAX's leaf by leaf (the train steps are
      tests/test_torch_port_backbones.py's);
  (f) the qtree loader's refusals.

The JAX int8 forwards run op by op, not under ``jax.jit`` (XLA fuses the
f32 epilogues under jit and moves int8 values by a step).  Serially about
120 s on one torch thread, most of it the JAX set-up: the op-by-op JAX
quantize and ladder compile each small op once.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.models import fcos_int8 as jf8
from pytorch_object_detection_tpu.nn import efficientnet_int8 as je8
from pytorch_object_detection_tpu.nn.efficientnet import EfficientNet as JaxEfficientNet
from pytorch_object_detection_tpu.ops import postprocess as jpost
from pytorch_object_detection_tpu_torch.eval.evaluator import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    make_eval_pipeline,
    make_eval_pipeline_int8,
)
from pytorch_object_detection_tpu_torch.models import fcos_int8
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.nn import efficientnet_int8
from pytorch_object_detection_tpu_torch.ops.gn import groupnorm_act
from pytorch_object_detection_tpu_torch.train import trainer
from pytorch_object_detection_tpu_torch.train.checkpoints import (
    flax_to_torch_name,
    load_efficientnet_qtree,
    load_fcoshead_qtree,
    load_flax_variables,
    load_fpn_classic_qtree,
)
from torch_port_fixtures import (
    BATCH,
    CANVAS,
    FEATURES,
    NUM_CLASSES,
    STRIDES,
    assert_close_to_ref,
    assert_same_qtree,
    assert_taps,
    branch_scales,
    cosine,
    jax_model,
    nhwc,
    perturbed_variables,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

EFF = dict(backbone="efficientnet-b0")
# The BatchNorm folds into each kernel through rsqrt, whose XLA:CPU value can
# be an ulp off torch's: a folded weight within an ulp of a rounding boundary
# then quantizes one step apart (RetinaNet's and the MC_FCOS blocks' 1e-5 of a
# tensor).  The MBConv kernels are small: one flip in block9's 75264-weight
# project kernel is 1.3e-5 of it (measured on an x86-64 CPU: printed), so the
# share held per tensor is 5e-5, still one step at most
FOLD_FLIP_SHARE = 5e-5
# The ``.d`` point's SE gate: the spatial mean and the two 1x1 convs sum in
# f32 in another order than XLA's reduce and conv, so the gate moves by an
# ulp and a value within an ulp of a rounding boundary lands one step apart
# (measured on an x86-64 CPU: printed); at most one step, on at most this
# share of a block's values
SE_FLIP_SHARE = 1e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree(t):
    return jax.tree_util.tree_map(np.array, t)  # writable copies


def _jnp(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


@pytest.fixture(scope="module")
def ef():
    """One perturbed FCOS on EfficientNet-B0 in both packages, JAX's float
    outputs, and JAX's int8 qtrees with their calibration inputs and taps
    (the backbone ladder run op by op)."""
    params, stats = perturbed_variables(seed=50, model="FCOS", **EFF)
    variables = {"params": params, "batch_stats": stats}
    bb = {"params": params["backbone"], "batch_stats": stats["backbone"]}
    x = np.random.default_rng(51).normal(size=(BATCH, CANVAS, CANVAS, 3)).astype(np.float32)
    endpoints = [np.asarray(t) for t in jax.jit(lambda v, x: JaxEfficientNet.b0().apply(v, x, False))(bb, x)]
    jm = jax_model("FCOS", **EFF)
    whole = jax.jit(lambda v, x: jm.apply(v, x, False))(variables, x)

    frames = np.random.default_rng(52).integers(0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)
    norm = ((frames.astype(np.float32) / np.float32(255.0) - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    bb_taps = {k: float(v) for k, v in jax.jit(je8.calibrate_efficientnet)(bb, jnp.asarray(norm)).items()}
    jq_bb = je8.quantize_efficientnet(bb, bb_taps)  # as the JAX quantize_backbone
    feats_q, feat_scales = je8.efficientnet_int8_forward(jq_bb, jnp.asarray(norm), jnp.float32, dequant=False)
    feats = tuple(q.astype(jnp.float32) * s for q, s in zip(feats_q, feat_scales))
    fpn_taps = {k: float(v) for k, v in jax.jit(jf8.calibrate_fpn_classic)(params["fpn"], feats).items()}
    jq_fpn = jax.jit(jf8.quantize_fpn_classic)(params["fpn"], fpn_taps, feat_scales)
    lq, lsc = jf8.fpn_classic_int8_forward(jq_fpn, feats_q, dequant=False)
    cal_levels = tuple(q.astype(jnp.float32) * s for q, s in zip(lq, lsc))
    head_taps = {k: float(v) for k, v in jax.jit(jf8.calibrate_fcoshead)(params["head"], cal_levels).items()}
    jq_head = jf8.quantize_fcoshead(params["head"], head_taps, lsc, NUM_CLASSES)

    model = build_model("FCOS", NUM_CLASSES, FEATURES, device="cpu", **EFF)
    load_flax_variables(model, params, stats)
    return dict(params=params, stats=stats, variables=variables, jm=jm, x=x, endpoints=endpoints,
                whole=tuple([np.asarray(t) for t in b] for b in whole), frames=frames, norm=norm, model=model,
                bb_taps=bb_taps, jq_bb=_tree(jq_bb), jq_fpn=_tree(jq_fpn), jq_head=_tree(jq_head),
                feats_q=_tree(list(feats_q)), feat_scales=_tree(list(feat_scales)), feats=_tree(list(feats)),
                fpn_taps=fpn_taps, cal_levels=_tree(list(cal_levels)), level_scales=_tree(list(lsc)),
                head_taps=head_taps)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("i", range(5), ids=[f"stride{2 ** (i + 1)}" for i in range(5)])
def test_b0_endpoints_match_flax(ef, i):
    backbone = ef["model"].backbone
    with torch.no_grad():
        got = backbone(torch.from_numpy(ef["x"]).permute(0, 3, 1, 2))
    assert backbone.endpoint_channels() == (16, 24, 40, 112, 320)
    assert_close_to_ref(nhwc(got[i]), ef["endpoints"][i], f"endpoint {i}")


def test_fcos_on_efficientnet_forward_matches_flax(ef):
    """The whole forward, per level and branch (reg through ScaleExp), each
    within 1e-4 of its branch's range over the five levels."""
    with torch.no_grad():
        got = ef["model"](torch.from_numpy(ef["x"]))
    scales = branch_scales(ef["whole"])
    for b, name in enumerate(("cls", "cnt", "reg")):
        for i, (g, w) in enumerate(zip(got[b], ef["whole"][b])):
            assert_close_to_ref(g, w, f"{name} P{i + 3}", ref_scale=scales[b])


# ---------------------------------------------------------------- (b)

def test_calibrate_and_quantize_match_jax(ef):
    """Taps within rtol 1e-5 of JAX's on the same f32 frames; from the JAX
    taps the quantized weights identical (but for FOLD_FLIP_SHARE's one-step
    flips), every scale and shift within rtol 1e-5."""
    backbone = ef["model"].backbone
    assert_taps(efficientnet_int8.calibrate_efficientnet(backbone, torch.from_numpy(ef["norm"])), ef["bb_taps"])
    got = efficientnet_int8.quantize_efficientnet(backbone, ef["bb_taps"])
    want = load_efficientnet_qtree(ef["jq_bb"], device="cpu")
    assert len(want["blocks"]) == 16 and tuple(want["blocks"][3]["dw"]["w"].shape) == (5, 5, 144)
    assert "expand" not in want["blocks"][0] and tuple(want["blocks"][1]["se"]["w1"].shape) == (96, 4)
    assert isinstance(want["stem"]["bn"], tuple)
    assert_same_qtree(got, want, int8_flip_share=FOLD_FLIP_SHARE)


# ---------------------------------------------------------------- (c)

def _jax_points(blk, m, x_q):
    """JAX's ``efficientnet_int8_forward`` loop body, op by op: the block's
    (``.e``, ``.d``, ``.out``) int8 maps."""
    e_q = x_q
    if "expand" in blk:
        e = blk["expand"]
        e_q = je8._clip8(je8._silu(je8._conv_pw_i8(x_q, e["w"]) * e["A"] + e["B"]) * e["inv"])
    d = blk["dw"]
    y_f = je8._silu(je8._conv_dw_i8(e_q, d["w"], m["stride"]) * d["A"] + d["B"])
    y_f = y_f * je8._se_gate(y_f, blk["se"])
    d_q = je8._clip8(y_f * d["inv"])
    pr = blk["project"]
    y_f = je8._conv_pw_i8(d_q, pr["w"]) * pr["A"] + pr["B"]
    if m["stride"] == 1 and x_q.shape[-1] == pr["w"].shape[-1]:
        y_f = y_f + x_q.astype(jnp.float32) * blk["res_mul"]
    return e_q, d_q, je8._clip8(y_f * pr["inv"])


@pytest.fixture(scope="module")
def jax_chain(ef):
    """JAX's stem output and every block's three points, each block on the
    previous block's JAX output."""
    jq = _jnp(ef["jq_bb"])
    st = jq["stem"]
    mult, shift = st["bn"]
    y = jax.lax.conv_general_dilated(jnp.asarray(ef["norm"]), st["kernel"] * mult, (2, 2), [(1, 1), (1, 1)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    x_q = je8._clip8(je8._silu(y + shift) * st["inv"])
    stem, blocks = np.asarray(x_q), []
    for m, blk in zip(je8.block_meta(), jq["blocks"]):
        pts = _jax_points(blk, m, x_q)
        blocks.append((np.asarray(x_q),) + tuple(np.asarray(p) for p in pts))
        x_q = pts[2]
    return stem, blocks


def _flips(got, want):
    d = np.abs(_np(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return int(d.max()) if d.size else 0, float((d > 0).mean())


def test_stem_and_requant_points_match_jax(ef, jax_chain):
    """The f32 stem quantized within one step of JAX's (its 27-term sums in
    another order: printed); per block, from JAX's own inputs: ``.e`` and
    ``.out`` equal, ``.d`` at most one step apart on at most SE_FLIP_SHARE."""
    q = load_efficientnet_qtree(ef["jq_bb"], device="cpu")
    stem_want, blocks = jax_chain
    step, share = _flips(efficientnet_int8.stem_int8(q["stem"], torch.from_numpy(ef["norm"])), stem_want)
    print(f"stem: max {step} step, share {share:.3g}")
    assert step <= 1 and share <= SE_FLIP_SHARE
    worst = 0.0
    for m, blk, (x_in, e_q, d_q, out_q) in zip(efficientnet_int8.block_meta(), q["blocks"], blocks):
        t = lambda a: torch.from_numpy(np.array(a))
        assert np.array_equal(_np(efficientnet_int8.expand_i8(blk, t(x_in))), e_q), m["name"]
        step, share = _flips(efficientnet_int8.dw_se_i8(blk, m["stride"], t(e_q)), d_q)
        worst = max(worst, share)
        assert step <= 1 and share <= SE_FLIP_SHARE, (m["name"], step, share)
        assert np.array_equal(_np(efficientnet_int8.project_i8(blk, m["stride"], t(d_q), t(x_in))), out_q), m["name"]
    print(f".d points: worst share of one-step flips {worst:.3g} over the 16 blocks")


def test_whole_ladder_c3_c5_match_jax(ef):
    """Through the whole ladder on the JAX qtree: the scales equal, C3..C5
    within cosine 1 - 1e-6 of JAX's op-by-op ladder (a flip at the stem or
    a ``.d`` point carries on; the flips printed); the dequantized
    endpoints in ``compute_dtype`` as JAX forms them."""
    q = load_efficientnet_qtree(ef["jq_bb"], device="cpu")
    got, scales = efficientnet_int8.efficientnet_int8_forward(q, torch.from_numpy(ef["norm"]), torch.float32,
                                                             dequant=False)
    assert [float(s) for s in scales] == [float(s) for s in ef["feat_scales"]]
    for i, (g, w) in enumerate(zip(got, ef["feats_q"])):
        step, share = _flips(g, w)
        cos = cosine(g.float(), w.astype(np.float32))
        print(f"C{i + 3} {w.shape}: max {step} step, share {share:.3g}, cosine {cos:.9f}")
        assert g.dtype == torch.int8 and tuple(g.shape) == w.shape and cos >= 1 - 1e-6
    deq = efficientnet_int8.efficientnet_int8_forward(q, torch.from_numpy(ef["norm"]), torch.float32)
    assert all(torch.equal(d, g.float() * s) for d, g, s in zip(deq, got, scales))


def test_fpn_and_head_on_jax_c3_c5_match_jax(ef):
    """The classic FPN bit-exact on JAX's C3..C5 (laterals of 40, 112, 320
    channels); the FCOSHead's 40 int8 tower stages equal op by op and its
    maps within rtol 1e-5 (the ResNet-50 FCOS's contract, tests/test_torch_port_fcos.py)."""
    fpn = load_fpn_classic_qtree(ef["jq_fpn"], "cpu")
    assert [fpn[f"lateral{i}"]["w"].shape[1] for i in (3, 4, 5)] == [40, 112, 320]
    levels, scales = fcos_int8.fpn_classic_int8_forward(fpn, [torch.from_numpy(f) for f in ef["feats_q"]],
                                                        dequant=False)
    want, _ = jf8.fpn_classic_int8_forward(_jnp(ef["jq_fpn"]), [jnp.asarray(f) for f in ef["feats_q"]],
                                           dequant=False)
    for got_l, want_l in zip(levels, want):
        assert np.array_equal(_np(got_l), np.asarray(want_l))
    assert [float(s) for s in scales] == [float(s) for s in ef["level_scales"]]
    head = load_fcoshead_qtree(ef["jq_head"], "cpu")
    jh = _jnp(ef["jq_head"])
    for i, x in enumerate(want):
        for branch in "cr":
            ours, theirs = torch.from_numpy(np.array(x)), x
            for j in range(fcos_int8.FCOS_TOWER):
                ours = fcos_int8.fcoshead_tower_i8(head, head["levels"][i], ours, branch, j)
                lv = jh["levels"][i]
                z = jf8._conv_i8(theirs, jh[f"w{branch}{j}"], pad=1) * lv[f"A{branch}{j}"]
                theirs = jf8._clip8(jf8._gn(z, *jh[f"gn{branch}{j}"], act="relu") * lv[f"inv_{branch}{j}"])
                assert np.array_equal(_np(ours), np.asarray(theirs)), (i, branch, j)
    got = fcos_int8.fcoshead_int8_forward(head, [torch.from_numpy(np.array(x)) for x in want])
    ref = jf8.fcoshead_int8_forward(jh, list(want))
    for g_b, w_b in zip(got, ref):
        for g, w in zip(g_b, w_b):
            w = np.asarray(w)
            np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


def test_calibrate_and_quantize_fpn_and_head_match_jax(ef):
    """The classic FPN and FCOSHead quantized on the EfficientNet's C3..C5:
    taps within rtol 1e-5 of JAX's, the qtrees as JAX's."""
    model = ef["model"]
    assert_taps(fcos_int8.calibrate_fpn_classic(model.fpn, [torch.from_numpy(f) for f in ef["feats"]]),
                ef["fpn_taps"])
    got = fcos_int8.quantize_fpn_classic(model.fpn, ef["fpn_taps"], [torch.from_numpy(s) for s in ef["feat_scales"]])
    assert_same_qtree(got, load_fpn_classic_qtree(ef["jq_fpn"], "cpu"))
    assert_taps(fcos_int8.calibrate_fcoshead(model.head, [torch.from_numpy(lv) for lv in ef["cal_levels"]]),
                ef["head_taps"])
    got = fcos_int8.quantize_fcoshead(model.head, ef["head_taps"], [torch.from_numpy(s) for s in ef["level_scales"]],
                                      NUM_CLASSES)
    assert_same_qtree(got, load_fcoshead_qtree(ef["jq_head"], "cpu"))


# ---------------------------------------------------------------- (d)

LADDERS = {"int8_backbone": dict(int8_fpn=False), "int8_fpn": dict(int8_fpn=True, int8_head=False),
           "full": dict(int8_fpn=True, int8_head=True)}


@pytest.fixture(scope="module")
def qtrees(ef):
    bb = load_efficientnet_qtree(ef["jq_bb"], device="cpu")
    fpn = load_fpn_classic_qtree(ef["jq_fpn"], "cpu")
    head = load_fcoshead_qtree(ef["jq_head"], "cpu")
    return {"int8_backbone": bb, "int8_fpn": {"backbone": bb, "fpn": fpn},
            "full": {"backbone": bb, "fpn": fpn, "head": head}}


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_make_eval_forward_int8_matches_jax(ef, qtrees, ladder):
    """``make_eval_forward_int8`` on the JAX qtrees against the JAX function
    run op by op, f32: cosine >= 0.9999 per level and branch (as the
    ResNet-50 FCOS); ``backend`` does not reach the EfficientNet ladder."""
    from pytorch_object_detection_tpu.train import trainer as jt

    kw = LADDERS[ladder]
    jq = {"int8_backbone": ef["jq_bb"], "int8_fpn": {"backbone": ef["jq_bb"], "fpn": ef["jq_fpn"]},
          "full": {"backbone": ef["jq_bb"], "fpn": ef["jq_fpn"], "head": ef["jq_head"]}}[ladder]
    jfwd = jt.make_eval_forward_int8(ef["jm"], compute_dtype=jnp.float32, backend="xla", **kw)
    want = jfwd(_jnp(jq), ef["params"], ef["stats"], jnp.asarray(ef["norm"]))
    model = ef["model"]
    got = trainer.make_eval_forward_int8(model, torch.float32, backend="xla", **kw)(qtrees[ladder],
                                                                                  torch.from_numpy(ef["norm"]))
    block = trainer.make_eval_forward_int8(model, torch.float32, backend="pallas_block", **kw)(
        qtrees[ladder], torch.from_numpy(ef["norm"]))
    for b, name in enumerate(("cls", "cnt", "reg")):
        for i, (g, w) in enumerate(zip(got[b], want[b])):
            cos = cosine(g, w)
            print(f"{ladder} {name} P{i + 3}: cosine {cos:.8f}")
            assert tuple(g.shape) == np.asarray(w).shape and g.dtype == torch.float32 and cos >= 0.9999
            assert torch.equal(g, block[b][i])


def test_make_eval_forward_int8_refuses_u8_input(ef):
    """JAX asserts that the EfficientNet ladder takes normalized floats; the
    port raises ``ValueError``, and so for the ResNet-only stems."""
    from pytorch_object_detection_tpu.train import trainer as jt

    with pytest.raises(AssertionError, match="ResNet-only"):
        jt.make_eval_forward_int8(ef["jm"], int8_fpn=True, int8_head=True, u8_input=True)
    for kw in (dict(u8_input=True), dict(direct_stem=True), dict(chain_segments=True)):
        with pytest.raises(ValueError, match="ResNet-only"):
            trainer.make_eval_forward_int8(ef["model"], torch.float32, int8_fpn=True, int8_head=True, **kw)


@pytest.fixture(scope="module")
def pipes(ef):
    """JAX's ``make_eval_pipeline_int8`` body (its defaults: the int8 FPN
    and head, the frames normalized first) run op by op on the fixture's
    JAX qtrees: the normalize, the forward, the decode.  (JAX's own
    function calibrates the FPN and head on its jitted ladder, which moves
    int8 values by a step: ROADMAP queue 3.)  The port's pipeline on its own
    f32 calibration and on those qtrees."""
    from pytorch_object_detection_tpu.train import trainer as jt

    jq = {"backbone": ef["jq_bb"], "fpn": ef["jq_fpn"], "head": ef["jq_head"]}
    x = (jnp.asarray(ef["frames"]).astype(jnp.float32) / 255.0 - jnp.asarray(IMAGENET_MEAN, jnp.float32)) \
        / jnp.asarray(IMAGENET_STD, jnp.float32)
    jfwd = jt.make_eval_forward_int8(ef["jm"], backend="xla", int8_fpn=True, int8_head=True, u8_input=False)
    maps = jfwd(_jnp(jq), ef["params"], ef["stats"], x)
    dets = jpost.decode_detections(*maps, STRIDES, 0.05, 0.6, 1000, (CANVAS, CANVAS))
    args = (ef["model"], torch.from_numpy(ef["norm"]), STRIDES, (CANVAS, CANVAS))
    own = make_eval_pipeline_int8(*args, compute_dtype=torch.float32)
    same = make_eval_pipeline_int8(*args, compute_dtype=torch.float32)
    same.qtree = {"backbone": load_efficientnet_qtree(jq["backbone"], device="cpu"),
                  "fpn": load_fpn_classic_qtree(jq["fpn"], "cpu"),
                  "head": load_fcoshead_qtree(jq["head"], "cpu")}
    return dict(args=args, own=own, same=same, x=np.asarray(x), maps=tuple([np.asarray(t) for t in b] for b in maps),
                dets=[np.asarray(t) for t in dets])


def test_int8_pipeline_keeps_the_jax_gate(ef, pipes):
    """``make_eval_pipeline_int8(FCOS on EfficientNet)``: the int8 FPN and
    head by default, from the uint8 frames normalized in f32 first (no
    uint8 stem); ``int8_head=False`` the float head behind the int8 FPN;
    ``int8_fpn=False`` the int8 backbone into the float FPN; each the maps
    of ``make_eval_forward_int8`` on its qtree; ``fused_head`` refused; the
    float pipeline runs."""
    own, args = pipes["own"], pipes["args"]
    frames = torch.from_numpy(ef["frames"])
    assert sorted(own.qtree) == ["backbone", "fpn", "head"] and not own.u8_input
    np.testing.assert_allclose(_np(own._input(frames)), pipes["x"], rtol=1e-6, atol=1e-6)
    for kw, ladder in ((dict(int8_head=False), "int8_fpn"), (dict(int8_fpn=False), "int8_backbone")):
        pipe = make_eval_pipeline_int8(*args, compute_dtype=torch.float32, **kw)
        assert not pipe.u8_input and ("blocks" in pipe.qtree) == (ladder == "int8_backbone")
        want = trainer.make_eval_forward_int8(ef["model"], torch.float32, **LADDERS[ladder])(pipe.qtree,
                                                                                            pipe._input(frames))
        before = groupnorm_act.launches
        for a_b, b_b in zip(pipe.forward_levels(frames), want):
            assert all(torch.equal(a, b) for a, b in zip(a_b, b_b))
        assert groupnorm_act.launches == before  # the plain GroupNorm on the CPU: no launch counted
    with pytest.raises(ValueError, match="fused_head"):
        make_eval_pipeline_int8(*args, fused_head=True, compute_dtype=torch.float32)
    dets = make_eval_pipeline(ef["model"], STRIDES, (CANVAS, CANVAS), compute_dtype=torch.float32)(frames)
    assert bool(torch.isfinite(dets.boxes).all()) and all(int(n) > 0 for n in dets.valid.sum(dim=1))


def test_int8_pipeline_matches_jax_body(ef, pipes):
    """On the JAX pipeline's own qtree the port's pipeline gives JAX's maps
    (cosine >= 1 - 1e-6: the stem's and SE's one-step flips carry on, test
    (c)) and its detections: the same kept count per image, each JAX
    detection with a port one of its class within 1e-3 of its score and
    0.05 pixels of its box.  The pipeline's own f32 calibration gives JAX's
    backbone qtree (but for the BN-fold flips)."""
    frames = torch.from_numpy(ef["frames"])
    assert_same_qtree(pipes["own"].qtree["backbone"], pipes["same"].qtree["backbone"], FOLD_FLIP_SHARE)
    levels = pipes["same"].forward_levels(frames)
    for b, branch in enumerate(("cls", "cnt", "reg")):
        coses = [cosine(g, w) for g, w in zip(levels[b], pipes["maps"][b])]
        print(f"{branch}: cosine per level {', '.join(f'{c:.9f}' for c in coses)}")
        assert min(coses) >= 1 - 1e-6
    scores, classes, boxes, valid = (_np(t) for t in pipes["same"](frames))
    w_scores, w_classes, w_boxes, w_valid = pipes["dets"]
    for b in range(BATCH):
        g, w = valid[b], w_valid[b]
        assert g.sum() == w.sum() > 0, (b, g.sum(), w.sum())
        same = ((classes[b][g][None, :] == w_classes[b][w][:, None])
                & (np.abs(scores[b][g][None, :] - w_scores[b][w][:, None]) <= 1e-3 * w_scores[b][w][:, None])
                & (np.abs(boxes[b][g][None, :, :] - w_boxes[b][w][:, None, :]).max(-1) <= 0.05))
        assert same.any(axis=1).all(), (b, int((~same.any(axis=1)).sum()))


# ---------------------------------------------------------------- (e)

@pytest.mark.parametrize("frozen_stages", [0, 1])
def test_param_labels_match_jax(ef, frozen_stages):
    """Leaf by leaf: every BatchNorm affine frozen, every conv (the stem's,
    the SE's) trainable, whatever ``frozen_stages`` says."""
    from pytorch_object_detection_tpu.train import trainer as jt

    flat = jax.tree_util.tree_flatten_with_path(jt.param_labels(ef["params"], True, frozen_stages))[0]
    want = {flax_to_torch_name(tuple(k.key for k in path)): v for path, v in flat}
    got = trainer.param_labels(ef["model"], True, frozen_stages)
    assert got == want
    assert got["backbone.stem_conv.weight"] == "train" and got["backbone.block3.se.fc1.bias"] == "train"
    assert got["backbone.stem_bn.weight"] == "freeze" and got["backbone.block15.bn2.bias"] == "freeze"


# ---------------------------------------------------------------- (f)

@pytest.mark.parametrize("fault", ["missing", "unused", "shape", "dtype"])
def test_efficientnet_qtree_loader_rejects_bad_trees(ef, fault):
    bad = jax.tree_util.tree_map(lambda a: a, ef["jq_bb"])
    blk = bad["blocks"][5]
    if fault == "missing":
        del blk["project"]["inv"]
    elif fault == "unused":
        blk["extra"] = np.zeros(3, np.float32)
    elif fault == "shape":
        blk["dw"]["A"] = np.zeros(7, np.float32)
    else:
        blk["expand"]["w"] = blk["expand"]["w"].astype(np.float32)
    with pytest.raises(KeyError if fault in ("missing", "unused") else ValueError):
        load_efficientnet_qtree(bad, device="cpu")
    with pytest.raises(KeyError):  # B0's tree is not B1's
        load_efficientnet_qtree(ef["jq_bb"], 1.0, 1.1, device="cpu")
