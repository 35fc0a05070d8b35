"""RetinaNet in the port against the JAX package (CPU, f32): the anchor codec, the losses, the float model, the
int8 ladder, the pipelines, a train step and the CLIs.

RetinaNet(20, 64) at the 128x128 canvas (P3..P7 at 16x16 down to 1x1, 3,069
anchors), B=2, with a perturbed variable tree
(``torch_port_fixtures.perturbed_variables``: the BatchNorms away from their
init, the subnets at their head init):

  (a) the codec: ``generate_anchors`` equal to JAX's; ``encode_targets`` with
      identical cls targets (the ignore band included) and loc within 1e-5 on
      a batch with padded, overlapping and tied GT; ``decode_anchor_detections``
      for both activations with identical top indices, classes and keep masks
      and boxes within 1e-5, on logits with ties and saturated sigmoids;
  (b) ``retinanet_loss`` and ``multibox_loss``: values and their gradients
      with respect to the logits and the loc predictions at f32 tolerance,
      with ties among the negatives' CE;
  (c) RetinaFPN's five levels and the whole ``(loc, cls)`` against
      ``model.apply``, within 1e-4 of the range;
  (d) the int8 ladder: the calibration taps and the quantized FPN and
      subnet trees against JAX's; every requant point of
      ``retinafpn_int8_forward`` and ``retinahead_int8_forward`` equal to
      JAX's op by op on the same qtree, loc and cls within rtol 1e-5; the int8
      model against the float one at the JAX test's cosines;
  (e) the float and int8 anchor pipelines against JAX's
      ``make_eval_pipeline_anchor`` and ``make_eval_pipeline_anchor_int8``
      (``backend="xla"``) on the same frames;
  (f) one f32 ``make_anchor_train_step`` (focal) against JAX's from one init,
      the CLIs on the committed VOC tree (``eval_coco --int8`` is
      tests/test_torch_port_coco.py's), the refusals, and the qtree loader's.

The JAX int8 FPN and subnets run op by op, not under ``jax.jit``.  Serially
about 90 s on one torch thread, most of it the JAX set-up, the JAX step's
compile and the CLIs' subprocesses.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.eval import evaluator as jev
from pytorch_object_detection_tpu.models import retinanet_int8 as jr8
from pytorch_object_detection_tpu.models.retinanet import RetinaFPN as JaxRetinaFPN
from pytorch_object_detection_tpu.ops import anchors as jan
from pytorch_object_detection_tpu_torch.eval.evaluator import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    make_default_pipeline,
    make_eval_pipeline_anchor,
    make_eval_pipeline_anchor_int8,
)
from pytorch_object_detection_tpu_torch.models import retinanet_int8
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.models.retinanet import STRIDES, RetinaFPN
from pytorch_object_detection_tpu_torch.ops import anchors
from pytorch_object_detection_tpu_torch.train import trainer
from pytorch_object_detection_tpu_torch.train.checkpoints import (
    flax_to_state_dict,
    flax_to_torch_name,
    load_flax_variables,
    load_retinanet_qtree,
)
from test_torch_port_train import assert_step_matches, jax_capture_state, numpy_batch, port_state, run_port_steps
from torch_port_fixtures import (
    BATCH,
    CANVAS,
    FEATURES,
    NUM_CLASSES,
    assert_close_to_ref,
    assert_same_qtree,
    assert_taps,
    cosine,
    jax_model,
    nchw,
    nhwc,
    perturbed_variables,
    run_cli,
    tiny_voc_config,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

HW = (CANVAS, CANVAS)
LEVEL_SHAPES = [(CANVAS // s, CANVAS // s) for s in STRIDES]
N_ANCHORS = 9 * sum(h * w for h, w in LEVEL_SHAPES)  # 3069


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree(t):
    return jax.tree_util.tree_map(np.array, t)  # writable copies


def _frames(seed):
    frames = np.random.default_rng(seed).integers(0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)
    norm = ((frames.astype(np.float32) / np.float32(255.0) - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    return frames, norm


@pytest.fixture(scope="module")
def rn():
    """One perturbed RetinaNet in both packages, the JAX float outputs and the
    JAX int8 trees step by step (its backbone calibrated in f32; JAX's own
    function takes ``quantize_backbone``'s bf16): the C3..C5 they give, the
    FPN taps and tree, its int8 levels op by op, the subnet taps and tree."""
    from pytorch_object_detection_tpu.nn.resnet_int8 import resnet50_int8_forward
    from pytorch_object_detection_tpu.train import trainer as jt

    params, stats = perturbed_variables(seed=50, model="RETINANET")
    variables = {"params": params, "batch_stats": stats}
    jm = jax_model("RETINANET")
    x = np.random.default_rng(51).normal(size=(BATCH, CANVAS, CANVAS, 3)).astype(np.float32)
    whole = jax.jit(lambda v, x: jm.apply(v, x, False))(variables, x)
    frames, norm = _frames(52)
    qbb = jt.quantize_backbone(jm, variables, jnp.asarray(norm), compute_dtype=jnp.float32)
    feats_q, scales = jax.jit(lambda im: resnet50_int8_forward(qbb, im, jnp.float32, dequant=False,
                                                               backend="xla"))(jnp.asarray(norm))
    feats = tuple(fq.astype(jnp.float32) * sc for fq, sc in zip(feats_q, scales))
    taps = {k: float(v) for k, v in jax.jit(jr8.calibrate_retinafpn)(params["fpn"], stats["fpn"], feats).items()}
    qf = jax.jit(jr8.quantize_retinafpn)(params["fpn"], stats["fpn"], taps, scales)
    levels_q, level_scales = jr8.retinafpn_int8_forward(qf, feats_q, dequant=False)
    levels = tuple(lv.astype(jnp.float32) * s for lv, s in zip(levels_q, level_scales))
    htaps = {k: float(v) for k, v in jax.jit(jr8.calibrate_retinahead)(params, levels).items()}
    qh = jr8.quantize_retinahead(params, htaps, level_scales)
    model = build_model("RETINANET", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    return dict(params=params, stats=stats, variables=variables, jm=jm, x=x, whole=[np.asarray(t) for t in whole],
                frames=frames, norm=norm, model=model, qbb=_tree(qbb), feats_q=_tree(list(feats_q)),
                feat_scales=_tree(list(scales)), feats=_tree(list(feats)), taps=taps, qf=_tree(qf),
                levels_q=_tree(list(levels_q)), level_scales=_tree(list(level_scales)), levels=_tree(list(levels)),
                htaps=htaps, qh=_tree(qh))


# ---------------------------------------------------------------- (a) the codec

@pytest.mark.parametrize("canvas", [(128, 128), (512, 512), (384, 640)], ids=["128", "512", "384x640"])
def test_generate_anchors_match_jax(canvas):
    shapes = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in STRIDES]
    got = anchors.generate_anchors(shapes, STRIDES)
    want = np.asarray(jan.generate_anchors(shapes, STRIDES))
    assert got.dtype == torch.float32 and got.shape == want.shape and np.array_equal(_np(got), want)
    assert build_model("RETINANET", 3, 8, device="cpu").level_shapes(canvas) == shapes


def gt_case():
    """[3, 8] GT boxes (-1 padded): overlapping boxes, two identical boxes with
    different labels (a tie, the first wins), a box matching an anchor
    exactly, an image with none."""
    boxes = np.full((3, 8, 4), -1.0, np.float32)
    labels = np.full((3, 8), -1, np.int32)
    boxes[0, :4] = [[10, 12, 60, 70], [30, 30, 90, 100], [30, 30, 90, 100], [0, 0, 127, 127]]
    labels[0, :4] = [3, 7, 9, 1]
    a = np.asarray(jan.generate_anchors(LEVEL_SHAPES, STRIDES))
    boxes[1, :2] = [a[40], [64, 64, 120, 110]]
    labels[1, :2] = [5, 20]
    return boxes, labels


def test_encode_targets_match_jax():
    boxes, labels = gt_case()
    a = anchors.generate_anchors(LEVEL_SHAPES, STRIDES)
    for pos, neg in ((0.5, 0.4), (0.5, 0.5)):
        loc, cls = anchors.encode_targets(a, torch.from_numpy(boxes), torch.from_numpy(labels), pos, neg)
        jloc, jcls = jan.encode_targets(jnp.asarray(_np(a)), jnp.asarray(boxes), jnp.asarray(labels), pos, neg)
        jloc, jcls = np.asarray(jloc), np.asarray(jcls)
        assert cls.dtype == torch.int32 and np.array_equal(_np(cls), jcls)
        counts = {v: int((jcls == v).sum()) for v in (-1, 0)}
        print(f"pos {pos} neg {neg}: {int((jcls > 0).sum())} positive, {counts[-1]} ignored, {counts[0]} negative")
        assert (jcls[:2] > 0).sum() > 0 and (jcls == 9).sum() == 0 and (jcls[2] == 0).all()  # the tie: label 7
        assert ((jcls == -1).sum() > 0) == (neg < pos)
        np.testing.assert_allclose(_np(loc), jloc, rtol=1e-5, atol=1e-5)


def decode_case(activation, seed=60):
    """(loc [2, N, 4], logits [2, N, C]) with exact ties (repeated rows) and,
    for the sigmoid, saturated logits (30 and 40 give one probability)."""
    rng = np.random.default_rng(seed)
    c = NUM_CLASSES + (activation == "softmax_bg0")
    loc = (rng.normal(size=(2, N_ANCHORS, 4)) * 0.3).astype(np.float32)
    logits = rng.normal(-3.0, 1.5, (2, N_ANCHORS, c)).astype(np.float32)
    logits[:, 99, 5] = 6.0
    logits[:, 100:140] = logits[:, 99:100]  # 40 rows tied with row 99, at the top of the sort
    logits[0, 500:520] = 2.0
    if activation == "sigmoid":
        logits[1, 10:30, 4] = 30.0
        logits[1, 10:30, 2] = 40.0  # saturated: the first class of the max wins (class 3)
    return loc, logits


@pytest.mark.parametrize("activation", ["sigmoid", "softmax_bg0"])
def test_decode_anchor_detections_match_jax(activation):
    loc, logits = decode_case(activation)
    a = anchors.generate_anchors(LEVEL_SHAPES, STRIDES)
    got = anchors.decode_anchor_detections(a, torch.from_numpy(loc), torch.from_numpy(logits), activation, 0.05,
                                           0.5, 1000, HW)
    want = [np.asarray(t) for t in jan.decode_anchor_detections(jnp.asarray(_np(a)), jnp.asarray(loc),
                                                                 jnp.asarray(logits), activation, 0.05, 0.5, 1000, HW)]
    scores, classes, boxes, valid = (_np(t) for t in got)
    # the top indices: the decoded box of a position names its anchor (the anchors are distinct)
    np.testing.assert_allclose(scores, want[0], rtol=1e-6, atol=0)
    assert np.array_equal(classes, want[1]) and np.array_equal(valid, want[3])
    np.testing.assert_allclose(boxes, want[2], rtol=1e-5, atol=1e-5)
    order = torch.sort(-torch.tensor(want[0]), dim=1, stable=True).indices
    assert torch.equal(order, torch.arange(1000).expand(2, -1))  # JAX's top-k is sorted, ties in index order
    n_tied = int((np.diff(want[0], axis=1) == 0).sum())
    print(f"{activation}: kept {valid.sum(1)}, {n_tied} tied neighbours")
    assert n_tied >= 2 * 40
    if activation == "sigmoid":
        assert (classes[1][scores[1] == 1.0] == 3).all() and (scores[1] == 1.0).sum() >= 20


def test_decode_with_kernel_a_wrapper_matches_plain():
    """On CPU tensors the kernel-A wrapper takes the plain NMS: the same keep mask."""
    loc, logits = decode_case("sigmoid", seed=61)
    a = anchors.generate_anchors(LEVEL_SHAPES, STRIDES)
    args = (a, torch.from_numpy(loc), torch.from_numpy(logits), "sigmoid", 0.05, 0.5, 1000, HW)
    assert all(torch.equal(x, y) for x, y in zip(anchors.decode_anchor_detections(*args),
                                                 anchors.decode_anchor_detections(*args, plain=True)))
    with pytest.raises(ValueError, match="activation"):
        anchors.decode_anchor_detections(*args[:3], "softmax")


# ---------------------------------------------------------------- (b) the losses

def loss_case(loss, seed=70):
    """Logits, loc predictions and targets from encode_targets on the GT case;
    for the MultiBox loss many negatives share one CE (identical logit rows),
    so the mining's ranking meets ties."""
    rng = np.random.default_rng(seed)
    boxes, labels = gt_case()
    a = jan.generate_anchors(LEVEL_SHAPES, STRIDES)
    pos, neg = (0.5, 0.4) if loss == "focal" else (0.5, 0.5)
    loc_t, cls_t = (np.asarray(t) for t in jan.encode_targets(a, jnp.asarray(boxes), jnp.asarray(labels), pos, neg))
    c = NUM_CLASSES + (loss == "multibox")
    logits = rng.normal(0.0, 2.0, (3, N_ANCHORS, c)).astype(np.float32)
    if loss == "multibox":
        logits[:, 1000:2000] = logits[:, 999:1000]  # 1000 negatives with one CE
    loc_p = (loc_t + rng.normal(0.0, 0.3, loc_t.shape)).astype(np.float32)
    return logits, loc_p, cls_t, loc_t


@pytest.mark.parametrize("loss", ["focal", "multibox"])
def test_losses_and_grads_match_jax(loss):
    logits, loc_p, cls_t, loc_t = loss_case(loss)

    def jax_losses(lg, lp):
        if loss == "focal":
            return jan.retinanet_loss(lg, lp, jnp.asarray(cls_t), jnp.asarray(loc_t), NUM_CLASSES)
        return jan.multibox_loss(lg, lp, jnp.asarray(cls_t), jnp.asarray(loc_t))

    want = {k: float(v) for k, v in jax_losses(jnp.asarray(logits), jnp.asarray(loc_p)).items()}
    g_lg, g_lp = jax.grad(lambda lg, lp: jax_losses(lg, lp)["total"], argnums=(0, 1))(jnp.asarray(logits),
                                                                                     jnp.asarray(loc_p))
    lg, lp = torch.from_numpy(logits).requires_grad_(), torch.from_numpy(loc_p).requires_grad_()
    ct, lt = torch.from_numpy(cls_t), torch.from_numpy(loc_t)
    got = (anchors.retinanet_loss(lg, lp, ct, lt, NUM_CLASSES) if loss == "focal"
           else anchors.multibox_loss(lg, lp, ct, lt))
    got["total"].backward()
    for k, v in want.items():
        assert abs(float(got[k].detach()) - v) <= 2e-6 * abs(v) + 1e-7, (k, float(got[k].detach()), v)
    for name, g, w in (("logits", lg.grad, g_lg), ("loc", lp.grad, g_lp)):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-6 * float(np.abs(w).max()), err_msg=name)
        assert (_np(g) != 0).sum() == (w != 0).sum(), name  # the same anchors get a gradient
    print(f"{loss}: {want}")


# ---------------------------------------------------------------- (c) the float model

def test_retinafpn_matches_flax(rn):
    rng = np.random.default_rng(80)
    feats = [rng.normal(size=(BATCH, CANVAS // s, CANVAS // s, c)).astype(np.float32)
             for s, c in ((8, 512), (16, 1024), (32, 2048))]
    want = JaxRetinaFPN(FEATURES).apply({"params": rn["params"]["fpn"], "batch_stats": rn["stats"]["fpn"]}, feats,
                                        False)
    fpn = load_flax_variables(RetinaFPN((512, 1024, 2048), FEATURES), rn["params"]["fpn"], rn["stats"]["fpn"]).eval()
    with torch.no_grad():
        got = fpn([nchw(f) for f in feats])
    assert len(got) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_to_ref(nhwc(g), np.asarray(w), f"P{i + 3}")


def test_retinanet_forward_matches_flax(rn):
    with torch.no_grad():
        loc, cls = rn["model"](torch.from_numpy(rn["x"]))
    assert tuple(loc.shape) == (BATCH, N_ANCHORS, 4) and tuple(cls.shape) == (BATCH, N_ANCHORS, NUM_CLASSES)
    assert_close_to_ref(loc, rn["whole"][0], "loc")
    assert_close_to_ref(cls, rn["whole"][1], "cls")


def test_flax_names_map_onto_the_port():
    """The BN scopes of RetinaFPN map onto the BatchNorm buffers, SubNet's convs
    keep their names, and every flax leaf has one port tensor."""
    assert flax_to_torch_name(("fpn", "p5_1_bn", "bn", "scale")) == "fpn.p5_1_bn.weight"
    assert flax_to_torch_name(("fpn", "p5_1_bn", "bn", "mean")) == "fpn.p5_1_bn.running_mean"
    assert flax_to_torch_name(("fpn", "p5_1_conv", "conv", "kernel")) == "fpn.p5_1_conv.weight"
    assert flax_to_torch_name(("classification", "out", "conv", "bias")) == "classification.out.bias"
    params, stats = perturbed_variables(seed=81, model="RETINANET")
    model = build_model("RETINANET", NUM_CLASSES, FEATURES, device="cpu")
    assert sorted(flax_to_state_dict(params, stats)) == sorted(model.state_dict())


# ---------------------------------------------------------------- (d) the int8 ladder

# The BatchNorm folds into each RetinaFPN kernel through rsqrt, whose XLA:CPU
# value can be an ulp off torch's: a folded weight within an ulp of a rounding
# boundary then quantizes one step apart (the MC_FCOS blocks' FOLD_FLIP_SHARE)
FOLD_FLIP_SHARE = 1e-5


def test_calibrate_and_quantize_match_jax(rn):
    """FPN and subnet taps within rtol 1e-5 of JAX's on the same f32 inputs;
    from the JAX taps, the int8 weights identical (but for FOLD_FLIP_SHARE's
    one-step flips in the FPN) and every scale and shift within rtol 1e-5."""
    model = rn["model"]
    assert_taps(retinanet_int8.calibrate_retinafpn(model.fpn, [torch.from_numpy(f) for f in rn["feats"]]), rn["taps"])
    assert_taps(retinanet_int8.calibrate_retinahead(model, [torch.from_numpy(f) for f in rn["levels"]]), rn["htaps"])
    want = load_retinanet_qtree({"backbone": rn["qbb"], "fpn": rn["qf"], "head": rn["qh"]}, "cpu")
    got_f = retinanet_int8.quantize_retinafpn(model.fpn, rn["taps"], [torch.from_numpy(s) for s in rn["feat_scales"]])
    assert_same_qtree(got_f, want["fpn"], int8_flip_share=FOLD_FLIP_SHARE)
    got_h = retinanet_int8.quantize_retinahead(model, rn["htaps"], [torch.from_numpy(s) for s in rn["level_scales"]])
    assert len(want["head"]["levels"]) == 5 and tuple(want["head"]["wpc"].shape) == (9 * NUM_CLASSES, 3, 3, FEATURES)
    assert_same_qtree(got_h, want["head"])


def _jax_fpn_points(q, feats_q):
    """The JAX ``retinafpn_int8_forward``'s requant points, op by op: t5, p5,
    m4, p4, m3, p3, p6, p7."""
    c3, c4, c5 = feats_q

    def rq(x, blk, pad=0, stride=1, partner=None, p_mul=None):
        y = jnp.maximum(jr8._conv_i8(x, blk["w"], pad=pad, stride=stride) * blk["A"] + blk["B"], 0.0)
        if partner is not None:
            y = y + partner.astype(jnp.float32) * p_mul
        return jr8._clip8(y)

    t5 = rq(c5, q["p5_1"])
    m4 = rq(c4, q["p4_1"], partner=jr8._up2(t5), p_mul=q["t5_to_m4"])
    m3 = rq(c3, q["p3_1"], partner=jr8._up2(m4), p_mul=q["m4_to_m3"])
    p6 = rq(c5, q["p6"], pad=1, stride=2)
    return dict(t5=t5, p5=rq(t5, q["p5_2"], pad=1), m4=m4, p4=rq(m4, q["p4_2"], pad=1), m3=m3,
                p3=rq(m3, q["p3_2"], pad=1), p6=p6, p7=rq(p6, q["p7"], pad=1, stride=2))


def test_retinafpn_int8_matches_jax(rn):
    """On the JAX int8 C3..C5 and FPN tree: every requant point equal to JAX's,
    op by op, and the five levels with their scales."""
    q = load_retinanet_qtree({"backbone": rn["qbb"], "fpn": rn["qf"], "head": rn["qh"]}, "cpu")["fpn"]
    qj = jax.tree_util.tree_map(jnp.asarray, rn["qf"])
    fq = [torch.from_numpy(f) for f in rn["feats_q"]]
    want = _jax_fpn_points(qj, [jnp.asarray(f) for f in rn["feats_q"]])
    c3, c4, c5 = fq
    rq = retinanet_int8._rq
    up = retinanet_int8.upsample2x_i8
    t5 = rq(c5, q["p5_1"])
    m4 = rq(c4, q["p4_1"], partner=up(t5), p_mul=q["t5_to_m4"])
    got = dict(t5=t5, m4=m4, m3=rq(c3, q["p3_1"], partner=up(m4), p_mul=q["m4_to_m3"]))
    levels, scales = retinanet_int8.retinafpn_int8_forward(q, fq, dequant=False)
    got.update(zip(("p3", "p4", "p5", "p6", "p7"), levels))
    for name, w in want.items():
        w = np.asarray(w)
        n_diff = int((_np(got[name]) != w).sum())
        print(f"{name} {w.shape}: {n_diff} int8 values differ, {float((w != 0).mean()):.3f} nonzero")
        assert got[name].dtype == torch.int8 and n_diff == 0, name
    assert [float(s) for s in scales] == [float(s) for s in rn["level_scales"]]
    deq = retinanet_int8.retinafpn_int8_forward(q, fq, torch.float32)
    assert all(torch.equal(d, lv.float() * s) for d, lv, s in zip(deq, levels, scales))


def test_retinahead_int8_matches_jax(rn):
    """On the JAX int8 levels and subnet tree: every tower stage equal to JAX's
    op by op (each from its own previous stage), loc and cls within rtol 1e-5."""
    q = load_retinanet_qtree({"backbone": rn["qbb"], "fpn": rn["qf"], "head": rn["qh"]}, "cpu")["head"]
    qj = jax.tree_util.tree_map(jnp.asarray, rn["qh"])
    for i, x in enumerate(rn["levels_q"]):
        lv, lvj = q["levels"][i], qj["levels"][i]
        for b in "cr":
            h, hj = torch.from_numpy(x), jnp.asarray(x)
            for j in range(4):
                z = retinanet_int8.conv_i8(h, q[f"w{b}{j}"]) * lv[f"A{b}{j}"] + lv[f"B{b}{j}"]
                h = retinanet_int8.clip8(torch.clamp(z, min=0.0))
                zj = jr8._conv_i8(hj, qj[f"w{b}{j}"], pad=1) * lvj[f"A{b}{j}"] + lvj[f"B{b}{j}"]
                hj = jr8._clip8(jnp.maximum(zj, 0.0))
                assert int((_np(h) != np.asarray(hj)).sum()) == 0, (i, b, j)
    got = retinanet_int8.retinahead_int8_forward(q, [torch.from_numpy(x) for x in rn["levels_q"]], 9, NUM_CLASSES)
    want = jr8.retinahead_int8_forward(qj, [jnp.asarray(x) for x in rn["levels_q"]], 9, NUM_CLASSES)
    for name, g, w in zip(("loc", "cls"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        print(f"{name}: max err {float(np.abs(_np(g) - w).max() / np.abs(w).max()):.3g} of the range")
        np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


def test_int8_close_to_float(rn):
    """The JAX test's contract (tests/test_retinanet_int8.py:47-49), on the
    port's own calibration (f32, the oracle backbone) on a normal draw: the
    int8 ladder's loc and cls against the float model's on another, loc
    cosine > 0.995, cls > 0.999."""
    model = rn["model"]
    calib = np.random.default_rng(53).normal(size=(BATCH, CANVAS, CANVAS, 3)).astype(np.float32)  # the JAX test's
    q = retinanet_int8.quantize_retinanet(model, torch.from_numpy(calib), "xla", torch.float32)
    assert sorted(q) == ["backbone", "fpn", "head"] and "stem_s2d" in q["backbone"]
    x = torch.from_numpy(rn["x"])
    loc_i, cls_i = retinanet_int8.retinanet_int8_forward(model, q, x, backend="xla")
    with torch.no_grad():
        loc_f, cls_f = model(x)
    c_loc, c_cls = cosine(loc_i, loc_f), cosine(cls_i, cls_f)
    print(f"int8 vs float: loc cosine {c_loc:.6f}, cls cosine {c_cls:.8f}")
    assert loc_i.shape == loc_f.shape and cls_i.shape == cls_f.shape
    assert c_loc > 0.995 and c_cls > 0.999


# ---------------------------------------------------------------- (e) the pipelines

@pytest.fixture(scope="module")
def pipes(rn):
    """JAX's float pipeline (jitted, f32) on the frames; JAX's int8 pipeline
    (``backend="xla"``) built by its own function, and its body run op by op
    on that function's qtree: the forward, then the anchor decode.  (Its
    jitted call is not the reference: XLA fuses the int8 epilogues under
    jit and moves int8 values by a step, which reorders hundreds of the
    1000 detections; ROADMAP queue 3.)"""
    frames = jnp.asarray(rn["frames"])
    jfloat = jev.make_eval_pipeline_anchor(rn["jm"], HW, compute_dtype=jnp.float32)
    jint8 = jev.make_eval_pipeline_anchor_int8(rn["jm"], rn["variables"], jnp.asarray(rn["norm"]), HW, backend="xla")
    free = dict(zip(jint8.__code__.co_freevars, (c.cell_contents for c in jint8.__closure__)))
    jq = _tree(free["qtree"])
    loc, cls = jr8.retinanet_int8_forward(rn["jm"], jax.tree_util.tree_map(jnp.asarray, jq), jnp.asarray(rn["norm"]),
                                          backend="xla")
    a = jan.generate_anchors(LEVEL_SHAPES, STRIDES)
    return dict(jfloat=[np.asarray(t) for t in jfloat(rn["params"], rn["stats"], frames)], jq=jq,
                jint8=[np.asarray(t) for t in jan.decode_anchor_detections(a, loc, cls, "sigmoid", 0.05, 0.5, 1000,
                                                                            HW)])


def _assert_same_detections(got, want, what, exact=True):
    """The kept detections of each image: with ``exact``, position by
    position (classes and keep masks identical, scores within rtol 1e-6,
    boxes within 1e-5 of the canvas); otherwise as sets (the same count, and
    each JAX detection has a port one of the same class, its score within
    rtol 1e-4 and its box within 0.05 pixels): f32 sums in another order can
    swap two near-tied scores in the sort, and a loc of ~10 (random weights)
    meets ``exp`` with its 1e-6 of rounding (measured on SSD300: 0.02 pixels,
    score 7e-6 relative)."""
    scores, classes, boxes, valid = (_np(t) for t in got)
    if exact:
        assert np.array_equal(valid, want[3]) and np.array_equal(classes[valid], want[1][valid]), what
        np.testing.assert_allclose(scores[valid], want[0][valid], rtol=1e-6, err_msg=what)
        np.testing.assert_allclose(boxes[valid], want[2][valid], rtol=0, atol=1e-5 * CANVAS, err_msg=what)
    for b in range(len(valid)):
        g, w = valid[b], want[3][b]
        assert g.sum() == w.sum(), (what, b)
        same = ((classes[b][g][None, :] == want[1][b][w][:, None])
                & (np.abs(scores[b][g][None, :] - want[0][b][w][:, None]) <= 1e-4 * want[0][b][w][:, None])
                & (np.abs(boxes[b][g][None, :, :] - want[2][b][w][:, None, :]).max(-1) <= 0.05))
        assert same.any(axis=1).all(), (what, b, int((~same.any(axis=1)).sum()))
    n_pos = int((valid == want[3]).all(axis=1).sum())
    print(f"{what}: {valid.sum(1)} kept, the same sets; keep masks identical on {n_pos} of {len(valid)} images")


def test_float_pipeline_matches_jax(rn, pipes):
    pipe = make_eval_pipeline_anchor(rn["model"], HW, compute_dtype=torch.float32)
    assert pipe.nms_plain and pipe.activation == "sigmoid" and tuple(pipe.anchors.shape) == (N_ANCHORS, 4)
    _assert_same_detections(pipe(torch.from_numpy(rn["frames"])), pipes["jfloat"], "float pipeline", exact=False)
    same = make_default_pipeline(rn["model"], STRIDES, HW, nms_iou=0.5)
    assert type(same) is type(pipe)
    with pytest.raises(ValueError, match="device resize"):
        make_default_pipeline(rn["model"], STRIDES, HW, device_resize=True)


def test_int8_pipeline_matches_jax(rn, pipes):
    """On the JAX pipeline's own qtree (carried across), the port's CPU path
    (``backend="xla"``) gives JAX's detections; on its own f32 calibration
    the loc and cls stay at the float contract's cosines to them."""
    frames = torch.from_numpy(rn["frames"])
    pipe = make_eval_pipeline_anchor_int8(rn["model"], torch.from_numpy(rn["norm"]), HW, backend="xla",
                                          compute_dtype=torch.float32)
    own = pipe.forward_levels(frames)
    pipe.qtree = load_retinanet_qtree(pipes["jq"], "cpu")
    _assert_same_detections(pipe(frames), pipes["jint8"], "int8 pipeline")
    same = pipe.forward_levels(frames)
    print(f"own calibration vs the JAX qtree: loc {cosine(own[0], same[0]):.6f}, cls {cosine(own[1], same[1]):.8f}")
    assert cosine(own[0], same[0]) > 0.995 and cosine(own[1], same[1]) > 0.999


# ---------------------------------------------------------------- (f) training, the CLIs

def test_anchor_train_step_matches_jax():
    """One f32 SGD step of RetinaNet(5, 64) (focal, 0.5/0.4) from the same
    weights and batch: the loss, each trainable parameter's gradient and the
    updated parameters (the train test's tolerances); the freeze set is JAX's
    (the stem and every BatchNorm)."""
    from pytorch_object_detection_tpu.train import trainer as jt

    n_classes = 5
    params, stats = perturbed_variables(82, "RETINANET", n_classes)
    state = jax_capture_state("RETINANET", 0, params, stats)
    a = jan.generate_anchors(LEVEL_SHAPES, STRIDES)
    step = jt.make_anchor_train_step(jax_model("RETINANET", n_classes), a, n_classes, jnp.float32, 0.5, 0.4,
                                     donate=False, loss="focal")
    images, boxes, labels = numpy_batch()
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(labels))
    want = ({k: float(v) for k, v in metrics.items()}, flax_to_state_dict(jax.device_get(state.opt_state[0])),
            flax_to_state_dict(jax.device_get(state.params)))
    port = port_state("RETINANET", 0, params, stats)
    jlabels = jax.tree_util.tree_flatten_with_path(jt.param_labels(params, True, 0))[0]
    frozen = {flax_to_torch_name(tuple(k.key for k in path)) for path, v in jlabels if v == "freeze"}
    assert frozen == {n for n, lbl in trainer.param_labels(port.model, True, 0).items() if lbl == "freeze"}
    pstep = trainer.make_anchor_train_step(port.model, torch.from_numpy(np.asarray(a)), n_classes, torch.float32,
                                           0.5, 0.4, "focal")
    before = {k: v.clone() for k, v in port.model.state_dict().items() if "running" in k}
    ((m, grads, after),) = run_port_steps(port, 1, tuple(torch.from_numpy(t) for t in (images, boxes, labels)),
                                          step=pstep)
    assert sorted(m) == ["cls", "reg", "total"]
    assert_step_matches(port, m, grads, after, *want, "RetinaNet focal step")
    assert all(torch.equal(v, port.model.state_dict()[k]) for k, v in before.items())
    with pytest.raises(ValueError, match="loss"):
        trainer.make_anchor_train_step(port.model, torch.zeros(1, 4), n_classes, loss="giou")


def _retina_config(tmp_path):
    cfg = tiny_voc_config(tmp_path, "RETINANET", STRIDES, [(-1, 64)] * 5)
    data = tmp_path / "RETINANET_data.yaml"
    data.write_text(data.read_text() + "  criterion : focal\n  pos_iou : 0.5\n  neg_iou : 0.4\n"
                    "  eval : {nms_iou: 0.5}\n")
    return cfg


def test_retinanet_clis(tmp_path, capsys):
    """``podt-torch-train --synthetic`` for two steps, then ``eval_voc`` of its
    checkpoint, float and ``--int8``, over the committed VOC tree; the
    refusals the JAX CLIs keep (``--ref-4stride``; here also the device
    resize, which the JAX dispatch asserts against) with exit 2."""
    cfg = _retina_config(tmp_path)
    run = run_cli(tmp_path, "train", "--config", cfg, "--device", "cpu", "--synthetic", "--steps", "2",
                  "--log-every", "1000")
    assert run.returncode == 0, run.stdout + run.stderr
    assert "training RETINANET on cpu" in run.stdout and "training done: step 2" in run.stdout
    ckpt = str(tmp_path / "checkpoint" / "retinanet")
    for flags in ([], ["--int8"]):
        run = run_cli(tmp_path, "eval_voc", "--config", cfg, "--split", "test", "--batch-size", "4", "--device",
                      "cpu", "--checkpoint", ckpt, *flags)
        assert run.returncode == 0, run.stderr[-3000:]
        lines = run.stdout.splitlines()
        assert lines[-1].startswith("mAP=====>") and sum(line.startswith("ap for ") for line in lines) == 20
    from pytorch_object_detection_tpu_torch.cli import eval_voc

    for flag in ("--ref-4stride", "--device-resize"):
        assert eval_voc.main(["--config", cfg, "--device", "cpu", flag]) == 2
        assert "RETINANET" in capsys.readouterr().err


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_retinanet_qtree_loader_rejects_bad_trees(rn, fault):
    bad = {"backbone": rn["qbb"], "fpn": _tree(rn["qf"]), "head": _tree(rn["qh"])}
    if fault == "missing":
        del bad["head"]["bc2"]
    elif fault == "unused":
        bad["fpn"]["p7"]["extra"] = np.zeros(3, np.float32)
    else:
        bad["head"]["levels"][4]["Ar1"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        load_retinanet_qtree(bad, "cpu")


def test_entry_points():
    built = build_model("retinanet", 5, 32, device="cpu", frozen_stages=1,
                        generator=torch.Generator().manual_seed(1))
    assert tuple(built.classification.out.weight.shape) == (45, 32, 3, 3)
    assert float(built.classification.out.bias.detach()[0]) == pytest.approx(-np.log(99.0))
    assert not built.backbone.grad_barrier_stages  # RetinaNet takes no frozen_stages: dropped, as JAX drops it
    with pytest.raises(ValueError, match="own ladder"):
        trainer.quantize_fpn(built, {}, torch.zeros(1, 64, 64, 3))
    with pytest.raises(ValueError, match="own ladder"):
        trainer.make_eval_forward_int8(built)
    with pytest.raises(ValueError, match="RetinaNet or an SSD300"):
        make_eval_pipeline_anchor(build_model("FCOS", 5, 32, device="cpu"), HW)
