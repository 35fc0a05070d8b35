"""The classic FCOS in the port against the JAX package (CPU, f32): the float modules, the int8 ladder, a train step.

FCOS(20, 64) at the 128x128 canvas (C5 at 4x4), B=2, with a perturbed
variable tree (``torch_port_fixtures.perturbed_variables``):

  (a) the classic FPN, the FCOSHead and the whole forward against the flax
      modules on the same weights, within 1e-4 of the range
      (``assert_close_to_ref``);
  (b) ``calibrate_*``/``quantize_*`` against JAX's, and the qtrees carried
      across by ``train/checkpoints``;
  (c) ``fpn_classic_int8_forward`` bit-exact on the JAX-built qtree, and
      ``fcoshead_int8_forward``: every int8 tower stage equal op by op, the
      maps within rtol 1e-5;
  (d) ``make_eval_forward_int8`` for the three ladders, and the pipelines'
      FCOS gate (the JAX evaluator.py:337-347);
  (e) one f32 train step against JAX's (the train test's tolerances and
      its ``assert_step_matches``), the freeze set, the CLIs on the
      committed VOC tree, the qtree loaders' refusals.

The JAX int8 forwards run op by op, not under ``jax.jit`` (XLA fuses the
f32 epilogues under jit and moves int8 values by a step).  Serially about
90 s on one torch thread, most of it the JAX set-up, the JAX step's compile
and the CLIs' subprocesses.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.models import fcos_int8 as jf8
from pytorch_object_detection_tpu.models.heads import FCOSHead as JaxFCOSHead
from pytorch_object_detection_tpu.nn.fpn import FPN as JaxFPN
from pytorch_object_detection_tpu.nn.resnet import ResNet50 as JaxResNet50
from pytorch_object_detection_tpu_torch.eval.evaluator import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    make_eval_pipeline,
    make_eval_pipeline_int8,
)
from pytorch_object_detection_tpu_torch.models import fcos_int8
from pytorch_object_detection_tpu_torch.models.registry import available_models, build_model
from pytorch_object_detection_tpu_torch.ops.gn import groupnorm_act
from pytorch_object_detection_tpu_torch.train import trainer
from pytorch_object_detection_tpu_torch.train.checkpoints import (
    load_backbone_qtree,
    load_fcoshead_qtree,
    load_flax_variables,
    load_fpn_classic_qtree,
)
from test_torch_port_train import JaxRun, assert_step_matches, port_batch, port_state, run_port_steps
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
    check_family_clis,
    cosine,
    jax_model,
    nchw,
    nhwc,
    perturbed_variables,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree(t):
    return jax.tree_util.tree_map(np.array, t)  # writable copies


@pytest.fixture(scope="module")
def fc():
    """One perturbed FCOS in both packages, the float chain's JAX outputs
    and the JAX int8 qtrees with their calibration inputs and taps."""
    from pytorch_object_detection_tpu.train import trainer as jt

    params, stats = perturbed_variables(seed=30, model="FCOS")
    variables = {"params": params, "batch_stats": stats}
    x = np.random.default_rng(31).normal(size=(BATCH, CANVAS, CANVAS, 3)).astype(np.float32)
    bb = {"params": params["backbone"], "batch_stats": stats["backbone"]}
    taps = [np.asarray(t) for t in jax.jit(lambda v, x: JaxResNet50().apply(v, x, False))(bb, x)]
    levels = [np.asarray(t) for t in jax.jit(lambda v, f: JaxFPN(FEATURES).apply(v, f, False))(
        {"params": params["fpn"]}, taps)]
    head = jax.jit(lambda v, lv: JaxFCOSHead(NUM_CLASSES, FEATURES).apply(v, lv))({"params": params["head"]}, levels)
    jm = jax_model("FCOS")
    whole = jax.jit(lambda v, x: jm.apply(v, x, False))(variables, x)

    frames = np.random.default_rng(32).integers(0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)
    norm = ((frames.astype(np.float32) / np.float32(255.0) - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    jq_bb = jt.quantize_backbone(jm, variables, jnp.asarray(norm), compute_dtype=jnp.float32)
    feats_q, feat_scales = jax.jit(lambda im: jt._backbone_int8_feats(jm, jq_bb, im))(jnp.asarray(norm))
    feats = tuple(q.astype(jnp.float32) * s for q, s in zip(feats_q, feat_scales))
    fpn_taps = {k: float(v) for k, v in jax.jit(jf8.calibrate_fpn_classic)(params["fpn"], feats).items()}
    jq_fpn = jax.jit(jf8.quantize_fpn_classic)(params["fpn"], fpn_taps, feat_scales)  # as jt.quantize_fpn
    lq, lsc = jax.jit(lambda f: jf8.fpn_classic_int8_forward(jq_fpn, f, dequant=False))(feats_q)  # jt.quantize_head's
    cal_levels = tuple(q.astype(jnp.float32) * s for q, s in zip(lq, lsc))
    head_taps = {k: float(v) for k, v in jax.jit(jf8.calibrate_fcoshead)(params["head"], cal_levels).items()}
    jq_head = jf8.quantize_fcoshead(params["head"], head_taps, lsc, NUM_CLASSES)

    model = build_model("FCOS", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    return dict(params=params, stats=stats, x=x, taps=taps, levels=levels,
                head=tuple([np.asarray(t) for t in b] for b in head),
                whole=tuple([np.asarray(t) for t in b] for b in whole), frames=frames, norm=norm, model=model,
                jq_bb=_tree(jq_bb), jq_fpn=_tree(jq_fpn), jq_head=_tree(jq_head), feats_q=_tree(list(feats_q)),
                feat_scales=_tree(list(feat_scales)), feats=_tree(list(feats)), fpn_taps=fpn_taps,
                cal_levels=_tree(list(cal_levels)), level_scales=_tree(list(lsc)), head_taps=head_taps)


# ---------------------------------------------------------------- (a)

@pytest.fixture(scope="module")
def port_float(fc):
    model = fc["model"]
    with torch.no_grad():
        levels = model.fpn([nchw(t) for t in fc["taps"]])
        head = model.head([nchw(t) for t in fc["levels"]])
        whole = model(torch.from_numpy(fc["x"]))
    return {"levels": [nhwc(t) for t in levels], "head": tuple([nhwc(t) for t in b] for b in head),
            "whole": tuple([_np(t) for t in b] for b in whole)}


@pytest.mark.parametrize("level", range(5), ids=[f"P{i}" for i in range(3, 8)])
def test_fpn_levels_match_flax(fc, port_float, level):
    assert_close_to_ref(port_float["levels"][level], fc["levels"][level], f"P{level + 3}")


@pytest.mark.parametrize("which", ["head", "whole"])
def test_fcoshead_and_fcos_forward_match_flax(fc, port_float, which):
    """The FCOSHead on the JAX levels, and the whole FCOS forward on the same
    images, per level and branch (reg through ScaleExp), each within 1e-4 of
    its branch's range over the five levels (one shared head)."""
    scales = branch_scales(fc[which])
    for b, name in enumerate(("cls", "cnt", "reg")):
        for i, (got, want) in enumerate(zip(port_float[which][b], fc[which][b])):
            assert_close_to_ref(got, want, f"{which} {name} P{i + 3}", ref_scale=scales[b])


# ---------------------------------------------------------------- (b)

def test_calibrate_and_quantize_fpn_classic_match_jax(fc):
    """Taps within rtol 1e-5 of JAX's on the same f32 C3..C5; from the JAX
    taps, int8 weights identical and every scale and shift within rtol
    1e-5 (plus 1e-6 of the vector's range)."""
    fpn = fc["model"].fpn
    assert_taps(fcos_int8.calibrate_fpn_classic(fpn, [torch.from_numpy(f) for f in fc["feats"]]), fc["fpn_taps"])
    got = fcos_int8.quantize_fpn_classic(fpn, fc["fpn_taps"], [torch.from_numpy(s) for s in fc["feat_scales"]])
    assert_same_qtree(got, load_fpn_classic_qtree(fc["jq_fpn"], "cpu"))


def test_calibrate_and_quantize_fcoshead_match_jax(fc):
    head = fc["model"].head
    assert_taps(fcos_int8.calibrate_fcoshead(head, [torch.from_numpy(lv) for lv in fc["cal_levels"]]),
                fc["head_taps"])
    got = fcos_int8.quantize_fcoshead(head, fc["head_taps"], [torch.from_numpy(s) for s in fc["level_scales"]],
                                      NUM_CLASSES)
    want = load_fcoshead_qtree(fc["jq_head"], "cpu")
    assert got["num_classes"] == want["num_classes"] == NUM_CLASSES and len(want["levels"]) == 5
    assert isinstance(want["gnc0"], tuple)
    assert_same_qtree(got, want)


# ---------------------------------------------------------------- (c)

@pytest.fixture(scope="module")
def jax_levels_q(fc):
    """The JAX int8 P3..P7 of the JAX int8 C3..C5, op by op."""
    jq = jax.tree_util.tree_map(jnp.asarray, fc["jq_fpn"])
    levels, _ = jf8.fpn_classic_int8_forward(jq, [jnp.asarray(f) for f in fc["feats_q"]], dequant=False)
    return [np.asarray(lv) for lv in levels]


def test_fpn_classic_int8_forward_bit_exact_vs_jax(fc, jax_levels_q):
    q = load_fpn_classic_qtree(fc["jq_fpn"], "cpu")
    levels, scales = fcos_int8.fpn_classic_int8_forward(q, [torch.from_numpy(f) for f in fc["feats_q"]],
                                                        dequant=False)
    for i, (got, want) in enumerate(zip(levels, jax_levels_q)):
        n_diff = int((_np(got) != want).sum())
        print(f"P{i + 3} {want.shape}: {n_diff} int8 values differ, {float((want != 0).mean()):.3f} nonzero")
        assert got.dtype == torch.int8 and tuple(got.shape) == want.shape and n_diff == 0
    assert [float(s) for s in scales] == [float(s) for s in fc["level_scales"]]
    deq = fcos_int8.fpn_classic_int8_forward(q, [torch.from_numpy(f) for f in fc["feats_q"]], torch.float32)
    assert all(torch.equal(d, lv.float() * s) for d, lv, s in zip(deq, levels, scales))


def _jax_tower(q, lv, x, branch, j):
    z = jf8._conv_i8(x, q[f"w{branch}{j}"], pad=1) * lv[f"A{branch}{j}"]
    return jf8._clip8(jf8._gn(z, *q[f"gn{branch}{j}"], act="relu") * lv[f"inv_{branch}{j}"])


def test_fcoshead_int8_forward_matches_jax(fc, jax_levels_q):
    """On the JAX int8 levels: every int8 tower stage of every level (four
    cls, four reg) equal to JAX's op by op, each from its own previous stage,
    and the maps (cls, cnt, reg through ScaleExp) within rtol 1e-5 of JAX's
    (measured on an x86-64 CPU: printed)."""
    q = load_fcoshead_qtree(fc["jq_head"], "cpu")
    qj = jax.tree_util.tree_map(jnp.asarray, fc["jq_head"])
    got = fcos_int8.fcoshead_int8_forward(q, [torch.from_numpy(lv) for lv in jax_levels_q])
    want = jf8.fcoshead_int8_forward(qj, [jnp.asarray(lv) for lv in jax_levels_q])
    stages = 0
    for i, x in enumerate(jax_levels_q):
        for branch in "cr":
            ours, theirs = torch.from_numpy(x), jnp.asarray(x)
            for j in range(fcos_int8.FCOS_TOWER):
                ours = fcos_int8.fcoshead_tower_i8(q, q["levels"][i], ours, branch, j)
                theirs = _jax_tower(qj, qj["levels"][i], theirs, branch, j)
                n_diff = int((_np(ours) != np.asarray(theirs)).sum())
                assert n_diff == 0, (i, branch, j, n_diff)
                stages += 1
    assert stages == 40
    for b, name in enumerate(("cls", "cnt", "reg")):
        for i, (g, w) in enumerate(zip(got[b], want[b])):
            w = np.asarray(w)
            print(f"{name} P{i + 3}: max err {float(np.abs(_np(g) - w).max() / np.abs(w).max()):.3g} of the range")
            np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


# ---------------------------------------------------------------- (d)

LADDERS = {"int8_backbone": dict(int8_fpn=False), "int8_fpn": dict(int8_fpn=True, int8_head=False),
           "full": dict(int8_fpn=True, int8_head=True, u8_input=True)}


@pytest.fixture(scope="module")
def qtrees(fc):
    bb = load_backbone_qtree(fc["jq_bb"], "cpu")
    fpn, head = load_fpn_classic_qtree(fc["jq_fpn"], "cpu"), load_fcoshead_qtree(fc["jq_head"], "cpu")
    return {"int8_backbone": bb, "int8_fpn": {"backbone": bb, "fpn": fpn},
            "full": {"backbone": bb, "fpn": fpn, "head": head}}


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_make_eval_forward_int8_matches_jax(fc, qtrees, ladder):
    """``make_eval_forward_int8(FCOS, backend="xla")`` on the JAX qtrees
    against the JAX function run op by op, f32: cosine >= 0.9999 per level
    and branch; ``"pallas_block"`` (every kernel's plain version on the
    CPU) equals ``"xla"``."""
    from pytorch_object_detection_tpu.train import trainer as jt

    kw = LADDERS[ladder]
    images = fc["frames"] if kw.get("u8_input") else fc["norm"]
    jq = {"int8_backbone": fc["jq_bb"], "int8_fpn": {"backbone": fc["jq_bb"], "fpn": fc["jq_fpn"]},
          "full": {"backbone": fc["jq_bb"], "fpn": fc["jq_fpn"], "head": fc["jq_head"]}}[ladder]
    jfwd = jt.make_eval_forward_int8(jax_model("FCOS"), compute_dtype=jnp.float32, backend="xla", **kw)
    want = jfwd(jax.tree_util.tree_map(jnp.asarray, jq), fc["params"], fc["stats"], jnp.asarray(images))
    model = fc["model"]
    got = trainer.make_eval_forward_int8(model, torch.float32, backend="xla", **kw)(qtrees[ladder],
                                                                                  torch.from_numpy(images))
    block = trainer.make_eval_forward_int8(model, torch.float32, backend="pallas_block", **kw)(
        qtrees[ladder], torch.from_numpy(images))
    for b, name in enumerate(("cls", "cnt", "reg")):
        for i, (g, w) in enumerate(zip(got[b], want[b])):
            cos = cosine(g, w)
            print(f"{ladder} {name} P{i + 3}: cosine {cos:.8f}")
            assert tuple(g.shape) == np.asarray(w).shape and g.dtype == torch.float32 and cos >= 0.9999
            assert torch.equal(g, block[b][i])


@pytest.mark.parametrize("gate", ["default", "int8_head=False", "int8_fpn=False"])
def test_int8_pipeline_fcos_gate(fc, qtrees, gate):
    """``make_eval_pipeline_int8(FCOS)`` follows the JAX gate: by default
    ``{"backbone", "fpn", "head"}`` from raw uint8 frames; ``int8_head=False``
    the int8 FPN into the float head (kernel B's plain version here);
    ``int8_fpn=False`` the int8 backbone alone from normalized frames; its
    maps are ``make_eval_forward_int8``'s on the pipeline's qtree, and on
    the JAX qtrees within cosine 0.9999 of the JAX function's.
    ``fused_head=True`` is refused."""
    gate_kw = {"default": {}, "int8_head=False": dict(int8_head=False), "int8_fpn=False": dict(int8_fpn=False)}[gate]
    model, norm = fc["model"], torch.from_numpy(fc["norm"])
    args = (model, norm, STRIDES, (CANVAS, CANVAS))
    pipe = make_eval_pipeline_int8(*args, compute_dtype=torch.float32, **gate_kw)
    ladder = {"default": "full", "int8_head=False": "int8_fpn", "int8_fpn=False": "int8_backbone"}[gate]
    keys = sorted(qtrees[ladder]) if ladder != "int8_backbone" else None
    assert (sorted(pipe.qtree) == keys) if keys else ("layer1_0" in pipe.qtree and "fpn" not in pipe.qtree)
    assert pipe.u8_input == (gate != "int8_fpn=False")
    frames = torch.from_numpy(fc["frames"])
    dets = pipe(frames)
    assert bool(torch.isfinite(dets.scores).all()) and all(int(n) > 0 for n in dets.valid.sum(dim=1))
    kw = dict(LADDERS[ladder], u8_input=pipe.u8_input)
    want = trainer.make_eval_forward_int8(model, torch.float32, **kw)(pipe.qtree, pipe._input(frames))
    for a_b, b_b in zip(pipe.forward_levels(frames), want):
        assert all(torch.equal(a, b) for a, b in zip(a_b, b_b))
    with pytest.raises(ValueError, match="fused_head"):
        make_eval_pipeline_int8(*args, fused_head=True, compute_dtype=torch.float32, **gate_kw)


def test_float_pipeline_and_entry_points(fc):
    """The float pipeline through the FCOSHead's 40 GroupNorms (kernel B's
    plain version on the CPU, no launch counted); the registry; the
    EfficientNet backbone built, its C3..C5 widths the FPN's laterals, and an
    unknown backbone refused."""
    model = fc["model"]
    pipe = make_eval_pipeline(model, STRIDES, (CANVAS, CANVAS), compute_dtype=torch.float32)
    before = groupnorm_act.launches
    dets = pipe(torch.from_numpy(fc["frames"]))
    assert groupnorm_act.launches == before
    assert tuple(dets.boxes.shape[:1]) == (BATCH,) and bool(torch.isfinite(dets.boxes).all())
    assert all(int(n) > 0 for n in dets.valid.sum(dim=1))
    assert {"FCOS", "MC_FCOS", "HISFCOS", "MNFCOS"} <= set(available_models())
    built = build_model("fcos", 5, 32, device="cpu", generator=torch.Generator().manual_seed(1))
    assert tuple(built.head.cls_pred.weight.shape) == (5, 32, 3, 3) and built.head.scale4.scale.item() == 1.0
    assert float(built.head.cls_pred.bias[0].detach()) == pytest.approx(-np.log(99.0))
    assert abs(float(built.head.cls_tower0.weight.detach().std()) - 0.01) < 2e-3
    assert float(built.fpn.down7.bias.detach().abs().max()) == 0
    assert built.fpn.down6.stride == (2, 2) and sum(1 for n, _ in built.head.named_modules() if "_gn" in n) == 8
    effnet = build_model("FCOS", 20, backbone="efficientnet-b0", device="cpu")
    assert effnet.backbone.endpoint_channels()[-3:] == (40, 112, 320)
    assert [getattr(effnet.fpn, f"lateral{i}").in_channels for i in (3, 4, 5)] == [40, 112, 320]
    with pytest.raises(ValueError, match="backbone"):
        build_model("FCOS", 20, backbone="efficientnet-b3", device="cpu")


# ---------------------------------------------------------------- (e)

TRAIN_STEPS = 2  # the second update carries the first's momentum


@pytest.fixture(scope="module")
def jax_fcos_step():
    return JaxRun("FCOS", 0, TRAIN_STEPS, seed=33)


def test_train_step_matches_jax(jax_fcos_step):
    """Two f32 SGD steps of FCOS(5, 64) from the same weights and batch,
    the momentum carried between them: after each, the loss, each trainable
    parameter's gradient and the updated parameters (the train test's
    tolerances: 5 % of a parameter's largest gradient, cosine 0.9999); the
    freeze set is JAX's ``param_labels``' (the stem and every BatchNorm);
    the GroupNorms launch no kernel under autograd."""
    from pytorch_object_detection_tpu.train import trainer as jt
    from pytorch_object_detection_tpu_torch.train.checkpoints import flax_to_torch_name

    run = jax_fcos_step
    state = port_state("FCOS", 0, run.params, run.stats)
    labels = jax.tree_util.tree_flatten_with_path(jt.param_labels(run.params, True, 0))[0]
    frozen = {flax_to_torch_name(tuple(k.key for k in path)) for path, v in labels if v == "freeze"}
    assert frozen == {n for n, lbl in trainer.param_labels(state.model, True, 0).items() if lbl == "freeze"}
    before = groupnorm_act.launches
    steps = run_port_steps(state, TRAIN_STEPS, port_batch(run))
    assert groupnorm_act.launches == before
    for i, (m, grads, after) in enumerate(steps):
        assert_step_matches(state, m, grads, after, run.losses[i], run.grads[i], run.after[i], f"FCOS step {i + 1}",
                            n_steps=i + 1)


def test_fcos_clis_train_and_evaluate(tmp_path):
    check_family_clis(tmp_path, "FCOS", STRIDES, [(-1, 64), (64, 128), (128, 256), (256, 512), (512, 9999999)],
                      ["--int8", "--device-resize"])


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_fcos_qtree_loaders_reject_bad_trees(fc, fault):
    for loader, tree, scope in ((load_fpn_classic_qtree, fc["jq_fpn"], "down7"),
                                (load_fcoshead_qtree, fc["jq_head"], None)):
        bad = jax.tree_util.tree_map(lambda a: a, tree)
        node = bad[scope] if scope else bad["levels"][2]
        if fault == "missing":
            del node["A" if scope else "Ar3"]
        elif fault == "unused":
            node["extra"] = np.zeros(3, np.float32)
        else:
            node["B" if scope else "Apc"] = np.zeros(7, np.float32)
        with pytest.raises(ValueError if fault == "shape" else KeyError):
            loader(bad, "cpu")
