"""MC_FCOS in the port against the JAX package (CPU, f32): the float modules, the int8 ladder, a train step.

MC_FCOS(20, 64) at the 128x128 canvas (C5 at 4x4, the four levels at
16x16 down to 2x2), B=2, with a perturbed variable tree
(``torch_port_fixtures.perturbed_variables``):

  (a) MCBlock (at its three input widths) and the whole MC_FCOS forward
      against the flax modules on the same weights, within 1e-4 of the range;
  (b) the neck/head calibration and quantization against JAX's, and the
      qtree carried across by ``train/checkpoints.load_mcfcos_qtree``;
  (c) the int8 MCBlocks, the four head inputs and every head tower stage
      equal to JAX's op by op, the maps within rtol 1e-5;
  (d) ``make_eval_pipeline_int8(MC_FCOS)`` against the JAX function's
      ladder on the CPU (``backend="xla"``, as the JAX function picks
      there): its gate, and its maps on the JAX qtree and on its own
      calibration;
  (e) the 4-stride decode and the ``len(strides) in (L, L-1)`` rule, one f32
      train step against JAX's, the CLIs on the committed VOC tree and the
      qtree loader's refusals.

The JAX int8 forwards run op by op, not under ``jax.jit``.  Serially about
90 s on one torch thread, most of it the JAX set-up, the JAX step's compile
and the CLIs' subprocesses.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.models import mcfcos_int8 as jm8
from pytorch_object_detection_tpu.models.mcfcos import MCBlock as JaxMCBlock
from pytorch_object_detection_tpu_torch.eval.evaluator import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    make_eval_pipeline,
    make_eval_pipeline_int8,
)
from pytorch_object_detection_tpu_torch.models import mcfcos_int8
from pytorch_object_detection_tpu_torch.models.mcfcos import STRIDES as MC_STRIDES
from pytorch_object_detection_tpu_torch.models.mcfcos import MCBlock
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.ops.gn import groupnorm_act
from pytorch_object_detection_tpu_torch.train import trainer
from pytorch_object_detection_tpu_torch.train.checkpoints import (
    flax_to_state_dict,
    flax_to_torch_name,
    load_backbone_qtree,
    load_flax_variables,
    load_mcfcos_qtree,
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
    branch_scales,
    check_family_clis,
    cosine,
    jax_model,
    nchw,
    nhwc,
    perturbed_variables,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

MC_RANGES = [(-1, 64), (64, 128), (128, 256), (256, 99999999)]  # config/voc.yaml's MC_FCOS block
MC_OPT = {"lr": 1e-8, "warmup_steps": 10}  # the two compared train steps' SGD (test_train_step_matches_jax)
# (block, input channels, concat parts): the three widths an MCBlock takes in the model
BLOCK_FORMS = [("ffm_mb1", FEATURES, 1), ("refine_mb1", 2 * FEATURES, 2), ("mb_top", 2048, 1)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree(t):
    return jax.tree_util.tree_map(np.array, t)  # writable copies


def _jax_frames(seed):
    frames = np.random.default_rng(seed).integers(0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)
    norm = ((frames.astype(np.float32) / np.float32(255.0) - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    return frames, norm


def jax_quantize_mcfcos(jm, variables, norm):
    """The JAX ``quantize_mcfcos`` step by step, its backbone calibrated in
    f32 (the JAX function takes ``quantize_backbone``'s bf16): the backbone
    qtree, the C3..C5 it gives, the neck/head taps and qtree."""
    from pytorch_object_detection_tpu.train import trainer as jt

    params, stats = variables["params"], variables["batch_stats"]
    qbb = jt.quantize_backbone(jm, variables, jnp.asarray(norm), compute_dtype=jnp.float32)
    feats_q, scales = jax.jit(lambda im: jt._backbone_int8_feats(jm, qbb, im))(jnp.asarray(norm))
    feats = tuple(fq.astype(jnp.float32) * sc for fq, sc in zip(feats_q, scales))
    taps = {k: float(v) for k, v in jax.jit(jm8.calibrate_mcfcos_neck_head)(params, stats, feats).items()}
    qnh = jax.jit(lambda p, s: jm8.quantize_mcfcos_neck_head(p, s, taps, scales, NUM_CLASSES))(params, stats)
    return qbb, feats_q, scales, feats, taps, qnh


@pytest.fixture(scope="module")
def mc():
    """One perturbed MC_FCOS in both packages, the JAX float outputs and the
    JAX int8 qtrees with their calibration inputs and taps."""
    params, stats = perturbed_variables(seed=40, model="MC_FCOS")
    variables = {"params": params, "batch_stats": stats}
    x = np.random.default_rng(41).normal(size=(BATCH, CANVAS, CANVAS, 3)).astype(np.float32)
    jm = jax_model("MC_FCOS")
    whole = jax.jit(lambda v, x: jm.apply(v, x, False))(variables, x)
    frames, norm = _jax_frames(42)
    qbb, feats_q, scales, feats, taps, qnh = jax_quantize_mcfcos(jm, variables, norm)
    model = build_model("MC_FCOS", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    return dict(params=params, stats=stats, variables=variables, x=x, jm=jm,
                whole=tuple([np.asarray(t) for t in b] for b in whole), frames=frames, norm=norm, model=model,
                jq_bb=_tree(qbb), jq_nh=_tree(qnh), feats_q=_tree(list(feats_q)), feat_scales=_tree(list(scales)),
                feats=_tree(list(feats)), taps=taps)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("form", BLOCK_FORMS, ids=[f[0] for f in BLOCK_FORMS])
def test_mcblock_matches_flax(mc, form):
    name, cin, _ = form
    p, s = mc["params"][name], mc["stats"][name]
    x = np.random.default_rng(cin).normal(size=(BATCH, 8, 8, cin)).astype(np.float32)
    want = jax.jit(lambda v, x: JaxMCBlock(FEATURES).apply(v, x, False))({"params": p, "batch_stats": s}, x)
    block = load_flax_variables(MCBlock(cin, FEATURES), p, s).eval()
    assert block.se.fc1.out_channels == cin // 2 // 6  # SE reduction 6
    with torch.no_grad():
        got = block(nchw(x))
    assert_close_to_ref(nhwc(got), np.asarray(want), name)


def test_mc_fcos_forward_matches_flax(mc):
    """The whole forward on the same images: four levels at strides 8..64,
    per level and branch (reg raw), each within 1e-4 of its branch's range
    over the levels (one shared head)."""
    with torch.no_grad():
        got = mc["model"](torch.from_numpy(mc["x"]))
    scales = branch_scales(mc["whole"])
    assert len(got[0]) == 4
    for b, name in enumerate(("cls", "cnt", "reg")):
        for i, (g, w) in enumerate(zip(got[b], mc["whole"][b])):
            assert tuple(g.shape[1:3]) == (CANVAS // MC_STRIDES[i],) * 2
            assert_close_to_ref(g, w, f"{name} level {i}", ref_scale=scales[b])


# ---------------------------------------------------------------- (b)

# The BatchNorm folds into each MCBlock conv's kernel through rsqrt, whose
# XLA:CPU value is up to 2 ulps off torch's (on 35 % of random inputs): a
# folded weight within an ulp of a rounding boundary then quantizes one step
# apart (measured: 2 of mb_top/pw1's 2 097 152 weights, printed).
FOLD_FLIP_SHARE = 1e-5


def test_calibrate_and_quantize_neck_head_match_jax(mc):
    """Taps within rtol 1e-5 of JAX's on the same f32 C3..C5; from the JAX
    taps, the int8 weights identical but for FOLD_FLIP_SHARE's one-step
    flips, every scale and shift within rtol 1e-5 (plus 1e-6 of the
    vector's range)."""
    model = mc["model"]
    assert_taps(mcfcos_int8.calibrate_mcfcos_neck_head(model, [torch.from_numpy(f) for f in mc["feats"]]), mc["taps"])
    got = mcfcos_int8.quantize_mcfcos_neck_head(model, mc["taps"], [torch.from_numpy(s) for s in mc["feat_scales"]],
                                                NUM_CLASSES)
    want = load_mcfcos_qtree(mc["jq_nh"], "cpu")
    assert got["num_classes"] == want["num_classes"] == NUM_CLASSES and len(want["levels"]) == 4
    assert isinstance(want["refine_mb2"]["pw1"]["A"], list) and len(want["refine_mb2"]["pw1"]["A"]) == 2
    assert_same_qtree(got, want, int8_flip_share=FOLD_FLIP_SHARE)


# ---------------------------------------------------------------- (c)

# mb_top's SE gate sums 1024 f32 products a term; XLA's conv and torch's
# matmul sum them in other orders (31 % of such sums an ulp apart), so a
# gated value on a rounding boundary moves one step, and pw3 and pw5 carry it
# on (measured: 10 of 8192 output values, one step, printed; 0 on the
# narrower blocks and on the fixture's ladder, test_neck_head_int8_matches_jax)
GATE_FLIPS = {"mb_top": (1, 5e-3)}  # block -> (max step, share of the outputs); the others exact


@pytest.mark.parametrize("form", BLOCK_FORMS, ids=[f[0] for f in BLOCK_FORMS])
def test_mcblock_int8_matches_jax(mc, form):
    """Each quantized MCBlock of the JAX qtree on random int8 parts (8x8):
    its output equal to the JAX ``_mcblock_i8``'s op by op (the SE gate in
    f32 from the exact int sum; the concat split along pw1's input
    channels), but for mb_top's one-step flips (GATE_FLIPS)."""
    name, cin, parts = form
    rng = np.random.default_rng(cin + parts)
    xs = [rng.integers(-127, 128, (BATCH, 8, 8, cin // parts)).astype(np.int8) for _ in range(parts)]
    q = load_mcfcos_qtree(mc["jq_nh"], "cpu")[name]
    qj = jax.tree_util.tree_map(jnp.asarray, mc["jq_nh"][name])
    got = mcfcos_int8._mcblock_i8(q, [torch.from_numpy(x) for x in xs])
    want = np.asarray(jm8._mcblock_i8(qj, [jnp.asarray(x) for x in xs]))
    d = np.abs(_np(got).astype(np.int32) - want.astype(np.int32))
    n_diff = int((d > 0).sum())
    print(f"{name}: {n_diff} of {want.size} int8 values differ, max {int(d.max())} step, "
          f"{float((want != 0).mean()):.3f} nonzero")
    max_step, share = GATE_FLIPS.get(name, (0, 0.0))
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    assert int(d.max()) <= max_step and n_diff <= share * d.size


def _jax_neck(q, feats_q):
    """The JAX ``mcfcos_neck_head_int8``'s neck, op by op: h1..h4."""
    c3, c4, c5 = feats_q
    cls, up, pool, mb, i8 = jm8._clip8, jm8._up2, jm8._pool2, jm8._mcblock_i8, jm8._conv_i8
    f32 = lambda t: t.astype(jnp.float32)
    x4 = mb(q["mb_top"], [pool(c5)])

    def ffm(name, lo, hi):
        blk = q[name]
        c = lo.shape[-1]
        acc = i8(lo, blk["w"][:, :, :c]) * blk["A"][0] + i8(up(hi), blk["w"][:, :, c:]) * blk["A"][1]
        return cls((acc + blk["B"]) * blk["inv"])

    x2 = mb(q["ffm_mb1"], [ffm("ffm_pw1", c4, c5)])
    x1 = mb(q["ffm_mb2"], [ffm("ffm_pw2", c3, c4)])
    blk = q["tf1"]
    x3 = cls(jm8._silu(i8(c5, blk["w"]) * blk["A"] + blk["B"]) * blk["inv"])
    add = lambda n, a, b: cls(f32(a) * q[n]["m1"] + f32(b) * q[n]["m2"])
    p1 = mb(q["fpn_mb1"], [x3])
    p2 = mb(q["fpn_mb2"], [add("p2in", up(p1), x2)])
    p3 = mb(q["fpn_mb3"], [add("p3in", up(p2), x1)])
    c1 = mb(q["refine_mb2"], [mb(q["refine_mb1"], [up(p1), p2]), pool(p3)])
    h2 = cls(i8(c1, q["h2"]["w"], pad=1) * q["h2"]["A"] + f32(p2) * q["h2"]["m2"])
    d = pool(c1)
    return add("h1", up(c1), p3), h2, add("h3", d, p1), add("h4", pool(d), x4)


def test_neck_head_int8_matches_jax(mc):
    """On the JAX int8 C3..C5 and qtree: the four head inputs equal to JAX's,
    every head tower stage equal op by op (each from its own previous stage),
    and the maps (reg raw) within rtol 1e-5 of JAX's (measured on an x86-64
    CPU: printed)."""
    q = load_mcfcos_qtree(mc["jq_nh"], "cpu")
    qj = jax.tree_util.tree_map(jnp.asarray, mc["jq_nh"])
    fq = [torch.from_numpy(f) for f in mc["feats_q"]]
    fj = [jnp.asarray(f) for f in mc["feats_q"]]
    heads, jheads = mcfcos_int8.mcfcos_neck_int8(q, fq), _jax_neck(qj, fj)
    for i, (h, hj) in enumerate(zip(heads, jheads)):
        n_diff = int((_np(h) != np.asarray(hj)).sum())
        print(f"h{i + 1} {tuple(h.shape)}: {n_diff} int8 values differ")
        assert n_diff == 0
        for j in range(mcfcos_int8.MC_TOWER):
            lv, lvj = q["levels"][i], qj["levels"][i]
            h = mcfcos_int8.mcfcos_tower_i8(q, lv, h, j)
            z = jm8._conv_i8(hj, qj[f"wt{j}"], pad=1) * lvj[f"A{j}"] + qj[f"bt{j}"]
            hj = jm8._clip8(jm8._silu(z) * lvj[f"inv{j}"])
            assert int((_np(h) != np.asarray(hj)).sum()) == 0, (i, j)
    got = mcfcos_int8.mcfcos_neck_head_int8(q, fq)
    want = jm8.mcfcos_neck_head_int8(qj, fj)
    for b, name in enumerate(("cls", "cnt", "reg")):
        for i, (g, w) in enumerate(zip(got[b], want[b])):
            w = np.asarray(w)
            print(f"{name} level {i}: max err {float(np.abs(_np(g) - w).max() / np.abs(w).max()):.3g} of the range")
            np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


# ---------------------------------------------------------------- (d)

@pytest.fixture(scope="module")
def pipes(mc):
    """The port's pipeline on its own f32 calibration, and on the JAX qtree;
    the JAX ladder (``mcfcos_int8_forward``, backend "xla", raw uint8
    frames) on the JAX qtree, op by op."""
    model, frames = mc["model"], torch.from_numpy(mc["frames"])
    args = (model, torch.from_numpy(mc["norm"]), MC_STRIDES, (CANVAS, CANVAS))
    own = make_eval_pipeline_int8(*args, compute_dtype=torch.float32)
    same = make_eval_pipeline_int8(*args, compute_dtype=torch.float32)
    same.qtree = {"backbone": load_backbone_qtree(mc["jq_bb"], "cpu"), "neck_head": load_mcfcos_qtree(mc["jq_nh"], "cpu")}
    jq = jax.tree_util.tree_map(jnp.asarray, {"backbone": mc["jq_bb"], "neck_head": mc["jq_nh"]})
    want = jm8.mcfcos_int8_forward(mc["jm"], jq, jnp.asarray(mc["frames"]), backend="xla", u8_stem=True)
    return dict(args=args, own=own, same=same, frames=frames, want=tuple([np.asarray(t) for t in b] for b in want),
                own_levels=own.forward_levels(frames), same_levels=same.forward_levels(frames))


def test_int8_pipeline_keeps_the_jax_gate(mc, pipes):
    """``make_eval_pipeline_int8(MC_FCOS)``: ``{"backbone", "neck_head"}``
    from raw uint8 frames whatever ``int8_fpn``/``int8_head`` say (the same
    maps); the oracle backbone on the CPU; ``fused_head=True`` refused;
    finite detections."""
    own, args, frames = pipes["own"], pipes["args"], pipes["frames"]
    assert sorted(own.qtree) == ["backbone", "neck_head"] and own.u8_input and "stem_s2d" in own.qtree["backbone"]
    assert torch.equal(own._input(frames), frames)
    for kw in (dict(int8_fpn=False), dict(int8_head=False)):
        other = make_eval_pipeline_int8(*args, compute_dtype=torch.float32, **kw)
        assert sorted(other.qtree) == ["backbone", "neck_head"] and other.u8_input
        other.qtree = own.qtree
        for a_b, b_b in zip(other.forward_levels(frames), pipes["own_levels"]):
            assert all(torch.equal(a, b) for a, b in zip(a_b, b_b))
    with pytest.raises(ValueError, match="fused_head"):
        make_eval_pipeline_int8(*args, fused_head=True, compute_dtype=torch.float32)
    dets = own(frames)
    assert bool(torch.isfinite(dets.scores).all()) and all(int(n) > 0 for n in dets.valid.sum(dim=1))
    before = groupnorm_act.launches
    pipes["same"](frames)
    assert groupnorm_act.launches == before


# On the JAX qtree every int8 stage agrees (test (c)), so the maps agree to
# f32 rounding; with the port's own calibration, whose scales differ from
# JAX's by f32 ulps all through the ladder, cosine >= 0.99.
SAME_QTREE_RTOL, OWN_QTREE_COS = 1e-5, 0.99


@pytest.mark.parametrize("branch", [0, 1, 2], ids=["cls", "cnt", "reg"])
def test_int8_pipeline_levels_match_jax(pipes, branch):
    for i, (same, own, want) in enumerate(zip(pipes["same_levels"][branch], pipes["own_levels"][branch],
                                              pipes["want"][branch])):
        assert tuple(same.shape) == want.shape and bool(torch.isfinite(own).all())
        cos = cosine(own, want)
        print(f"branch {branch} level {i}: own calibration cosine {cos:.8f}")
        np.testing.assert_allclose(_np(same), want, rtol=SAME_QTREE_RTOL, atol=SAME_QTREE_RTOL * np.abs(want).max())
        assert cos >= OWN_QTREE_COS


# ---------------------------------------------------------------- (e)

def test_four_stride_decode_rule(mc):
    """The float pipeline decodes the four levels at strides 8..64, or the
    first three (the reference's zip-truncation); two or five strides
    raise, as the JAX ``len(strides) in (L, L-1)`` assertion does."""
    model, frames = mc["model"], torch.from_numpy(mc["frames"])
    pipe = make_eval_pipeline(model, MC_STRIDES, (CANVAS, CANVAS), compute_dtype=torch.float32)
    dets = pipe(frames)
    assert bool(torch.isfinite(dets.boxes).all()) and all(int(n) > 0 for n in dets.valid.sum(dim=1))
    levels = pipe.forward_levels(frames)
    assert [t.shape[1] for t in levels[0]] == [16, 8, 4, 2]
    make_eval_pipeline(model, MC_STRIDES[:3], (CANVAS, CANVAS), compute_dtype=torch.float32).decode(levels)
    for strides in (MC_STRIDES[:2], (8, 16, 32, 64, 128)):
        with pytest.raises(ValueError, match="strides for a 4-level model"):
            make_eval_pipeline(model, strides, (CANVAS, CANVAS), compute_dtype=torch.float32).decode(levels)


def test_train_step_matches_jax():
    """Two f32 SGD steps of MC_FCOS(5, 64) at its four strides and
    config/voc.yaml's ranges, from the same weights and batch, the momentum
    carried between them: after each, the loss, each trainable parameter's
    gradient and the updated parameters (the train test's tolerances); the
    freeze set is JAX's ``param_labels``' (the stem and every BatchNorm,
    ``tf1_bn`` and the head's ``bn0..3`` among them).  At lr 1e-8: from
    these weights JAX's own step 2 is NaN at the train test's 1e-2 and has
    a cnt loss of 2.6e13 at 1e-4 (ROADMAP queue 3); at 1e-8 most trainable
    tensors still move by more than their tolerance, and dropping the
    momentum would put most of them out of it."""
    from pytorch_object_detection_tpu.train import trainer as jt

    shapes = [(CANVAS // s, CANVAS // s) for s in MC_STRIDES]
    params, stats = perturbed_variables(43, "MC_FCOS", 5)
    state = jax_capture_state("MC_FCOS", 0, params, stats, MC_OPT)
    step = jt.make_train_step(jax_model("MC_FCOS", 5), shapes, MC_STRIDES, MC_RANGES, "giou", jnp.float32,
                              donate=False)
    images, boxes, labels = numpy_batch()
    want = []
    for _ in range(2):
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(labels))
        want.append(({k: float(v) for k, v in metrics.items()}, flax_to_state_dict(jax.device_get(state.opt_state[0])),
                     flax_to_state_dict(jax.device_get(state.params))))
    port = port_state("MC_FCOS", 0, params, stats, opt=MC_OPT)
    jlabels = jax.tree_util.tree_flatten_with_path(jt.param_labels(params, True, 0))[0]
    frozen = {flax_to_torch_name(tuple(k.key for k in path)) for path, v in jlabels if v == "freeze"}
    assert frozen == {n for n, lbl in trainer.param_labels(port.model, True, 0).items() if lbl == "freeze"}
    pstep = trainer.make_train_step(port.model, shapes, MC_STRIDES, MC_RANGES, "giou", torch.float32)
    batch = tuple(torch.from_numpy(a) for a in (images, boxes, labels))
    for i, ((m, grads, after), (want_losses, want_grads, want_after)) in enumerate(
            zip(run_port_steps(port, len(want), batch, step=pstep), want)):
        assert_step_matches(port, m, grads, after, want_losses, want_grads, want_after, f"MC_FCOS step {i + 1}",
                            n_steps=i + 1, lr=MC_OPT["lr"])


def test_mc_fcos_clis_train_and_evaluate(tmp_path):
    check_family_clis(tmp_path, "MC_FCOS", MC_STRIDES, MC_RANGES, ["--int8"])


def test_entry_points():
    built = build_model("mc_fcos", 5, 32, device="cpu", generator=torch.Generator().manual_seed(1))
    assert tuple(built.head.cls.weight.shape) == (5, 32, 3, 3) and built.head.cls.bias is None
    assert built.mb_top.se.fc1.out_channels == 1024 // 6 and built.refine_mb1.pw1.in_channels == 64
    assert not any("scale" in n for n, _ in built.named_parameters())  # no ScaleExp
    with pytest.raises(ValueError, match="quantize_mcfcos"):
        trainer.quantize_fpn(built, {}, torch.zeros(1, 64, 64, 3))
    with pytest.raises(ValueError, match="direct_stem"):
        trainer.make_eval_forward_int8(built, direct_stem=True)


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_mcfcos_qtree_loader_rejects_bad_trees(mc, fault):
    bad = jax.tree_util.tree_map(lambda a: a, mc["jq_nh"])
    if fault == "missing":
        del bad["refine_mb2"]["se"]["b1"]
    elif fault == "unused":
        bad["h3"]["extra"] = np.zeros(3, np.float32)
    else:
        bad["levels"][3]["A2"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        load_mcfcos_qtree(bad, "cpu")
