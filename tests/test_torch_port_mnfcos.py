"""MNFCOS in the port against the JAX package (CPU, f32): the float modules and the int8 ladder.

MNFCOS(20, 64) at the 128x128 canvas (the JAX minimum: its P6 and P7 are
2x2 max pools of P5 and P6, so C5 must be at least 4x4), B=2, with a
perturbed variable tree (``torch_port_fixtures.perturbed_variables``):

  (a) the float modules: MNBlock at its five (kernel, dilation) forms
      (rtol 1e-4, atol 2e-4), the LightweightFPN, the MNHead and the whole
      forward (within 1e-4 of the range, ``assert_close_to_ref``: the
      pyramid's residual chains have no norm, so its values reach 1e4-1e5
      here and an absolute tolerance means nothing), each against the flax
      module on the same weights: the same f32 operations, summed in
      another order;
  (b) K12's plain version against the JAX oracle ``_mnblock_i8`` run op by
      op (bit-exact) and the JAX kernel in interpret mode (its contract:
      at most one int8 step on under 1e-3 of the elements);
  (c) the LightweightFPN and MNHead ladders on the JAX-built qtrees,
      carried across by ``train/checkpoints``, and the port's own
      calibration and quantization against JAX's;
  (d) the detector: ``make_eval_forward_int8`` against the JAX function
      run op by op, its backends, and the pipelines' MNFCOS rules.

The JAX int8 forwards run op by op, not under ``jax.jit`` (XLA fuses the
f32 epilogues under jit and moves int8 values by a step; see
test_torch_port_int8_fpn).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.models import mnfcos_int8 as jm8
from pytorch_object_detection_tpu.models.heads import MNHead as JaxMNHead
from pytorch_object_detection_tpu.nn.fpn import LightweightFPN as JaxLightweightFPN
from pytorch_object_detection_tpu.nn.layers import MNBlock as JaxMNBlock
from pytorch_object_detection_tpu.nn.resnet import ResNet50 as JaxResNet50
from pytorch_object_detection_tpu_torch.eval.evaluator import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    make_eval_pipeline,
    make_eval_pipeline_int8,
)
from pytorch_object_detection_tpu_torch.models import mnfcos_int8
from pytorch_object_detection_tpu_torch.models.registry import available_models, build_model
from pytorch_object_detection_tpu_torch.nn.layers import MNBlock
from pytorch_object_detection_tpu_torch.ops.qhead import _gn
from pytorch_object_detection_tpu_torch.ops.qmnblock import qmnblock, qmnblock_plain
from pytorch_object_detection_tpu_torch.ops.quant import clip8, conv_i8
from pytorch_object_detection_tpu_torch.train import trainer
from pytorch_object_detection_tpu_torch.train.checkpoints import (
    load_backbone_qtree,
    load_flax_variables,
    load_lwfpn_qtree,
    load_mnhead_qtree,
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
    jax_model,
    nchw,
    nhwc,
    perturbed_variables,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

RTOL, ATOL = 1e-4, 2e-4
# (block in the pyramid, kernel, dilation): the five forms of the model
BLOCK_FORMS = [("mnb3", 3, 1), ("mnb4", 3, 2), ("mnb5", 5, 2), ("mnb6", 5, 1), ("mnb7", 7, 1)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cos(a, b):
    a, b = _np(a).astype(np.float64).ravel(), _np(b).astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _tree(t):
    return jax.tree_util.tree_map(np.array, t)  # writable copies


@pytest.fixture(scope="module")
def mn():
    """One perturbed MNFCOS in both packages, the float chain's JAX outputs
    and the JAX int8 qtrees with the head's calibration levels and taps."""
    from pytorch_object_detection_tpu.train import trainer as jt

    params, stats = perturbed_variables(seed=20, model="MNFCOS")
    variables = {"params": params, "batch_stats": stats}
    sub = lambda scope: {"params": params[scope], "batch_stats": stats[scope]}
    x = np.random.default_rng(21).normal(size=(BATCH, CANVAS, CANVAS, 3)).astype(np.float32)
    taps = [np.asarray(t) for t in jax.jit(lambda v, x: JaxResNet50().apply(v, x, False))(sub("backbone"), x)]
    levels = [np.asarray(t) for t in jax.jit(
        lambda v, f: JaxLightweightFPN(FEATURES).apply(v, f, False))(sub("fpn"), taps)]
    head = jax.jit(lambda v, lv: JaxMNHead(NUM_CLASSES, FEATURES).apply(v, lv, False))(sub("head"), levels)
    jm = jax_model("MNFCOS")
    whole = jax.jit(lambda v, x: jm.apply(v, x, False))(variables, x)

    frames = np.random.default_rng(22).integers(0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)
    norm = ((frames.astype(np.float32) / np.float32(255.0) - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    jq_bb = jt.quantize_backbone(jm, variables, jnp.asarray(norm), compute_dtype=jnp.float32)
    feats_q, feat_scales = jax.jit(lambda im: jt._backbone_int8_feats(jm, jq_bb, im))(jnp.asarray(norm))
    feats = tuple(q.astype(jnp.float32) * s for q, s in zip(feats_q, feat_scales))
    fpn_taps = {k: float(v) for k, v in jax.jit(jm8.calibrate_lwfpn)(params["fpn"], stats["fpn"], feats).items()}
    jq_fpn = jax.jit(jm8.quantize_lwfpn)(params["fpn"], stats["fpn"], fpn_taps, feat_scales)
    lq, lsc = jax.jit(lambda f: jm8.lwfpn_int8_forward(jq_fpn, f, dequant=False))(feats_q)  # jt.quantize_head's levels
    cal_levels = tuple(q.astype(jnp.float32) * s for q, s in zip(lq, lsc))
    head_taps = {k: float(v) for k, v in jax.jit(jm8.calibrate_mnhead)(params["head"], stats["head"],
                                                                         cal_levels).items()}
    jq_head = jm8.quantize_mnhead(params["head"], stats["head"], head_taps, lsc, NUM_CLASSES)

    model = build_model("MNFCOS", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    return dict(params=params, stats=stats, variables=variables, x=x, taps=taps, levels=levels,
                head=tuple([np.asarray(t) for t in b] for b in head), whole=tuple([np.asarray(t) for t in b]
                                                                                 for b in whole),
                frames=frames, norm=norm, model=model, jq_bb=_tree(jq_bb), jq_fpn=_tree(jq_fpn),
                jq_head=_tree(jq_head), feats_q=_tree(list(feats_q)), feat_scales=_tree(list(feat_scales)),
                feats=_tree(list(feats)), fpn_taps=fpn_taps, cal_levels=_tree(list(cal_levels)),
                level_scales=_tree(list(lsc)), head_taps=head_taps)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("form", BLOCK_FORMS, ids=[f"k{k}d{d}" for _, k, d in BLOCK_FORMS])
def test_mnblock_matches_flax(mn, form):
    name, k, d = form
    p, s = mn["params"]["fpn"][name], mn["stats"]["fpn"][name]
    x = np.random.default_rng(k * 10 + d).normal(size=(BATCH, 16, 16, FEATURES)).astype(np.float32)
    want = jax.jit(lambda v, x: JaxMNBlock(FEATURES, k, d, 2).apply(v, x, False))({"params": p, "batch_stats": s}, x)
    block = load_flax_variables(MNBlock(FEATURES, k, d, alpha=2), p, s).eval()
    with torch.no_grad():
        got = block(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def port_float(mn):
    model = mn["model"]
    with torch.no_grad():
        levels = model.fpn([nchw(t) for t in mn["taps"]])
        head = model.head([nchw(t) for t in mn["levels"]])
        whole = model(torch.from_numpy(mn["x"]))
    return {"levels": [nhwc(t) for t in levels], "head": tuple([nhwc(t) for t in b] for b in head),
            "whole": tuple([_np(t) for t in b] for b in whole)}


@pytest.mark.parametrize("level", range(5), ids=[f"P{i}" for i in range(3, 8)])
def test_lightweight_fpn_levels_match_flax(mn, port_float, level):
    assert_close_to_ref(port_float["levels"][level], mn["levels"][level], f"P{level + 3}")


@pytest.mark.parametrize("which", ["head", "whole"])
def test_mnhead_and_mnfcos_forward_match_flax(mn, port_float, which):
    """The MNHead on the JAX levels, and the whole MNFCOS forward on the
    same images, per level and branch (reg through ScaleExp), each within
    1e-4 of its branch's range over the five levels (one shared head)."""
    scales = branch_scales(mn[which])
    for b, name in enumerate(("cls", "cnt", "reg")):
        for i, (got, want) in enumerate(zip(port_float[which][b], mn[which][b])):
            assert_close_to_ref(got, want, f"{which} {name} P{i + 3}", ref_scale=scales[b])


# ---------------------------------------------------------------- (b)

def _rand_block(rng, c, k, alpha=2):
    """A random int8 MNBlock and its scales in the JAX layouts (numpy), as
    tests/test_quant.py:1213-1226 draws them."""
    blk = dict(wdw=rng.integers(-127, 128, (k, k, 1, c)).astype(np.int8),
               swdw=(np.abs(rng.standard_normal(c)) * 1e-3 + 1e-5).astype(np.float32),
               bdw=(rng.standard_normal(c) * 0.1).astype(np.float32),
               w1=rng.integers(-127, 128, (1, 1, c, alpha * c)).astype(np.int8),
               sw1=(np.abs(rng.standard_normal(alpha * c)) * 1e-3 + 1e-5).astype(np.float32),
               b1=(rng.standard_normal(alpha * c) * 0.1).astype(np.float32),
               w2=rng.integers(-127, 128, (1, 1, alpha * c, c)).astype(np.int8),
               sw2=(np.abs(rng.standard_normal(c)) * 1e-3 + 1e-5).astype(np.float32),
               b2=(rng.standard_normal(c) * 0.1).astype(np.float32))
    sc = {k2: np.float32(v) for k2, v in dict(s_in=0.05, s_a1=0.03, s_a2=0.04, s_out=0.06).items()}
    return blk, sc


def _port_block(blk, sc):
    """A JAX-layout block as the port's tensors (the loader's conversion)."""
    out = {}
    for key, arr in blk.items():
        if key == "wdw":
            arr = arr[:, :, 0]
        elif arr.dtype == np.int8:
            arr = arr[0, 0].T
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out, {k: torch.tensor(v) for k, v in sc.items()}


# (H, W, kernel, dilation): tests/test_quant.py:1230-1254's shapes
PLAIN_CASES = [(16, 16, 3, 1), (16, 16, 3, 2), (14, 22, 3, 2), (16, 16, 5, 2), (8, 8, 5, 1), (4, 4, 7, 1),
               (14, 22, 7, 1)]


@pytest.mark.parametrize("case", PLAIN_CASES, ids=[f"{h}x{w}_k{k}d{d}" for h, w, k, d in PLAIN_CASES])
def test_plain_k12_bit_exact_vs_jax_oracle(case):
    h, w, k, d = case
    rng = np.random.default_rng(h * 100 + w + 7 * k + d)
    blk, sc = _rand_block(rng, 64, k)
    x = rng.integers(-127, 128, (2, h, w, 64)).astype(np.int8)
    want = np.asarray(jm8._mnblock_i8({n: jnp.asarray(a) for n, a in blk.items()},
                                      {n: jnp.asarray(a) for n, a in sc.items()}, jnp.asarray(x), k, d,
                                      use_pallas=False))
    pblk, psc = _port_block(blk, sc)
    got = qmnblock_plain(pblk, psc, torch.from_numpy(x), k, d)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    n_diff = int((_np(got) != want).sum())
    print(f"{h}x{w} k{k} d{d}: {n_diff} of {want.size} int8 values differ, {float((want != 0).mean()):.3f} nonzero")
    assert n_diff == 0 and (want != 0).mean() > 0.5


def test_jax_interpret_kernel_within_one_step_of_plain_k12():
    """The JAX kernel in interpret mode against the port's plain version on
    the smallest of the JAX test's shapes (4x4, k7): its own contract, at
    most one int8 step on under 1e-3 of the elements (FMA contraction in
    the compiled kernel body)."""
    from pytorch_object_detection_tpu.ops.pallas_qmnblock import qmnblock as jax_qmnblock

    rng = np.random.default_rng(5)
    blk, sc = _rand_block(rng, 64, 7)
    x = rng.integers(-127, 128, (1, 4, 4, 64)).astype(np.int8)
    j = {n: jnp.asarray(a) for n, a in blk.items()}
    got = np.asarray(jax_qmnblock(jnp.asarray(x), j["wdw"], j["swdw"], j["bdw"], j["w1"], j["sw1"], j["b1"], j["w2"],
                                  j["sw2"], j["b2"], *[jnp.float32(sc[n]) for n in ("s_in", "s_a1", "s_a2", "s_out")],
                                  kernel=7, dilation=1, interpret=True))
    pblk, psc = _port_block(blk, sc)
    want = _np(qmnblock_plain(pblk, psc, torch.from_numpy(x), 7, 1))
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"interpret vs plain: max {int(diff.max())} step, {int((diff > 0).sum())} of {diff.size} differ")
    assert int(diff.max()) <= 1 and (diff > 0).mean() < 1e-3


# ---------------------------------------------------------------- (c)

def test_calibrate_and_quantize_lwfpn_match_jax(mn):
    """Taps within rtol 1e-5 of JAX's on the same f32 C3..C5; from the JAX
    taps, int8 weights identical and every scale and shift within rtol
    1e-5 (plus 1e-6 of the vector's range)."""
    fpn = mn["model"].fpn
    assert_taps(mnfcos_int8.calibrate_lwfpn(fpn, [torch.from_numpy(f) for f in mn["feats"]]), mn["fpn_taps"])
    got = mnfcos_int8.quantize_lwfpn(fpn, mn["fpn_taps"], [torch.from_numpy(s) for s in mn["feat_scales"]])
    assert_same_qtree(got, load_lwfpn_qtree(mn["jq_fpn"], "cpu"))


def test_calibrate_and_quantize_mnhead_match_jax(mn):
    head = mn["model"].head
    assert_taps(mnfcos_int8.calibrate_mnhead(head, [torch.from_numpy(lv) for lv in mn["cal_levels"]]),
                 mn["head_taps"])
    got = mnfcos_int8.quantize_mnhead(head, mn["head_taps"], [torch.from_numpy(s) for s in mn["level_scales"]],
                                      NUM_CLASSES)
    want = load_mnhead_qtree(mn["jq_head"], "cpu")
    assert got["num_classes"] == want["num_classes"] == NUM_CLASSES and len(want["levels"]) == 5
    assert isinstance(want["gnc"], tuple)
    assert_same_qtree(got, want)


@pytest.fixture(scope="module")
def jax_levels_q(mn):
    """The JAX int8 P3..P7 of the JAX int8 C3..C5, op by op."""
    jq = jax.tree_util.tree_map(jnp.asarray, mn["jq_fpn"])
    levels, _ = jm8.lwfpn_int8_forward(jq, [jnp.asarray(f) for f in mn["feats_q"]], dequant=False)
    return [np.asarray(lv) for lv in levels]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_lwfpn_int8_forward_bit_exact_vs_jax(mn, jax_levels_q, backend):
    """Each int8 level equal to JAX's; ``"pallas"`` (K12's wrapper: its
    plain version on a CPU tensor, no launch counted) the same."""
    q = load_lwfpn_qtree(mn["jq_fpn"], "cpu")
    before = qmnblock.launches
    levels, scales = mnfcos_int8.lwfpn_int8_forward(q, [torch.from_numpy(f) for f in mn["feats_q"]], dequant=False,
                                                    backend=backend)
    assert qmnblock.launches == before
    for i, (got, want) in enumerate(zip(levels, jax_levels_q)):
        n_diff = int((_np(got) != want).sum())
        print(f"P{i + 3} {want.shape}: {n_diff} int8 values differ")
        assert got.dtype == torch.int8 and tuple(got.shape) == want.shape and n_diff == 0
    assert [float(s) for s in scales] == [float(s) for s in mn["level_scales"]]
    deq = mnfcos_int8.lwfpn_int8_forward(q, [torch.from_numpy(f) for f in mn["feats_q"]], torch.float32,
                                         backend=backend)
    assert all(torch.equal(d, lv.float() * s) for d, lv, s in zip(deq, levels, scales))


def _head_stages(q, lv, x, port):
    """The int8 stages of one head level (block1, block2, the two towers)
    and its maps, each from the stage before: the port's (``port``) or the
    JAX oracle's, op by op."""
    if port:
        block = lambda b, y: qmnblock_plain(q[b], lv[b], y, 3, 2)
        conv, gn, c8 = conv_i8, _gn, clip8
    else:
        block = lambda b, y: jm8._mnblock_i8(q[b], lv[b], y, 3, 2, use_pallas=False)
        conv, gn, c8 = (lambda y, w: jm8._conv_i8(y, w, pad=w.shape[0] // 2)), jm8._gn, jm8._clip8
    y1 = block("block1", x)
    y2 = block("block2", y1)
    c = c8(gn(conv(y2, q["wc"]) * lv["Ac"], *q["gnc"], act="silu") * lv["inv_c"])
    r = c8(gn(conv(y2, q["wr"]) * lv["Ar"], *q["gnr"], act="silu") * lv["inv_r"])
    return {"block1": y1, "block2": y2, "c": c, "r": r}


def test_mnhead_int8_forward_matches_jax(mn, jax_levels_q):
    """On the JAX int8 levels: the int8 stages of each level (both blocks,
    both towers) equal JAX's op by op, and the maps (cls, cnt, reg through
    ScaleExp) within rtol 1e-5 of JAX's (measured on an x86-64 CPU:
    printed).  ``backend="pallas"`` equals ``"xla"``."""
    q = load_mnhead_qtree(mn["jq_head"], "cpu")
    qj = jax.tree_util.tree_map(jnp.asarray, mn["jq_head"])
    levels_q = [torch.from_numpy(lv) for lv in jax_levels_q]
    got = mnfcos_int8.mnhead_int8_forward(q, levels_q)
    want = jm8.mnhead_int8_forward(qj, [jnp.asarray(lv) for lv in jax_levels_q])
    pallas = mnfcos_int8.mnhead_int8_forward(q, levels_q, backend="pallas", num_classes=NUM_CLASSES)
    assert all(torch.equal(a, b) for ga, pa in zip(got, pallas) for a, b in zip(ga, pa))
    for i, x in enumerate(jax_levels_q):
        ours = _head_stages(q, q["levels"][i], torch.from_numpy(x), port=True)
        theirs = _head_stages(qj, qj["levels"][i], jnp.asarray(x), port=False)
        for stage in ours:
            n_diff = int((_np(ours[stage]) != np.asarray(theirs[stage])).sum())
            assert n_diff == 0, (i, stage, n_diff)
    for b, name in enumerate(("cls", "cnt", "reg")):
        for i, (g, w) in enumerate(zip(got[b], want[b])):
            w = np.asarray(w)
            err = float(np.abs(_np(g) - w).max() / np.abs(w).max())
            print(f"{name} P{i + 3}: max err {err:.3g} of the range")
            np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


# ---------------------------------------------------------------- (d)

LADDERS = {"int8_backbone": dict(int8_fpn=False), "int8_fpn": dict(int8_fpn=True, int8_head=False),
           "full": dict(int8_fpn=True, int8_head=True, u8_input=True)}


@pytest.fixture(scope="module")
def qtrees(mn):
    bb = load_backbone_qtree(mn["jq_bb"], "cpu")
    fpn, head = load_lwfpn_qtree(mn["jq_fpn"], "cpu"), load_mnhead_qtree(mn["jq_head"], "cpu")
    return {"int8_backbone": bb, "int8_fpn": {"backbone": bb, "fpn": fpn},
            "full": {"backbone": bb, "fpn": fpn, "head": head}}


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_make_eval_forward_int8_matches_jax(mn, qtrees, ladder):
    """``make_eval_forward_int8(MNFCOS, backend="xla")`` on the JAX qtrees
    against the JAX function run op by op, f32: cosine >= 0.9999 per level
    and branch; ``"pallas_block"`` (every kernel's plain version on the
    CPU) equals ``"xla"``."""
    from pytorch_object_detection_tpu.train import trainer as jt

    kw = LADDERS[ladder]
    images = mn["frames"] if kw.get("u8_input") else mn["norm"]
    jq = {"int8_backbone": mn["jq_bb"], "int8_fpn": {"backbone": mn["jq_bb"], "fpn": mn["jq_fpn"]},
          "full": {"backbone": mn["jq_bb"], "fpn": mn["jq_fpn"], "head": mn["jq_head"]}}[ladder]
    jfwd = jt.make_eval_forward_int8(jax_model("MNFCOS"), compute_dtype=jnp.float32, backend="xla", **kw)
    want = jfwd(jax.tree_util.tree_map(jnp.asarray, jq), mn["params"], mn["stats"], jnp.asarray(images))
    model = mn["model"]
    got = trainer.make_eval_forward_int8(model, torch.float32, backend="xla", **kw)(qtrees[ladder],
                                                                                  torch.from_numpy(images))
    block = trainer.make_eval_forward_int8(model, torch.float32, backend="pallas_block", **kw)(
        qtrees[ladder], torch.from_numpy(images))
    for b, name in enumerate(("cls", "cnt", "reg")):
        for i, (g, w) in enumerate(zip(got[b], want[b])):
            cos = _cos(g, w)
            print(f"{ladder} {name} P{i + 3}: cosine {cos:.8f}")
            assert tuple(g.shape) == np.asarray(w).shape and g.dtype == torch.float32 and cos >= 0.9999
            assert torch.equal(g, block[b][i])


def test_int8_pipeline_keeps_the_jax_gate(mn):
    """``make_eval_pipeline_int8(MNFCOS)`` quantizes the backbone only and
    takes normalized frames, whatever ``int8_fpn`` asks (JAX
    evaluator.py:340); ``fused_head=True`` is refused; its maps are the
    int8-backbone forward's."""
    model, norm = mn["model"], torch.from_numpy(mn["norm"])
    args = (model, norm, STRIDES, (CANVAS, CANVAS))
    pipe = make_eval_pipeline_int8(*args, compute_dtype=torch.float32)
    assert "fpn" not in pipe.qtree and "head" not in pipe.qtree and "layer1_0" in pipe.qtree and not pipe.u8_input
    frames = torch.from_numpy(mn["frames"])
    dets = pipe(frames)
    assert bool(torch.isfinite(dets.scores).all()) and all(int(n) > 0 for n in dets.valid.sum(dim=1))
    want = trainer.make_eval_forward_int8(model, torch.float32)(pipe.qtree, pipe._input(frames))
    for a_b, b_b in zip(pipe.forward_levels(frames), want):
        assert all(torch.equal(a, b) for a, b in zip(a_b, b_b))
    for kw in (dict(), dict(int8_fpn=False)):
        with pytest.raises(ValueError, match="fused_head"):
            make_eval_pipeline_int8(*args, fused_head=True, compute_dtype=torch.float32, **kw)


def test_float_pipeline_and_entry_points(mn):
    model = mn["model"]
    pipe = make_eval_pipeline(model, STRIDES, (CANVAS, CANVAS), compute_dtype=torch.float32)
    dets = pipe(torch.from_numpy(mn["frames"]))
    assert tuple(dets.boxes.shape[:1]) == (BATCH,) and bool(torch.isfinite(dets.boxes).all())
    assert all(int(n) > 0 for n in dets.valid.sum(dim=1))
    assert "MNFCOS" in available_models()
    built = build_model("mnfcos", 5, 32, device="cpu", generator=torch.Generator().manual_seed(1))
    assert tuple(built.head.cls_pred.weight.shape) == (5, 32, 1, 1) and built.head.scale2.scale.item() == 1.0
    assert tuple(built.fpn.mnb7.ddw.weight.shape) == (32, 1, 7, 7) and built.fpn.mnb5.ddw.dilation == (2, 2)
    effnet = build_model("FCOS", 20, backbone="efficientnet-b0", device="cpu")
    assert [getattr(effnet.fpn, f"lateral{i}").in_channels for i in (3, 4, 5)] == [40, 112, 320]
    with pytest.raises(ValueError, match="backbone"):
        build_model("FCOS", 20, backbone="mobilenet-v2", device="cpu")
    with pytest.raises(NotImplementedError, match="HISFCOS and MNFCOS"):
        trainer.quantize_backbone(torch.nn.Linear(2, 2), torch.zeros(1, 8, 8, 3))


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_mnfcos_qtree_loaders_reject_bad_trees(mn, fault):
    for loader, tree in ((load_lwfpn_qtree, mn["jq_fpn"]), (load_mnhead_qtree, mn["jq_head"])):
        bad = jax.tree_util.tree_map(lambda a: a, tree)
        blk = bad["mnb6"] if loader is load_lwfpn_qtree else bad["block2"]
        if fault == "missing":
            del blk["sw1"]
        elif fault == "unused":
            blk["extra"] = np.zeros(3, np.float32)
        else:
            blk["b2"] = np.zeros(7, np.float32)
        with pytest.raises(ValueError if fault == "shape" else KeyError):
            loader(bad, "cpu")
