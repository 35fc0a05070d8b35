"""The int8 HISHead serving slice of the port against the JAX package (CPU, f32).

Raw uint8 frames -> the exact uint8 stem (K1) -> the int8 ResNet-50 ->
the int8 HisFPN -> the int8 HISHead (K7, K9) -> ScaleExp -> decode: the
JAX package's default ``make_eval_pipeline_int8``.  On the CPU every
kernel wrapper runs its plain version, so this holds the plain versions
against the JAX oracles, at HISFCOS(20, 64), B=2, 256x256:

  (a) the head's calibration taps and quantization;
  (b) the plain level against ``_hishead_level_i8_xla``, stage by stage;
  (c) the JAX kernels in interpret mode against the plain level;
  (d) ``hishead_int8_forward``'s backends and K9 choice;
  (e) the whole slice and its detections, and int8 head vs float head;
  (f) the loader.

The JAX qtrees reach the port through ``train/checkpoints``, so both sides
run on the same int8 weights.  The JAX forwards run op by op, not under
``jax.jit`` (XLA fuses the f32 epilogues under jit; see
test_torch_port_int8_fpn).  Up to the head the two packages agree bit for
bit; in the head each GroupNorm's f32 mean and variance sum in another
order, which moves an int8 value by one step now and then.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu_torch.eval.evaluator import IMAGENET_MEAN, IMAGENET_STD, make_eval_pipeline_int8
from pytorch_object_detection_tpu_torch.models import head_int8
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.nn.fpn_int8 import hisfpn_int8_forward
from pytorch_object_detection_tpu_torch.ops.boxes import pairwise_iou
from pytorch_object_detection_tpu_torch.ops.qhead import _gn, qhishead_level, qhishead_level2, qhishead_level_plain
from pytorch_object_detection_tpu_torch.ops.qhis import depthwise3x3_i8
from pytorch_object_detection_tpu_torch.ops.quant import clip8, conv_i8
from pytorch_object_detection_tpu_torch.train.checkpoints import (
    load_backbone_qtree,
    load_flax_variables,
    load_fpn_qtree,
    load_head_qtree,
)
from torch_port_fixtures import BATCH, FEATURES, NUM_CLASSES, STRIDES, jax_head_form, jax_model, perturbed_variables
from torch_port_fixtures import port_head_qtree

CANVAS = 256  # levels 32x32 .. 2x2; at 128 the 1x1 level's GroupNorm is ill-conditioned
STAGES = ("x1q", "x2q", "yq", "cq", "rq")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cos(a, b):
    a, b = _np(a).astype(np.float64).ravel(), _np(b).astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(q):
    """A port head qtree's tensors by name (``gn1.0``, ``L2.Ac``, ...)."""
    out = {}
    for k, v in q.items():
        if k == "levels":
            out.update({f"L{i}.{n}": t for i, lv in enumerate(v) for n, t in lv.items()})
        elif isinstance(v, tuple):
            out.update({f"{k}.{i}": t for i, t in enumerate(v)})
        elif k != "num_classes":
            out[k] = v
    return out


def _draw_i8(seed, *shape):
    rng = np.random.default_rng(seed)
    return np.clip(np.round(rng.normal(0, 40, shape)), -127, 127).astype(np.int8)


@pytest.fixture(scope="module")
def head_setup():
    """Both packages' int8 slices of one perturbed HISFCOS: the JAX qtrees
    (backbone with the uint8 stem, HisFPN, head, the head's calibration
    levels and taps as ``quantize_head`` makes them), the JAX default
    pipeline's levels from uint8 frames, and the port's model."""
    import jax
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.models import head_int8 as jh
    from pytorch_object_detection_tpu.nn import fpn_int8 as jf
    from pytorch_object_detection_tpu.train import trainer as jt

    params, stats = perturbed_variables(seed=10)
    variables = {"params": params, "batch_stats": stats}
    frames = np.random.default_rng(11).integers(0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)
    norm = ((frames.astype(np.float32) / np.float32(255.0) - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    jm = jax_model()
    jq_bb = jt.quantize_backbone(jm, variables, jnp.asarray(norm), compute_dtype=jnp.float32)
    jq_fpn = jt.quantize_fpn(jm, variables, jq_bb, jnp.asarray(norm), jnp.float32)

    @jax.jit
    def levels_of(images):  # jt.quantize_head, step by step, to keep its levels and taps
        feats_q, _ = jt._backbone_int8_feats(jm, jq_bb, images)
        lq, sc = jf.hisfpn_int8_forward(jq_fpn, feats_q, dequant=False)
        return tuple(q.astype(jnp.float32) * s for q, s in zip(lq, sc)), sc

    levels, level_scales = levels_of(jnp.asarray(norm))
    jtaps = {k: float(v) for k, v in jax.jit(jh.calibrate_hishead)(params["head"], levels).items()}
    jq_head = jh.quantize_hishead(params["head"], jtaps, level_scales, NUM_CLASSES)
    jfwd = jt.make_eval_forward_int8(jm, compute_dtype=jnp.float32, backend="xla", int8_fpn=True, int8_head=True,
                                     u8_input=True)
    jlevels = jfwd({"backbone": jq_bb, "fpn": jq_fpn, "head": jq_head}, params, stats, jnp.asarray(frames))

    model = build_model("HISFCOS", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(params=params, frames=frames, norm=norm, model=model, jq_bb=tree(jq_bb), jq_fpn=tree(jq_fpn),
                jq_head=tree(jq_head), jq_head_j=jq_head, jtaps=jtaps,
                levels=[np.asarray(lv) for lv in levels], level_scales=[np.asarray(s) for s in level_scales],
                jlevels=tuple([np.asarray(t) for t in branch] for branch in jlevels))


# ---------------------------------------------------------------- (a)

def test_calibrate_and_quantize_hishead_match_jax(head_setup):
    """Taps within rtol 1e-5 of JAX's on the same f32 levels (f32 convs and
    GroupNorm sums in another order); from the JAX taps, int8 weights
    identical and every epilogue vector within rtol 1e-6 (the same f32
    operations on the same scales)."""
    head = head_setup["model"].head
    taps = head_int8.calibrate_hishead(head, [torch.from_numpy(lv) for lv in head_setup["levels"]])
    jtaps = head_setup["jtaps"]
    assert sorted(taps) == sorted(jtaps) and len(jtaps) == 5 * 5
    rel = {k: abs(taps[k] - jtaps[k]) / abs(jtaps[k]) for k in jtaps}
    worst = max(rel, key=rel.get)
    print(f"worst tap {worst}: relative difference {rel[worst]:.3g}")
    assert rel[worst] <= 1e-5, f"{worst}: relative difference {rel[worst]:.3g}"

    got = head_int8.quantize_hishead(head, jtaps, [torch.from_numpy(s) for s in head_setup["level_scales"]],
                                     NUM_CLASSES)
    want = load_head_qtree(head_setup["jq_head"], "cpu")
    assert sorted(got) == sorted(want) and got["num_classes"] == want["num_classes"] == NUM_CLASSES
    assert len(got["levels"]) == len(want["levels"]) == 5 and isinstance(got["gn1"], tuple)
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == torch.int8:
            assert torch.equal(g, w), f"{name}: {int((g != w).sum())} int8 weights differ"
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0, msg=name)


# ---------------------------------------------------------------- (b)

def _stage_fns(q, lv, jh=None):
    """The level's five requant stages, each from the int8 map before it:
    JAX's (``jh`` the JAX module, jnp trees) or the port's."""
    if jh is not None:
        conv = lambda x, w, pad=0, groups=1: jh._conv_i8(x, w, pad, groups)
        dw = lambda x: conv(x, q["wdw"], 1, x.shape[-1])
        gn, c8, f32 = jh._gn, jh._clip8, lambda x: x.astype(np.float32)
    else:
        conv = lambda x, w, pad=0, groups=1: conv_i8(x, w)
        dw = lambda x: depthwise3x3_i8(x, q["wdw"])
        gn, c8, f32 = _gn, clip8, lambda x: x.float()
    return {
        "x1q": lambda x: c8(gn(conv(x, q["w1"]) * lv["A1"], *q["gn1"], act="relu") * lv["inv_x1"]),
        "x2q": lambda x1q: c8(gn(dw(x1q) * lv["Adw"], *q["gn2"], act="silu") * lv["inv_x2"]),
        "yq": lambda x2q, x: c8(conv(x2q, q["w2"]) * lv["A2"] + lv["B2"] + f32(x) * lv["res_mul"]),
        "cq": lambda yq: c8(gn(conv(yq, q["wc"], 1) * lv["Ac"], *q["gnc"], act="relu") * lv["inv_c"]),
        "rq": lambda yq: c8(gn(conv(yq, q["wr"], 1) * lv["Ar"], *q["gnr"], act="relu") * lv["inv_r"]),
    }


# (id, level index of the slice's head or None for the 80-class head, H, W)
LEVEL_CASES = [("8x8", 2, 8, 8), ("2x2", 4, 2, 2), ("7x11_80cls", None, 7, 11)]


@pytest.mark.parametrize("case", LEVEL_CASES, ids=[c[0] for c in LEVEL_CASES])
def test_plain_level_matches_jax_oracle(head_setup, case):
    """The plain level (K7's and K9's plain version) against the JAX oracle
    run op by op, B=2, random int8 inputs: cls and cnt|reg within 1e-2 of
    their range, cosine >= 0.9999.  Stage by stage, each from the JAX map
    before it: at most one int8 step, on under 1 % of the elements (the
    GroupNorm means and variances sum in another f32 order); observed on
    an x86-64 CPU: 0 elements at every stage, and outputs equal."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.models import head_int8 as jh

    name, idx, h, w = case
    if idx is None:  # an 80-class head made by the port, carried to the JAX form
        qp, _ = port_head_qtree(FEATURES, 80, [(h, w)], seed=3)
        jq_np, idx = jax_head_form(qp), 0
    else:
        jq_np = head_setup["jq_head"]
    q = load_head_qtree(jq_np, "cpu")
    qj = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else v if k in ("levels", "num_classes")
              else jnp.asarray(v)) for k, v in jq_np.items()}
    lvj = {k: jnp.asarray(v) for k, v in jq_np["levels"][idx].items()}
    lv = q["levels"][idx]
    x = _draw_i8(h * w, BATCH, h, w, FEATURES)

    want_cls, want_cr = jh._hishead_level_i8_xla(qj, lvj, jnp.asarray(x))
    got_cls, got_cr = qhishead_level_plain(q, lv, torch.from_numpy(x))
    assert tuple(got_cls.shape) == want_cls.shape == (BATCH, h, w, q["num_classes"])
    assert tuple(got_cr.shape) == want_cr.shape == (BATCH, h, w, 5)
    for what, got, want in (("cls", got_cls, want_cls), ("cr", got_cr, want_cr)):
        err, cos = _rel_err(got, want), _cos(got, want)
        print(f"{name} {what}: max err {err:.3g} of the range, cosine {cos:.8f}")
        assert err <= 1e-2 and cos >= 0.9999, (what, err, cos)

    fj, fp = _stage_fns(qj, lvj, jh), _stage_fns(q, lv)
    prev = {}
    prev["x1q"] = np.asarray(fj["x1q"](jnp.asarray(x))), fp["x1q"](torch.from_numpy(x))
    prev["x2q"] = np.asarray(fj["x2q"](jnp.asarray(prev["x1q"][0]))), fp["x2q"](torch.from_numpy(prev["x1q"][0]))
    prev["yq"] = (np.asarray(fj["yq"](jnp.asarray(prev["x2q"][0]), jnp.asarray(x))),
                  fp["yq"](torch.from_numpy(prev["x2q"][0]), torch.from_numpy(x)))
    for s in ("cq", "rq"):
        prev[s] = np.asarray(fj[s](jnp.asarray(prev["yq"][0]))), fp[s](torch.from_numpy(prev["yq"][0]))
    for s in STAGES:
        want, got = prev[s]
        d = np.abs(_np(got).astype(np.int32) - want.astype(np.int32))
        print(f"{name} {s}: {int((d > 0).sum())} of {d.size} int8 values differ, max {int(d.max())} step")
        assert int(d.max()) <= 1 and (d > 0).mean() < 0.01, s
        assert (want != 0).mean() > 0.05  # not degenerate


# ---------------------------------------------------------------- (c)

# (id, JAX kernel, level index, batch): even and odd batches; an odd batch
# through qhishead_level2 runs qhishead_level in both packages
INTERPRET_CASES = [("k7_8x8", "qhishead_level", 2, 2), ("k7_2x2", "qhishead_level", 4, 2),
                   ("k9_8x8", "qhishead_level2", 2, 2), ("k9_2x2_odd", "qhishead_level2", 4, 1)]


@pytest.mark.parametrize("case", INTERPRET_CASES, ids=[c[0] for c in INTERPRET_CASES])
def test_jax_kernels_in_interpret_mode_match_plain_level(head_setup, case):
    """The JAX Pallas kernels in interpret mode (``row_chunk=4``, as
    tests/test_quant.py:586-629 runs them) against the port's plain level
    on the same int8 input: their own contract, max error under 0.05 of
    max|cls| and cosine over 0.999 on both outputs (the TPU kernels keep
    bf16 pre-norm maps and bf16 outputs)."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.ops import pallas_qhead

    name, fn, idx, b = case
    q = load_head_qtree(head_setup["jq_head"], "cpu")
    h = CANVAS // STRIDES[idx]
    x = _draw_i8(100 + idx, b, h, h, FEATURES)
    qj = head_setup["jq_head_j"]
    got = getattr(pallas_qhead, fn)(qj, qj["levels"][idx], jnp.asarray(x), num_classes=NUM_CLASSES, row_chunk=4,
                                    interpret=True)
    want = qhishead_level_plain(q, q["levels"][idx], torch.from_numpy(x))
    scale = float(want[0].abs().max())
    for what, g, w in zip(("cls", "cr"), got, want):
        g = np.asarray(g.astype(jnp.float32))
        err, cos = float(np.abs(g - _np(w)).max()) / scale, _cos(g, w)
        print(f"{name} {what}: max err {err:.3g} of max|cls|, cosine {cos:.7f}")
        assert g.shape == tuple(w.shape) and err < 0.05 and cos > 0.999, (what, err, cos)


# ---------------------------------------------------------------- (d)

@pytest.fixture(scope="module")
def slice_levels_q(head_setup):
    """The port's int8 P3..P7 of the frames, on the JAX qtrees (the same
    values as JAX's, bit for bit: test_torch_port_int8_fpn)."""
    from pytorch_object_detection_tpu_torch.nn.resnet_int8 import resnet50_int8_forward

    bb = load_backbone_qtree(head_setup["jq_bb"], "cpu")
    feats_q, _ = resnet50_int8_forward(bb, torch.from_numpy(head_setup["frames"]), torch.float32, dequant=False,
                                       u8_stem=True)
    return hisfpn_int8_forward(load_fpn_qtree(head_setup["jq_fpn"], "cpu"), feats_q, torch.float32, dequant=False)


@pytest.mark.parametrize("v2", ["auto", "on", "off"])
def test_hishead_int8_forward_backends_agree_on_cpu(head_setup, slice_levels_q, v2):
    """``backend="pallas"`` (the K7/K9 wrappers, their plain version on
    the CPU, no launch counted) equals ``"xla"`` for every K9 choice; the
    outputs are the float head's contract: NHWC f32 (cls, cnt, reg), reg
    through exp(pred * scale_exp[i])."""
    q = load_head_qtree(head_setup["jq_head"], "cpu")
    levels_q, _ = slice_levels_q
    before = (qhishead_level.launches, qhishead_level2.launches)
    xla = head_int8.hishead_int8_forward(q, levels_q, backend="xla")
    pallas = head_int8.hishead_int8_forward(q, levels_q, backend="pallas", num_classes=NUM_CLASSES, v2=v2)
    assert (qhishead_level.launches, qhishead_level2.launches) == before
    for a_b, b_b in zip(xla, pallas):
        assert len(a_b) == 5 and all(torch.equal(a, b) for a, b in zip(a_b, b_b))
    cls, cnt, reg = xla
    for i, lq in enumerate(levels_q):
        n = lq.shape[:3]
        assert cls[i].shape == (*n, NUM_CLASSES) and cnt[i].shape == (*n, 1) and reg[i].shape == (*n, 4)
        assert bool((reg[i] > 0).all()) and cls[i].dtype == torch.float32
    with pytest.raises(ValueError, match="v2"):
        head_int8.hishead_int8_forward(q, levels_q, backend="pallas", v2="1")
    with pytest.raises(ValueError, match="num_classes"):
        qhishead_level(q, q["levels"][0], levels_q[0], num_classes=80)


# ---------------------------------------------------------------- (e)

@pytest.fixture(scope="module")
def slice_runs(head_setup):
    from pytorch_object_detection_tpu.ops.postprocess import decode_detections

    args = (head_setup["model"], torch.from_numpy(head_setup["norm"]), STRIDES, (CANVAS, CANVAS))
    pipe = make_eval_pipeline_int8(*args, compute_dtype=torch.float32)  # the defaults: int8 FPN and head
    frames = torch.from_numpy(head_setup["frames"])
    own = pipe.forward_levels(frames)
    same = copy.copy(pipe)
    same.qtree = {"backbone": load_backbone_qtree(head_setup["jq_bb"], "cpu"),
                  "fpn": load_fpn_qtree(head_setup["jq_fpn"], "cpu"),
                  "head": load_head_qtree(head_setup["jq_head"], "cpu")}
    levels = same.forward_levels(frames)
    jdets = decode_detections(*head_setup["jlevels"], STRIDES, 0.05, 0.6, 1000, (CANVAS, CANVAS))
    return dict(pipe=pipe, same=same, own=own, levels=levels, dets=same.decode(levels),
                jdets=[np.asarray(a) for a in jdets], args=args)


# On the same qtrees the int8 stages up to the head agree exactly, so the
# maps differ only by the head's one-step flips: cosine >= 0.9999 per level
# (measured on an x86-64 CPU: printed).  With the port's own calibration,
# whose scales differ from JAX's by f32 ulps all through the ladder
# (test_torch_port_int8_fpn's OWN_QTREE): cosine >= 0.99.
SAME_QTREE_COS, OWN_QTREE_COS = 0.9999, 0.99


@pytest.mark.parametrize("branch", [0, 1, 2], ids=["cls", "cnt", "reg"])
def test_int8_head_slice_levels_match_jax(head_setup, slice_runs, branch):
    for which, min_cos in (("levels", SAME_QTREE_COS), ("own", OWN_QTREE_COS)):
        for i, (got, want) in enumerate(zip(slice_runs[which][branch], head_setup["jlevels"][branch])):
            assert tuple(got.shape) == want.shape and bool(torch.isfinite(got).all())
            cos = _cos(got, want)
            print(f"{which} branch {branch} level {i}: cosine {cos:.8f}, max err {_rel_err(got, want):.4g} "
                  "of the range")
            assert cos >= min_cos, (which, branch, i, cos)


def test_int8_head_slice_detections_match_jax(slice_runs):
    """On the same qtrees, at least 95 of each image's top-100 JAX
    detections have a port detection of the same class at IoU > 0.9
    (printed: the measured count)."""
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


def test_default_pipeline_takes_raw_frames_and_backends_agree(head_setup, slice_runs):
    """The defaults build ``{"backbone", "fpn", "head"}`` and take the raw
    uint8 frames; ``backend="xla"`` (the per-op oracles) gives what the
    kernels' plain versions give."""
    pipe, args = slice_runs["pipe"], slice_runs["args"]
    frames = torch.from_numpy(head_setup["frames"])
    assert sorted(pipe.qtree) == ["backbone", "fpn", "head"] and pipe.u8_input
    assert torch.equal(pipe._input(frames), frames)
    xla = make_eval_pipeline_int8(*args, compute_dtype=torch.float32, backend="xla")
    xla.qtree = pipe.qtree
    for a_b, b_b in zip(xla.forward_levels(frames), slice_runs["own"]):
        assert all(torch.equal(a, b) for a, b in zip(a_b, b_b))


def test_int8_head_close_to_float_head(head_setup, slice_levels_q):
    """The int8 head against the port's float HISHead (f32) on the same
    dequantized levels: cosine > 0.99 per output and level (the contract
    of tests/test_quant.py:572-583)."""
    q = load_head_qtree(head_setup["jq_head"], "cpu")
    levels_q, scales = slice_levels_q
    got = head_int8.hishead_int8_forward(q, levels_q)
    with torch.no_grad():
        ref = head_setup["model"].head([(lq.float() * s).permute(0, 3, 1, 2) for lq, s in zip(levels_q, scales)])
    for name, g_b, r_b in zip(("cls", "cnt", "reg"), got, ref):
        for i, (g, r) in enumerate(zip(g_b, r_b)):
            cos = _cos(g, r.permute(0, 2, 3, 1))
            print(f"{name} level {i}: int8 vs float head cosine {cos:.6f}")
            assert cos > 0.99, (name, i, cos)


# ---------------------------------------------------------------- (f)

def test_load_head_qtree_round_trip_and_rejects_bad_trees(head_setup):
    qp, _ = port_head_qtree(32, 80, [(3, 5), (2, 2)], seed=4)
    back = load_head_qtree(jax_head_form(qp), "cpu")
    assert back["num_classes"] == 80 and len(back["levels"]) == 2 and isinstance(back["gnr"], tuple)
    back, qp = _flat(back), _flat(qp)
    assert sorted(back) == sorted(qp)
    assert all(back[k].dtype == v.dtype and torch.equal(back[k], v) for k, v in qp.items())
    jq = head_setup["jq_head"]
    bad = copy.deepcopy(jq)
    del bad["levels"][2]["Ac"]
    with pytest.raises(KeyError, match="missing"):
        load_head_qtree(bad, "cpu")
    bad = copy.deepcopy(jq)
    bad["levels"][0]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unused"):
        load_head_qtree(bad, "cpu")
    bad = copy.deepcopy(jq)
    bad["wc"] = bad["wc"][:, :, :8]
    with pytest.raises(ValueError, match="wc"):
        load_head_qtree(bad, "cpu")
    bad = copy.deepcopy(jq)
    bad["gnr"] = (bad["gnr"][0], bad["gnr"][1][:4])
    with pytest.raises(ValueError, match="gnr/1"):
        load_head_qtree(bad, "cpu")
    bad = dict(jq, num_classes=20.0)
    with pytest.raises(ValueError, match="num_classes"):
        load_head_qtree(bad, "cpu")
