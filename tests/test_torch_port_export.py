"""The serving export of the port against the JAX package's (CPU, f32).

  (a) ``torch.library.opcheck`` on every ``podt`` op (``ops/library.py``)
      at a small shape: the CPU implementation (the plain version) against
      the fake one, the schema, and the op traced with dynamic shapes; the
      arguments are those the wrappers build when they take the op route;
  (b) JAX ``tests/test_aux.py``'s ``test_export_eval_pipeline_roundtrip``
      and ``test_export_int8_serving_roundtrip`` mirrored: HISFCOS(5, 64)
      at 128x128, B=2, 50 detections, the same weights on both sides
      (``load_flax_variables``) and, for int8, JAX's qtree
      (``load_backbone_qtree`` / ``load_fpn_qtree`` / ``load_head_qtree``).
      The port's saved-and-loaded program equals its live pipeline bit for
      bit, and its graph holds one op node per kernel call the pipeline
      makes.  Float: JAX's ``export_eval_pipeline`` computes in its default
      bf16, so the test runs it with JAX's ``make_eval_pipeline`` at f32, as
      the port's program runs on the CPU; the two agree within JAX's own
      tolerance (scores atol 1e-5, ``valid`` equal; measured 5.7e-7 on an
      x86-64 CPU).  int8: the port's program equals JAX's pipeline run op by
      op (scores atol 1e-5, measured 0; ``valid`` equal).  JAX's 5e-3
      (artifact against its live jitted pipeline) does not hold against
      the artifact: XLA's fusions move int8 values by a step, which the
      GroupNorms of the 2x2 and 1x1 levels amplify, and the artifact's
      scores lie 0.0253 from JAX's own op-by-op math at this size; the
      port's lie no farther from the artifact than that, with ``valid``
      equal.

Serially about 90 s on one torch thread, most of it the two JAX exports'
compiles and JAX's op-by-op int8 run.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu_torch.eval.evaluator import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    make_eval_pipeline,
    make_eval_pipeline_int8,
)
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.ops import library
from pytorch_object_detection_tpu_torch.train.checkpoints import (
    load_backbone_qtree,
    load_flax_variables,
    load_fpn_qtree,
    load_head_qtree,
)
from pytorch_object_detection_tpu_torch.utils import export as X
from torch_port_fixtures import jax_model, perturbed_module_variables, port_block, port_head_qtree, rand_qblock
from torch_port_fixtures import port_hisfpn_qtree, port_stem_s2d
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

CLASSES, HW, BATCH, MAX_DET = 5, (128, 128), 2, 50
# launches of one call of each pipeline on the card, as op nodes of the graph (the plain NMS on the CPU)
FLOAT_NODES = {"groupnorm_act": 20, "nms_fixpoint": 1}
INT8_NODES = {"qstem_conv": 1, "qbottleneck": 13, "qbottleneck_s2": 3, "qmatmul": 3, "qmaxpool2x2_seeds": 1,
              "qhisblock": 7, "qhishead_level": 5, "nms_fixpoint": 1}


# ---------------------------------------------------------------- (a)

def _captured(module, attr: str, call):
    """The arguments ``call()`` hands ``module.<attr>`` (an op) on the op route."""
    seen = []
    op = getattr(module, attr)

    def record(*args):
        seen.append(args)
        return op(*args)

    setattr(module, attr, record)
    library.EAGER_OPS = True
    try:
        call()
    finally:
        library.EAGER_OPS = False
        setattr(module, attr, op)
    assert seen, attr
    return seen[0]


def _i8(g, *shape):
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


def _case(name: str):
    """(op, arguments) of one op at a small shape, through its wrapper."""
    from pytorch_object_detection_tpu_torch.models.heads import HISHead
    from pytorch_object_detection_tpu_torch.ops import cuda_nms, gn, head, nms, qblock, qchain, qconv, qhead, qhis
    from pytorch_object_detection_tpu_torch.ops import qpool, qstem, stem

    g = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(7)
    boxes = torch.rand(2, 40, 2, generator=g) * 50
    boxes = torch.cat([boxes, boxes + 5 + torch.rand(2, 40, 2, generator=g) * 20], -1)
    valid = torch.rand(2, 40, generator=g) > 0.2
    x8 = _i8(g, 2, 8, 8, 64)
    blk = port_block(rand_qblock(rng, 64, 16, 64, projection=False))
    blk2 = port_block(rand_qblock(rng, 64, 16, 64, projection=True))
    vecs = [blk2[k] for k in ("A1", "B1", "A2", "B2", "A3", "B3")]
    if name == "nms_keep_mask":
        return cuda_nms, "nms_keep_mask_op", lambda: cuda_nms.cuda_nms_keep_mask(boxes, valid, 0.5)
    if name == "nms_fixpoint":
        return nms, "nms_fixpoint_op", lambda: nms.nms_fixpoint_op(boxes, valid, 0.5)
    if name == "groupnorm_act":
        x, sc = torch.randn(2, 64, 5, 7, generator=g), torch.rand(64, generator=g) + 0.5
        bi = torch.randn(64, generator=g)
        return gn, "groupnorm_act_op", lambda: gn.groupnorm_act(x, sc, bi, act="silu")
    if name == "qstem_conv":
        frames = torch.randint(0, 256, (2, 16, 24, 3), generator=g, dtype=torch.uint8)
        st = port_stem_s2d(3)
        return qstem, "qstem_conv_op", lambda: qstem.qstem_conv(frames, st)
    if name == "qbottleneck":
        return qblock, "qbottleneck_op", lambda: qblock.qbottleneck(
            x8, blk["w1"], blk["w2"], blk["w3"], *[blk[k] for k in ("A1", "B1", "A2", "B2", "A3", "B3")],
            short_mul=blk["short_mul"])
    if name == "qbottleneck_s2":
        return qblock, "qbottleneck_s2_op", lambda: qblock.qbottleneck_s2(
            x8, blk2["w1"], blk2["w2"], blk2["w3"], blk2["wd"], *vecs, blk2["Ad"], blk2["Bd"])
    if name == "qmatmul":
        w, a, b = _i8(g, 32, 64), torch.rand(32, generator=g) * 1e-3, torch.randn(32, generator=g)
        res = _i8(g, 128, 32)
        return qconv, "qmatmul_op", lambda: qconv.qmatmul(x8.reshape(-1, 64), w, a, b, res=res, res_scale=0.7)
    if name == "qconv3x3":
        w, a, b = _i8(g, 32, 3, 3, 64), torch.rand(32, generator=g) * 1e-3, torch.randn(32, generator=g)
        return qconv, "qconv3x3_op", lambda: qconv.qconv3x3(x8, w, a, b)
    if name in ("qmaxpool2x2", "qmaxpool2x2_seeds", "qmaxpool3x3s2"):
        x = _i8(g, 2, 9, 11, 32)
        return qpool, f"{name}_op", lambda: getattr(qpool, name)(x)
    if name == "qhisblock":
        his = port_hisfpn_qtree(32)["his2"]
        xa, xb = _i8(g, 2, 4, 6, 32), _i8(g, 2, 8, 12, 32)
        return qhis, "qhisblock_op", lambda: qhis.qhisblock(his, xa, xb_q=xb, combine="up_add", ca=0.8,
                                                            cb=torch.tensor(0.6))
    if name in ("qhishead_level", "qhishead_level2"):
        q, levels_q = port_head_qtree(32, 3, [(6, 5)])
        return qhead, f"{name}_op", lambda: getattr(qhead, name)(q, q["levels"][0], levels_q[0])
    if name == "stem_bn_pool_quant":
        x, mult, shift = torch.randn(2, 9, 7, 16, generator=g), torch.rand(16, generator=g) + 0.5, torch.randn(
            16, generator=g)
        return stem, "stem_bn_pool_quant_op", lambda: stem.stem_bn_pool_quant(x, mult, shift, torch.tensor(0.05))
    if name == "qchain":
        chain, x = [(blk2, 2), (blk, 1)], _i8(g, 2, 9, 7, 64)
        return qchain, "qchain_op", lambda: qchain.qchain(x, chain)
    if name == "hishead_level_fused":
        packed = head.hishead_params_pack(HISHead(3, 32, generator=g).eval(), 3, torch.bfloat16)
        x = torch.randn(2, 5, 6, 32, generator=g).to(torch.bfloat16)
        return head, "hishead_level_fused_op", lambda: head.hishead_level_fused(x, packed, 3)
    raise KeyError(name)


OPS = ("nms_keep_mask", "nms_fixpoint", "groupnorm_act", "qstem_conv", "qbottleneck", "qbottleneck_s2", "qmatmul",
       "qconv3x3", "qmaxpool2x2", "qmaxpool2x2_seeds", "qmaxpool3x3s2", "qhisblock", "qhishead_level",
       "qhishead_level2", "stem_bn_pool_quant", "qchain", "hishead_level_fused")


def test_every_op_is_covered():
    library.load_ops()
    defined = {n for n in dir(torch.ops.podt) if not n.startswith("_") and n != "name"}
    assert defined == set(OPS)


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    """opcheck: the schema, the fake implementation against the CPU one (shapes, dtypes, strides), the op
    under aot_autograd with dynamic shapes; and the op's output equals the wrapper's direct (plain) result."""
    module, attr, call = _case(name)
    args = _captured(module, attr, call)
    op = getattr(torch.ops.podt, name).default
    torch.library.opcheck(op, args)
    got, direct = op(*args), call()
    for a, b in zip(got if isinstance(got, tuple) else (got,), direct if isinstance(direct, tuple) else (direct,)):
        assert torch.equal(a, b), name


def test_wrappers_take_the_op_only_while_tracing():
    """Eager calls launch directly (no op in between); under the tracer the
    wrapper is one op node; on ``meta`` tensors the fake implementation runs."""
    from pytorch_object_detection_tpu_torch.ops import gn

    class M(torch.nn.Module):
        def forward(self, x, s, b):
            return gn.groupnorm_act(x, s, b, act="relu")

    x, s, b = torch.randn(1, 32, 3, 3), torch.ones(32), torch.zeros(32)
    assert not library.tracing(x) and not library.route(x)
    graph = torch.export.export(M(), (x, s, b), strict=False).graph
    assert [str(n.target) for n in graph.nodes if n.op == "call_function"] == ["podt.groupnorm_act.default"]
    meta = gn.groupnorm_act(x.to("meta"), s.to("meta"), b.to("meta"))
    assert meta.is_meta and meta.shape == x.shape


# ---------------------------------------------------------------- (b)

@pytest.fixture(scope="module")
def setup():
    """Both packages' HISFCOS(5, 64) on the same perturbed weights; the frames and the calibration batch."""
    jm = jax_model("HISFCOS", CLASSES)
    params, stats = perturbed_module_variables(jm, (1, *HW, 3), 23)
    model = build_model("HISFCOS", CLASSES, 64, device="cpu")
    load_flax_variables(model, params, stats)
    frames = np.random.default_rng(0).integers(0, 255, (BATCH, *HW, 3), np.uint8)
    calib = np.random.default_rng(1).uniform(size=(BATCH, *HW, 3)).astype(np.float32)
    return dict(jm=jm, params=params, stats=stats, model=model.eval(), frames=frames, calib=calib)


def _port_roundtrip(ep, tmp_path, name):
    path = str(tmp_path / f"{name}.pt2")
    X.save_exported(ep, path)
    return X.load_exported(path)


def test_export_eval_pipeline_roundtrip(setup, tmp_path, monkeypatch):
    import functools

    import jax.numpy as jnp
    from pytorch_object_detection_tpu.eval import evaluator as jev
    from pytorch_object_detection_tpu.utils import export as jx

    # JAX's export computes in make_eval_pipeline's default bf16; here in f32, as the port's program on the CPU
    monkeypatch.setattr(jev, "make_eval_pipeline", functools.partial(jev.make_eval_pipeline, compute_dtype=jnp.float32))
    jexp = jx.export_eval_pipeline(setup["jm"], setup["params"], setup["stats"], BATCH, HW, max_detections=MAX_DET)
    jx.save_exported(jexp, str(tmp_path / "pipeline.jaxexport"))
    jscores, _, jboxes, jvalid = jx.load_exported(str(tmp_path / "pipeline.jaxexport")).call(
        jnp.asarray(setup["frames"]))

    ep = X.export_eval_pipeline(setup["model"], BATCH, HW, max_detections=MAX_DET, compute_dtype=torch.float32)
    assert X.op_counts(ep) == FLOAT_NODES
    loaded = _port_roundtrip(ep, tmp_path, "float")
    frames = torch.from_numpy(setup["frames"])
    scores, classes, boxes, valid = loaded.module()(frames)
    assert tuple(boxes.shape) == (BATCH, MAX_DET, 4)
    live = make_eval_pipeline(setup["model"], X.STRIDES, HW, max_detections=MAX_DET, compute_dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip((scores, classes, boxes, valid), live(frames)))
    err = float(np.abs(scores.numpy() - np.asarray(jscores)).max())
    print(f"float: port program vs JAX artifact, max |scores diff| {err:.3g}")
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-5)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))

    # the weights as an input (JAX bake_weights=False): the same detections from the model's state dict
    ep_w = X.export_eval_pipeline(setup["model"], BATCH, HW, max_detections=MAX_DET, bake_weights=False,
                                  compute_dtype=torch.float32)
    weights = {k: v.detach().clone() for k, v in setup["model"].state_dict().items()}
    got = _port_roundtrip(ep_w, tmp_path, "float_w").module()(weights, frames)
    assert all(torch.equal(a, b) for a, b in zip(got, (scores, classes, boxes, valid)))


def test_export_int8_serving_roundtrip(setup, tmp_path):
    import jax
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.train import trainer as jt
    from pytorch_object_detection_tpu.utils import export as jx

    from pytorch_object_detection_tpu.eval.evaluator import make_eval_pipeline_int8 as jax_make_eval_pipeline_int8

    jm, v = setup["jm"], {"params": setup["params"], "batch_stats": setup["stats"]}
    calib = jnp.asarray(setup["calib"])
    kw = dict(max_detections=MAX_DET, backend="xla", nms_impl="fixpoint")  # JAX's CPU-testable backends
    jexp = jx.export_eval_pipeline_int8(jm, v, calib, BATCH, HW, **kw)
    jx.save_exported(jexp, str(tmp_path / "int8.jaxexport"))
    jscores, _, _, jvalid = jx.load_exported(str(tmp_path / "int8.jaxexport")).call(jnp.asarray(setup["frames"]))
    jpipe = jax_make_eval_pipeline_int8(jm, v, calib, X.STRIDES, HW, **kw)  # calibrated as the export's
    with jax.disable_jit():  # JAX's pipeline op by op: its math without XLA's fusions
        jlive = jpipe(v["params"], v["batch_stats"], jnp.asarray(setup["frames"]))
    # JAX's qtree, as its make_eval_pipeline_int8 calibrates it (f32 on the CPU)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    jq_bb = jt.quantize_backbone(jm, v, calib)
    jq_fpn = jt.quantize_fpn(jm, v, jq_bb, calib)
    jq_head = jt.quantize_head(jm, v, jq_bb, jq_fpn, calib)

    pipe = make_eval_pipeline_int8(setup["model"], torch.from_numpy(setup["calib"]), X.STRIDES, HW,
                                   max_detections=MAX_DET, compute_dtype=torch.float32)
    pipe.qtree = {"backbone": load_backbone_qtree(tree(jq_bb), "cpu"), "fpn": load_fpn_qtree(tree(jq_fpn), "cpu"),
                  "head": load_head_qtree(tree(jq_head), "cpu")}
    ep = X.export_pipeline(pipe, BATCH)
    assert X.op_counts(ep) == INT8_NODES
    frames = torch.from_numpy(setup["frames"])
    scores, classes, boxes, valid = _port_roundtrip(ep, tmp_path, "int8").module()(frames)
    assert tuple(boxes.shape) == (BATCH, MAX_DET, 4)
    assert all(torch.equal(a, b) for a, b in zip((scores, classes, boxes, valid), pipe(frames)))
    live_err = float(np.abs(scores.numpy() - np.asarray(jlive.scores)).max())
    err = float(np.abs(scores.numpy() - np.asarray(jscores)).max())
    jax_err = float(np.abs(np.asarray(jlive.scores) - np.asarray(jscores)).max())
    print(f"int8: max |scores diff|: port program vs JAX op by op {live_err:.3g}, vs JAX's artifact {err:.3g}; "
          f"JAX op by op vs its artifact {jax_err:.3g}")
    np.testing.assert_allclose(scores.numpy(), np.asarray(jlive.scores), atol=1e-5)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jlive.valid))
    assert err <= jax_err + 1e-5
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))

    # the entry point calibrates on the same batch (f32 on the CPU) and exports the same graph
    ep2 = X.export_eval_pipeline_int8(setup["model"], torch.from_numpy(setup["calib"]), BATCH, HW,
                                      max_detections=MAX_DET, compute_dtype=torch.float32)
    assert X.op_counts(ep2) == INT8_NODES
    with pytest.raises(ValueError, match="no mesh, no device resize"):
        X.export_eval_pipeline_int8(setup["model"], torch.from_numpy(setup["calib"]), BATCH, HW, device_resize=True)


def test_normalize_constants_match_jax():
    """The programs normalize with the pipelines' ImageNet statistics, the JAX package's."""
    from pytorch_object_detection_tpu.data.pipeline import IMAGENET_MEAN as JM, IMAGENET_STD as JS

    np.testing.assert_array_equal(np.asarray(IMAGENET_MEAN, np.float32), np.asarray(JM, np.float32))
    np.testing.assert_array_equal(np.asarray(IMAGENET_STD, np.float32), np.asarray(JS, np.float32))
