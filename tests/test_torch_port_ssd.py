"""SSD300 in the port against the JAX package (CPU, f32): the submodules, the whole model, the int8 ladder, the
pipelines, a train step and the CLIs.

SSD300(21) exists at 300x300 only (its VALID extra layers need about 270
pixels), so the whole model runs there at B=1, built once for the module
from a perturbed variable tree (``torch_port_fixtures.perturbed_variables``:
He-normal kernels, the L2Norm scale around 20); the submodules run at small
shapes on their own:

  (a) ``default_boxes``; VGG16's two outputs (pool3's ceil mode on an odd
      map), L2Norm, each ExtraLayer (the stride-2 ones padded, the stride-1
      ones VALID) and the whole ``(loc, conf)`` against the flax modules,
      within 1e-4 of the range; the flax names (``l2norm/scale``, the bare
      ``conv2``);
  (b) the int8 ladder: the int8 max pools against JAX's ``_maxpool_i8``
      (2x2, pool3's ceil mode, pool5's 3x3/1 'same'); the calibration taps
      and the quantized tree against ``quantize_ssd300``'s; every requant
      point of ``ssd300_int8_forward`` (each VGG conv and pool, the
      scale-free L2Norm, each extra conv) equal to JAX's op by op on the
      same qtree, loc and conf within rtol 1e-5; the int8 model against the
      float one at the JAX test's cosines;
  (c) the float and int8 anchor pipelines against JAX's
      ``make_eval_pipeline_anchor`` and ``make_eval_pipeline_anchor_int8``
      (the int8 body run op by op on that function's qtree);
  (d) one f32 ``make_anchor_train_step`` (``"multibox"``, 0.5/0.5) against
      JAX's from one init (``l2norm.scale`` trains, nothing is frozen), the
      CLIs on the committed VOC tree and the refusals, and the qtree loader's.

The JAX int8 ladder runs op by op, not under ``jax.jit``.  Serially about
90 s on one torch thread, a third of it the JAX int8 ladder op by op.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.eval import evaluator as jev
from pytorch_object_detection_tpu.models import ssd as jssd
from pytorch_object_detection_tpu.models import ssd_int8 as js8
from pytorch_object_detection_tpu.nn.vgg import VGG16 as JaxVGG16
from pytorch_object_detection_tpu.ops import anchors as jan
from pytorch_object_detection_tpu_torch.eval.evaluator import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    make_default_pipeline,
    make_eval_pipeline_anchor,
    make_eval_pipeline_anchor_int8,
)
from pytorch_object_detection_tpu_torch.models import ssd_int8
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.models.ssd import EXTRAS, ExtraLayer, L2Norm, default_boxes
from pytorch_object_detection_tpu_torch.nn.vgg import VGG16
from pytorch_object_detection_tpu_torch.train import trainer
from pytorch_object_detection_tpu_torch.train.checkpoints import (
    flax_to_state_dict,
    flax_to_torch_name,
    load_flax_variables,
    load_ssd300_qtree,
)
from test_torch_port_retinanet import _assert_same_detections
from test_torch_port_train import assert_step_matches, jax_capture_state, numpy_batch, port_state, run_port_steps
from torch_port_fixtures import (
    NUM_CLASSES,
    VOC_TREE,
    assert_close_to_ref,
    assert_same_qtree,
    assert_taps,
    cosine,
    jax_model,
    nchw,
    nhwc,
    perturbed_variables,
    run_cli,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

HW = (300, 300)
N_BOXES = 8732


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree(t):
    return jax.tree_util.tree_map(np.array, t)  # writable copies


def _jax_ladder(q, images):
    """The JAX ``ssd300_int8_forward`` op by op, keeping every requant point:
    ``input``, each conv, each pool (``<conv>.pool``), ``f1``, each extra
    conv (``extra<k>.c1``, ``.c2``); and (loc, conf)."""
    pts = {"input": js8.quantize_act(images, q["s_input"])}
    x, conv4_3 = pts["input"], None
    pools = {"conv1_2": {}, "conv2_2": {}, "conv3_3": dict(ceil=True), "conv4_3": {},
             "conv5_3": dict(window=3, stride=1, pad_same=True)}
    for name, pad, stride, dil in js8.VGG_CONVS:
        acc = js8._conv_i8(x, q[name]["w"], pad=pad, stride=stride, dilation=dil)
        x = pts[name] = js8._clip8(jnp.maximum(acc * q[name]["A"] + q[name]["B"], 0.0))
        if name == "conv4_3":
            conv4_3 = x
        if name in pools:
            x = pts[f"{name}.pool"] = js8._maxpool_i8(x, **pools[name])
    levels = [js8._clip8(js8._l2norm_f(conv4_3.astype(jnp.float32), q["l2_gamma"]) / q["s_f1"]), x]
    pts["f1"] = levels[0]
    for scope, stride, pad in js8.EXTRA_SPECS:
        for c, (p, s) in (("c1", (0, 1)), ("c2", (pad, stride))):
            blk = q[f"{scope}.{c}"]
            acc = js8._conv_i8(levels[-1] if c == "c1" else pts[f"{scope}.c1"], blk["w"], pad=p, stride=s)
            pts[f"{scope}.{c}"] = js8._clip8(jnp.maximum(acc * blk["A"] + blk["B"], 0.0))
        levels.append(pts[f"{scope}.c2"])
    locs, confs = [], []
    for i, feat in enumerate(levels):
        locs.append((js8._conv_i8(feat, q[f"loc{i}"]["w"], pad=1) * q[f"loc{i}"]["A"] + q[f"loc{i}"]["B"])
                    .reshape(1, -1, 4))
        confs.append((js8._conv_i8(feat, q[f"conf{i}"]["w"], pad=1) * q[f"conf{i}"]["A"] + q[f"conf{i}"]["B"])
                     .reshape(1, -1, NUM_CLASSES + 1))
    return pts, (jnp.concatenate(locs, 1), jnp.concatenate(confs, 1))


@pytest.fixture(scope="module")
def ssd():
    """One perturbed SSD300 in both packages at B=1: the JAX float outputs,
    JAX's float pipeline (jitted, f32), JAX's int8 pipeline built by its own
    function (``quantize_ssd300`` on the frames), that qtree, and its ladder
    run op by op on the frames (every requant point, loc and conf)."""
    params, _ = perturbed_variables(seed=90, model="SSD300")
    jm = jax_model("SSD300")
    rng = np.random.default_rng(91)
    x = rng.normal(size=(1, *HW, 3)).astype(np.float32)
    frames = rng.integers(0, 256, (1, *HW, 3), dtype=np.uint8)
    norm = ((frames.astype(np.float32) / np.float32(255.0) - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    whole = jax.jit(lambda v, x: jm.apply(v, x, False))({"params": params}, x)
    jfloat = jev.make_eval_pipeline_anchor(jm, HW, compute_dtype=jnp.float32)
    jint8 = jev.make_eval_pipeline_anchor_int8(jm, {"params": params}, jnp.asarray(norm), HW)
    free = dict(zip(jint8.__code__.co_freevars, (c.cell_contents for c in jint8.__closure__)))
    jq = _tree(free["qtree"])
    pts, maps = _jax_ladder(jax.tree_util.tree_map(jnp.asarray, jq), jnp.asarray(norm))
    model = build_model("SSD300", NUM_CLASSES, device="cpu")
    load_flax_variables(model, params)
    return dict(params=params, jm=jm, x=x, frames=frames, norm=norm, whole=[np.asarray(t) for t in whole],
                jfloat=[np.asarray(t) for t in jfloat(params, {}, jnp.asarray(frames))], jq=jq, pts=_tree(pts),
                maps=_tree(list(maps)), model=model)


# ---------------------------------------------------------------- (a) the float modules

def test_default_boxes_match_jax():
    got = default_boxes(300)
    want = np.asarray(jssd.default_boxes(300))
    assert got.dtype == torch.float32 and tuple(got.shape) == (N_BOXES, 4) and np.array_equal(_np(got), want)


def test_vgg16_matches_flax(ssd):
    """76x76: pool3 meets the odd 19x19 map (ceil mode: 10x10), pool5 and
    conv6's dilation 6 run on 5x5."""
    x = np.random.default_rng(92).normal(size=(2, 76, 76, 3)).astype(np.float32)
    want = JaxVGG16().apply({"params": ssd["params"]["backbone"]}, x)
    vgg = load_flax_variables(VGG16(), ssd["params"]["backbone"]).eval()
    with torch.no_grad():
        got = vgg(nchw(x))
    assert [tuple(nhwc(g).shape) for g in got] == [(2, 10, 10, 512), (2, 5, 5, 1024)]
    for g, w, name in zip(got, want, ("conv4_3", "conv7")):
        assert_close_to_ref(nhwc(g), np.asarray(w), name)


def test_l2norm_matches_flax(ssd):
    x = np.random.default_rng(93).normal(size=(2, 6, 7, 512)).astype(np.float32)
    x[0, 0, 0] = 0.0  # a zero vector: the 1e-10 keeps it finite
    want = jssd.L2Norm().apply({"params": ssd["params"]["l2norm"]}, x)
    norm = load_flax_variables(L2Norm(512), ssd["params"]["l2norm"])
    with torch.no_grad():
        got = norm(nchw(x))
    assert_close_to_ref(nhwc(got), np.asarray(want), "L2Norm")
    assert float(norm.scale.detach().mean()) == pytest.approx(20.0, rel=0.1)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_extra_layer_matches_flax(ssd, k):
    cin, mid, out, stride, pad = EXTRAS[k - 1]
    size = (19, 10, 5, 3)[k - 1]
    x = np.abs(np.random.default_rng(94 + k).normal(size=(2, size, size, cin))).astype(np.float32)
    want = jssd.ExtraLayer(mid, out, stride, pad=bool(pad)).apply({"params": ssd["params"][f"extra{k}"]}, x)
    layer = load_flax_variables(ExtraLayer(cin, mid, out, stride, pad), ssd["params"][f"extra{k}"])
    with torch.no_grad():
        got = layer(nchw(x))
    assert nhwc(got).shape == np.asarray(want).shape == (2, (10, 5, 3, 1)[k - 1], (10, 5, 3, 1)[k - 1], out)
    assert_close_to_ref(nhwc(got), np.asarray(want), f"extra{k}")


def test_ssd300_forward_matches_flax(ssd):
    with torch.no_grad():
        loc, conf = ssd["model"](torch.from_numpy(ssd["x"]))
    assert tuple(loc.shape) == (1, N_BOXES, 4) and tuple(conf.shape) == (1, N_BOXES, NUM_CLASSES + 1)
    assert_close_to_ref(loc, ssd["whole"][0], "loc")
    assert_close_to_ref(conf, ssd["whole"][1], "conf")


def test_flax_names_map_onto_the_port(ssd):
    assert flax_to_torch_name(("l2norm", "scale")) == "l2norm.scale"
    assert flax_to_torch_name(("extra1", "conv2", "kernel")) == "extra1.conv2.weight"
    assert flax_to_torch_name(("extra1", "conv1", "conv", "kernel")) == "extra1.conv1.weight"
    assert sorted(flax_to_state_dict(ssd["params"])) == sorted(ssd["model"].state_dict())
    assert [ssd["model"].extra3.conv2.padding, ssd["model"].extra1.conv2.padding] == [(0, 0), (1, 1)]


# ---------------------------------------------------------------- (b) the int8 ladder

@pytest.mark.parametrize("form", [dict(), dict(ceil=True), dict(window=3, stride=1, pad_same=True)],
                         ids=["2x2", "ceil", "same3x3"])
def test_int8_maxpool_matches_jax(form):
    x = np.random.default_rng(95).integers(-127, 128, (2, 75, 37, 16)).astype(np.int8)
    want = np.asarray(js8._maxpool_i8(jnp.asarray(x), **form))
    kw = dict(dict(window=2, stride=2, ceil=False, pad_same=False), **form)
    got = ssd_int8.maxpool_i8(torch.from_numpy(x), **kw)
    assert got.dtype == torch.int8 and np.array_equal(_np(got), want), want.shape


def test_calibrate_and_quantize_match_jax(ssd, monkeypatch):
    """Taps within rtol 1e-5 of JAX's on the same f32 frames; from JAX's
    taps, every int8 weight identical and every scale and shift within rtol
    1e-5 (VGG has no norm to fold)."""
    model, norm = ssd["model"], torch.from_numpy(ssd["norm"])
    jtaps = {k: float(v) for k, v in jax.jit(js8.calibrate_ssd)(ssd["params"], jnp.asarray(ssd["norm"])).items()}
    assert_taps(ssd_int8.calibrate_ssd(model, norm), jtaps)
    monkeypatch.setattr(ssd_int8, "calibrate_ssd", lambda m, x: jtaps)
    assert_same_qtree(ssd_int8.quantize_ssd300(model, norm), load_ssd300_qtree(ssd["jq"], "cpu"))


def test_ssd300_int8_matches_jax(ssd):
    """On JAX's qtree and frames: every requant point equal to JAX's op by op
    (each from its own previous stage), loc and conf within rtol 1e-5."""
    q = load_ssd300_qtree(ssd["jq"], "cpu")
    pts = {k: torch.from_numpy(v) for k, v in ssd["pts"].items()}
    n_points = 0

    def same(name, got):
        nonlocal n_points
        want = ssd["pts"][name]
        n_diff = int((_np(got) != want).sum())
        assert got.dtype == torch.int8 and tuple(got.shape) == want.shape and n_diff == 0, (name, n_diff)
        n_points += 1

    same("input", ssd_int8.quantize_act(torch.from_numpy(ssd["norm"]), q["s_input"]))
    prev = pts["input"]
    for name, pad, stride, dil in ssd_int8.VGG_CONVS:
        same(name, ssd_int8._rq(prev, q[name], pad, stride, dil))
        prev = pts[name]
        if name in ssd_int8.POOL_AFTER:
            same(f"{name}.pool", ssd_int8.maxpool_i8(prev, *ssd_int8.POOL_AFTER[name]))
            prev = pts[f"{name}.pool"]
    same("f1", ssd_int8.clip8(ssd_int8._l2norm_f(pts["conv4_3"].float(), q["l2_gamma"]) / q["s_f1"]))
    for scope, stride, pad in ssd_int8.EXTRA_SPECS:
        same(f"{scope}.c1", ssd_int8._rq(prev, q[f"{scope}.c1"]))
        same(f"{scope}.c2", ssd_int8._rq(pts[f"{scope}.c1"], q[f"{scope}.c2"], pad, stride))
        prev = pts[f"{scope}.c2"]
    print(f"{n_points} requant points equal to JAX's")
    levels = ssd_int8.ssd300_int8_levels(q, torch.from_numpy(ssd["norm"]))
    assert [tuple(lv.shape[1:3]) for lv in levels] == [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
    got = ssd_int8.ssd300_int8_forward(ssd["model"], q, torch.from_numpy(ssd["norm"]))
    for name, g, w in zip(("loc", "conf"), got, ssd["maps"]):
        print(f"{name}: max err {float(np.abs(_np(g) - w).max() / np.abs(w).max()):.3g} of the range")
        np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


def test_int8_close_to_float(ssd):
    """The JAX test's contract (tests/test_ssd_int8.py:49-50), on the port's
    own calibration on a normal draw: loc and conf cosines to the float
    model > 0.999 on another."""
    model = ssd["model"]
    calib = np.random.default_rng(97).normal(size=(1, *HW, 3)).astype(np.float32)  # the JAX test's draw: normal
    q = ssd_int8.quantize_ssd300(model, torch.from_numpy(calib))
    x = torch.from_numpy(ssd["x"])
    loc_i, conf_i = ssd_int8.ssd300_int8_forward(model, q, x)
    with torch.no_grad():
        loc_f, conf_f = model(x)
    c_loc, c_conf = cosine(loc_i, loc_f), cosine(conf_i, conf_f)
    print(f"int8 vs float: loc cosine {c_loc:.6f}, conf cosine {c_conf:.6f}")
    assert c_loc > 0.999 and c_conf > 0.999


# ---------------------------------------------------------------- (c) the pipelines

def test_float_pipeline_matches_jax(ssd):
    pipe = make_eval_pipeline_anchor(ssd["model"], HW, compute_dtype=torch.float32)
    assert pipe.activation == "softmax_bg0" and tuple(pipe.anchors.shape) == (N_BOXES, 4)
    dets = pipe(torch.from_numpy(ssd["frames"]))
    assert bool(((dets.classes >= 1) & (dets.classes <= NUM_CLASSES)).all())  # the background never a class
    _assert_same_detections(dets, ssd["jfloat"], "float pipeline", exact=False)
    assert type(make_default_pipeline(ssd["model"], (), HW, nms_iou=0.45)) is type(pipe)
    with pytest.raises(ValueError, match="300x300"):
        make_eval_pipeline_anchor(ssd["model"], (304, 304))


def test_int8_pipeline_matches_jax(ssd):
    """On JAX's qtree (carried across), the detections of JAX's pipeline body
    run op by op: identical."""
    frames = torch.from_numpy(ssd["frames"])
    pipe = make_eval_pipeline_anchor_int8(ssd["model"], torch.from_numpy(ssd["norm"]), HW)
    assert sorted(pipe.qtree)[:3] == ["conf0", "conf1", "conf2"] and "l2_gamma" in pipe.qtree
    pipe.qtree = load_ssd300_qtree(ssd["jq"], "cpu")
    a = jnp.asarray(_np(default_boxes(300)))
    want = [np.asarray(t) for t in jan.decode_anchor_detections(a, jnp.asarray(ssd["maps"][0]),
                                                                 jnp.asarray(ssd["maps"][1]), "softmax_bg0", 0.05,
                                                                 0.5, 1000, HW)]
    _assert_same_detections(pipe(frames), want, "int8 pipeline")


# ---------------------------------------------------------------- (d) training, the CLIs

def test_anchor_train_step_matches_jax():
    """One f32 SGD step of SSD300(5 + 1) (MultiBox, 0.5/0.5) at B=1 from the
    same weights and batch: the loss, each parameter's gradient and the
    updated parameters (the train test's tolerances); nothing is frozen
    (VGG has no BatchNorm and no ``conv1``), ``l2norm.scale`` among them."""
    from pytorch_object_detection_tpu.train import trainer as jt

    n_classes = 5
    params, stats = perturbed_variables(96, "SSD300", n_classes)
    state = jax_capture_state("SSD300", 0, params, stats)
    a = jssd.default_boxes(300)
    step = jt.make_anchor_train_step(jax_model("SSD300", n_classes), a, n_classes, jnp.float32, 0.5, 0.5,
                                     donate=False, loss="multibox")
    images, boxes, labels = numpy_batch(hw=HW, batch=1)
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(labels))
    want = ({k: float(v) for k, v in metrics.items()}, flax_to_state_dict(jax.device_get(state.opt_state[0])),
            flax_to_state_dict(jax.device_get(state.params)))
    port = port_state("SSD300", 0, params, stats)
    assert set(trainer.param_labels(port.model, True, 0).values()) == {"train"}
    assert "l2norm.scale" in port.trainable_names()
    pstep = trainer.make_anchor_train_step(port.model, torch.tensor(np.asarray(a)), n_classes, torch.float32,
                                           0.5, 0.5, "multibox")
    ((m, grads, after),) = run_port_steps(port, 1, tuple(torch.from_numpy(t) for t in (images, boxes, labels)),
                                          step=pstep)
    assert_step_matches(port, m, grads, after, *want, "SSD300 multibox step")


def _ssd_config(tmp_path) -> str:
    data = tmp_path / "ssd_data.yaml"
    data.write_text(f"dataset_setting:\n  class_num : 20\n  train_07 : '{VOC_TREE}'\n  test_07 : '{VOC_TREE}'\n"
                    f"  type : 'test'\n  input : [128, 128]\n  num_workers : 2\n  max_boxes : 16\n"
                    f"SSD300:\n  input : [300, 300]\n  canvas_align : 1\n  channel : 256\n  Epoch : 1\n"
                    f"  batch_size : 2\n  optimizer : {{name : SGD, lr : 1.0e-3}}\n  schedule : {{warmup_steps : 10}}\n"
                    f"  criterion : multibox\n  pos_iou : 0.5\n  neg_iou : 0.5\n  eval : {{nms_iou: 0.45}}\n")
    main = tmp_path / "ssd.yaml"
    main.write_text(f"dataset : VOC\nmodel : SSD300\nVOC : {data}\nsavename : ssd\n")
    return str(main)


def test_ssd300_clis(tmp_path, capsys):
    """``podt-torch-train --synthetic`` for a step at 300x300, ``eval_voc``
    of its checkpoint over the committed VOC tree; the JAX CLIs' refusals
    with exit 2 (``--ref-4stride``, the device resize; ``eval_coco --int8``
    is tests/test_torch_port_coco.py's)."""
    from pytorch_object_detection_tpu_torch.cli import eval_voc

    cfg = _ssd_config(tmp_path)
    run = run_cli(tmp_path, "train", "--config", cfg, "--device", "cpu", "--synthetic", "--steps", "1",
                  "--log-every", "1000")  # no TensorBoard writer: it would import TensorFlow
    assert run.returncode == 0, run.stdout + run.stderr
    assert "training SSD300 on cpu" in run.stdout and "training done: step 1" in run.stdout
    run = run_cli(tmp_path, "eval_voc", "--config", cfg, "--split", "test", "--batch-size", "4", "--device", "cpu",
                  "--checkpoint", str(tmp_path / "checkpoint" / "ssd"))
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    assert lines[-1].startswith("mAP=====>") and sum(line.startswith("ap for ") for line in lines) == 20
    for flag in ("--ref-4stride", "--device-resize"):
        assert eval_voc.main(["--config", cfg, "--device", "cpu", flag]) == 2
        assert "SSD300" in capsys.readouterr().err


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_ssd300_qtree_loader_rejects_bad_trees(ssd, fault):
    bad = _tree(ssd["jq"])
    if fault == "missing":
        del bad["extra3.c2"]["B"]
    elif fault == "unused":
        bad["conv6"]["extra"] = np.zeros(3, np.float32)
    else:
        bad["loc5"]["A"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        load_ssd300_qtree(bad, "cpu")


def test_entry_points():
    built = build_model("ssd300", 20, 999, device="cpu", frozen_stages=1, generator=torch.Generator().manual_seed(1))
    assert built.num_classes == 21 and tuple(built.conf0.weight.shape) == (4 * 21, 512, 3, 3)
    assert tuple(built.conf1.weight.shape) == (6 * 21, 1024, 3, 3) and tuple(built.loc5.weight.shape) == (16, 256, 3, 3)
    w = built.extra2.conv2.weight.detach()  # the bare flax conv's lecun normal: std sqrt(1 / fan_in), cut at 2 std
    assert float(w.std()) == pytest.approx((1.0 / (128 * 9)) ** 0.5, rel=0.05)
    assert float(w.abs().max()) <= 2.0 * (1.0 / (128 * 9)) ** 0.5 / 0.87962566 + 1e-6
    with pytest.raises(ValueError, match="own ladder"):
        trainer.quantize_backbone(built, torch.zeros(1, 300, 300, 3))
    with pytest.raises(ValueError, match="compute_dtype"):
        trainer.make_anchor_train_step(built, default_boxes(300), 20, compute_dtype=torch.float16)
