"""Learning at the COCO canvas: the port against the JAX package (CPU).

  * ``data/synthetic_corpus``: ``write_synthetic_voc`` and
    ``write_synthetic_coco`` (and the module's command line) against
    ``scripts/make_synthetic_voc.py`` and ``scripts/make_synthetic_coco.py``
    run by subprocess, at ``--train 3 --val 2`` and two seeds: every file
    byte for byte (JPEG bytes, XML, JSON);
  * the COCO training data path: ``COCODataset(augment=HostAugment())``
    under ``DetectionLoader`` against the JAX classes on one corpus (an
    image left without annotations, a crowd row), at a cut canvas of
    128x256, with ``max_boxes`` 16 and 2 (the truncation keeps the
    annotation order): the same images, boxes, labels, scales and ids
    over two shuffled epochs, bit for bit;
  * the FCOS targets at the 896x1408 COCO canvas (P7 7x11) on the corpus's
    boxes with 80 classes, and one f32 train step of HISFCOS(80, 64) on a
    COCO batch at 128x256, B=2, from the same weights as JAX's step (the
    tolerances of tests/test_torch_port_train.py);
  * ``podt-torch-train --device cpu`` on a tiny COCO config (2 steps,
    ``--eval-every 1``), then ``podt-torch-eval-coco --device cpu
    --checkpoint`` on its checkpoint: exit 0, finite AP lines, and the
    detections those of the checkpoint's weights;
  * the last public functions: ``ops/boxes.ltrb_to_boxes``,
    ``boxes_to_ltrb``, ``box_area`` (exact), ``nn/layers.ConvBnAct``,
    ``SeparableConv``, ``MCBottle``, ``ICSPBlock`` on the JAX modules'
    variables (``assert_close_to_ref``), ``models/registry.register`` and
    ``train/trainer.make_eval_forward`` (f32 within ``assert_close_to_ref``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.core import config as jax_config
from pytorch_object_detection_tpu.data import augment as jax_augment
from pytorch_object_detection_tpu.data import coco as jax_coco
from pytorch_object_detection_tpu.data import pipeline as jax_pipeline
from pytorch_object_detection_tpu.models import registry as jax_registry
from pytorch_object_detection_tpu.nn import layers as jax_layers
from pytorch_object_detection_tpu.ops import boxes as jax_boxes
from pytorch_object_detection_tpu.ops import targets as jax_targets
from pytorch_object_detection_tpu.train import trainer as jax_trainer
from pytorch_object_detection_tpu_torch.core import config as port_config
from pytorch_object_detection_tpu_torch.data import augment, coco, pipeline, synthetic_corpus
from pytorch_object_detection_tpu_torch.eval.evaluator import evaluate_coco, make_eval_pipeline
from pytorch_object_detection_tpu_torch.models import registry
from pytorch_object_detection_tpu_torch.nn import layers
from pytorch_object_detection_tpu_torch.ops import boxes, targets
from pytorch_object_detection_tpu_torch.train import trainer
from pytorch_object_detection_tpu_torch.train.checkpoints import (
    flax_to_state_dict,
    load_flax_variables,
    load_model_checkpoint,
)
from test_torch_port_train import OPT_CFG, assert_step_matches, jax_capture_state
from torch_port_fixtures import (  # noqa: F401 (one_torch_thread: autouse)
    REPO,
    assert_close_to_ref,
    jax_model,
    one_torch_thread,
    perturbed_module_variables,
    perturbed_variables,
    run_cli,
)

CUT = (128, 256)  # a cut COCO canvas (tests/test_torch_port_coco.py's)
STRIDES = (8, 16, 32, 64, 128)
RANGES = [(-1, 32), (32, 96), (96, 192), (192, 384), (384, 9999999)]
COCO_CLASSES = 80


def tree_bytes(root):
    """``{relative path: bytes}`` of every file under ``root``."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


# ---------------------------------------------------------------------------
# the corpora
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kind", ["voc", "coco"])
def test_synthetic_corpus_matches_the_scripts_byte_for_byte(tmp_path, kind, seed):
    want_root, got_root = str(tmp_path / "script"), str(tmp_path / "port")
    script = os.path.join(REPO, "scripts", f"make_synthetic_{kind}.py")
    run = subprocess.run([sys.executable, script, want_root, "--train", "3", "--val", "2", "--seed", str(seed)],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert run.returncode == 0, run.stderr[-2000:]
    if kind == "voc":
        synthetic_corpus.write_synthetic_voc(got_root, 3, 2, seed)
    else:  # through the module's command line
        assert synthetic_corpus.main(["coco", got_root, "--train", "3", "--val", "2", "--seed", str(seed)]) == 0
    want, got = tree_bytes(want_root), tree_bytes(got_root)
    n_json = 2 if kind == "coco" else 0
    assert len(want) == (5 + n_json if kind == "coco" else 2 * 5 + 2), sorted(want)
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name


def test_synthetic_corpus_imports_no_jax():
    src = open(synthetic_corpus.__file__).read()
    assert "jax" not in src.replace("pytorch_object_detection_tpu_torch", "")
    code = ("import sys; import pytorch_object_detection_tpu_torch.data.synthetic_corpus; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'PIL', 'pytorch_object_detection_tpu')))")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and run.stdout.strip() == "[]", run.stdout + run.stderr


# ---------------------------------------------------------------------------
# the COCO training data path
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A seeded COCO corpus (6 train, 2 val images) whose train annotations
    lose image 3's boxes (``filter_empty`` drops it) and mark one row of
    image 1 as a crowd (kept out of the training targets)."""
    root = str(tmp_path_factory.mktemp("coco_corpus"))
    synthetic_corpus.write_synthetic_coco(root, 6, 2, 0)
    path = os.path.join(root, "instances_train.json")
    with open(path) as f:
        data = json.load(f)
    data["annotations"] = [a for a in data["annotations"] if a["image_id"] != 3]
    next(a for a in data["annotations"] if a["image_id"] == 1)["iscrowd"] = 1
    with open(path, "w") as f:
        json.dump(data, f)
    return root


def batches_of(loader, epochs: int = 2):
    out = []
    for _ in range(epochs):
        out += [(b.images.copy(), b.boxes.copy(), b.labels.copy(), b.scales.copy(), b.content_w.copy(),
                 list(b.image_ids)) for b in loader]
    return out


@pytest.mark.parametrize("max_boxes", [16, 2])
def test_coco_train_data_path_matches_jax(corpus, max_boxes):
    img_dir, ann = os.path.join(corpus, "train"), os.path.join(corpus, "instances_train.json")
    port_ds = coco.COCODataset(img_dir, ann, CUT, augment=augment.HostAugment(seed=7))
    jax_ds = jax_coco.COCODataset(img_dir, ann, CUT, augment=jax_augment.HostAugment(seed=7))
    assert len(port_ds) == len(jax_ds) == 5  # the image without boxes is filtered
    assert [im["id"] for im in port_ds.images] == [im["id"] for im in jax_ds.images]
    # one decode thread: the augment's random stream is drawn in the samples' order on both sides
    got = batches_of(pipeline.DetectionLoader(port_ds, 2, max_boxes=max_boxes, num_workers=1, seed=3,
                                              process_count=1, process_index=0))
    want = batches_of(jax_pipeline.DetectionLoader(jax_ds, 2, max_boxes=max_boxes, num_workers=1, seed=3,
                                                   process_count=1, process_index=0))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g[0].shape == (2, *CUT, 3) and g[0].tobytes() == w[0].tobytes()
        for a, b in zip(g[1:5], w[1:5]):
            np.testing.assert_array_equal(a, b)
        assert g[5] == w[5]
    n_boxes = [int((b[2] > 0).sum(1).max()) for b in got]
    assert max(n_boxes) == max_boxes or max_boxes == 16  # 2 truncates: every image holds at least 2 boxes
    assert port_ds.augment.rng.getstate() == jax_ds.augment.rng.getstate()
    assert all(int(lab.max()) <= COCO_CLASSES for _, _, lab, *_ in got)


def test_coco_canvas_targets_match_jax(corpus):
    """The recipe's level shapes (P7 7x11) and the FCOS targets of the
    corpus's boxes on the 896x1408 canvas, 80 classes."""
    cfg_path = os.path.join(REPO, "config", "synth_coco.yaml")
    port_cfg, jcfg = port_config.load_config(cfg_path), jax_config.load_config(cfg_path)
    shapes = port_config.level_shapes(port_cfg)
    assert shapes == jax_config.level_shapes(jcfg) == [(112, 176), (56, 88), (28, 44), (14, 22), (7, 11)]
    assert port_config.canvas_hw(port_cfg) == (896, 1408) and port_config.num_classes(port_cfg) == 80
    ranges = port_config.limit_ranges(port_cfg)
    ds = coco.COCODataset(os.path.join(corpus, "train"), os.path.join(corpus, "instances_train.json"))
    gt = np.full((len(ds), 16, 4), -1.0, np.float32)
    lab = np.full((len(ds), 16), -1, np.int32)
    for i, info in enumerate(ds.images):
        rows = np.asarray(ds.anns_by_img[info["id"]], np.float32)
        scale = min(896 / info["height"], 1408 / info["width"])
        gt[i, :len(rows)], lab[i, :len(rows)] = rows[:, :4] * scale, rows[:, 4]
    fn = jax.jit(lambda g, l: jax_targets.generate_targets(shapes, STRIDES, ranges, g, l))
    want = jax.device_get(fn(jnp.asarray(gt), jnp.asarray(lab)))
    got = targets.generate_targets(shapes, STRIDES, ranges, torch.from_numpy(gt), torch.from_numpy(lab))
    np.testing.assert_array_equal(got.cls.numpy(), np.asarray(want.cls))
    np.testing.assert_allclose(got.cnt.numpy(), np.asarray(want.cnt), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.reg.numpy(), np.asarray(want.reg), rtol=0, atol=1e-6)
    assert int(got.cls.max()) > 20 and (got.cls > 0).sum() > 0


def test_coco_train_step_matches_jax(corpus):
    """One f32 step of HISFCOS(80, 64), stage 1 frozen, on a COCO batch at
    128x256, B=2, against JAX's step from the same weights."""
    ds = coco.COCODataset(os.path.join(corpus, "train"), os.path.join(corpus, "instances_train.json"), CUT)
    batch = next(iter(pipeline.DetectionLoader(ds, 2, max_boxes=16, shuffle=False, num_workers=1,
                                               process_count=1, process_index=0)))
    mean, std = np.array(pipeline.IMAGENET_MEAN, np.float32), np.array(pipeline.IMAGENET_STD, np.float32)
    images = ((batch.images.astype(np.float32) / 255.0 - mean) / std).astype(np.float32)
    shapes = [(-(-CUT[0] // s), -(-CUT[1] // s)) for s in STRIDES]
    assert shapes[-1] == (1, 2)

    params, stats = perturbed_variables(4, "HISFCOS", COCO_CLASSES)
    model = jax_model("HISFCOS", COCO_CLASSES, frozen_stages=1)
    state = jax_capture_state("HISFCOS", 1, params, stats)
    step = jax_trainer.make_train_step(model, shapes, STRIDES, RANGES, "giou", jnp.float32, donate=False)
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(batch.boxes), jnp.asarray(batch.labels))
    want_losses = {k: float(v) for k, v in metrics.items()}
    want_grads = flax_to_state_dict(jax.device_get(state.opt_state[0]))
    want_after = flax_to_state_dict(jax.device_get(state.params))

    net = registry.build_model("HISFCOS", COCO_CLASSES, 64, frozen_stages=1, device="cpu")
    load_flax_variables(net, params, stats)
    pstate = trainer.create_train_state(net, OPT_CFG, freeze_bn=True, frozen_stages=1)
    m = trainer.make_train_step(net, shapes, STRIDES, RANGES, "giou", torch.float32)(
        pstate, torch.from_numpy(images), torch.from_numpy(batch.boxes), torch.from_numpy(batch.labels))
    grads = {k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None}
    after = {k: p.detach().clone() for k, p in net.named_parameters()}
    assert_step_matches(pstate, m, grads, after, want_losses, want_grads, want_after, "HISFCOS(80) COCO step")


# ---------------------------------------------------------------------------
# the CLIs on a tiny COCO config
# ---------------------------------------------------------------------------
def test_train_then_eval_coco_clis(tmp_path, corpus):
    data = tmp_path / "coco_data.yaml"
    data.write_text(
        f"dataset_setting:\n  class_num : 80\n  TrainData : '{corpus}/train'\n"
        f"  TrainAnnotation : '{corpus}/instances_train.json'\n  ValData : '{corpus}/val'\n"
        f"  ValAnnotation : '{corpus}/instances_val.json'\n  input : [{CUT[0]}, {CUT[1]}]\n  num_workers : 2\n"
        f"  max_boxes : 16\nHISFCOS:\n  channel: 64\n  Epoch: 2\n  batch_size: 4\n"
        f"  optimizer: {{name : SGD, lr : 5.0e-3, momentum : 0.9, weight_decay : 0.0001}}\n"
        f"  schedule: {{warmup_steps : 300, milestones : [800, 1050]}}\n  criterion : giou\n"
        f"  stride : {list(STRIDES)}\n  range : {[list(r) for r in RANGES]}\n")
    cfg = tmp_path / "coco.yaml"
    cfg.write_text(f"dataset : COCO\nmodel : HISFCOS\nCOCO : {data}\namp : True\nsavename : tiny_coco\n")
    run = run_cli(tmp_path, "train", "--config", str(cfg), "--device", "cpu", "--steps", "2", "--eval-every", "1",
                  "--log-every", "1000")  # no TensorBoard writer: it would import TensorFlow
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    assert "training HISFCOS on cpu" in run.stdout and "training done: step 2" in run.stdout, run.stdout
    assert "new best mAP" in run.stdout  # the eval of the first epoch ran (5 train images at B=4: a step an epoch)
    ckpt = str(tmp_path / "checkpoint" / "tiny_coco")
    assert max(os.listdir(ckpt)) == "step_00000002.pt"  # the newest, which the eval CLI reads
    assert os.listdir(ckpt + "_best")

    out = str(tmp_path / "dets.json")
    run = run_cli(tmp_path, "eval_coco", "--config", str(cfg), "--device", "cpu", "--batch-size", "2",
                  "--checkpoint", ckpt, "--results-json", out)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = dict(line.split(": ", 1) for line in run.stdout.splitlines() if ": " in line)
    for key in ("AP", "AP50", "AP75"):
        assert math.isfinite(float(lines[key])), run.stdout
    assert int(lines["num_images"]) == 2

    # the CLI's detections are those of the checkpoint's weights, not of the untrained init
    val = coco.COCODataset(os.path.join(corpus, "val"), os.path.join(corpus, "instances_val.json"), (128, 256),
                           filter_empty=False)
    dets = {}
    for what in ("trained", "untrained"):
        net = registry.build_model("HISFCOS", COCO_CLASSES, 64, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
        if what == "trained":
            load_model_checkpoint(net, ckpt)
        path = str(tmp_path / f"{what}.json")
        pipe = make_eval_pipeline(net, STRIDES, CUT, compute_dtype=torch.float32)
        evaluate_coco(net, val, strides=STRIDES, batch_size=2, results_json=path, verbose=False, pipeline=pipe)
        dets[what] = json.load(open(path))
    got = json.load(open(out))
    assert got and got == dets["trained"] and got != dets["untrained"]


# ---------------------------------------------------------------------------
# the last public functions
# ---------------------------------------------------------------------------
def test_ltrb_box_functions_match_jax():
    rng = np.random.default_rng(11)
    coords = rng.uniform(0, 512, (40, 2)).astype(np.float32)
    offsets = rng.uniform(0, 200, (3, 40, 4)).astype(np.float32)
    xyxy = rng.uniform(-50, 600, (3, 40, 4)).astype(np.float32)  # some with x2 < x1: area clamps them
    got = boxes.ltrb_to_boxes(torch.from_numpy(coords), torch.from_numpy(offsets)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_boxes.ltrb_to_boxes(jnp.asarray(coords), jnp.asarray(offsets))))
    back = boxes.boxes_to_ltrb(torch.from_numpy(coords), torch.from_numpy(xyxy)).numpy()
    np.testing.assert_array_equal(back, np.asarray(jax_boxes.boxes_to_ltrb(jnp.asarray(coords), jnp.asarray(xyxy))))
    area = boxes.box_area(torch.from_numpy(xyxy)).numpy()
    np.testing.assert_array_equal(area, np.asarray(jax_boxes.box_area(jnp.asarray(xyxy))))
    assert (area == 0).any() and (area > 0).any()
    # a round trip through both directions
    np.testing.assert_allclose(boxes.boxes_to_ltrb(torch.from_numpy(coords), torch.from_numpy(got)).numpy(), offsets,
                               rtol=0, atol=1e-4)


LIBRARY_MODULES = {
    # name: (JAX module, port module, input channels)
    "ConvBnAct": (lambda: jax_layers.ConvBnAct(32), lambda: layers.ConvBnAct(16, 32), 16),
    "ConvBnAct-DWconv-SiLU-s2": (lambda: jax_layers.ConvBnAct(16, stride=2, act="SiLU", mode="DWconv"),
                                 lambda: layers.ConvBnAct(16, 16, stride=2, act="SiLU", mode="DWconv"), 16),
    "ConvBnAct-5x5-d2": (lambda: jax_layers.ConvBnAct(24, kernel=5, dilation=2),
                         lambda: layers.ConvBnAct(16, 24, kernel=5, dilation=2), 16),
    "SeparableConv": (lambda: jax_layers.SeparableConv(24), lambda: layers.SeparableConv(16, 24), 16),
    "MCBottle": (lambda: jax_layers.MCBottle(16), lambda: layers.MCBottle(16, 16), 16),
    "ICSPBlock": (lambda: jax_layers.ICSPBlock(24), lambda: layers.ICSPBlock(16, 24), 16),
}


@pytest.mark.parametrize("name", sorted(LIBRARY_MODULES))
def test_library_modules_match_jax(name):
    """Each module on the JAX module's (perturbed) variables, loaded by
    ``load_flax_variables``: the same f32 output within
    ``assert_close_to_ref``'s tolerance (the convolutions' sums in another
    order)."""
    jax_ctor, port_ctor, cin = LIBRARY_MODULES[name]
    jmod = jax_ctor()
    params, stats = perturbed_module_variables(jmod, (2, 12, 10, cin), 3)
    x = np.random.default_rng(5).normal(0, 1, (2, 12, 10, cin)).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    want = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x), False))
    net = load_flax_variables(port_ctor().eval(), params, stats)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close_to_ref(got, want, name)


@dataclasses.dataclass
class _Toy:
    num_classes: int
    features: int = 256
    frozen_stages: int = 0


def test_register_matches_jax():
    """``@register`` adds a builder to the table ``build_model`` reads, under
    its upper-cased name, as JAX's does; keywords the builder lacks are
    dropped."""
    jax_registry.available_models()  # the JAX table fills itself only while empty
    try:
        assert registry.register("toy_net")(_Toy) is _Toy and jax_registry.register("toy_net")(_Toy) is _Toy
        assert "TOY_NET" in registry.available_models() and "TOY_NET" in jax_registry.available_models()
        got = registry.build_model("Toy_Net", 3, 8, frozen_stages=1, device="cpu")
        want = jax_registry.build_model("Toy_Net", 3, 8, frozen_stages=1, device="cpu")
        assert got == want == _Toy(3, 8, 1)
    finally:
        registry._PORTED.pop("TOY_NET", None)
        jax_registry._REGISTRY.pop("TOY_NET", None)
    assert "TOY_NET" not in registry.available_models() and "HISFCOS" in jax_registry.available_models()


def test_make_eval_forward_matches_jax():
    params, stats = perturbed_variables(6, "HISFCOS")
    images = np.random.default_rng(8).normal(0, 1, (2, 128, 128, 3)).astype(np.float32)
    want = jax_trainer.make_eval_forward(jax_model("HISFCOS"), jnp.float32)(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, stats), jnp.asarray(images))
    net = load_flax_variables(registry.build_model("HISFCOS", 20, 64, device="cpu"), params, stats)
    fwd = trainer.make_eval_forward(net, torch.float32)
    got = fwd(torch.from_numpy(images))
    for branch, g_b, w_b in zip(("cls", "cnt", "reg"), got, want):
        scale = max(float(np.abs(np.asarray(w)).max()) for w in w_b)
        for i, (g, w) in enumerate(zip(g_b, w_b)):
            assert g.dtype == torch.float32 and not g.requires_grad
            assert_close_to_ref(g, np.asarray(w), f"{branch} P{i + 3}", ref_scale=scale)
    # in bf16: a cast copy, f32 outputs, the caller's model untouched
    bf = trainer.make_eval_forward(net, torch.bfloat16)(torch.from_numpy(images))
    assert next(net.parameters()).dtype == torch.float32
    for g_b, b_b in zip(got, bf):
        for g, b in zip(g_b, b_b):
            assert b.dtype == torch.float32 and b.shape == g.shape
            assert float(torch.nn.functional.cosine_similarity(b.flatten(), g.flatten(), dim=0)) > 0.99
