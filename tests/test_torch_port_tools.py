"""The port's tools against the JAX package's (CPU, f32).

  (a) ``utils/gradcam.gradcam_fcos`` against JAX's on the same weights:
      HISFCOS, FCOS and FCOS on EfficientNet-B0 (20 classes, 64 features,
      128x128); MC_FCOS, which JAX's ``_fpn_head_for`` does not split
      (KeyError), is refused with a ValueError;
  (b) ``utils/model_info.model_info`` against JAX's for HISFCOS, FCOS and
      MNFCOS at 128x128: params, params by module, batch_stats and output
      shapes exact; FLOPs (FlopCounterMode against XLA's cost analysis)
      within [1.00, 1.10] of JAX's;
  (c) ``podt-torch-model-info`` prints the JAX CLI's "total params" line for
      FCOS at 128 (JAX ``tests/test_scripts.py:89-94``);
      ``podt-torch-visualize --device cpu`` on a committed JPEG writes its
      overlay and counts its pipeline's valid detections;
  (d) ``utils/profile``: ``StepTimer``, ``device_memory_stats("cpu")`` is
      None, a CPU trace that names its annotation; the entry points.

Serially about 70 s on one torch thread, most of it JAX's three compiles
for the FLOP counts and its GradCAM runs.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.train.checkpoints import load_flax_variables
from pytorch_object_detection_tpu_torch.utils import gradcam, model_info, profile
from torch_port_fixtures import CANVAS, FEATURES, NUM_CLASSES, REPO, VOC_TREE, jax_model, perturbed_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

# GradCAM, port against JAX: both run the same f32 network and its backward
# to C5 with the sums in another order; the map is ReLU of a 2048-channel sum
# that cancels, min-max normalized, so a small map amplifies the relative
# error.  Measured on an x86-64 CPU (printed): max 8.0e-6 and 3.37e-3 on
# HISFCOS's two images (mean 5.5e-4 on the second), 9.6e-6 on FCOS, 3.0e-6
# on FCOS on EfficientNet-B0
GRADCAM_ATOL, GRADCAM_MEAN = 1e-2, 1e-3
FLOP_RATIO = (1.00, 1.10)


def _frames(seed=3):
    return np.random.default_rng(seed).normal(0.0, 1.0, (2, CANVAS, CANVAS, 3)).astype(np.float32)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("name,kw", [("HISFCOS", {}), ("FCOS", {}), ("FCOS", {"backbone": "efficientnet-b0"})],
                         ids=["HISFCOS", "FCOS", "FCOS-effnet-b0"])
def test_gradcam_matches_jax(name, kw):
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.utils.gradcam import gradcam_fcos as jax_gradcam

    params, stats = perturbed_variables(seed=31, model=name, **kw)
    x = _frames()
    want = jax_gradcam(jax_model(name, **kw), {"params": params, "batch_stats": stats}, jnp.asarray(x))
    model = build_model(name, NUM_CLASSES, FEATURES, device="cpu", **kw)
    load_flax_variables(model, params, stats)
    got = gradcam.gradcam_fcos(model.eval(), torch.from_numpy(x))
    err, mean = float(np.abs(got - want).max()), float(np.abs(got - want).mean())
    print(f"{name} {kw}: GradCAM max abs diff {err:.3g}, mean {mean:.3g} (range [{got.min():.3g}, {got.max():.3g}])")
    assert got.shape == want.shape == (2, CANVAS, CANVAS)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert err <= GRADCAM_ATOL and mean <= GRADCAM_MEAN


def test_gradcam_refuses_mc_fcos_where_jax_fails():
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.utils.gradcam import gradcam_fcos as jax_gradcam

    params, stats = perturbed_variables(seed=32, model="MC_FCOS")
    with pytest.raises(KeyError, match="fpn"):  # JAX falls through to the FCOS branch: no params["fpn"]
        jax_gradcam(jax_model("MC_FCOS"), {"params": params, "batch_stats": stats}, jnp.asarray(_frames()[:1]))
    model = build_model("MC_FCOS", NUM_CLASSES, FEATURES, device="cpu")
    with pytest.raises(ValueError, match="MC_FCOS has no such split"):
        gradcam.gradcam_fcos(model, torch.from_numpy(_frames()[:1]))


def test_overlay_heatmap():
    image = np.full((4, 5, 3), 100, np.uint8)
    cam = np.linspace(0.0, 1.0, 20, dtype=np.float32).reshape(4, 5)
    out = gradcam.overlay_heatmap(image, cam)
    from pytorch_object_detection_tpu.utils.gradcam import overlay_heatmap as jax_overlay

    assert out.dtype == np.uint8 and out.shape == image.shape
    np.testing.assert_array_equal(out, jax_overlay(image, cam))


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("name", ["HISFCOS", "FCOS", "MNFCOS"])
def test_model_info_matches_jax(name):
    from pytorch_object_detection_tpu.utils.model_info import model_info as jax_model_info

    shape = (1, CANVAS, CANVAS, 3)
    want = jax_model_info(jax_model(name), shape)
    got = model_info.model_info(name, shape, num_classes=NUM_CLASSES, features=FEATURES)
    assert got["params"] == want["params"]
    assert got["params_by_module"] == want["params_by_module"]
    assert got["batch_stats"] == want["batch_stats"]
    # the port's models take and give NHWC, as the flax models do: the same shapes, no permutation
    assert got["output_shapes"] == tuple(list(branch) for branch in want["output_shapes"])
    ratio = got["flops"] / want["flops"]
    print(f"{name}: FLOPs port {got['flops']:.6g} (FlopCounterMode), JAX {want['flops']:.6g} (XLA), "
          f"ratio {ratio:.4f}")
    assert FLOP_RATIO[0] <= ratio <= FLOP_RATIO[1]


def test_model_info_of_a_built_model_leaves_it_alone():
    model = build_model("MNFCOS", NUM_CLASSES, FEATURES, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    info = model_info.model_info(model, (1, CANVAS, CANVAS, 3))
    assert info["params"] == model_info.model_info("MNFCOS", (1, CANVAS, CANVAS, 3), features=FEATURES)["params"]
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert not next(model.parameters()).is_meta


# ---------------------------------------------------------------- (c)

def _run_cli(module, *args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", f"pytorch_object_detection_tpu_torch.cli.{module}", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_model_info_cli_prints_the_jax_total():
    r = _run_cli("model_info", "--model", "FCOS", "--size", "128")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "total params: 32,157,022" in r.stdout  # JAX tests/test_scripts.py:94
    assert r.stdout.splitlines()[0] == "FCOS @ 1x128x128x3"


TINY = """dataset_setting:
  class_num : 20
  train_07 : '{voc}'
  test_07 : '{voc}'
  input : [128, 128]
HISFCOS:
  channel: 64
  stride : [8, 16, 32, 64, 128]
"""


def test_visualize_cli_writes_the_overlay(tmp_path):
    import cv2

    from pytorch_object_detection_tpu_torch.cli import visualize
    from pytorch_object_detection_tpu_torch.data.voc import resize_to_canvas

    (tmp_path / "tiny_data.yaml").write_text(TINY.format(voc=VOC_TREE))
    (tmp_path / "tiny.yaml").write_text("dataset : VOC\nmodel : HISFCOS\nVOC : tiny_data.yaml\nsavename : tiny\n")
    image = os.path.join(VOC_TREE, "JPEGImages", "va00000.jpg")
    out = tmp_path / "overlay.jpg"
    r = _run_cli("visualize", "--config", str(tmp_path / "tiny.yaml"), "--image", image, "--out", str(out),
                 "--device", "cpu", "--score-threshold", "0.05")
    assert r.returncode == 0, r.stderr[-2000:]
    written = cv2.imread(str(out))
    assert written is not None and written.shape == (128, 128, 3)
    # the count it prints is its pipeline's: the same build here
    from PIL import Image

    _, model, canvas, strides = visualize.build(str(tmp_path / "tiny.yaml"), "", torch.device("cpu"))
    canvas_img = resize_to_canvas(np.asarray(Image.open(image).convert("RGB")), None, canvas)[0]
    n = int(visualize.detect(model, canvas_img, canvas, strides, 0.05).valid.sum())
    assert r.stdout.strip().splitlines()[-1].startswith(f"{n} detections -> {out}")
    assert visualize.main(["--config", str(tmp_path / "tiny.yaml"), "--image", image]) == 1  # no card here


# ---------------------------------------------------------------- (d)

def test_profile_on_the_cpu(tmp_path):
    from pytorch_object_detection_tpu.utils.profile import StepTimer as JaxStepTimer

    t = profile.StepTimer()
    assert t.tick(32) > 0 and t.tick(32) > 0
    assert isinstance(JaxStepTimer().tick(1), float)
    assert profile.device_memory_stats("cpu") is None
    with profile.trace(str(tmp_path / "trace")) as logdir:
        with profile.annotate("podt_region"):
            torch.ones(64).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        assert "podt_region" in f.read()


def test_tool_entry_points_resolve():
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    for name, mod in (("podt-torch-visualize", "visualize"), ("podt-torch-model-info", "model_info")):
        assert scripts[name] == f"pytorch_object_detection_tpu_torch.cli.{mod}:main"
        assert callable(importlib.import_module(f"pytorch_object_detection_tpu_torch.cli.{mod}").main)
