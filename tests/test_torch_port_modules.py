"""PyTorch port vs the JAX package, module by module, f32 on the CPU.

The same weights (a numpy-filled flax tree, grafted with
``load_flax_variables``) and the same numpy inputs go through each flax
module and its port: HisBlock, the ResNet-50 taps, the HisFPN levels and
the HISHead per-level (cls, cnt, reg).  Each module gets the JAX side's
input, so an error points at one module.  Tolerance: see
``tests/torch_port_fixtures.assert_close_to_ref``.
"""
from __future__ import annotations

import copy
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.models.heads import HISHead as JaxHISHead
from pytorch_object_detection_tpu.nn.fpn import HisFPN as JaxHisFPN
from pytorch_object_detection_tpu.nn.layers import HisBlock as JaxHisBlock
from pytorch_object_detection_tpu.nn.resnet import ResNet50 as JaxResNet50
from pytorch_object_detection_tpu_torch.models.fcos import HISFCOS
from pytorch_object_detection_tpu_torch.models.heads import HISHead
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.nn.fpn import HisFPN
from pytorch_object_detection_tpu_torch.nn.layers import HisBlock
from pytorch_object_detection_tpu_torch.nn.resnet import ResNet50
from pytorch_object_detection_tpu_torch.parallel.mesh import create_mesh
from pytorch_object_detection_tpu_torch.train.checkpoints import load_flax_variables
from torch_port_fixtures import (
    BATCH,
    CANVAS,
    FEATURES,
    NUM_CLASSES,
    assert_close_to_ref,
    branch_scales,
    nchw,
    nhwc,
    perturbed_variables,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sub(params, stats, scope):
    return {"params": params[scope], "batch_stats": stats.get(scope, {})}


@pytest.fixture(scope="module")
def chain():
    """Variables plus each stage's JAX input and output on one numpy image batch."""
    params, stats = perturbed_variables(seed=0)
    x = np.random.default_rng(1).normal(size=(BATCH, CANVAS, CANVAS, 3)).astype(np.float32)
    taps = jax.jit(lambda v, x: JaxResNet50().apply(v, x, False))(_sub(params, stats, "backbone"), x)
    taps = [np.asarray(t) for t in taps]
    levels = jax.jit(lambda v, f: JaxHisFPN(FEATURES).apply(v, f, False))(_sub(params, stats, "fpn"), taps)
    levels = [np.asarray(t) for t in levels]
    head = jax.jit(lambda v, l: JaxHISHead(NUM_CLASSES, FEATURES).apply(v, l))({"params": params["head"]}, levels)
    head = tuple([np.asarray(t) for t in branch] for branch in head)
    return {"params": params, "stats": stats, "x": x, "taps": taps, "levels": levels, "head": head}


@pytest.fixture(scope="module")
def port_outputs(chain):
    p, s = chain["params"], chain["stats"]
    backbone = load_flax_variables(ResNet50(), p["backbone"], s["backbone"]).eval()
    fpn = load_flax_variables(HisFPN((4 * 128, 4 * 256, 4 * 512), FEATURES), p["fpn"], s["fpn"]).eval()
    head = load_flax_variables(HISHead(NUM_CLASSES, FEATURES), p["head"]).eval()
    with torch.no_grad():
        taps = backbone(nchw(chain["x"]))
        levels = fpn([nchw(t) for t in chain["taps"]])
        outs = head([nchw(t) for t in chain["levels"]])
    return {"taps": [nhwc(t) for t in taps], "levels": [nhwc(t) for t in levels],
            "head": tuple([nhwc(t) for t in branch] for branch in outs)}


def test_hisblock_matches_flax(chain):
    p, s = chain["params"]["fpn"]["his3"], chain["stats"]["fpn"]["his3"]
    x = np.random.default_rng(2).normal(size=(BATCH, 16, 16, FEATURES)).astype(np.float32)
    want = jax.jit(lambda v, x: JaxHisBlock(FEATURES).apply(v, x, False))(
        {"params": p, "batch_stats": s}, x)
    block = load_flax_variables(HisBlock(FEATURES, FEATURES), p, s).eval()
    with torch.no_grad():
        got = block(nchw(x))
    assert_close_to_ref(nhwc(got), want, "HisBlock")


@pytest.mark.parametrize("tap", [0, 1, 2], ids=["C3", "C4", "C5"])
def test_resnet50_taps_match_flax(chain, port_outputs, tap):
    assert_close_to_ref(port_outputs["taps"][tap], chain["taps"][tap], f"tap {tap}")


@pytest.mark.parametrize("level", range(5), ids=[f"P{i}" for i in range(3, 8)])
def test_hisfpn_levels_match_flax(chain, port_outputs, level):
    assert_close_to_ref(port_outputs["levels"][level], chain["levels"][level], f"P{level + 3}")


@pytest.mark.parametrize("level", range(5), ids=[f"P{i}" for i in range(3, 8)])
def test_hishead_level_matches_flax(chain, port_outputs, level):
    scales = branch_scales(chain["head"])
    for b, name in enumerate(("cls", "cnt", "reg")):
        assert_close_to_ref(port_outputs["head"][b][level], chain["head"][b][level],
                            f"{name} level {level}", ref_scale=scales[b])


def test_port_holds_every_flax_variable(chain):
    """The port has exactly as many parameters + buffers as the flax tree has
    leaves (load_flax_variables checks the names one by one)."""
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves((chain["params"], chain["stats"])))
    model = HISFCOS(NUM_CLASSES, FEATURES, device="cpu")
    n_port = sum(t.numel() for t in model.state_dict().values())
    assert n_port == n_flax


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_load_flax_variables_rejects_mismatched_tree(chain, fault):
    params, stats = copy.deepcopy(chain["params"]), copy.deepcopy(chain["stats"])
    if fault == "missing":
        del params["head"]["stem_gn1"]["gn"]["bias"]
        err = KeyError
    elif fault == "unused":
        params["head"]["extra_conv"] = {"conv": {"kernel": np.zeros((1, 1, 2, 2), np.float32)}}
        err = KeyError
    else:
        stats["backbone"]["bn1"]["bn"]["var"] = np.ones(65, np.float32)
        err = ValueError
    model = HISFCOS(NUM_CLASSES, FEATURES, device="cpu")
    before = model.backbone.bn1.running_var.clone()
    with pytest.raises(err):
        load_flax_variables(model, params, stats)
    assert torch.equal(model.backbone.bn1.running_var, before)  # nothing written


def test_unported_options_raise():
    # the space-to-depth stem is ported (tests/test_torch_port_fused.py holds it to JAX); another mode is refused
    s2d = ResNet50(stem_mode="s2d")
    assert tuple(s2d.conv1_s2d.weight.shape) == (64, 12, 4, 4) and not hasattr(s2d, "conv1")
    with pytest.raises(ValueError, match="stem_mode"):
        ResNet50(stem_mode="s4d")
    effnet = build_model("FCOS", 20, backbone="efficientnet-b0", device="cpu")
    assert [getattr(effnet.fpn, f"lateral{i}").in_channels for i in (3, 4, 5)] == [40, 112, 320]
    with pytest.raises(RuntimeError, match="process group"):  # tp and sp are ported: their mesh takes the ranks
        create_mesh(model_parallel=2)
    with pytest.raises(KeyError):
        build_model("NOPE", 20)


def test_seeded_init_is_reproducible_and_follows_jax_distributions():
    a = build_model("HISFCOS", NUM_CLASSES, FEATURES, device="cpu", generator=torch.Generator().manual_seed(3))
    b = build_model("HISFCOS", NUM_CLASSES, FEATURES, device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), name
    # cls prior bias -log(99); ScaleExp 1.2; torch-default conv bound 1/sqrt(fan_in)
    assert torch.allclose(a.head.cls_pred.bias, torch.full((NUM_CLASSES,), -float(np.log(99.0))))
    assert a.head.scale3.scale.item() == pytest.approx(1.2)
    w = a.head.cls_tower0.weight
    assert w.abs().max().item() <= 1.0 / np.sqrt(FEATURES * 9)
    # ResNet convs: normal(0, sqrt(2 / fan_out))
    w = a.backbone.layer3_2.conv2.weight
    assert w.std().item() == pytest.approx(np.sqrt(2.0 / (256 * 9)), rel=0.05)


def test_port_imports_no_jax():
    """Importing the port, and everything chip_smoke.py imports, leaves jax
    out of sys.modules, and PyYAML, cv2 and PIL too (the raw-tile evaluation
    path needs no cv2, nothing falls back to PIL, and the serving path needs
    no PyYAML at import); finding the libjpeg a Pillow wheel bundles does not
    import PIL."""
    code = (
        "import sys\n"
        "import pytorch_object_detection_tpu_torch\n"
        "from pytorch_object_detection_tpu_torch.models import registry, fcos, heads\n"
        "from pytorch_object_detection_tpu_torch.nn import layers, resnet, fpn\n"
        "from pytorch_object_detection_tpu_torch.ops import boxes, nms, cuda_nms, gn, postprocess\n"
        "from pytorch_object_detection_tpu_torch.eval import evaluator, voc_map, coco_map\n"
        "from pytorch_object_detection_tpu_torch.core import config\n"
        "from pytorch_object_detection_tpu_torch.native import lib\n"
        "from pytorch_object_detection_tpu_torch.data import voc, coco, decode, pipeline\n"
        "from pytorch_object_detection_tpu_torch.cli import eval_voc, eval_coco\n"
        "lib.jpeg_link(False)\n"
        "from pytorch_object_detection_tpu_torch.train import checkpoints\n"
        "from pytorch_object_detection_tpu_torch import _build\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'pytorch_object_detection_tpu.')))\n"
        "bad += [m for m in ('yaml', 'cv2', 'PIL') if m in sys.modules]  # none needed at import\n"
        "bad += [m for m in sys.modules if m == 'pytorch_object_detection_tpu']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
