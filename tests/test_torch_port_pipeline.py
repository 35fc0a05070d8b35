"""The whole float serving slice: port make_eval_pipeline vs the JAX one (CPU, f32).

Same grafted weights, same uint8 frames.  The per-level maps (the JAX
``make_eval_forward`` at f32, which the JAX pipeline runs) must agree
within tests/torch_port_fixtures.assert_close_to_ref's tolerance, and the
detections must match: at least 90 of each image's top-100 JAX detections
have a port detection of the same class at IoU > 0.99.  (Exact equality is
not asked here: a level map differing by 1e-6 may swap two near-tied scores
in the top-k, which the per-level check already bounds.)

The canvas is 256x256, not the 128x128 of the module tests: at 128 the
stride-128 level is 1x1, where a GroupNorm group of the 64-wide head holds
two values whose variance cancels (E[x^2] - mean^2 of two near-equal
numbers), so rounding noise of 1e-6 in the input becomes 1e-3 in the
output.  At 256 that level is 2x2 (eight values per group).  The full-width
model at 512 has 4x4 and 8 channels per group.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.eval.evaluator import make_eval_pipeline as jax_make_eval_pipeline
from pytorch_object_detection_tpu.train.trainer import make_eval_forward as jax_make_eval_forward
from pytorch_object_detection_tpu_torch.eval.evaluator import IMAGENET_MEAN, IMAGENET_STD, make_eval_pipeline
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.ops.boxes import pairwise_iou
from pytorch_object_detection_tpu_torch.train.checkpoints import load_flax_variables
from torch_port_fixtures import (
    BATCH,
    FEATURES,
    NUM_CLASSES,
    STRIDES,
    assert_close_to_ref,
    branch_scales,
    jax_model,
    perturbed_variables,
)

CANVAS = 256


@pytest.fixture(scope="module")
def runs():
    params, stats = perturbed_variables(seed=4)
    frames = np.random.default_rng(5).integers(0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)
    jax_pipe = jax_make_eval_pipeline(jax_model(), STRIDES, (CANVAS, CANVAS), compute_dtype=jnp.float32)
    jax_dets = jax_pipe(params, stats, jnp.asarray(frames))
    x = (jnp.asarray(frames).astype(jnp.float32) / 255.0 - jnp.asarray(IMAGENET_MEAN)) / jnp.asarray(IMAGENET_STD)
    jax_levels = jax_make_eval_forward(jax_model(), jnp.float32)(params, stats, x)

    model = build_model("HISFCOS", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    pipe = make_eval_pipeline(model, STRIDES, (CANVAS, CANVAS), compute_dtype=torch.float32)
    levels = pipe.forward_levels(torch.from_numpy(frames))
    return {
        "jax_levels": tuple([np.asarray(t) for t in branch] for branch in jax_levels),
        "jax_dets": [np.asarray(a) for a in jax_dets],
        "levels": levels,
        "dets": pipe.decode(levels),
        "pipe": pipe,
    }


@pytest.mark.parametrize("branch", [0, 1, 2], ids=["cls", "cnt", "reg"])
def test_pipeline_level_maps_match_jax(runs, branch):
    scale = branch_scales(runs["jax_levels"])[branch]
    for i, (got, want) in enumerate(zip(runs["levels"][branch], runs["jax_levels"][branch])):
        assert_close_to_ref(got, want, f"branch {branch} level {i}", ref_scale=scale)


def test_pipeline_detections_match_jax(runs):
    scores, classes, boxes, valid = runs["jax_dets"]
    dets = runs["dets"]
    for b in range(BATCH):
        want_idx = np.nonzero(valid[b])[0][:100]
        assert len(want_idx) == 100
        got_v = dets.valid[b]
        iou = pairwise_iou(torch.from_numpy(boxes[b][want_idx]), dets.boxes[b][got_v])
        same_class = torch.from_numpy(classes[b][want_idx])[:, None] == dets.classes[b][got_v][None, :]
        matched = ((iou > 0.99) & same_class).any(dim=1)
        assert int(matched.sum()) >= 90, int(matched.sum())


def test_pipeline_output_contract(runs):
    dets, k = runs["dets"], min(1000, sum((CANVAS // s) ** 2 for s in STRIDES))
    assert dets.scores.shape == dets.classes.shape == dets.valid.shape == (BATCH, k)
    assert dets.boxes.shape == (BATCH, k, 4)
    assert dets.classes.dtype == torch.int32 and dets.valid.dtype == torch.bool
    assert torch.all(dets.scores[:, :-1] >= dets.scores[:, 1:])  # sorted
    assert torch.all(dets.scores[dets.valid] >= 0.05)
    assert torch.all((dets.boxes >= 0) & (dets.boxes <= CANVAS - 1))
    assert torch.all((dets.classes >= 1) & (dets.classes <= NUM_CLASSES))
    for branch, c in zip(runs["levels"], (NUM_CLASSES, 1, 4)):
        assert [tuple(t.shape) for t in branch] == [(BATCH, CANVAS // s, CANVAS // s, c) for s in STRIDES]
        assert all(t.dtype == torch.float32 and torch.isfinite(t).all() for t in branch)


def test_pipeline_rejects_bad_strides_and_inputs(runs):
    pipe = runs["pipe"]
    short = make_eval_pipeline(pipe.model, STRIDES[:3], (CANVAS, CANVAS), compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="strides"):
        short.decode(runs["levels"])
    # the reference's 4-of-5 truncation is the one allowed short form
    four = make_eval_pipeline(pipe.model, STRIDES[:4], (CANVAS, CANVAS), compute_dtype=torch.float32)
    assert four.decode(runs["levels"]).scores.shape[1] == min(1000, sum((CANVAS // s) ** 2 for s in STRIDES[:4]))
    with pytest.raises(ValueError, match="uint8"):
        pipe(torch.zeros(1, CANVAS, CANVAS, 3))
