"""PyTorch port vs the JAX package: boxes, GroupNorm, NMS and decode (CPU).

On the CPU every kernel wrapper of the port takes its plain version, so
these tests hold the plain versions (the references kernels A and B are held
to on the card) against the JAX functions, including the Pallas kernels run
in interpret mode as the JAX package's own tests run them.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.nn.layers import GroupNorm32 as JaxGroupNorm32
from pytorch_object_detection_tpu.ops import boxes as jax_boxes
from pytorch_object_detection_tpu.ops.nms import batched_class_nms as jax_batched_class_nms
from pytorch_object_detection_tpu.ops.pallas_gn import groupnorm_act as jax_groupnorm_act
from pytorch_object_detection_tpu.ops.pallas_nms import pallas_batched_class_nms
from pytorch_object_detection_tpu.ops.postprocess import decode_detections as jax_decode
from pytorch_object_detection_tpu_torch.ops import boxes
from pytorch_object_detection_tpu_torch.ops.cuda_nms import cuda_batched_class_nms
from pytorch_object_detection_tpu_torch.ops.gn import groupnorm_act, groupnorm_act_plain
from pytorch_object_detection_tpu_torch.ops.nms import batched_class_nms
from pytorch_object_detection_tpu_torch.ops.postprocess import decode_detections
from torch_port_fixtures import ADVERSARIAL_KEEP, STRIDES, nchw, nhwc, nms_case
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

# ---------------------------------------------------------------- boxes


def test_level_coords_match_jax():
    shapes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    np.testing.assert_array_equal(boxes.all_level_coords(shapes, STRIDES).numpy(),
                                  np.asarray(jax_boxes.all_level_coords(shapes, STRIDES)))
    np.testing.assert_array_equal(boxes.level_coords(3, 5, 16).numpy(),
                                  np.asarray(jax_boxes.level_coords(3, 5, 16)))


def test_clip_and_pairwise_iou_match_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-20, 140, (2, 50, 2)).astype(np.float32)
    b = np.concatenate([xy, xy + rng.uniform(-5, 60, (2, 50, 2)).astype(np.float32)], -1)
    np.testing.assert_array_equal(boxes.clip_boxes(torch.from_numpy(b), 100, 120).numpy(),
                                  np.asarray(jax_boxes.clip_boxes(jnp.asarray(b), 100, 120)))
    got = boxes.pairwise_iou(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_boxes.pairwise_iou(jnp.asarray(b), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)

# ---------------------------------------------------------------- GroupNorm (kernel B's plain version)


@pytest.mark.parametrize("ch", [64, 128])
@pytest.mark.parametrize("act", ["none", "relu", "silu"])
def test_groupnorm_plain_matches_jax(act, ch):
    """Port plain GN (NCHW) vs the Pallas kernel in interpret mode and vs
    flax GroupNorm32, f32, max abs err <= 1e-5 (outputs are O(1); both
    sides take f32 statistics over the same groups)."""
    rng = np.random.default_rng(ch)
    x = (rng.normal(size=(2, 8, 6, ch)) * 2.0 + rng.normal(size=ch)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, ch).astype(np.float32)
    bias = rng.normal(0.0, 0.3, ch).astype(np.float32)
    got = nhwc(groupnorm_act_plain(nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), act=act))
    via_pallas = np.asarray(jax_groupnorm_act(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                              groups=32, eps=1e-5, act=act, interpret=True))
    via_flax = np.asarray(JaxGroupNorm32(act=act).apply(
        {"params": {"gn": {"scale": scale, "bias": bias}}}, jnp.asarray(x)))
    assert np.max(np.abs(got - via_pallas)) <= 1e-5
    assert np.max(np.abs(got - via_flax)) <= 1e-5
    # on a CPU tensor the wrapper IS the plain version
    wrapped = groupnorm_act(nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), act=act)
    np.testing.assert_array_equal(nhwc(wrapped), got)


@pytest.mark.parametrize("act", ["none", "relu", "silu"])
def test_groupnorm_plain_with_bf16_params_matches_f32_run_and_jax(act):
    """The pipeline's bf16 model hands kernel B bf16 scale and bias, which
    it reads exactly in f32: the plain version on bf16 scale and bias equals
    its run on the same values in f32 bit for bit, and the Pallas kernel in
    interpret mode on those values within 1e-5 (f32 maps, O(1) outputs)."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 8, 6, 64)) * 2.0 + rng.normal(size=64)).astype(np.float32)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.normal(0.0, 0.3, 64).astype(np.float32)).to(torch.bfloat16)
    got = groupnorm_act(nchw(x), scale, bias, act=act)
    want = groupnorm_act_plain(nchw(x), scale.float(), bias.float(), act=act)
    assert torch.equal(got, want)
    via_pallas = np.asarray(jax_groupnorm_act(jnp.asarray(x), jnp.asarray(scale.float().numpy()),
                                              jnp.asarray(bias.float().numpy()), groups=32, eps=1e-5, act=act,
                                              interpret=True))
    assert np.max(np.abs(nhwc(got) - via_pallas)) <= 1e-5


def test_groupnorm_keeps_dtype_and_rejects_bad_input():
    x = torch.randn(2, 64, 4, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    y = groupnorm_act(x, torch.ones(64), torch.zeros(64), act="silu")
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    with pytest.raises(ValueError):
        groupnorm_act(x, torch.ones(64), torch.zeros(64), act="gelu")
    with pytest.raises(ValueError):
        groupnorm_act(x[:, :48], torch.ones(48), torch.zeros(48))

# ---------------------------------------------------------------- NMS (kernel A's plain version)


@pytest.mark.parametrize("case", ["random", "padding", "adversarial"])
def test_nms_plain_matches_jax_exactly(case):
    b, c, v, thr = nms_case(case)
    scores = np.sort(np.random.default_rng(0).uniform(size=v.shape))[:, ::-1].copy().astype(np.float32)
    want = np.asarray(jax_batched_class_nms(jnp.asarray(b), jnp.asarray(scores), jnp.asarray(c),
                                            jnp.asarray(v), thr))
    via_pallas = np.asarray(pallas_batched_class_nms(jnp.asarray(b), jnp.asarray(scores), jnp.asarray(c),
                                                     jnp.asarray(v), thr, interpret=True))
    tb, ts, tc, tv = (torch.from_numpy(a) for a in (b, scores, c, v))
    got = batched_class_nms(tb, ts, tc, tv, thr).numpy()
    wrapped = cuda_batched_class_nms(tb, ts, tc, tv, thr).numpy()  # CPU -> plain version
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, via_pallas)
    np.testing.assert_array_equal(wrapped, want)
    if case == "adversarial":
        np.testing.assert_array_equal(got, ADVERSARIAL_KEEP)

# ---------------------------------------------------------------- decode


def _levels(seed, ties, c=4, batch=2, canvas=128):
    """Per-level NHWC numpy head outputs.  ``ties``: logits on a coarse grid,
    so scores tie exactly and the class argmax has ties within a row.  Few
    classes, so that same-class boxes overlap and NMS suppresses some."""
    rng = np.random.default_rng(seed)
    cls_l, cnt_l, reg_l = [], [], []
    for s in STRIDES:
        h = w = canvas // s
        cls = rng.normal(-2.0, 1.5, (batch, h, w, c))
        cnt = rng.normal(0.0, 1.5, (batch, h, w, 1))
        if ties:
            cls, cnt = np.round(cls), np.round(cnt)
        reg = np.exp(rng.normal(np.log(s * 2.0), 0.6, (batch, h, w, 4)))
        cls_l.append(cls.astype(np.float32))
        cnt_l.append(cnt.astype(np.float32))
        reg_l.append(reg.astype(np.float32))
    return cls_l, cnt_l, reg_l


@pytest.mark.parametrize("seed,ties,max_det,image_hw", [
    (0, False, 1000, (128, 128)),
    (1, True, 1000, (128, 128)),
    (2, True, 100, None),
    (3, False, 50, (120, 100)),
])
def test_decode_matches_jax(seed, ties, max_det, image_hw):
    """Same per-level tensors through JAX decode (fixpoint NMS) and the
    port's decode: classes and valid identical, scores and boxes within 1e-6."""
    cls_l, cnt_l, reg_l = _levels(seed, ties)
    want = jax_decode([jnp.asarray(a) for a in cls_l], [jnp.asarray(a) for a in cnt_l],
                      [jnp.asarray(a) for a in reg_l], STRIDES, 0.05, 0.6, max_det, image_hw,
                      nms_impl="fixpoint")
    t = lambda xs: [torch.from_numpy(a) for a in xs]
    got = decode_detections(t(cls_l), t(cnt_l), t(reg_l), STRIDES, 0.05, 0.6, max_det, image_hw)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-6)
    above = got.scores >= 0.05
    assert got.valid.any() and (above & ~got.valid).any()  # NMS suppressed some
