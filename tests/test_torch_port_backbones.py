"""The remaining backbones and layers in the port against the JAX package (CPU, f32).

  (a) EfficientNet-B2 (width 1.1, depth 1.2) at 64x64, B=2: its five
      endpoints against flax within 1e-4 of the range; every variant B0..B7:
      the module tree (names and shapes, the SE widths from Python's
      ``round``) as flax's, the int8 block table as JAX's ``block_meta``, and
      ``load_efficientnet_qtree`` taking JAX's B7 qtree (``width_mult=2.0``,
      ``depth_mult=3.1``);
  (b) MobileNetV2's (C3, C4, C5) taps against flax within 1e-4 of the range;
  (c) ``nn/layers.DepthwiseConv`` and ``ops/qhis.depthwise_i8`` with a
      stride: the strided int8 depthwise against XLA's grouped int8 conv
      (exact), stride 1 at the MC_FCOS, MNFCOS and HisBlock callers' kernels
      and dilations bit for bit the map the full-resolution formula gives,
      and the module's seeded weights as before;
  (d) DCNv2 (``nn/deform.py``) at 12x12, C=8, F=8 with random offsets that
      cross the border, at stride 1 and 2: the forward within 1e-5 of the
      output range, the gradients of the input, the kernel and the offset and
      modulator convs within 1e-4 of each one's largest (against
      ``jax.grad``), the identity at zero offsets; the flax tree loaded
      by name;
  (e) FCOS on EfficientNet-B0: two f32 train steps against JAX's (the train
      test's tolerances), and ``evaluate_voc`` of its int8 pipeline over the
      committed VOC tree with the device resize.

Serially about 70 s on one torch thread, most of it the JAX train step's
compile.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.nn import efficientnet_int8 as je8
from pytorch_object_detection_tpu.nn import layers as jax_layers
from pytorch_object_detection_tpu.nn.deform import DeformableConv as JaxDeformableConv
from pytorch_object_detection_tpu.nn.deform import deform_sample as jax_deform_sample
from pytorch_object_detection_tpu.nn.efficientnet import EfficientNet as JaxEfficientNet
from pytorch_object_detection_tpu.nn.mobilenet import MobileNetV2 as JaxMobileNetV2
from pytorch_object_detection_tpu_torch.nn import efficientnet as eff
from pytorch_object_detection_tpu_torch.nn import efficientnet_int8
from pytorch_object_detection_tpu_torch.nn.deform import DeformableConv, deform_sample
from pytorch_object_detection_tpu_torch.nn.layers import Conv, DepthwiseConv
from pytorch_object_detection_tpu_torch.nn.mobilenet import MobileNetV2
from pytorch_object_detection_tpu_torch.ops.gn import groupnorm_act
from pytorch_object_detection_tpu_torch.ops.qhis import depthwise_i8
from pytorch_object_detection_tpu_torch.train.checkpoints import (
    flax_to_state_dict,
    load_efficientnet_qtree,
    load_flax_variables,
)
from test_torch_port_train import JaxRun, assert_step_matches, port_batch, port_state, run_port_steps
from torch_port_fixtures import VOC_TREE, assert_close_to_ref, nhwc, perturbed_module_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

VARIANTS = [f"b{i}" for i in range(8)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------- (a)

def test_b2_endpoints_match_flax():
    jm = JaxEfficientNet.variant("b2")
    params, stats = perturbed_module_variables(jm, (1, 64, 64, 3), 60)
    x = np.random.default_rng(61).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))({"params": params, "batch_stats": stats}, x)
    model = eff.EfficientNet.variant("b2").eval()
    load_flax_variables(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert model.endpoint_channels() == (16, 24, 48, 120, 352) and len(model.specs) == 23
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_to_ref(nhwc(g), np.asarray(w), f"B2 endpoint {i}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_tree_and_block_table_match_jax(variant):
    """The port's module tree is flax's, name by name and shape by shape (the
    widened widths and the SE widths at each block); the int8 ladder's block
    table is JAX's."""
    jm = JaxEfficientNet.variant(variant)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, False), jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: v.shape for k, v in flax_to_state_dict(zeros["params"], zeros["batch_stats"]).items()}
    model = eff.EfficientNet.variant(variant)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    w, d = eff._SCALING[variant]
    assert efficientnet_int8.block_meta(w, d) == je8.block_meta(w, d)


def test_b7_qtree_loads():
    """JAX's B7 qtree (its shapes from ``jax.eval_shape`` of
    ``quantize_efficientnet`` at ``width_mult=2.0``, ``depth_mult=3.1``)
    passes the loader's shape check into the port's form; B0's multipliers
    refuse it."""
    jm = JaxEfficientNet.variant("b7")
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, False), jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    taps = {"stem": 1.0}
    for m in je8.block_meta(2.0, 3.1):
        taps.update({f"{m['name']}.{p}": 1.0 for p in ("e", "d", "out")})
    qshapes = jax.eval_shape(lambda v: je8.quantize_efficientnet(v, taps, 2.0, 3.1), shapes)
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), qshapes)
    q = load_efficientnet_qtree(tree, 2.0, 3.1, device="cpu")
    assert len(q["blocks"]) == 55 and tuple(q["stem"]["kernel"].shape) == (64, 3, 3, 3)
    assert q["blocks"][-1]["project"]["w"].dtype == torch.int8 and tuple(q["blocks"][-1]["project"]["w"].shape) == (
        640, 3840)
    with pytest.raises(KeyError):
        load_efficientnet_qtree(tree, device="cpu")


# ---------------------------------------------------------------- (b)

def test_mobilenet_v2_taps_match_flax():
    jm = JaxMobileNetV2()
    params, stats = perturbed_module_variables(jm, (1, 64, 64, 3), 62)
    x = np.random.default_rng(63).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))({"params": params, "batch_stats": stats}, x)
    model = MobileNetV2().eval()
    load_flax_variables(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [g.shape[1] for g in got] == [32, 96, 320] and [g.shape[2] for g in got] == [8, 4, 2]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_to_ref(nhwc(g), np.asarray(w), f"MobileNetV2 tap C{i + 3}")


# ---------------------------------------------------------------- (c)

@pytest.mark.parametrize("k,stride,hw", [(3, 2, (16, 16)), (5, 2, (16, 16)), (3, 2, (15, 9)), (5, 2, (7, 11)),
                                         (5, 1, (9, 12))])
def test_depthwise_i8_strided_matches_xla(k, stride, hw):
    """The int8 depthwise at ``stride`` from strided slices against XLA's
    grouped int8 conv (the JAX ladder's ``_conv_dw_i8``): exact."""
    rng = np.random.default_rng(k * 10 + stride + hw[0])
    x = rng.integers(-127, 128, (2, *hw, 24), dtype=np.int8)
    w = rng.integers(-127, 128, (k, k, 24), dtype=np.int8)
    want = np.asarray(je8._conv_dw_i8(jnp.asarray(x), jnp.asarray(w[:, :, None, :]), stride))
    got = depthwise_i8(torch.from_numpy(x), torch.from_numpy(w), stride=stride)
    assert tuple(got.shape) == want.shape and np.array_equal(_np(got), want)


@pytest.mark.parametrize("k,d", [(3, 1), (3, 2), (5, 1), (5, 2), (7, 1)])
def test_depthwise_i8_callers_keep_their_bits(k, d):
    """At stride 1, the MC_FCOS and HisBlock depthwise (3x3) and the MNBlocks'
    (k, d): the map the full-resolution formula gives, bit for bit."""
    rng = np.random.default_rng(k + 7 * d)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 13, 10, 16), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, k, 16), dtype=np.int8))
    pad = d * (k - 1) // 2
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad)).int()
    want = sum(xp[:, ky * d:ky * d + 13, kx * d:kx * d + 10] * w[ky, kx].int() for ky in range(k) for kx in range(k))
    assert torch.equal(depthwise_i8(x, w, d), want.float())


@pytest.mark.parametrize("k,d", [(3, 1), (5, 2), (7, 1)])
def test_depthwise_conv_module_keeps_its_weights_and_takes_a_stride(k, d):
    """``DepthwiseConv(ch, k, d, generator)`` draws the weights the bare
    grouped ``Conv`` draws from the same seed (its callers' bits); with
    ``stride=2`` it is flax's ``DepthwiseConv(k, 2)``, symmetric padding."""
    a = DepthwiseConv(16, k, d, generator=torch.Generator().manual_seed(k))
    b = Conv(16, 16, k, dilation=d, groups=16, bias=False, generator=torch.Generator().manual_seed(k))
    assert torch.equal(a.weight, b.weight) and a.stride == (1, 1) and a.padding == b.padding
    s2 = DepthwiseConv(16, k, stride=2, generator=torch.Generator().manual_seed(k))
    jm = jax_layers.DepthwiseConv(k, 2)
    x = np.random.default_rng(k).normal(size=(2, 11, 14, 16)).astype(np.float32)
    params = {"dw": {"conv": {"kernel": s2.weight.detach().permute(2, 3, 1, 0).numpy()}}}
    want = np.asarray(jm.apply({"params": params}, x))
    with torch.no_grad():
        got = s2(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close_to_ref(nhwc(got), want, "DepthwiseConv stride 2")


# ---------------------------------------------------------------- (d)

def _dcn_case(stride, seed):
    """A DCNv2 (C=8, F=8, 3x3) flax tree whose offset and modulator convs are
    random (offsets of about +-2 pixels, many taps outside the 12x12 map),
    its input, and the port module loaded from the tree."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 12, 12, 8)).astype(np.float32)
    params = {"offset_conv": {"kernel": rng.normal(0, 0.25, (3, 3, 8, 18)).astype(np.float32),
                              "bias": rng.normal(0, 0.5, 18).astype(np.float32)},
              "modulator_conv": {"kernel": rng.normal(0, 0.2, (3, 3, 8, 9)).astype(np.float32),
                                 "bias": rng.normal(0, 0.2, 9).astype(np.float32)},
              "kernel": rng.normal(0, 0.2, (9, 8, 8)).astype(np.float32)}
    model = DeformableConv(8, 8, 3, stride=stride)
    load_flax_variables(model, params)
    return x, params, model, JaxDeformableConv(8, 3, stride)


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_forward_and_gradients_match_jax(stride):
    x, params, model, jm = _dcn_case(stride, 64 + stride)
    offsets = np.asarray(jax.lax.conv_general_dilated(
        x, params["offset_conv"]["kernel"], (stride, stride), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) + params["offset_conv"]["bias"]
    base = np.arange(offsets.shape[1]) * stride
    outside = ((base[None, :, None, None] + offsets[..., 0::2] < 0)
               | (base[None, :, None, None] + offsets[..., 0::2] > 11)).mean()
    assert outside > 0.05, outside  # the border is crossed

    def jloss(p, x, g):
        return jnp.sum(jm.apply({"params": p}, x) * g)

    want = np.asarray(jm.apply({"params": params}, x))
    g = np.random.default_rng(7).normal(size=want.shape).astype(np.float32)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, x, g)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    out = model(xt)
    err = float(np.abs(nhwc(out.detach()) - want).max())
    print(f"stride {stride} forward: max err {err / float(np.abs(want).max()):.3g} of the range")
    assert err <= 1e-5 * float(np.abs(want).max())
    (out * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    grads = {"input": (_np(xt.grad.permute(0, 2, 3, 1)), np.asarray(jgx))}
    got_p = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgp))
    for name, p in model.named_parameters():
        grads[name] = (_np(p.grad), got_p[name])
    assert sorted(grads) == ["input", "modulator_conv.bias", "modulator_conv.weight", "offset_conv.bias",
                             "offset_conv.weight", "weight"]
    for name, (got, ref) in grads.items():
        err = float(np.abs(got - ref).max())
        print(f"stride {stride} d/d{name}: max err {err / float(np.abs(ref).max()):.3g} of its largest")
        assert err <= 1e-4 * float(np.abs(ref).max()), name


def test_dcn_identity_at_zero_offsets():
    """At init (zero offset and modulator convs) the module is the regular
    conv with its kernel; zero offsets sample each pixel at its tap, a tap
    outside the map at zero (tests/test_aux.py's identities)."""
    model = DeformableConv(16, 8, 3, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(1))
    want = torch.nn.functional.conv2d(x, model.weight.detach().reshape(3, 3, 16, 8).permute(3, 2, 0, 1), padding=1)
    with torch.no_grad():
        torch.testing.assert_close(model(x), want, rtol=1e-5, atol=1e-5)
    img = torch.arange(16.0).reshape(1, 4, 4, 1)
    taps = deform_sample(img, torch.zeros(1, 4, 4, 18), 3)
    jtaps = np.asarray(jax_deform_sample(jnp.asarray(img.numpy()), jnp.zeros((1, 4, 4, 18)), 3))
    assert float(taps[0, 1, 2, 4, 0]) == float(img[0, 1, 2, 0]) and float(taps[0, 0, 0, 0, 0]) == 0.0
    assert np.array_equal(_np(taps), jtaps)
    assert float(model.weight.detach().std()) == pytest.approx(np.sqrt(2.0 / (9 * 8)), rel=0.1)  # He normal, fan-out


# ---------------------------------------------------------------- (e)

def test_fcos_efficientnet_train_step_matches_jax():
    """Two f32 SGD steps of FCOS(5, 64) on EfficientNet-B0 from the same
    weights and batch: the loss, each trainable parameter's gradient and the
    updated parameters (the train test's tolerances); the GroupNorms launch
    no kernel under autograd."""
    eff_kw = dict(backbone="efficientnet-b0")
    run = JaxRun("FCOS", 0, 2, seed=53, **eff_kw)
    state = port_state("FCOS", 0, run.params, run.stats, **eff_kw)
    before = groupnorm_act.launches
    steps = run_port_steps(state, 2, port_batch(run))
    assert groupnorm_act.launches == before
    for i, (m, grads, after) in enumerate(steps):
        assert_step_matches(state, m, grads, after, run.losses[i], run.grads[i], run.after[i],
                            f"FCOS-EfficientNet step {i + 1}", n_steps=i + 1)


def test_fcos_efficientnet_evaluate_voc():
    """``evaluate_voc`` of the EfficientNet FCOS's int8 pipeline (the device
    resize from raw tiles, the frames normalized before the ladder) over the
    committed VOC tree at 128x128: every image scored, a finite mAP."""
    from pytorch_object_detection_tpu_torch.cli.eval_voc import first_batch_calib
    from pytorch_object_detection_tpu_torch.data.voc import VOCDataset
    from pytorch_object_detection_tpu_torch.eval.evaluator import evaluate_voc, make_eval_pipeline_int8
    from pytorch_object_detection_tpu_torch.models.registry import build_model

    model = build_model("FCOS", 20, 64, backbone="efficientnet-b0", device="cpu",
                        generator=torch.Generator().manual_seed(4))
    voc = VOCDataset(VOC_TREE, "test", (128, 128), raw_tiles=True)
    pipe = make_eval_pipeline_int8(model, first_batch_calib(voc, 4, (128, 128), torch.device("cpu")),
                                   (8, 16, 32, 64, 128), (128, 128), device_resize=True, compute_dtype=torch.float32)
    assert not pipe.u8_input
    r = evaluate_voc(model, voc, batch_size=4, num_workers=2, pipeline=pipe, verbose=False)
    assert r["num_images"] == len(voc) == 8 and np.isfinite(r["mAP"])
