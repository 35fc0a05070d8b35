"""The bf16 fused float path of the port against the JAX package (CPU, f32).

  (a) K16's plain version (``ops/fused.matmul_bn_act_plain``) against the
      JAX ``matmul_bn_act`` in interpret mode;
  (b) the fused ResNet-50 (``nn/fused_resnet.resnet50_fused_forward``)
      against the JAX one in interpret mode and against the port's module
      forward, and the space-to-depth stem (``ResNet50(stem_mode="s2d")``);
  (c) K15: the packed operands against the JAX packer, the plain version
      (``ops/head.hishead_level_fused_plain``) against the JAX
      ``hishead_level_fused`` in interpret mode and against the port's
      float ``HISHead``;
  (d) K4': the three plain epilogues against the JAX kernel bodies of
      ``scripts/dev_qmm_variants.py`` run through ``pl.pallas_call`` in
      interpret mode;
  (e) the slice: ``make_eval_forward_int8(fused_head=True)`` against the
      JAX composition it follows (the int8 backbone's XLA oracle, the
      BN-folded HisFPN, the fused head per level in interpret mode, then
      ScaleExp), and the options around it.

Inputs come from numpy seeds and reach both frameworks as numpy arrays.
JAX's own ``fused_head`` path calls the Pallas kernel without
``interpret``, so it cannot run on the CPU; (e) assembles the same steps.
About 80 s serially on one x86-64 core, most of it the JAX set-up and the
interpret-mode Pallas calls.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu_torch.eval.evaluator import IMAGENET_MEAN, IMAGENET_STD, make_eval_pipeline_int8
from pytorch_object_detection_tpu_torch.models.heads import HISHead
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.nn.fused_resnet import fold_resnet50, resnet50_fused_forward
from pytorch_object_detection_tpu_torch.nn.resnet import ResNet50, s2d_stem_kernel
from pytorch_object_detection_tpu_torch.ops.fused import conv1x1_bn_act, matmul_bn_act_plain
from pytorch_object_detection_tpu_torch.ops.head import hishead_level_fused_plain, hishead_params_pack
from pytorch_object_detection_tpu_torch.ops.qmm_variants import qmm_variant_plain
from pytorch_object_detection_tpu_torch.train.checkpoints import load_backbone_qtree, load_flax_variables
from pytorch_object_detection_tpu_torch.train.trainer import make_eval_forward_int8, quantize_backbone, quantize_fpn
from torch_port_fixtures import BATCH, FEATURES, NUM_CLASSES, STRIDES, jax_model, perturbed_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

SLICE_CANVAS = 256  # levels 32x32 .. 2x2
# K15's plain version against the JAX kernel in interpret mode: max |diff|
# over each output's max |value| and cosine.  Both compute the same bf16
# steps; XLA:CPU may keep an f32 intermediate between two bf16 ops where
# torch rounds, and the f32 sums run in another order, so a bf16 value
# moves by a step now and then and the moves pass through the later stages
K15_MAX_ERR, K15_MIN_COS = 2.0**-6, 0.9999


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cos(a, b):
    a, b = _np(a).astype(np.float64).ravel(), _np(b).astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("act", [True, False], ids=["relu", "noact"])
@pytest.mark.parametrize("residual", [True, False], ids=["res", "nores"])
@pytest.mark.parametrize("shape", [(256, 128, 256), (512, 64, 64)], ids=["256x128x256", "512x64x64"])
def test_k16_plain_matches_jax(shape, residual, act):
    """f32 on both sides, the JAX contract (tests/test_pallas_nms.py:112-123):
    rtol 1e-4, atol 1e-4; the sums differ only in their order."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.ops.pallas_fused import matmul_bn_act

    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    x, w = rng.normal(size=(m, k)).astype(np.float32), rng.normal(size=(k, n)).astype(np.float32)
    scale, shift = rng.normal(size=n).astype(np.float32), rng.normal(size=n).astype(np.float32)
    res = rng.normal(size=(m, n)).astype(np.float32) if residual else None
    want = matmul_bn_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift),
                         None if res is None else jnp.asarray(res), act=act, interpret=True)
    got = matmul_bn_act_plain(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
                              torch.from_numpy(scale), torch.from_numpy(shift),
                              None if res is None else torch.from_numpy(res), act)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the NHWC 1x1-conv form reshapes around the same GEMM
    conv = conv1x1_bn_act(torch.from_numpy(x).reshape(2, m // 2, 1, k), torch.from_numpy(np.ascontiguousarray(w.T)),
                          torch.from_numpy(scale), torch.from_numpy(shift),
                          None if res is None else torch.from_numpy(res).reshape(2, m // 2, 1, n), act)
    assert torch.equal(conv.reshape(m, n), got)


# ---------------------------------------------------------------- (b)

@pytest.fixture(scope="module")
def backbone_setup():
    """One ResNet-50's flax variables (the JAX init, as test_pallas_nms's
    test does), the port's backbone holding the same weights, and a 64x64
    image."""
    import jax
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.nn.resnet import ResNet50 as JaxResNet50

    img = np.random.default_rng(0).normal(size=(1, 64, 64, 3)).astype(np.float32)
    variables = JaxResNet50().init(jax.random.PRNGKey(1), jnp.asarray(img), False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = ResNet50().eval()
    load_flax_variables(port, variables["params"], variables["batch_stats"])
    return dict(variables=variables, port=port, img=img)


def test_fused_backbone_matches_jax_and_module(backbone_setup):
    """The port's fused forward against the JAX fused forward (K16 in
    interpret mode) and against the port's module forward, f32: rtol 1e-4,
    atol 2e-4 (the JAX contract, tests/test_pallas_nms.py:96-109)."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.nn.fused_resnet import resnet50_fused_forward as jax_fused

    port, img = backbone_setup["port"], backbone_setup["img"]
    want = jax_fused(backbone_setup["variables"], jnp.asarray(img), compute_dtype=jnp.float32, interpret=True)
    x = torch.from_numpy(img)
    folded = fold_resnet50(port, torch.float32)
    got = resnet50_fused_forward(port, x, torch.float32, folded=folded)
    with torch.no_grad():
        module = port(x.permute(0, 3, 1, 2).contiguous())
    assert [tuple(t.shape) for t in got] == [(1, 8, 8, 512), (1, 4, 4, 1024), (1, 2, 2, 2048)]
    for g, w, mod in zip(got, want, module):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(_np(g), _np(mod.permute(0, 2, 3, 1)), rtol=1e-4, atol=2e-4)
    # the folded weights are reused, not read again: the same result from a fresh fold
    for g, again in zip(got, resnet50_fused_forward(port, x, torch.float32)):
        assert torch.equal(g, again)


def test_s2d_stem_matches_jax_and_the_conv7_stem(backbone_setup):
    """``ResNet50(stem_mode="s2d")`` on the JAX s2d model's weights
    (``conv1_s2d = s2d_stem_kernel(conv1)``, the rest shared) against the
    JAX s2d model, and against the port's conv7 model: the space-to-depth
    form is the same function, so f32 sums in another order only (the
    module tolerance of ``assert_close_to_ref``, 1e-4 of the range)."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.nn.resnet import ResNet50 as JaxResNet50
    from pytorch_object_detection_tpu.nn.resnet import s2d_stem_kernel as jax_s2d_stem_kernel

    from torch_port_fixtures import assert_close_to_ref

    variables, img = backbone_setup["variables"], backbone_setup["img"]
    params = dict(variables["params"])
    conv7 = params.pop("conv1")["conv"]["kernel"]
    params["conv1_s2d"] = {"kernel": np.asarray(jax_s2d_stem_kernel(jnp.asarray(conv7)))}
    want = JaxResNet50(stem_mode="s2d").apply({"params": params, "batch_stats": variables["batch_stats"]},
                                               jnp.asarray(img), False)
    port = ResNet50(stem_mode="s2d").eval()
    load_flax_variables(port, params, variables["batch_stats"])  # backbone/conv1_s2d/kernel carried across
    torch.testing.assert_close(port.conv1_s2d.weight,
                               s2d_stem_kernel(torch.from_numpy(conv7)).permute(3, 2, 0, 1), rtol=0, atol=0)
    x = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got, conv7_out = port(x), backbone_setup["port"](x)
    for i, (g, w, c) in enumerate(zip(got, want, conv7_out)):
        assert_close_to_ref(g.permute(0, 2, 3, 1), w, f"s2d C{i + 3} vs JAX")
        assert_close_to_ref(g, c.numpy(), f"s2d C{i + 3} vs conv7")
    with pytest.raises(ValueError, match="stem_mode"):
        ResNet50(stem_mode="s4d")


# ---------------------------------------------------------------- (c)

def _head_pair(nc: int, seed: int):
    """A JAX HISHead's perturbed params (GN affines, biases and kernels away
    from init) and the port's HISHead holding them, f=64."""
    import jax
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.models.heads import HISHead as JaxHISHead

    shapes = jax.eval_shape(lambda k, x: JaxHISHead(nc, FEATURES).init(k, [x] * 5), jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 4, FEATURES)))  # five levels: scale0 .. scale4
    rng = np.random.default_rng(seed)

    def fill(tree, path=()):
        out = {}
        for key, v in tree.items():
            if not hasattr(v, "shape"):
                out[key] = fill(v, path + (key,))
            elif key == "kernel":
                out[key] = rng.normal(0.0, np.sqrt(2.0 / np.prod(v.shape[:3])), v.shape).astype(np.float32)
            elif key == "scale" and path[-1] == "gn":
                out[key] = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
            elif key == "scale":
                out[key] = (1.2 * rng.uniform(0.8, 1.2, v.shape)).astype(np.float32)
            else:
                out[key] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        return out

    params = fill(shapes["params"])
    head = HISHead(nc, FEATURES).eval()
    load_flax_variables(head, params)
    return params, head


def test_k15_pack_matches_jax():
    """Every packed operand equals the JAX packer's on the same weights."""
    import jax
    from pytorch_object_detection_tpu.ops.pallas_head import hishead_params_pack as jax_pack

    params, head = _head_pair(80, 1)
    want = jax.tree_util.tree_map(np.asarray, jax_pack(params, 80))
    got = hishead_params_pack(head, 80)
    for key in ("pw1", "dw", "pw2", "cls_t", "reg_t", "pred_cls", "pred_cr", "gn", "bias"):
        assert got[key].dtype == {np.float32: torch.float32}.get(want[key].dtype.type, torch.bfloat16), key
        np.testing.assert_array_equal(_np(got[key].float()), want[key].astype(np.float32), err_msg=key)
    assert (got["f"], got["f2"]) == (FEATURES, 2 * FEATURES)
    # the kernel's [N, K] layouts hold the same weights
    f = FEATURES
    torch.testing.assert_close(got["k_pw1"], got["pw1"].t(), rtol=0, atol=0)
    torch.testing.assert_close(got["k_pw2"], got["pw2"].t(), rtol=0, atol=0)
    torch.testing.assert_close(got["k_tow"], torch.cat([got["cls_t"], got["reg_t"]], -1).reshape(9 * f, 2 * f).t(),
                               rtol=0, atol=0)
    torch.testing.assert_close(got["k_cls"], got["pred_cls"].reshape(9 * f, 80).t(), rtol=0, atol=0)
    torch.testing.assert_close(got["k_cr"], got["pred_cr"].reshape(9 * f, 5).t(), rtol=0, atol=0)


@pytest.mark.parametrize("nc", [20, 80])
@pytest.mark.parametrize("hw", [(8, 8), (4, 4), (7, 11)], ids=["8x8", "4x4", "7x11"])
def test_k15_plain_matches_jax_kernel(hw, nc):
    """The plain version against ``hishead_level_fused(interpret=True)`` on
    the same weights and bf16 input, B=2, f=64: per output (cls, cnt, raw
    reg) max |diff| within 2^-6 of its max |value| and cosine >= 0.9999."""
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.ops.pallas_head import hishead_level_fused as jax_fused_head
    from pytorch_object_detection_tpu.ops.pallas_head import hishead_params_pack as jax_pack

    params, head = _head_pair(nc, hw[0] * hw[1] + nc)
    x = (np.random.default_rng(nc).normal(size=(BATCH, *hw, FEATURES)) * 0.5).astype(np.float32)
    x_bf = torch.from_numpy(x).bfloat16()
    want = np.asarray(jax_fused_head(jnp.asarray(x).astype(jnp.bfloat16), jax_pack(params, nc), nc,
                                     interpret=True).astype(jnp.float32))
    got = hishead_level_fused_plain(x_bf, hishead_params_pack(head, nc), nc)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (BATCH, *hw, nc + 5)
    got = _np(got.float())
    for name, sl in (("cls", slice(0, nc)), ("cnt", slice(nc, nc + 1)), ("reg", slice(nc + 1, nc + 5))):
        g, w = got[..., sl], want[..., sl]
        err, rng_ = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert np.isfinite(g).all() and err <= K15_MAX_ERR * rng_ and _cos(g, w) >= K15_MIN_COS, \
            f"{name}: max abs err {err:.4g} (range {rng_:.4g}), cosine {_cos(g, w):.8f}"


def test_k15_plain_matches_float_hishead():
    """The plain version (bf16 steps) against the port's float HISHead in
    f32 on the same weights, with ScaleExp on the regression: the JAX
    contract and set-up of tests/test_quant.py:359-382 (HISHead(20, 256)
    at its init, input N(0, 0.25), 8x8, B=2; 0.08 on cls, 0.04 on cnt, 0.1
    on reg, absolute)."""
    nc = NUM_CLASSES
    head = HISHead(nc, 256, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy((np.random.default_rng(8).normal(size=(BATCH, 8, 8, 256)) * 0.5).astype(np.float32))
    out = hishead_level_fused_plain(x, hishead_params_pack(head, nc), nc).float()
    with torch.no_grad():
        cls_l, cnt_l, reg_l = head([x.bfloat16().float().permute(0, 3, 1, 2).contiguous()])
    got_reg = torch.exp(out[..., nc + 1:] * head.scale0.scale.detach())
    for name, got, want, tol in (("cls", out[..., :nc], cls_l[0], 0.08), ("cnt", out[..., nc:nc + 1], cnt_l[0], 0.04),
                                 ("reg", got_reg, reg_l[0], 0.1)):
        d = float((got - want.permute(0, 2, 3, 1)).abs().max())
        assert d < tol, f"{name}: {d:.4g}"


# ---------------------------------------------------------------- (d)

def _qmm_script():
    path = Path(__file__).resolve().parents[1] / "scripts" / "dev_qmm_variants.py"
    spec = importlib.util.spec_from_file_location("dev_qmm_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["full", "nores", "shift"])
def test_k4_prime_plain_bit_exact_vs_jax(variant):
    """Each plain epilogue against the script's kernel body through
    ``pl.pallas_call(..., interpret=True)`` with the script's block specs,
    at M=1024 (the script's K=64, N=256): 0 differing int8 elements, the
    shift variant's wrap included (its weights are drawn wide enough that
    ``acc >> 8`` leaves +-127)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    script = _qmm_script()
    m, k, n = 1024, script.K, script.N
    rng = np.random.default_rng(11)
    x = rng.integers(-127, 127, (m, k)).astype(np.int8)
    # the script's weights in [-16, 16); the shift variant's sums reach past +-127 * 256 only with wider ones
    w = rng.integers(-16, 16, (k, n)).astype(np.int8) if variant != "shift" else rng.integers(
        -127, 128, (k, n)).astype(np.int8)
    a = (np.abs(rng.normal(size=(1, n))) * 1e-3).astype(np.float32)
    b = rng.normal(size=(1, n)).astype(np.float32)
    res = rng.integers(-127, 127, (m, n)).astype(np.int8)
    s = script._spec(script.TM, k, script.TN)
    kern = {"full": script.k_full, "nores": script.k_nores, "shift": script.k_shift}[variant]
    with_res = variant == "full"
    args = [x, w, a, b] + ([res] if with_res else [])
    want = np.asarray(pl.pallas_call(
        kern, grid=(m // script.TM, n // script.TN),
        in_specs=[s["x"], s["w"], s["ab"], s["ab"]] + ([s["out"]] if with_res else []),
        out_specs=s["out"], out_shape=jax.ShapeDtypeStruct((m, n), jnp.int8), interpret=True,
    )(*[jnp.asarray(t) for t in args]))
    got = qmm_variant_plain(variant, torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
                            torch.from_numpy(a[0]), torch.from_numpy(b[0]),
                            torch.from_numpy(res) if with_res else None)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(_np(got), want)
    if variant == "shift":  # the wrap is exercised
        acc = x.astype(np.int64) @ w.astype(np.int64)
        assert np.abs(acc >> 8).max() > 127


# ---------------------------------------------------------------- (e)

@pytest.fixture(scope="module")
def slice_runs():
    """HISFCOS(20, 64) at 256x256, B=2, f32: the JAX qtree, the JAX
    composition of the fused-head path run op by op, and the port's
    ``make_eval_forward_int8(fused_head=True)`` on the same weights."""
    import jax
    import jax.numpy as jnp
    from pytorch_object_detection_tpu.nn.fused_fpn import hisfpn_folded_forward as jax_folded_fpn
    from pytorch_object_detection_tpu.nn.resnet_int8 import resnet50_int8_forward as jax_int8_forward
    from pytorch_object_detection_tpu.ops.pallas_head import hishead_level_fused as jax_fused_head
    from pytorch_object_detection_tpu.ops.pallas_head import hishead_params_pack as jax_pack
    from pytorch_object_detection_tpu.train import trainer as jt

    params, stats = perturbed_variables(seed=6)
    frames = np.random.default_rng(7).integers(0, 256, (BATCH, SLICE_CANVAS, SLICE_CANVAS, 3), dtype=np.uint8)
    norm = ((frames.astype(np.float32) / np.float32(255.0) - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    jqtree = jt.quantize_backbone(jax_model(), {"params": params, "batch_stats": stats}, jnp.asarray(norm),
                                  compute_dtype=jnp.float32)
    feats = jax_int8_forward(jqtree, jnp.asarray(norm), jnp.float32, backend="xla")
    levels = jax_folded_fpn(params["fpn"], stats["fpn"], feats, jnp.float32)
    packed = jax_pack(params["head"], NUM_CLASSES)
    jax_out = ([], [], [])
    for i, lv in enumerate(levels):
        out = jax_fused_head(lv.astype(jnp.bfloat16), packed, NUM_CLASSES, interpret=True)
        s = params["head"][f"scale{i}"]["scale"]
        jax_out[0].append(np.asarray(out[..., :NUM_CLASSES].astype(jnp.float32)))
        jax_out[1].append(np.asarray(out[..., NUM_CLASSES:NUM_CLASSES + 1].astype(jnp.float32)))
        jax_out[2].append(np.asarray(jnp.exp(out[..., NUM_CLASSES + 1:].astype(jnp.float32) * s)))

    model = build_model("HISFCOS", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    qtree = load_backbone_qtree(jax.tree_util.tree_map(np.asarray, jqtree), "cpu")
    fwd = make_eval_forward_int8(model, torch.float32, fused_head=True, use_pallas_gn=True)
    levels_port = fwd(qtree, torch.from_numpy(norm))
    return dict(jax=jax_out, port=levels_port, model=model, norm=norm, frames=frames, qtree=qtree)


@pytest.mark.parametrize("branch", [0, 1, 2], ids=["cls", "cnt", "reg"])
def test_fused_head_slice_matches_jax(slice_runs, branch):
    """Per level and branch, cosine >= 0.9999 against the JAX composition
    (the int8 backbone is bit-exact; the FPN's f32 sums and K15's bf16
    steps move a value by a bf16 step now and then)."""
    for i, (got, want) in enumerate(zip(slice_runs["port"][branch], slice_runs["jax"][branch])):
        got = _np(got)
        assert got.shape == want.shape and got.dtype == np.float32 and np.isfinite(got).all()
        assert _cos(got, want) >= 0.9999, f"branch {branch} level {i}: cosine {_cos(got, want):.8f}"


def test_fused_head_pipeline_decodes_and_options(slice_runs):
    """The pipeline with ``fused_head=True`` decodes finite detections and
    its maps equal the forward's; ``fused_head`` is ignored by the forward
    where JAX ignores it (``int8_fpn=True``, ``backend="xla"``) and refused
    there by the pipeline; ``use_pallas_gn`` is accepted."""
    model, norm, frames = slice_runs["model"], torch.from_numpy(slice_runs["norm"]), torch.from_numpy(
        slice_runs["frames"])
    args = (model, norm, STRIDES, (SLICE_CANVAS, SLICE_CANVAS))
    pipe = make_eval_pipeline_int8(*args, int8_fpn=False, fused_head=True, compute_dtype=torch.float32)
    pipe.qtree = slice_runs["qtree"]
    levels = pipe.forward_levels(frames)
    for got_b, want_b in zip(levels, slice_runs["port"]):
        assert all(torch.equal(a, b) for a, b in zip(got_b, want_b))
    dets = pipe.decode(levels)
    assert torch.isfinite(dets.scores).all() and torch.isfinite(dets.boxes).all()
    assert all(int(n) > 0 for n in dets.valid.sum(dim=1))
    for kw in (dict(int8_fpn=True), dict(int8_fpn=False, backend="xla")):
        with pytest.raises(ValueError, match="fused_head"):
            make_eval_pipeline_int8(*args, fused_head=True, compute_dtype=torch.float32, **kw)
    # ignored by the forward: the same maps as without it
    qtree = slice_runs["qtree"]
    x = norm[:1, :128, :128]
    for kw in (dict(backend="xla"), dict(backend="xla", use_pallas_gn=True)):
        a = make_eval_forward_int8(model, torch.float32, fused_head=True, **kw)(qtree, x)
        b = make_eval_forward_int8(model, torch.float32, **kw)(qtree, x)
        assert all(torch.equal(p, q) for pb, qb in zip(a, b) for p, q in zip(pb, qb))
    fq = {"backbone": qtree, "fpn": quantize_fpn(model, qtree, x)}
    a, b = (make_eval_forward_int8(model, torch.float32, fused_head=fh, int8_fpn=True)(fq, x) for fh in (True, False))
    assert all(torch.equal(p, q) for pb, qb in zip(a, b) for p, q in zip(pb, qb))
    # the fused head's maps follow the float head's at bf16 precision on this path
    unfused = make_eval_forward_int8(model, torch.float32)(qtree, norm)
    for got_b, want_b in zip(slice_runs["port"], unfused):
        for g, w in zip(got_b, want_b):
            assert _cos(g, w) >= 0.999


def test_quantize_backbone_of_the_port_feeds_the_fused_head(slice_runs):
    """The port's own calibration gives a qtree the fused-head forward takes
    (the slice test used the JAX package's).  The two qtrees differ where an
    ulp of the BN fold moves a weight or a scale (test_torch_port_int8), so
    int8 values move by a step and the maps are held at the int8 tests'
    cosine, 0.99."""
    model, norm = slice_runs["model"], torch.from_numpy(slice_runs["norm"])
    qtree = quantize_backbone(model, norm, torch.float32)
    out = make_eval_forward_int8(model, torch.float32, fused_head=True)(qtree, norm)
    for got_b, want_b in zip(out, slice_runs["port"]):
        for g, w in zip(got_b, want_b):
            assert g.shape == w.shape and bool(torch.isfinite(g).all()) and _cos(g, w) >= 0.99
