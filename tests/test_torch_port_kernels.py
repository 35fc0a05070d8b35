"""The port's kernels against their plain versions: A (NMS), B (GroupNorm),
C (int8 bottleneck), K1 (uint8 stem, under the chooser's tiles and forced
ones), K4 (int8 GEMM), K4' (its three timing epilogues), K5 (int8
HisBlock, under every tile of its chooser, and with the level pool in its
load), K6 (int8 2x2 pool, and the HisFPN's two seeds in one launch), K7/K9 (one int8
HISHead level), K10 (int8 3x3/2 pool), K11 (int8 3x3 conv), K13 (a chain of
int8 bottlenecks), K15 (one bf16 HISHead level), K16 (the bf16 GEMM with
the BN/residual/ReLU epilogue), K17 (the bf16 stem tail) and K12 (one
whole int8 MNBlock); kernel B and K17 also under every tile their choosers
weigh, with one CUDA kernel a call.  A train step on the card: kernel B
launched no time in it (its wrapper raises when asked for a gradient) and 20
times in an eval forward after it, the frozen weights unchanged, the bf16
step against the f32 step.

The kernel cases need an NVIDIA card (marker ``cuda``) and skip elsewhere.
This file imports no JAX, so it runs on the card's machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py

The CPU cases check what the wrappers do without a card: plain version,
no launch counted, bad operands refused.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu_torch.models.heads import HISHead
from pytorch_object_detection_tpu_torch.nn.resnet import space_to_depth
from pytorch_object_detection_tpu_torch.ops.cuda_nms import cuda_batched_class_nms, cuda_nms_keep_mask
from pytorch_object_detection_tpu_torch.ops.fused import conv1x1_bn_act, matmul_bn_act, matmul_bn_act_plain
from pytorch_object_detection_tpu_torch.ops.gn import groupnorm_act, groupnorm_act_plain
from pytorch_object_detection_tpu_torch.ops.nms import batched_class_nms
from pytorch_object_detection_tpu_torch.ops.qblock import card_limits, qbottleneck, qbottleneck_s2
from pytorch_object_detection_tpu_torch.ops.head import (
    FHEAD_PASSES, fhead_options, hishead_level_fused, hishead_level_fused_plain, hishead_params_pack)
from pytorch_object_detection_tpu_torch.ops.qchain import qchain, qchain_plain
from pytorch_object_detection_tpu_torch.ops.qconv import qconv1x1, qconv3x3, qconv3x3_plain, qmatmul
from pytorch_object_detection_tpu_torch.ops.qhis import qhisblock
from pytorch_object_detection_tpu_torch.ops.qmnblock import mn_options, qmnblock, qmnblock_plain
from pytorch_object_detection_tpu_torch.ops.qmm_variants import VARIANTS, qmm_variant, qmm_variant_plain
from pytorch_object_detection_tpu_torch.ops.qpool import (
    qmaxpool2x2, qmaxpool2x2_seeds, qmaxpool2x2_seeds_plain, qmaxpool3x3s2, qmaxpool3x3s2_plain)
from pytorch_object_detection_tpu_torch.ops.qstem import qstem_conv, qstem_plain, to_rgbx
from pytorch_object_detection_tpu_torch.ops.stem import stem_bn_pool_quant, stem_bn_pool_quant_plain
from torch_port_fixtures import (
    ADVERSARIAL_KEEP,
    nms_case,
    port_block,
    port_head_qtree,
    port_hisfpn_qtree,
    port_stem_s2d,
    rand_qblock,
    resnet50_block_shapes,
    run_port_block,
)

# (C, H=W) of the head's GroupNorms at the 512x512 canvas: stem_gn1/2 on
# 2*256 channels, cls/reg on 256, levels 64x64 .. 4x4
HEAD_SHAPES = [(c, h) for h in (64, 32, 16, 8, 4) for c in (512, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gn_inputs(c, h, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, c, h, h, generator=g) * 2.0 + torch.randn(1, c, 1, 1, generator=g)
    scale = torch.rand(c, generator=g) + 0.5
    bias = torch.randn(c, generator=g) * 0.3
    return x.to(device, dtype), scale.to(device), bias.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "relu", "silu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gn_kernel_matches_plain(cuda, dtype, act):
    """f32: max abs err <= 1e-5 (same f32 math, another summation order).
    bf16: both sides compute in f32 from the same bf16 input and round once
    to bf16, so an element differs by at most one bf16 rounding step where
    the f32 values straddle a rounding boundary: <= 2**-7 relative plus a
    small absolute term near 0."""
    for i, (c, h) in enumerate(HEAD_SHAPES):
        x, scale, bias = _gn_inputs(c, h, dtype, cuda, i)
        with torch.no_grad():
            got = groupnorm_act(x, scale, bias, act=act)
            want = groupnorm_act_plain(x, scale, bias, act=act)
        assert got.dtype == dtype and got.shape == x.shape
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)
        else:
            torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-3)


# (B, C, H, W): a head shape of each size class, the COCO canvas's P3 slab (a cluster of 8), odd H*W (slabs off
# the 16-byte grid at C=64) and a 1x1 map
GN_TILE_SHAPES = [(8, 512, 64, 64), (8, 256, 16, 16), (8, 512, 4, 4), (2, 512, 112, 176), (3, 256, 7, 11),
                  (2, 64, 7, 11), (2, 32, 1, 1)]


def _cuda_kernel_names(fn):
    """Names of the CUDA kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")
            and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]


@pytest.mark.cuda
@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16], ids=["f32-params", "bf16-params"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GN_TILE_SHAPES, ids=[f"B{b}-C{c}-{h}x{w}" for b, c, h, w in GN_TILE_SHAPES])
def test_gn_kernel_same_bits_under_every_tile(cuda, shape, dtype, pdtype):
    """Kernel B under every tile ops/gn.gn_options gives (the streaming
    path's among them): within its contract against the plain version (f32
    1e-5, bf16 one rounding step), and the same bits as under the
    chooser's tile (the sums are taken in fixed 4 KB chunks, folded in
    order)."""
    from pytorch_object_detection_tpu_torch.ops.gn import gn_options

    b, c, h, w = shape
    g = torch.Generator().manual_seed(c + h + w)
    x = (torch.randn(b, c, h, w, generator=g) * 2.0 + torch.randn(1, c, 1, 1, generator=g)).to(cuda, dtype)
    scale = (torch.rand(c, generator=g) + 0.5).to(cuda, pdtype)
    bias = (torch.randn(c, generator=g) * 0.3).to(cuda, pdtype)
    tiles = gn_options(b, c, h * w, 32, x.element_size(), card_limits(cuda)[1])
    assert any(t[0] == "stream" for t in tiles)
    for act in ("relu", "silu"):
        with torch.no_grad():
            want = groupnorm_act_plain(x, scale, bias, act=act)
            chosen = groupnorm_act(x, scale, bias, act=act)
            for tile in tiles:
                got = groupnorm_act(x, scale, bias, act=act, tile=tile)
                assert torch.equal(got, chosen), f"{tile}: {int((got != chosen).sum())} differ from the chooser's"
        if dtype == torch.float32:
            torch.testing.assert_close(chosen, want, rtol=0.0, atol=1e-5)
        else:
            torch.testing.assert_close(chosen.float(), want.float(), rtol=2**-7, atol=1e-3)


@pytest.mark.cuda
def test_gn_wrapper_launches_one_kernel_on_bf16_params(cuda):
    """The pipeline's bf16 GroupNorm32 (bf16 map, scale and bias): one call of
    kernel B's wrapper is one CUDA kernel, no cast of the parameters."""
    x, scale, bias = _gn_inputs(512, 16, torch.bfloat16, cuda, 0)
    scale, bias = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    with torch.no_grad():
        names = _cuda_kernel_names(lambda: groupnorm_act(x, scale, bias, act="silu"))
    assert len(names) == 1 and "gn_act_kernel" in names[0], names


@pytest.mark.cuda
def test_gn_kernel_rejects_other_layouts(cuda):
    x, scale, bias = _gn_inputs(256, 8, torch.float32, cuda, 0)
    with torch.no_grad():
        with pytest.raises(ValueError):
            groupnorm_act(x.to(memory_format=torch.channels_last), scale, bias)
        with pytest.raises(ValueError):
            groupnorm_act(x.half(), scale, bias)
    with pytest.raises(RuntimeError):  # no backward
        groupnorm_act(x.requires_grad_(), scale, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "padding", "adversarial"])
def test_nms_kernel_matches_plain_exactly(cuda, case):
    b, c, v, thr = (torch.from_numpy(a) if not isinstance(a, float) else a for a in nms_case(case))
    scores = torch.linspace(1.0, 0.0, b.shape[1]).expand(b.shape[0], -1)
    want = batched_class_nms(b, scores, c, v, thr)
    before = cuda_nms_keep_mask.launches
    got = cuda_batched_class_nms(b.to(cuda), scores.to(cuda), c.to(cuda), v.to(cuda), thr)
    torch.cuda.synchronize()
    assert cuda_nms_keep_mask.launches == before + 1
    assert torch.equal(got.cpu(), want)
    if case == "adversarial":
        assert torch.equal(got.cpu(), torch.from_numpy(ADVERSARIAL_KEEP))


@pytest.mark.cuda
def test_nms_kernel_matches_plain_at_serving_shape(cuda):
    """B=8, K=1000 (the decode's top-k), boxes clustered so chains of
    suppression are long; exact equality with the plain fixpoint on the card."""
    g = torch.Generator().manual_seed(5)
    xy = torch.rand(8, 1000, 2, generator=g) * 200
    wh = torch.rand(8, 1000, 2, generator=g) * 60 + 4
    boxes = torch.cat([xy, xy + wh], -1).to(cuda)
    classes = torch.randint(1, 4, (8, 1000), generator=g, dtype=torch.int32).to(cuda)
    valid = (torch.rand(8, 1000, generator=g) > 0.1).to(cuda)
    scores = torch.linspace(1.0, 0.0, 1000, device=cuda).expand(8, -1)
    want = batched_class_nms(boxes, scores, classes, valid, 0.6)
    got = cuda_batched_class_nms(boxes, scores, classes, valid, 0.6)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(valid.sum())


def _nms_tile_case(name, b, k):
    """(boxes [B, K, 4] f32, valid [B, K] bool) for kernel A's tile scan:
    random boxes, all invalid, a chain in which each box suppresses the
    next (IoU 2/3 with it, 3/7 with the one after), and 8 clusters whose
    members sit 8 rows apart, so suppression crosses every tile edge."""
    rng = np.random.default_rng(b * 10007 + k)
    if name == "chain":
        x = np.arange(k, dtype=np.float32)[None, :, None] * 2.0
        boxes = np.concatenate([x, np.zeros_like(x), x + 10.0, np.full_like(x, 10.0)], -1).repeat(b, 0)
        return torch.from_numpy(boxes), torch.ones(b, k, dtype=torch.bool)
    if name == "edges":
        centre = rng.uniform(20, 400, (b, 8, 2))[:, np.arange(k) % 8]
        xy = centre + rng.uniform(-6, 6, (b, k, 2))
        wh = rng.uniform(20, 30, (b, k, 2))
    else:
        xy = rng.uniform(0, 300, (b, k, 2))
        wh = rng.uniform(10, 80, (b, k, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(b, k)) > (1.1 if name == "invalid" else 0.15))
    return boxes, valid


# (case, B, K): K at, below and above one 64-row tile and at the decode's
# top-k, B = 1 and 64, no valid box, the suppression chain, clusters across tile edges
NMS_TILE_CASES = [("random", 1, 1), ("random", 3, 63), ("random", 3, 64), ("random", 3, 65), ("random", 1, 1000),
                  ("random", 64, 1000), ("invalid", 4, 200), ("chain", 2, 1000), ("chain", 1, 65),
                  ("edges", 8, 256), ("edges", 64, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", NMS_TILE_CASES, ids=[f"{c[0]}_b{c[1]}_k{c[2]}" for c in NMS_TILE_CASES])
def test_nms_kernel_tile_scan_matches_plain_exactly(cuda, case):
    """Kernel A's 64-row tile scan against the plain fixpoint, bit for bit,
    one counted launch."""
    from pytorch_object_detection_tpu_torch.ops.nms import nms_keep_mask

    name, b, k = case
    boxes, valid = _nms_tile_case(name, b, k)
    want = nms_keep_mask(boxes, valid, 0.6)
    before = cuda_nms_keep_mask.launches
    got = cuda_nms_keep_mask(boxes.to(cuda), valid.to(cuda), 0.6)
    torch.cuda.synchronize()
    assert cuda_nms_keep_mask.launches == before + 1
    assert torch.equal(got.cpu(), want)
    if name == "chain":  # every other box kept
        assert torch.equal(want, (torch.arange(k) % 2 == 0).expand(b, k))
    if name == "invalid":
        assert not bool(want.any())


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    b, c, v, thr = (torch.from_numpy(a) if not isinstance(a, float) else a for a in nms_case("random"))
    scores = torch.linspace(1.0, 0.0, b.shape[1]).expand(b.shape[0], -1)
    x, scale, bias = _gn_inputs(64, 8, torch.float32, "cpu", 0)
    gn_before, nms_before = groupnorm_act.launches, cuda_nms_keep_mask.launches
    assert torch.equal(cuda_batched_class_nms(b, scores, c, v, thr), batched_class_nms(b, scores, c, v, thr))
    assert torch.equal(groupnorm_act(x, scale, bias, act="relu"),
                       groupnorm_act_plain(x, scale, bias, act="relu"))
    assert (groupnorm_act.launches, cuda_nms_keep_mask.launches) == (gn_before, nms_before)


# (name, H, W, Cin, Cw, Cout, stride, projection): identity, projection and
# stride 2, then odd and not-power-of-two maps at both strides
QBLOCK_CASES = [
    ("identity", 16, 16, 64, 16, 64, 1, False),
    ("projection", 16, 16, 32, 16, 64, 1, True),
    ("stride2", 16, 16, 64, 32, 128, 2, True),
    ("odd", 13, 11, 64, 32, 64, 1, False),
    ("odd_stride2", 13, 11, 32, 16, 64, 2, True),
    ("nonpow2", 12, 20, 64, 16, 64, 1, False),
    ("nonpow2_stride2", 24, 40, 64, 16, 128, 2, True),
]


def _qblock_case(cin, cw, cout, projection, b, h, w, seed, device):
    rng = np.random.default_rng(seed)
    blk = port_block(rand_qblock(rng, cin, cw, cout, projection), device)
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)).to(device)
    return blk, x


@pytest.mark.cuda
@pytest.mark.parametrize("case", QBLOCK_CASES, ids=[c[0] for c in QBLOCK_CASES])
def test_qblock_kernel_matches_plain_exactly(cuda, case):
    """0 differing int8 elements against the plain version on the card and
    on the CPU, on an odd batch, whatever the tile (``tile`` overrides the
    chooser: 8x8 or 8x16 tiles, one or two blocks per tile; the maps leave
    ragged tiles); each launch adds one to its own wrapper's count only."""
    name, h, w, cin, cw, cout, stride, projection = case
    blk, x = _qblock_case(cin, cw, cout, projection, 3, h, w, sum(map(ord, name)), cuda)
    want = run_port_block(blk, x, stride, plain=True)
    cpu = run_port_block({k: v.cpu() for k, v in blk.items()}, x.cpu(), stride)
    assert torch.equal(want.cpu(), cpu)
    counter, other = (qbottleneck_s2, qbottleneck) if stride == 2 else (qbottleneck, qbottleneck_s2)
    for tile in (None, (8, 1), (16, 1), (8, 2)):
        if tile is not None and (cw % (16 * tile[1]) or cout % (16 * tile[1])):
            continue
        before = (counter.launches, other.launches)
        got = run_port_block(blk, x, stride, tile=tile)
        torch.cuda.synchronize()
        assert (counter.launches, other.launches) == (before[0] + 1, before[1])
        assert got.dtype == torch.int8 and got.shape == want.shape and got.is_contiguous()
        n_diff = int((got != want).sum())
        assert n_diff == 0, f"{name} tile={tile}: {n_diff} of {want.numel()} int8 elements differ"
    assert 0 < (want > 0).float().mean() and (want == 127).float().mean() < 0.05  # not degenerate


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("shape", resnet50_block_shapes(), ids=[s[0] for s in resnet50_block_shapes()])
def test_qblock_kernel_at_resnet50_shapes(cuda, shape, batch):
    """The 16 bottlenecks of ResNet-50 at the 512x512 canvas, B=2 and B=8,
    on the chooser's tile: 0 differing elements."""
    scope, h, w, cin, cw, cout, stride = shape
    blk, x = _qblock_case(cin, cw, cout, scope.endswith("_0"), batch, h, w, len(scope) + h, cuda)
    got = run_port_block(blk, x, stride)
    want = run_port_block(blk, x, stride, plain=True)
    torch.cuda.synchronize()
    assert got.shape == (batch, (h - 1) // stride + 1, (w - 1) // stride + 1, cout)
    assert torch.equal(got, want), f"{scope}: {int((got != want).sum())} int8 elements differ"


# (scope, split): clusters of 2, 4 and 8 blocks per 8x8 tile on the blocks
# of stages 2-4, stride 1 and 2, and a ragged 13x11 map
CLUSTER_CASES = [(scope, split) for scope in ("layer2_0", "layer3_1", "layer4_0", "layer4_1") for split in (2, 4, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLUSTER_CASES, ids=[f"{c[0]}-s{c[1]}" for c in CLUSTER_CASES])
def test_qblock_kernel_cluster_split(cuda, case):
    """A cluster of 2, 4 or 8 blocks per tile, each computing 1/split of
    every conv's channels and sharing a1 and a2 through distributed shared
    memory: 0 differing elements, at the stage's map and at a ragged one."""
    scope, split = case
    _, h, w, cin, cw, cout, stride = next(s for s in resnet50_block_shapes() if s[0] == scope)
    for hh, ww, batch in ((h, w, 2), (13, 11, 3)):
        blk, x = _qblock_case(cin, cw, cout, scope.endswith("_0"), batch, hh, ww, split + hh, cuda)
        got = run_port_block(blk, x, stride, tile=(8, split))
        want = run_port_block(blk, x, stride, plain=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"{scope} {hh}x{ww} split={split}: {int((got != want).sum())} differ"


@pytest.mark.cuda
def test_qblock_kernel_rejects_other_layouts(cuda):
    blk, x = _qblock_case(64, 16, 64, False, 2, 8, 8, 0, cuda)
    with pytest.raises(ValueError):  # NCHW
        run_port_block(blk, x.permute(0, 3, 1, 2).contiguous(), 1)
    with pytest.raises(ValueError):  # not int8
        run_port_block(blk, x.float(), 1)
    with pytest.raises(ValueError):  # NHWC-shaped but not contiguous
        run_port_block(blk, x.transpose(1, 2), 1)
    with pytest.raises(ValueError):  # a weight on another device
        run_port_block(dict(blk, w2=blk["w2"].cpu()), x, 1)


def test_qblock_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    from pytorch_object_detection_tpu_torch.ops.qblock import qbottleneck_plain

    before = (qbottleneck.launches, qbottleneck_s2.launches)
    for stride, projection in ((1, False), (1, True), (2, True)):
        blk, x = _qblock_case(32, 16, 32 if not projection else 64, projection, 2, 9, 7, stride, "cpu")
        got = run_port_block(blk, x, stride)
        vecs = {k.lower(): blk[k] for k in ("A1", "B1", "A2", "B2", "A3", "B3")}
        short = (dict(wd=blk["wd"], ad=blk["Ad"], bd=blk["Bd"]) if projection
                 else dict(short_mul=torch.tensor(float(blk["short_mul"]))))
        assert torch.equal(got, qbottleneck_plain(x, blk["w1"], blk["w2"], blk["w3"], **vecs, stride=stride,
                                                  **short))
    assert (qbottleneck.launches, qbottleneck_s2.launches) == before
    blk, x = _qblock_case(32, 16, 32, False, 1, 8, 8, 0, "cpu")
    with pytest.raises(ValueError, match="int8"):
        run_port_block(blk, x.float(), 1)
    with pytest.raises(ValueError):  # NCHW: w1 does not match the channel dim
        run_port_block(blk, x.permute(0, 3, 1, 2).contiguous(), 1)


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _frames(shape, seed):
    return torch.randint(0, 256, shape, generator=torch.Generator().manual_seed(seed), dtype=torch.uint8)


# frames: the serving canvas, canvases that are not powers of two, RGBX, a 2x6 frame
QSTEM_SHAPES = [(2, 512, 512, 3), (2, 96, 80, 3), (2, 96, 80, 4), (1, 2, 6, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QSTEM_SHAPES, ids=["512", "96x80", "96x80_rgbx", "2x6"])
def test_qstem_kernel_matches_plain_exactly(cuda, shape):
    """K1 on raw uint8 frames: 0 differing int8 elements against its plain
    version (the s2d oracle) on the card and on the CPU; one launch each."""
    st = port_stem_s2d(0)
    u8 = _frames(shape, shape[1])
    want = qstem_conv(u8, st)
    before = qstem_conv.launches
    got = qstem_conv(u8.to(cuda), _on(st, cuda))
    torch.cuda.synchronize()
    assert qstem_conv.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(qstem_conv(u8.to(cuda), _on(st, cuda), plain=True).cpu(), want)
    assert torch.equal(got.cpu(), want), f"{int((got.cpu() != want).sum())} int8 elements differ"
    assert (want > 0).float().mean() > 0.05


# (B, H, W): the serving canvas at B=8, the COCO canvas, a 64x96 frame and a
# 6x10 frame (3-channel rows of 30 bytes: not 16-byte aligned), odd batches
QSTEM_CASES = [(b, h, w, cin) for b, h, w in ((8, 512, 512), (1, 896, 1408), (3, 64, 96), (3, 6, 10), (1, 512, 512))
               for cin in (3, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", QSTEM_CASES, ids=[f"B{c[0]}-{c[1]}x{c[2]}x{c[3]}" for c in QSTEM_CASES])
def test_qstem_kernel_exact_under_its_tiles(cuda, case):
    """K1 (the implicit GEMM on the int8 tensor cores) against
    :func:`qstem_plain` on the card: 0 differing elements under the
    chooser's tile and under forced ones (a small tile, 1x1 pooled
    positions, the widest and the tallest that fit)."""
    from pytorch_object_detection_tpu_torch.ops.qblock import card_limits
    from pytorch_object_detection_tpu_torch.ops.qstem import pick_stem_tile

    b, h, w, cin = case
    st = _on(port_stem_s2d(0), cuda)
    u8 = _frames((b, h, w, cin), h + w + cin).to(cuda)
    want = qstem_plain(st, space_to_depth(to_rgbx(u8), 2))
    before = qstem_conv.launches
    got = qstem_conv(u8, st)
    torch.cuda.synchronize()
    assert qstem_conv.launches == before + 1
    assert torch.equal(got, want), f"{pick_stem_tile(b, h, w, *card_limits(cuda))}: {int((got != want).sum())} differ"
    for tile in ((2, 3), (1, 1), (8, 32), (32, 8)):
        forced = qstem_conv(u8, st, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(forced, want), f"{tile}: {int((forced != want).sum())} differ"


@pytest.mark.cuda
def test_qstem_kernel_takes_a_stem_entry_made_in_inference_mode(cuda):
    """K1 on a stem entry whose tensors were made under
    ``torch.inference_mode``, and again after its weights (``w`` and K1's
    ``wt``) are replaced: exact against its plain version each time; an
    entry without ``wt`` is refused."""
    u8 = _frames((2, 64, 96, 3), 5).to(cuda)
    with torch.inference_mode():
        st = _on(port_stem_s2d(0), cuda)
        for _ in range(2):
            got = qstem_conv(u8, st)
            assert torch.equal(got, qstem_conv(u8, st, plain=True))
            w = st["w"].flip(0).contiguous()
            st = dict(st, w=w, wt=w.t().contiguous())
        with pytest.raises(KeyError, match="wt"):
            qstem_conv(u8, {k: v for k, v in st.items() if k != "wt"})


def test_stem_entry_carries_k1_layout():
    """``quantize_stem_s2d`` stores K1's weights beside the s2d taps: ``wt``
    is ``w`` transposed to [64, 256], contiguous int8."""
    st = port_stem_s2d(0)
    assert st["wt"].dtype == torch.int8 and st["wt"].shape == (64, 256) and st["wt"].is_contiguous()
    assert torch.equal(st["wt"], st["w"].t())


# (M, K, N): the laterals tf1..tf3 at the 512 canvas, B=2 (tf1 on split K),
# and ragged M and N, one on split K
QMM_SHAPES = [(512, 2048, 256), (2048, 1024, 256), (8192, 512, 256), (37, 48, 24), (1000, 2064, 136)]


def _qmm_case(m, k, n, cuda):
    g = torch.Generator().manual_seed(m + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    a = torch.rand(n, generator=g) * 0.01 / k ** 0.5
    b = torch.randn(n, generator=g) * 5
    res = torch.randint(-127, 128, (m, n), generator=g, dtype=torch.int8)
    return (x, w, a, b, res), [t.to(cuda) for t in (x, w, a, b, res)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QMM_SHAPES, ids=["tf1", "tf2", "tf3", "ragged", "ragged_split"])
def test_qmm_kernel_matches_plain_exactly(cuda, shape):
    """K4 with and without the residual, with and without ReLU, on the
    chooser's tile and on forced ones (128x128, 128x64, K split in 3 where
    it has 3 steps of 64 bytes):
    0 differing elements against ``torch._int_mm`` + the oracle's epilogue."""
    m, k, n = shape
    (x, w, a, b, res), dev = _qmm_case(m, k, n, cuda)
    for relu in (True, False):
        for with_res in (False, True):
            kw = dict(relu=relu, res=dev[4] if with_res else None, res_scale=0.37)
            want = qmatmul(*dev[:4], plain=True, **kw)
            assert torch.equal(want.cpu(), qmatmul(x, w, a, b, **dict(kw, res=res if with_res else None)))
            for tile in (None, (128, 1), (64, 1), (64, min(3, -(-k // 64)))):
                before = qmatmul.launches
                got = qmatmul(*dev[:4], tile=tile, **kw)
                torch.cuda.synchronize()
                assert qmatmul.launches == before + 1
                assert got.dtype == torch.int8 and got.shape == (m, n)
                assert torch.equal(got, want), \
                    f"relu={relu} res={with_res} tile={tile}: {int((got != want).sum())} differ"
    got = qconv1x1(dev[0].reshape(1, m, 1, k), dev[1], dev[2], dev[3])
    assert torch.equal(got.reshape(m, n), qmatmul(*dev[:4], plain=True))


def _per_conv_gemms():
    """(name, M, K, N) of the per-conv backend's 36 bottleneck 1x1s at B=2."""
    out = []
    for scope, h, w, cin, cw, cout, stride in resnet50_block_shapes():
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        out += [(f"{scope}.conv1", 2 * h * w, cin, cw), (f"{scope}.conv3", 2 * ho * wo, cw, cout)]
        if scope.endswith("_0"):
            out.append((f"{scope}.shortcut", 2 * ho * wo, cin, cout))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("gemm", _per_conv_gemms(), ids=[g[0] for g in _per_conv_gemms()])
def test_qmm_kernel_at_per_conv_shapes(cuda, gemm):
    """K4 at the 36 1x1 convs of the per-conv backend, B=2 (the small maps
    on split K): 0 differing elements."""
    _, m, k, n = gemm
    _, dev = _qmm_case(m, k, n, cuda)
    got = qmatmul(*dev[:4], res=dev[4], res_scale=0.5)
    want = qmatmul(*dev[:4], res=dev[4], res_scale=0.5, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{int((got != want).sum())} of {want.numel()} differ"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 64, 256), (2, 8, 8, 256), (2, 7, 5, 48), (2, 9, 6, 24), (2, 1, 1, 16)],
                         ids=["64x64", "8x8", "odd", "c24", "1x1"])
def test_qpool_kernel_matches_plain_exactly(cuda, shape):
    """K6 at the pyramid's shapes and at odd sizes (VALID floors them) and a
    channel count that is not a multiple of 16: 0 differing elements."""
    x = torch.randint(-128, 128, shape, generator=torch.Generator().manual_seed(shape[1]), dtype=torch.int8)
    before = qmaxpool2x2.launches
    got = qmaxpool2x2(x.to(cuda))
    torch.cuda.synchronize()
    assert qmaxpool2x2.launches == before + (1 if got.numel() else 0)
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    assert torch.equal(got.cpu(), qmaxpool2x2(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 16, 256), (3, 7, 11, 48), (2, 9, 6, 24), (1, 5, 3, 16), (2, 1, 1, 16)],
                         ids=["16x16", "7x11", "c24", "5x3", "1x1"])
def test_qpool_seeds_kernel_matches_plain_exactly(cuda, shape):
    """K6's seeds kernel (seed6 = pool(x), seed7 = pool(seed6), one launch)
    at the HisFPN's t5 shape, odd sizes and maps VALID floors to nothing: 0
    differing elements; a channel count that is not a multiple of 16 is
    refused, and launches nothing."""
    x = torch.randint(-128, 128, shape, generator=torch.Generator().manual_seed(shape[2]), dtype=torch.int8)
    before = (qmaxpool2x2_seeds.launches, qmaxpool2x2.launches)
    if shape[3] % 16:
        with pytest.raises(ValueError, match="multiple of 16"):
            qmaxpool2x2_seeds(x.to(cuda))
        assert (qmaxpool2x2_seeds.launches, qmaxpool2x2.launches) == before
        return
    s6, s7 = qmaxpool2x2_seeds(x.to(cuda))
    torch.cuda.synchronize()
    assert (qmaxpool2x2_seeds.launches, qmaxpool2x2.launches) == (before[0] + (1 if s6.numel() else 0), before[1])
    w6, w7 = qmaxpool2x2_seeds_plain(x)
    assert s6.shape == w6.shape and s7.shape == w7.shape == (shape[0], shape[1] // 4, shape[2] // 4, shape[3])
    assert torch.equal(s6.cpu(), w6) and torch.equal(s7.cpu(), w7)


# (block, H, W) of the default pipeline's seven HisBlocks at 512x512 (their
# output sizes); K5 takes each with the pool-add glue of a finer level
HIS_SEVEN = [("his1", 16, 16), ("his2", 32, 32), ("his3", 64, 64), ("his4", 32, 32), ("his5", 16, 16),
             ("his6", 8, 8), ("his7", 4, 4)]
QHIS_POOL_CASES = [(name, h, w, b, odd) for name, h, w in HIS_SEVEN for b, odd in ((8, 0), (3, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", QHIS_POOL_CASES, ids=[f"{c[0]}_{c[1]}x{c[2]}_b{c[3]}" for c in QHIS_POOL_CASES])
def test_qhis_pool_add_equals_k6_then_add(cuda, case):
    """K5 with the level pool in its load (``combine="pool_add"``, a finer
    level of 2H x 2W, or 2H+1 x 2W+1 on the odd batch) equals, bit for
    bit, K6 then K5 with ``"add"``, under the chooser's tile and every
    forced one; one K5 launch, counted as a pool_add one."""
    from pytorch_object_detection_tpu_torch.ops.qblock import card_limits

    name, h, w, b, odd = case
    blk, _, kw = _qhis_case(256, name, "add", h, w, b, cuda)
    g = torch.Generator().manual_seed(h * b + odd)
    fine = torch.clamp(torch.round(torch.randn(b, 2 * h + odd, 2 * w + odd, 256, generator=g) * 40), -127, 127)
    fine = fine.to(torch.int8).to(cuda)
    want = qhisblock(blk, qmaxpool2x2(fine), **kw)
    before = (qhisblock.launches, qhisblock.pool_add_launches)
    got = qhisblock(blk, fine, **dict(kw, combine="pool_add"))
    torch.cuda.synchronize()
    assert (qhisblock.launches, qhisblock.pool_add_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want), int((got != want).sum())
    for tile in _his_forced_tiles(b, h, w, 256, card_limits(cuda)[1]):
        forced = qhisblock(blk, fine, tile=tile, **dict(kw, combine="pool_add"))
        torch.cuda.synchronize()
        assert torch.equal(forced, want), tile


# (features, block, combine, H, W): the full width at 64x64 (his3) down to
# 4x4 (his7, where the dilated shifts reach past the map) and a narrow
# block at an odd size and at 1x1
QHIS_CASES = [(256, "his3", "up_add", 64, 64), (256, "his1", None, 16, 16), (256, "his7", "add", 4, 4),
              (64, "his4", "add", 13, 11), (64, "his6", "add", 1, 1)]


def _qhis_case(features, name, combine, h, w, b, device):
    blk = _on(port_hisfpn_qtree(features, 1)[name], device)
    g = torch.Generator().manual_seed(h * w + b)
    draw = lambda *s: torch.clamp(torch.round(torch.randn(*s, generator=g) * 40), -127, 127).to(torch.int8)
    xb = draw(b, h, w, features).to(device) if combine else None
    xa = draw(b, h // 2, w // 2, features) if combine == "up_add" else draw(b, h, w, features)
    return blk, xa.to(device), dict(xb_q=xb, combine=combine, ca=0.6, cb=0.7)


def _qhis_check(got, want, b, h, w, features):
    """K5 against its plain version: at most one int8 step, under 5 % of
    elements differing (SiLU/sigmoid through the card's expf, the SE dots
    in another order)."""
    assert got.dtype == torch.int8 and got.shape == want.shape == (b, h, w, features)
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.05, (int(d.max()), float((d > 0).float().mean()))
    assert (want != 0).float().mean() > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("case", QHIS_CASES, ids=[f"{c[0]}_{c[1]}_{c[3]}x{c[4]}" for c in QHIS_CASES])
def test_qhis_kernel_within_one_step_of_plain(cuda, case):
    """K5 (three CUDA kernels, one counted launch) against its plain version
    on the card."""
    features, name, combine, h, w = case
    blk, xa, kw = _qhis_case(features, name, combine, h, w, 2, cuda)
    before = qhisblock.launches
    got = qhisblock(blk, xa, **kw)
    torch.cuda.synchronize()
    assert qhisblock.launches == before + 1
    _qhis_check(got, qhisblock(blk, xa, plain=True, **kw), 2, h, w, features)


# (features, block, combine, H, W, batch) that reach each branch of
# ops/qhis.pick_his_tile on an H100: channel slices on the 16x16, 4x4 and
# 1x1 levels, two images an out block at 4x4 and 1x1 (B=64), 64- and
# 128-row producer blocks, each combine, the narrow block at odd sizes
QHIS_TILE_CASES = [(256, "his7", "add", 4, 4, 64), (256, "his6", "add", 1, 1, 64), (256, "his5", "add", 16, 16, 8),
                   (256, "his2", "up_add", 32, 32, 8), (256, "his1", None, 16, 16, 8), (64, "his4", "add", 13, 11, 8),
                   (64, "his1", None, 9, 7, 4), (64, "his3", "up_add", 10, 6, 3)]


def _his_forced_tiles(b, h, w, cin, smem_max):
    """Tiles to force on every kernel: one image (64 rows) and all channels a
    block; the most images (128 rows) a block that fit; the most slices."""
    from pytorch_object_detection_tpu_torch.ops.qhis import HIS_KERNELS, his_ipbs, his_slices, his_smem_bytes

    single = {"produce": (64, 1), "mid": (1, 1), "out": (1, 1)}
    packed = {k: next(i for i in his_ipbs(k, b, h, w) if his_smem_bytes(k, i, h, w, cin, 1) <= smem_max)
              for k in HIS_KERNELS}
    packed = {k: (i, 1) for k, i in packed.items()}
    sliced = {k: (64 if k == "produce" else 1, his_slices(k, cin)[-1]) for k in HIS_KERNELS}
    return [single, packed, sliced]


@pytest.mark.cuda
@pytest.mark.parametrize("case", QHIS_TILE_CASES, ids=[f"{c[0]}_{c[1]}_{c[3]}x{c[4]}_b{c[5]}" for c in QHIS_TILE_CASES])
def test_qhis_kernel_at_the_choosers_branches(cuda, case):
    """K5 against its plain version where the tile chooser splits channels
    and packs images; its output equals, bit for bit, that of every forced
    tile: one image and all channels a block, the most images a block, the
    most slices."""
    from pytorch_object_detection_tpu_torch.ops.qblock import card_limits
    from pytorch_object_detection_tpu_torch.ops.qhis import pick_his_tile

    features, name, combine, h, w, b = case
    blk, xa, kw = _qhis_case(features, name, combine, h, w, b, cuda)
    got = qhisblock(blk, xa, **kw)
    _qhis_check(got, qhisblock(blk, xa, plain=True, **kw), b, h, w, features)
    sm_count, smem_max = card_limits(cuda)
    picked = pick_his_tile(b, h, w, features, sm_count, smem_max)
    for tile in _his_forced_tiles(b, h, w, features, smem_max):
        forced = qhisblock(blk, xa, tile=tile, **kw)
        torch.cuda.synchronize()
        assert torch.equal(forced, got), (picked, tile)


# (features, classes, H, W, batch): the full width at the 512x512 canvas's
# P3 and P7, a 1x1 level, the COCO canvas's 7x11 level with 80 classes (odd
# batch), and a narrow head
QHEAD_CASES = [(256, 20, 64, 64, 2), (256, 20, 4, 4, 3), (256, 20, 1, 1, 2), (256, 80, 7, 11, 3), (64, 20, 8, 8, 2)]
# K7/K9 against their plain version: the JAX kernels' contract, max error
# under 0.05 of the range (here each output's own, stricter for cnt|reg than
# JAX's max|cls|) and cosine over 0.999, the cosine tightened to what the
# card shows with margin (worst seen in chip_smoke.py 0.0114 of the range,
# cosine 0.9999993): the statistics are exact where the plain version's are
# f32 sums, and SiLU goes through expf, so an int8 step moves now and then
QHEAD_MAX_ERR, QHEAD_MIN_COS = 0.05, 0.99999


def _qhead_case(features, nc, h, w, b, device):
    qtree, _ = port_head_qtree(features, nc, [(h, w)], batch=1, seed=features + nc + h)
    g = torch.Generator().manual_seed(h * w + b)
    x = torch.clamp(torch.round(torch.randn(b, h, w, features, generator=g) * 40), -127, 127).to(torch.int8)
    return _on(qtree, device), qtree["levels"][0], x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", QHEAD_CASES, ids=[f"{c[0]}_{c[1]}cls_{c[2]}x{c[3]}_b{c[4]}" for c in QHEAD_CASES])
@pytest.mark.parametrize("k9", [False, True], ids=["k7", "k9"])
def test_qhead_kernels_match_plain(cuda, case, k9):
    """K7 and K9 (eight CUDA kernels each, one counted launch) against their
    plain version on the card; K9 on an odd batch runs K7 and counts there."""
    from pytorch_object_detection_tpu_torch.ops.qhead import qhishead_level, qhishead_level2

    features, nc, h, w, b = case
    q, _, x = _qhead_case(features, nc, h, w, b, cuda)
    lv = q["levels"][0]
    fn = qhishead_level2 if k9 else qhishead_level
    before = (qhishead_level.launches, qhishead_level2.launches)
    got = fn(q, lv, x)
    torch.cuda.synchronize()
    pair = k9 and b % 2 == 0
    assert (qhishead_level.launches, qhishead_level2.launches) == (before[0] + (not pair), before[1] + pair)
    want = qhishead_level(q, lv, x, plain=True)
    for what, g, r in zip(("cls", "cr"), got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape == (b, h, w, nc if what == "cls" else 5)
        err = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        gd, rd = g.double().flatten(), r.double().flatten()
        cos = float(gd @ rd / (gd.norm() * rd.norm()))
        assert bool(torch.isfinite(g).all()) and err <= QHEAD_MAX_ERR and cos >= QHEAD_MIN_COS, (what, err, cos)


# (features, classes, H, W, batch) that reach each branch of
# ops/qhead.pick_head_tile on an H100: channel slices on the 16x16 and 8x8
# levels at B=8, several images a block at 4x4 and 1x1 (B=64), image pairs
# on a 2x2 level, the narrow head and 80 classes on an odd-sized level
QHEAD_TILE_CASES = [(256, 20, 16, 16, 8), (256, 20, 8, 8, 8), (256, 20, 4, 4, 64), (256, 80, 1, 1, 64),
                    (64, 20, 2, 2, 16), (64, 80, 28, 44, 2), (256, 80, 14, 22, 4)]


def _qhead_check(got, want, b, h, w, nc):
    for what, g, r in zip(("cls", "cr"), got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape == (b, h, w, nc if what == "cls" else 5)
        err = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        gd, rd = g.double().flatten(), r.double().flatten()
        cos = float(gd @ rd / (gd.norm() * rd.norm()))
        assert bool(torch.isfinite(g).all()) and err <= QHEAD_MAX_ERR and cos >= QHEAD_MIN_COS, (what, err, cos)


@pytest.mark.cuda
@pytest.mark.parametrize("case", QHEAD_TILE_CASES, ids=[f"{c[0]}_{c[1]}cls_{c[2]}x{c[3]}_b{c[4]}" for c in QHEAD_TILE_CASES])
def test_qhead_kernels_at_the_choosers_branches(cuda, case):
    """K7 and K9 against their plain version where the tile chooser splits
    channels and packs images; the outputs equal those of one image and all
    channels a block on every pass, bit for bit."""
    from pytorch_object_detection_tpu_torch.ops.qhead import HEAD_PASSES, qhishead_level, qhishead_level2

    features, nc, h, w, b = case
    q, _, x = _qhead_case(features, nc, h, w, b, cuda)
    lv = q["levels"][0]
    got = qhishead_level(q, lv, x)
    _qhead_check(got, qhishead_level(q, lv, x, plain=True), b, h, w, nc)
    one = qhishead_level(q, lv, x, tile={p: (1, 1) for p in HEAD_PASSES})
    assert all(torch.equal(a, c) for a, c in zip(one, got))
    k9 = qhishead_level2(q, lv, x)
    assert all(torch.equal(a, c) for a, c in zip(k9, got))


K9_EVEN_CASES = [c for c in QHEAD_CASES + QHEAD_TILE_CASES if c[4] % 2 == 0] + [(256, 80, 112, 176, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K9_EVEN_CASES, ids=[f"{c[0]}_{c[1]}cls_{c[2]}x{c[3]}_b{c[4]}" for c in K9_EVEN_CASES])
def test_k9_equals_k7_bit_for_bit(cuda, case):
    """K9 recomputes pw1 on the halo where K7 stores z1, and takes image
    pairs: the same exact int32 sums, f32 steps and GroupNorm statistics, so
    the same bits on an even batch."""
    from pytorch_object_detection_tpu_torch.ops.qhead import qhishead_level, qhishead_level2

    features, nc, h, w, b = case
    q, _, x = _qhead_case(features, nc, h, w, b, cuda)
    lv = q["levels"][0]
    before = qhishead_level2.launches
    k9 = qhishead_level2(q, lv, x)
    assert qhishead_level2.launches == before + 1
    k7 = qhishead_level(q, lv, x)
    assert all(torch.equal(a, c) for a, c in zip(k9, k7))


@pytest.mark.cuda
def test_qhead_kernels_reject_other_layouts(cuda):
    from pytorch_object_detection_tpu_torch.ops.qhead import qhishead_level, qhishead_level2

    q, _, x = _qhead_case(64, 20, 7, 11, 2, cuda)
    lv = q["levels"][0]
    flat = torch.empty(x.numel() + 16, dtype=torch.int8, device=cuda)
    for fn in (qhishead_level, qhishead_level2):
        with pytest.raises(ValueError):  # NHWC-shaped but not contiguous
            fn(q, lv, x.transpose(1, 2))
        with pytest.raises(ValueError):  # not 16-byte aligned
            fn(q, lv, flat[1:1 + x.numel()].view(x.shape))
        with pytest.raises(ValueError):  # not int8
            fn(q, lv, x.float())
        with pytest.raises(ValueError):  # a weight on another device
            fn(dict(q, wc=q["wc"].cpu()), lv, x)
        with pytest.raises(ValueError):  # a level vector of another width
            fn(q, dict(lv, Ac=lv["Ac"][:8]), x)


def test_qhead_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    from pytorch_object_detection_tpu_torch.ops.qhead import qhishead_level, qhishead_level2, qhishead_level_plain

    before = (qhishead_level.launches, qhishead_level2.launches)
    for b in (2, 1):
        q, lv, x = _qhead_case(32, 20, 5, 3, b, "cpu")
        want = qhishead_level_plain(q, lv, x)
        for fn in (qhishead_level, qhishead_level2):
            got = fn(q, lv, x, num_classes=20)
            assert all(torch.equal(a, c) for a, c in zip(got, want))
            assert got[0].shape == (b, 5, 3, 20) and got[1].shape == (b, 5, 3, 5)
    assert (qhishead_level.launches, qhishead_level2.launches) == before
    with pytest.raises(ValueError, match="int8"):
        qhishead_level(q, lv, x.float())
    with pytest.raises(ValueError, match="channels"):
        qhishead_level2(q, lv, x[..., :16])


def test_k6_seeds_and_k5_pool_add_take_plain_version_on_cpu():
    """On the CPU the seeds and K5's pool-add glue run their plain
    versions (two 2x2 pools; the pool, then the add), count no launch and
    refuse a map whose pool is not xb's size."""
    from pytorch_object_detection_tpu_torch.ops.qhis import combine_plain, qhisblock_plain
    from pytorch_object_detection_tpu_torch.ops.qpool import qmaxpool2x2_plain

    before = (qmaxpool2x2_seeds.launches, qhisblock.launches, qhisblock.pool_add_launches)
    x = torch.randint(-127, 128, (2, 9, 7, 32), dtype=torch.int8)
    s6, s7 = qmaxpool2x2_seeds(x)
    assert torch.equal(s6, qmaxpool2x2_plain(x)) and torch.equal(s7, qmaxpool2x2_plain(qmaxpool2x2_plain(x)))
    blk = port_hisfpn_qtree(32, 2)["his5"]
    xb = torch.randint(-127, 128, (2, 4, 3, 32), dtype=torch.int8)
    got = qhisblock(blk, x, xb_q=xb, combine="pool_add", ca=0.5, cb=0.25)
    assert torch.equal(got, qhisblock_plain(blk, combine_plain(qmaxpool2x2_plain(x), xb, "add", 0.5, 0.25)))
    assert (qmaxpool2x2_seeds.launches, qhisblock.launches, qhisblock.pool_add_launches) == before
    with pytest.raises(ValueError, match="pool_add"):
        qhisblock(blk, x[:, :7], xb_q=xb, combine="pool_add")
    with pytest.raises(ValueError, match="int8"):
        qmaxpool2x2_seeds(x.float())


def test_int8_fpn_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    from pytorch_object_detection_tpu_torch.ops.qhis import combine_plain, qhisblock_plain
    from pytorch_object_detection_tpu_torch.ops.qpool import qmaxpool2x2_plain
    from pytorch_object_detection_tpu_torch.ops.qstem import qstem_plain, to_rgbx
    from pytorch_object_detection_tpu_torch.nn.resnet import space_to_depth

    counters = (qstem_conv, qmatmul, qhisblock, qmaxpool2x2)
    before = [c.launches for c in counters]
    st = port_stem_s2d(0)
    u8 = _frames((1, 16, 12, 3), 0)
    assert torch.equal(qstem_conv(u8, st), qstem_plain(st, space_to_depth(to_rgbx(u8), 2)))
    x = torch.randint(-127, 128, (2, 6, 4, 32), dtype=torch.int8)
    assert torch.equal(qmaxpool2x2(x), qmaxpool2x2_plain(x))
    blk = port_hisfpn_qtree(32, 2)["his5"]
    assert torch.equal(qhisblock(blk, x, xb_q=x, combine="add", ca=0.5, cb=0.5),
                       qhisblock_plain(blk, combine_plain(x, x, "add", 0.5, 0.5)))
    lat = port_hisfpn_qtree(32, 2)["tf3"]
    assert qmatmul(x.reshape(-1, 32).repeat(1, 16), lat["w"], lat["A"], lat["B"]).shape == (48, 32)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="uint8"):
        qstem_conv(u8.float(), st)
    with pytest.raises(ValueError, match="even"):
        qstem_conv(u8[:, :15], st)
    with pytest.raises(ValueError, match="up_add"):
        qhisblock(blk, x, xb_q=x, combine="up_add")
    with pytest.raises(ValueError, match="xb_q"):
        qhisblock(blk, x, combine="add")
    with pytest.raises(ValueError, match="w must be"):
        qmatmul(x.reshape(-1, 32), lat["w"], lat["A"], lat["B"])


# (B, H, W, Cin, Cout): conv2 of the four ResNet-50 stages at the 512x512
# canvas, B=2; odd sizes; an output width that is not a multiple of 64
QCONV3_SHAPES = [(2, 128, 128, 64, 64), (2, 64, 64, 128, 128), (2, 32, 32, 256, 256), (2, 16, 16, 512, 512),
                 (2, 13, 11, 32, 48), (1, 5, 7, 16, 80)]


def _qconv3_case(b, h, w, cin, cout, device):
    g = torch.Generator().manual_seed(h * w + cout)
    x = torch.randint(-127, 128, (b, h, w, cin), generator=g, dtype=torch.int8)
    wt = torch.randint(-16, 16, (cout, 3, 3, cin), generator=g, dtype=torch.int8)
    a = torch.rand(cout, generator=g) * 0.12 / (9 * cin) ** 0.5 + 1e-4  # acc * a: about 40 int8 steps
    bias = torch.randn(cout, generator=g) * 5
    return [t.to(device) for t in (x, wt, a, bias)]


def _qconv3_tiles(h, w, cin, cout, device):
    """Every (tw, split) K11 takes on this shape (fits, whole 16-channel
    slices), and None: the chooser's."""
    from pytorch_object_detection_tpu_torch.ops.qblock import card_limits
    from pytorch_object_detection_tpu_torch.ops.qconv import CONV3_SPLITS, CONV3_TILE_WIDTHS, conv3_smem_bytes

    smem_max = card_limits(torch.device(device))[1]
    return [None] + [(tw, sp) for tw in CONV3_TILE_WIDTHS for sp in CONV3_SPLITS
                     if cout % (16 * sp) == 0 and conv3_smem_bytes(tw, cin) <= smem_max]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QCONV3_SHAPES, ids=["s1_128", "s2_64", "s3_32", "s4_16", "odd", "cout80"])
def test_qconv3x3_kernel_matches_plain_exactly(cuda, shape):
    """K11: 0 differing int8 elements against ``conv_i8`` + the epilogue on
    the card and on the CPU, under every tile it takes; one launch each."""
    x, wt, a, b = _qconv3_case(*shape, cuda)
    want = qconv3x3(x, wt, a, b, plain=True)
    assert torch.equal(want.cpu(), qconv3x3(*(t.cpu() for t in (x, wt, a, b))))
    for tile in _qconv3_tiles(*shape[1:], cuda):
        before = qconv3x3.launches
        got = qconv3x3(x, wt, a, b, tile=tile)
        torch.cuda.synchronize()
        assert qconv3x3.launches == before + 1
        assert got.dtype == torch.int8 and got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got, want), f"tile={tile}: {int((got != want).sum())} of {want.numel()} differ"
    assert 0.05 < (want > 0).float().mean() and (want == 127).float().mean() < 0.05  # not degenerate


K10_SHAPES = [(2, 256, 256, 64), (8, 256, 256, 64), (64, 256, 256, 64), (2, 448, 704, 64), (2, 15, 21, 64),
              (3, 129, 97, 32), (2, 9, 6, 24), (2, 1, 1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K10_SHAPES, ids=["stem", "stem_b8", "stem_b64", "coco", "odd", "odd_c32", "c24",
                                                   "1x1"])
def test_qmaxpool3x3s2_kernel_matches_plain_exactly(cuda, shape):
    """K10 at the direct stem's map (B=2, 8 and 64), the COCO canvas's, odd
    sizes, a channel count that is not a multiple of 16 (the one-byte form)
    and a 1x1 map: 0 differing elements against the plain version on the
    same card."""
    x = torch.randint(-128, 128, shape, generator=torch.Generator(device=cuda).manual_seed(shape[1]), device=cuda,
                      dtype=torch.int8)
    before = qmaxpool3x3s2.launches
    got = qmaxpool3x3s2(x)
    torch.cuda.synchronize()
    assert qmaxpool3x3s2.launches == before + 1
    assert got.shape == (shape[0], (shape[1] - 1) // 2 + 1, (shape[2] - 1) // 2 + 1, shape[3])
    assert torch.equal(got, qmaxpool3x3s2(x, plain=True))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 256, 256, 64), (3, 129, 97, 32), (2, 7, 300, 16)], ids=["stem_b8", "odd",
                                                                                              "wide"])
def test_qmaxpool3x3s2_same_under_every_band(cuda, shape):
    """K10 under every band of ``POOL3_ROWS`` x ``POOL3_COLS`` that fits the
    card: the same bits as under the chooser's; a forced band is refused
    where C is not a multiple of 16."""
    from pytorch_object_detection_tpu_torch.ops.qblock import card_limits
    from pytorch_object_detection_tpu_torch.ops.qpool import POOL3_COLS, POOL3_ROWS, pool3_smem_bytes

    x = torch.randint(-128, 128, shape, generator=torch.Generator(device=cuda).manual_seed(7), device=cuda,
                      dtype=torch.int8)
    want = qmaxpool3x3s2(x)
    smem_max = card_limits(cuda)[1]
    bands = [(r, c) for r in POOL3_ROWS for c in POOL3_COLS if pool3_smem_bytes(shape[3], r, c) <= smem_max]
    differ = [t for t in bands if not torch.equal(qmaxpool3x3s2(x, tile=t), want)]
    torch.cuda.synchronize()
    assert len(bands) > 20 and not differ, differ
    with pytest.raises(ValueError, match="tile"):
        qmaxpool3x3s2(x[..., :8].contiguous(), tile=(2, 64))
    with pytest.raises(ValueError, match="tile"):
        qmaxpool3x3s2(x, tile=(3, 64))


def _stem_tail_case(shape, device, seed=0):
    g = torch.Generator().manual_seed(seed + shape[1])
    x = (torch.randn(shape, generator=g) * 3).to(torch.bfloat16)
    c = shape[-1]
    mult, shift = torch.rand(c, generator=g) + 0.3, torch.randn(c, generator=g) * 0.5
    scale = torch.tensor(float(x.float().abs().max()) / 127.0 * 0.8)  # a few values clip
    return [t.to(device) for t in (x, mult, shift, scale)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 256, 64), (2, 15, 21, 64), (1, 2, 2, 8)], ids=["stem", "odd", "2x2"])
def test_stem_tail_kernel_matches_plain_exactly(cuda, shape):
    """K17 against its plain version on the card (the same bf16 ops in the
    same order, each rounded to bf16): 0 differing int8 elements."""
    x, mult, shift, scale = _stem_tail_case(shape, cuda)
    before = stem_bn_pool_quant.launches
    got = stem_bn_pool_quant(x, mult, shift, scale)
    torch.cuda.synchronize()
    assert stem_bn_pool_quant.launches == before + 1
    want = stem_bn_pool_quant(x, mult, shift, scale, plain=True)
    assert got.dtype == torch.int8 and got.shape == want.shape == (shape[0], (shape[1] - 1) // 2 + 1,
                                                                   (shape[2] - 1) // 2 + 1, shape[3])
    assert torch.equal(got, want), f"{int((got != want).sum())} of {want.numel()} differ"
    assert (want > 0).float().mean() > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 256, 256, 64), (64, 256, 256, 64), (3, 129, 97, 64)],
                         ids=["B8", "B64", "odd"])
def test_stem_tail_kernel_exact_under_forced_bands(cuda, shape):
    """K17 at B=8, B=64 and an odd frame size under its chooser's band and
    forced ones, with f32 and with bf16 mult and shift: 0 differing int8
    elements from the plain version."""
    from pytorch_object_detection_tpu_torch.ops.stem import pick_stem_tail_tile

    x, mult, shift, scale = _stem_tail_case(shape, cuda)
    want = stem_bn_pool_quant(x, mult, shift, scale, plain=True)
    print(f"chooser's band {pick_stem_tail_tile(*shape[:3], *card_limits(cuda))}")
    for tile in (None, (1, 8), (4, 32), (16, 8), (2, 64), (32, 8)):
        for m, s in ((mult, shift), (mult.bfloat16(), shift.bfloat16())):
            got = stem_bn_pool_quant(x, m, s, scale, tile=tile)
            assert torch.equal(got, want), f"band {tile}: {int((got != want).sum())} of {want.numel()} differ"


@pytest.mark.cuda
def test_stem_tail_call_launches_conv_and_k17_only(cuda):
    """After a qtree's first stem-tail call has kept the folded BN and the
    bf16 kernel (nn/resnet_int8.stem_tail_params), a call launches the
    conv's (cuDNN's) kernels and one K17: none of PyTorch's elementwise
    kernels (the BN fold, a cast or a copy)."""
    from pytorch_object_detection_tpu_torch.nn.resnet_int8 import stem_tail_int8

    g = torch.Generator().manual_seed(3)
    bn = {"scale": torch.rand(64, generator=g) + 0.5, "bias": torch.randn(64, generator=g) * 0.2,
          "mean": torch.randn(64, generator=g) * 0.1, "var": torch.rand(64, generator=g) + 0.5}
    qtree = {"stem": {"kernel": (torch.randn(64, 3, 7, 7, generator=g) * 0.1).to(cuda),
                      "bn": {k: v.to(cuda) for k, v in bn.items()}},
             "stem_scale": torch.tensor(0.05, device=cuda)}
    images = torch.randn(2, 64, 64, 3, generator=g).to(cuda, torch.bfloat16)
    with torch.no_grad():
        first = stem_tail_int8(qtree, images)
        names = _cuda_kernel_names(lambda: stem_tail_int8(qtree, images))
        assert torch.equal(stem_tail_int8(qtree, images), first)
    assert sum("stem_tail_kernel" in n for n in names) == 1, names
    assert not [n for n in names if "at::native" in n], names  # PyTorch's fold, cast and copy kernels


def _chain(specs, seed, device):
    """[(blk, stride)] of random bottlenecks for (Cin, Cw, Cout, stride) specs."""
    rng = np.random.default_rng(seed)
    return [(port_block(rand_qblock(rng, cin, cw, cout, cin != cout or s == 2), device), s)
            for cin, cw, cout, s in specs]


# the three backbone segments of ResNet-50 at the 512x512 canvas (input H, W), and a short odd-sized chain
SEGMENT_SPECS = {
    "c3": ((128, 128), [(64, 64, 256, 1), (256, 64, 256, 1), (256, 64, 256, 1), (256, 128, 512, 2),
                        (512, 128, 512, 1), (512, 128, 512, 1), (512, 128, 512, 1)]),
    "c4": ((64, 64), [(512, 256, 1024, 2)] + [(1024, 256, 1024, 1)] * 5),
    "c5": ((32, 32), [(1024, 512, 2048, 2)] + [(2048, 512, 2048, 1)] * 2),
    "odd": ((13, 11), [(32, 16, 64, 1), (64, 16, 64, 1), (64, 32, 96, 2), (96, 32, 96, 1)]),
}


def _chain_tiles(blocks, h, w, cin, device):
    """None (the chooser's), each (tw, split) that every block of the chain
    takes, and per block the largest split it takes (mixed cluster sizes)."""
    from pytorch_object_detection_tpu_torch.ops.qblock import SPLITS, TILE_WIDTHS, card_limits
    from pytorch_object_detection_tpu_torch.ops.qchain import chain_shapes, chain_smem_bytes

    convs = [(hi, wi, blk["w1"].shape[0], cout, s)
             for (blk, s), ((hi, wi, _), (_, _, cout)) in zip(blocks, chain_shapes((h, w, cin), blocks))]
    smem_max = card_limits(torch.device(device))[1]
    takes = lambda t, c: c[2] % (16 * t[1]) == 0 and c[3] % (16 * t[1]) == 0
    uniform = [(tw, sp) for tw in TILE_WIDTHS for sp in SPLITS if (tw == 8 or sp == 1)
               and all(takes((tw, sp), c) for c in convs) and chain_smem_bytes(convs, [(tw, sp)] * len(convs)) <= smem_max]
    widest = [(8, max(sp for sp in SPLITS if takes((8, sp), c))) for c in convs]
    return [None] + uniform + [widest]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("seg", list(SEGMENT_SPECS))
def test_qchain_kernel_matches_kernel_c_exactly(cuda, seg, batch):
    """K13 (one cooperative launch per chain) against kernel C block after
    block and against the plain chain: 0 differing int8 elements under the
    chooser's tiles and forced ones (every tile each block takes, and each
    block's largest cluster)."""
    (h, w), specs = SEGMENT_SPECS[seg]
    blocks = _chain(specs, len(seg) + h, cuda)
    x = torch.randint(-127, 128, (batch, h, w, specs[0][0]), generator=torch.Generator().manual_seed(h),
                      dtype=torch.int8).to(cuda)
    want = x
    for blk, stride in blocks:
        want = run_port_block(blk, want, stride)
    for tile in _chain_tiles(blocks, h, w, specs[0][0], cuda):
        before = (qchain.launches, qbottleneck.launches, qbottleneck_s2.launches)
        got = qchain(x, blocks, tile=tile)
        torch.cuda.synchronize()
        assert (qchain.launches, qbottleneck.launches, qbottleneck_s2.launches) == (before[0] + 1, *before[1:])
        assert got.dtype == torch.int8 and got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got, want), (f"{seg} B={batch} tile={tile}: {int((got != want).sum())} of "
                                        f"{want.numel()} differ from kernel C")
    assert torch.equal(qchain(x, blocks, plain=True), want)
    assert 0 < (want > 0).float().mean()


@pytest.mark.cuda
def test_new_kernels_reject_other_layouts(cuda):
    x, wt, a, b = _qconv3_case(2, 8, 8, 32, 32, cuda)
    with pytest.raises(ValueError):  # NHWC-shaped but not contiguous
        qconv3x3(x.transpose(1, 2), wt, a, b)
    with pytest.raises(ValueError):  # channels not a multiple of 16
        qconv3x3(x[..., :24].contiguous(), wt[..., :24].contiguous(), a, b)
    with pytest.raises(ValueError):  # a weight on another device
        qconv3x3(x, wt.cpu(), a, b)
    with pytest.raises(ValueError):
        qmaxpool3x3s2(x.transpose(1, 2))
    xs, mult, shift, scale = _stem_tail_case((1, 8, 8, 16), cuda)
    with pytest.raises(ValueError):  # K17 takes bf16 on the card
        stem_bn_pool_quant(xs.float(), mult, shift, scale)
    with pytest.raises(ValueError):
        stem_bn_pool_quant(xs.transpose(1, 2), mult, shift, scale)
    blocks = _chain([(32, 16, 32, 1)], 0, cuda)
    with pytest.raises(ValueError):  # x NHWC-shaped but not contiguous
        qchain(x.transpose(1, 2), blocks)
    with pytest.raises(ValueError):  # a weight on another device
        qchain(x, [(dict(blocks[0][0], w2=blocks[0][0]["w2"].cpu()), 1)])


def test_new_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    counters = (qconv3x3, qmaxpool3x3s2, stem_bn_pool_quant, qchain)
    before = [c.launches for c in counters]
    x, wt, a, b = _qconv3_case(2, 6, 5, 16, 32, "cpu")
    assert torch.equal(qconv3x3(x, wt, a, b), qconv3x3_plain(x, wt, a, b))
    assert torch.equal(qmaxpool3x3s2(x), qmaxpool3x3s2_plain(x))
    xs, mult, shift, scale = _stem_tail_case((1, 7, 6, 16), "cpu")
    got = stem_bn_pool_quant(xs, mult, shift, scale)
    assert got.shape == (1, 4, 3, 16)
    assert torch.equal(got, stem_bn_pool_quant_plain(xs, mult.bfloat16(), shift.bfloat16(), 1.0 / scale))
    blocks = _chain([(16, 16, 32, 1), (32, 16, 32, 2)], 1, "cpu")
    assert torch.equal(qchain(x, blocks), qchain_plain(x, blocks))
    assert qchain(x, blocks).shape == (2, 3, 3, 32)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="w must be"):
        qconv3x3(x, wt[:, :, :, :8], a, b)
    with pytest.raises(ValueError, match="int8"):
        qmaxpool3x3s2(x.float())
    with pytest.raises(ValueError, match="mult"):
        stem_bn_pool_quant(xs, mult[:8], shift, scale)
    with pytest.raises(ValueError, match="w1"):  # the second block's input has 32 channels, not 16
        qchain(x, blocks[1:])
    with pytest.raises(ValueError, match="1 to"):
        qchain(x, [])


# K16 (M, K, N): conv1 and conv3 of each ResNet-50 stage at the 512 canvas,
# B=2, and odd M, N and K (K not a multiple of 8: the word-by-word loads)
K16_SHAPES = [(32768, 64, 64), (32768, 256, 64), (32768, 64, 256), (8192, 512, 128), (8192, 128, 512),
              (2048, 1024, 256), (2048, 256, 1024), (512, 2048, 512), (512, 512, 2048), (1000, 77, 130),
              (37, 24, 5), (129, 8, 65)]
# K16 against its plain version: both round an f32 sum of the same exact
# products once to bf16, summed in another order, so an output may be one
# bf16 step apart (at most 2**-7 of it) where the sums straddle a rounding
# boundary; the atol covers the sums' order near 0
K16_RTOL = 2.0**-7


def _k16_case(m, k, n, device, seed=0):
    g = torch.Generator().manual_seed(seed + m + k + n)
    x = torch.randn(m, k, generator=g).bfloat16()
    w = (torch.randn(n, k, generator=g) / k ** 0.5).bfloat16()
    scale, shift = torch.rand(n, generator=g) + 0.5, torch.randn(n, generator=g) * 0.1
    res = torch.randn(m, n, generator=g).bfloat16()
    return [t.to(device) for t in (x, w, scale, shift, res)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K16_SHAPES, ids=[f"{m}x{k}x{n}" for m, k, n in K16_SHAPES])
def test_k16_kernel_matches_plain(cuda, shape):
    """K16 with and without the residual and the ReLU against its plain
    version on the card: within one bf16 step; one launch a call."""
    x, w, scale, shift, res = _k16_case(*shape, cuda)
    for act in (True, False):
        for r in (None, res):
            before = matmul_bn_act.launches
            got = matmul_bn_act(x, w, scale, shift, r, act)
            torch.cuda.synchronize()
            assert matmul_bn_act.launches == before + 1
            want = matmul_bn_act_plain(x, w, scale, shift, r, act)
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            tol = 2.0**-12 * float(want.float().abs().max())
            close = torch.isclose(got.float(), want.float(), rtol=K16_RTOL, atol=tol)
            assert bool(close.all()), f"act={act} res={r is not None}: {int((~close).sum())} of {want.numel()} apart"
    got = conv1x1_bn_act(x.reshape(1, shape[0], 1, shape[1]), w.reshape(shape[2], shape[1], 1, 1), scale, shift)
    assert torch.equal(got.reshape(shape[0], shape[2]), matmul_bn_act(x, w, scale, shift))


# K16 (M, K, N) on each side of the tile and ring edges: M not a multiple
# of 128, K of one step (32), a step and a quarter (40) and two steps and a
# quarter (72), N of 8, 64 (128 x 64 tiles) and 65, 200 (a ragged 128 x 128)
K16_EDGE_SHAPES = [(129, 32, 64), (1000, 40, 200), (4097, 72, 65), (300, 64, 8), (255, 96, 128), (131, 2048, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K16_EDGE_SHAPES, ids=[f"{m}x{k}x{n}" for m, k, n in K16_EDGE_SHAPES])
@pytest.mark.parametrize("layout", ["aligned", "x_unaligned", "res_unaligned"])
def test_k16_kernel_at_tile_and_ring_edges(cuda, shape, layout):
    """K16 within one bf16 step of its plain version at the edges of its
    tiles and ring, with and without the residual; an x that is not 16-byte
    aligned takes the word-by-word tile, a residual that is not takes the
    element-wise epilogue."""
    m, k, n = shape
    x, w, scale, shift, res = _k16_case(m, k, n, cuda, seed=3)
    if layout == "x_unaligned":
        x = torch.empty(m * k + 1, dtype=x.dtype, device=cuda)[1:].view(m, k).copy_(x)
    if layout == "res_unaligned":
        res = torch.empty(m * n + 1, dtype=res.dtype, device=cuda)[1:].view(m, n).copy_(res)
    for r in (None, res):
        got = matmul_bn_act(x, w, scale, shift, r, True)
        want = matmul_bn_act_plain(x, w, scale, shift, r, True)
        close = torch.isclose(got.float(), want.float(), rtol=K16_RTOL, atol=2.0**-12 * float(want.float().abs().max()))
        assert bool(close.all()), f"res={r is not None}: {int((~close).sum())} of {want.numel()} apart"


@pytest.mark.cuda
def test_k16_rejects_other_dtypes_and_layouts(cuda):
    x, w, scale, shift, res = _k16_case(64, 32, 48, cuda)
    with pytest.raises(ValueError, match="float32"):  # f32 runs the plain version on the CPU only
        matmul_bn_act(x.float(), w.float(), scale, shift)
    with pytest.raises(ValueError):  # not contiguous
        matmul_bn_act(x.t().contiguous().t(), w, scale, shift)
    with pytest.raises(ValueError):  # a vector on another device
        matmul_bn_act(x, w, scale.cpu(), shift)
    with pytest.raises(ValueError):  # the residual of another shape
        matmul_bn_act(x, w, scale, shift, res[:, :8])


# K15 (features, classes, H, W, B): the 512 canvas's P3 and P7, a 1x1 level,
# an odd level with 80 classes on a narrow f=64 head, and an odd batch
K15_CASES = [(256, 20, 64, 64, 2), (256, 20, 4, 4, 2), (256, 80, 1, 1, 2), (64, 80, 7, 11, 2), (64, 20, 16, 16, 3)]
# K15 against its plain version: the bf16 steps are the same, the GroupNorm
# partial sums add in another order and expf is not torch's sigmoid, so a
# bf16 value moves by a step now and then and the move passes through the
# later stages: max |diff| within 2**-5 of each output's range, cosine
K15_MAX_ERR, K15_MIN_COS = 2.0**-5, 0.9999


def _k15_case(features, nc, h, w, b, device):
    head = HISHead(nc, features, generator=torch.Generator().manual_seed(features + nc)).eval()
    g = torch.Generator().manual_seed(h * w + b)
    x = (torch.randn(b, h, w, features, generator=g) * 2.0).bfloat16()
    return hishead_params_pack(head.to(device), nc), x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K15_CASES, ids=[f"f{c[0]}_{c[1]}cls_{c[2]}x{c[3]}_b{c[4]}" for c in K15_CASES])
def test_k15_kernel_matches_plain(cuda, case):
    """K15 (five CUDA kernels, one counted launch) against its plain version
    on the card, per output (cls, cnt, raw reg)."""
    features, nc, h, w, b = case
    packed, x = _k15_case(features, nc, h, w, b, cuda)
    before = hishead_level_fused.launches
    got = hishead_level_fused(x, packed, nc)
    torch.cuda.synchronize()
    assert hishead_level_fused.launches == before + 1
    want = hishead_level_fused_plain(x, packed, nc)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (b, h, w, nc + 5)
    _k15_within_contract(got, want, nc)


def _k15_within_contract(got, want, nc):
    for name, sl in (("cls", slice(0, nc)), ("cnt", slice(nc, nc + 1)), ("reg", slice(nc + 1, nc + 5))):
        g, r = got[..., sl].double(), want[..., sl].double()
        err = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        cos = float((g.flatten() @ r.flatten()) / (g.norm() * r.norm()))
        assert bool(torch.isfinite(g).all()) and err <= K15_MAX_ERR and cos >= K15_MIN_COS, (name, err, cos)


# K15 at the fused-head pipeline's five levels (256 features, 20 classes), B=8 and B=64
K15_PATH = [(b, s) for b in (8, 64) for s in (64, 32, 16, 8, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K15_PATH, ids=[f"B{b}_{s}x{s}" for b, s in K15_PATH])
def test_k15_kernel_at_the_path_shapes_under_every_tile(cuda, case):
    """K15 within its contract at the path's shapes, and the same output
    under every block its chooser weighs for each pass (the others the
    chooser's): the tiles stay 8x8 or 8x16, no GEMM's K is cut, and each
    GroupNorm is folded from per-tile sums in tile order."""
    b, s = case
    packed, x = _k15_case(256, 20, s, s, b, cuda)
    base = hishead_level_fused(x, packed, 20)
    _k15_within_contract(base, hishead_level_fused_plain(x, packed, 20), 20)
    smem_max = card_limits(cuda)[1]
    for pass_ in FHEAD_PASSES:
        for opt in fhead_options(pass_, b, s, s, 256, 20, smem_max):
            assert torch.equal(hishead_level_fused(x, packed, 20, tile={pass_: opt}), base), (pass_, opt)


@pytest.mark.cuda
def test_k15_rejects_other_dtypes_and_layouts(cuda):
    packed, x = _k15_case(64, 20, 7, 11, 2, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        hishead_level_fused(x.float(), packed, 20)
    with pytest.raises(ValueError):  # NHWC-shaped but not contiguous
        hishead_level_fused(x.transpose(1, 2), packed, 20)
    with pytest.raises(ValueError):  # a packed operand on another device
        hishead_level_fused(x, dict(packed, k_tow=packed["k_tow"].cpu()), 20)
    with pytest.raises(ValueError):  # more features than the kernel takes
        wide, xw = _k15_case(512, 20, 2, 2, 1, cuda)
        hishead_level_fused(xw, wide, 20)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 64, 256), (1000, 48, 200)], ids=["script_k_n", "ragged"])
def test_k4_prime_kernels_match_plain_exactly(cuda, shape):
    """K4''s three epilogues on K4's tile: 0 differing elements against their
    plain versions, the shift variant's wrap included; one launch each."""
    m, k, n = shape
    g = torch.Generator().manual_seed(m)
    x = torch.randint(-127, 127, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    a, b = torch.rand(n, generator=g) * 1e-3, torch.randn(n, generator=g)
    res = torch.randint(-127, 127, (m, n), generator=g, dtype=torch.int8)
    dev = [t.to(cuda) for t in (x, w, a, b, res)]
    for variant in VARIANTS:
        r = dev[4] if variant == "full" else None
        before = qmm_variant.launches
        got = qmm_variant(variant, *dev[:4], r)
        torch.cuda.synchronize()
        assert qmm_variant.launches == before + 1
        want = qmm_variant_plain(variant, *dev[:4], r)
        assert got.dtype == torch.int8 and torch.equal(got, want), f"{variant}: {int((got != want).sum())} differ"
    assert int((torch._int_mm(dev[0][:64], dev[1].t().contiguous()) >> 8).abs().max()) > 127  # the wrap occurs


def test_fused_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    """K16, K15 and K4' on CPU tensors: the plain version, no launch
    counted, and operands of the wrong shape refused."""
    counters = (matmul_bn_act, hishead_level_fused, qmm_variant)
    before = [c.launches for c in counters]
    x, w, scale, shift, res = _k16_case(37, 24, 5, "cpu")
    assert torch.equal(matmul_bn_act(x, w, scale, shift, res), matmul_bn_act_plain(x, w, scale, shift, res))
    assert matmul_bn_act(x.float(), w.float(), scale, shift).dtype == torch.float32
    packed, xh = _k15_case(64, 20, 3, 5, 1, "cpu")
    assert torch.equal(hishead_level_fused(xh, packed, 20), hishead_level_fused_plain(xh, packed, 20))
    xq = torch.randint(-127, 127, (40, 32), dtype=torch.int8)
    wq = torch.randint(-127, 127, (24, 32), dtype=torch.int8)
    a, b = torch.rand(24) * 1e-3, torch.randn(24)
    assert torch.equal(qmm_variant("nores", xq, wq, a, b), qmm_variant_plain("nores", xq, wq, a, b))
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="w must be"):
        matmul_bn_act(x, w[:, :8], scale, shift)
    with pytest.raises(ValueError, match="scale"):
        matmul_bn_act(x, w, scale[:2], shift)
    with pytest.raises(ValueError, match="NHWC"):
        hishead_level_fused(xh[..., :32], packed, 20)
    with pytest.raises(ValueError, match="classes"):
        hishead_level_fused(xh, packed, 80)
    with pytest.raises(ValueError, match="res"):
        qmm_variant("full", xq, wq, a, b)
    with pytest.raises(ValueError, match="variant"):
        qmm_variant("half", xq, wq, a, b)


# K12: the 15 MNBlock calls of an MNFCOS(20, 256) forward at 512x512 (the
# pyramid's five blocks, then the head's block1 and block2 at each level),
# B=2: (name, H=W, kernel, dilation)
QMN_PATH = [("mnb5", 16, 5, 2), ("mnb4", 32, 3, 2), ("mnb3", 64, 3, 1), ("mnb6", 8, 5, 1), ("mnb7", 4, 7, 1)] + [
    (f"P{i + 3}_{blk}", 64 >> i, 3, 2) for i in range(5) for blk in ("block1", "block2")]
# odd maps (a COCO-canvas level, 7x11, 1x1) at the two other block forms and two widths: (H, W, C, kernel, dilation)
QMN_ODD = [(h, w, c, k, d) for h, w in ((28, 44), (7, 11), (1, 1)) for c in (64, 256) for k, d in ((5, 2), (7, 1))]
# K12 against its plain version: the JAX kernel's contract (tests/test_quant.py:1200-1254), at most one int8
# step on under 1e-3 of the elements (the card's expf against the CPU's, were they to differ)
QMN_MAX_STEP, QMN_MAX_SHARE = 1, 1e-3


def _qmn_case(b, h, w, c, k, seed, device, alpha=2):
    """A random int8 MNBlock in the port's layout, its scales and an input,
    drawn as tests/test_quant.py:1213-1226 draws them."""
    g = torch.Generator().manual_seed(seed)
    cm = alpha * c
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    pos = lambda n: torch.rand(n, generator=g) * 1e-3 + 1e-5
    nrm = lambda n: torch.randn(n, generator=g) * 0.1
    blk = dict(wdw=i8(k, k, c), swdw=pos(c), bdw=nrm(c), w1=i8(cm, c), sw1=pos(cm), b1=nrm(cm), w2=i8(c, cm),
               sw2=pos(c), b2=nrm(c))
    sc = {n: torch.tensor(v) for n, v in dict(s_in=0.05, s_a1=0.03, s_a2=0.04, s_out=0.06).items()}
    return _on(blk, device), _on(sc, device), i8(b, h, w, c).to(device)


def _qmn_check(blk, sc, x, k, d):
    before = qmnblock.launches
    got = qmnblock(blk, sc, x, k, d)
    torch.cuda.synchronize()
    assert qmnblock.launches == before + 1
    want = qmnblock_plain(blk, sc, x, k, d)
    diff = (got.int() - want.int()).abs()
    n_diff = int((diff > 0).sum())
    print(f"K12 {tuple(x.shape)} k{k} d{d}: {n_diff} of {diff.numel()} differ, max {int(diff.max())} step")
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert int(diff.max()) <= QMN_MAX_STEP and n_diff / diff.numel() < QMN_MAX_SHARE
    assert float((want != 0).float().mean()) > 0.5  # not degenerate
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", QMN_PATH, ids=[c[0] for c in QMN_PATH])
def test_qmnblock_kernel_at_the_path_shapes(cuda, case):
    _, hw, k, d = case
    blk, sc, x = _qmn_case(2, hw, hw, 256, k, QMN_PATH.index(case), cuda)
    _qmn_check(blk, sc, x, k, d)


QMN_PATH_B = [(b,) + case for b in (8, 64) for case in QMN_PATH]


@pytest.mark.cuda
@pytest.mark.parametrize("case", QMN_PATH_B, ids=[f"B{c[0]}_{c[1]}" for c in QMN_PATH_B])
def test_qmnblock_kernel_at_the_path_shapes_under_every_tile(cuda, case):
    """K12 at the ladder's 15 call shapes, B=8 and B=64, against its plain
    version, and bit for bit the same under every tile it takes (int32
    sums are exact in any order; the epilogue's steps do not depend on the
    tile)."""
    b, _, hw, k, d = case
    blk, sc, x = _qmn_case(b, hw, hw, 256, k, QMN_PATH.index(case[1:]), cuda)
    base = _qmn_check(blk, sc, x, k, d)
    for opt in mn_options(b, hw, hw, 256, 512, k, d, card_limits(cuda)[1]):
        assert torch.equal(qmnblock(blk, sc, x, k, d, tile=opt), base), opt


@pytest.mark.cuda
@pytest.mark.parametrize("case", QMN_ODD, ids=[f"{h}x{w}_c{c}_k{k}d{d}" for h, w, c, k, d in QMN_ODD])
def test_qmnblock_kernel_at_odd_shapes(cuda, case):
    h, w, c, k, d = case
    blk, sc, x = _qmn_case(3, h, w, c, k, h * w + c + k, cuda)
    _qmn_check(blk, sc, x, k, d)


@pytest.mark.cuda
def test_qmnblock_kernel_rejects_other_operands(cuda):
    blk, sc, x = _qmn_case(2, 8, 8, 64, 3, 1, cuda)
    flat = torch.empty(x.numel() + 16, dtype=torch.int8, device=cuda)
    before = qmnblock.launches
    with pytest.raises(ValueError, match="int8"):
        qmnblock(blk, sc, x.float(), 3, 1)
    with pytest.raises(ValueError, match="wdw"):  # a kernel of another size than asked
        qmnblock(blk, sc, x, 5, 1)
    with pytest.raises(ValueError, match="dilation"):
        qmnblock(blk, sc, x, 3, 3)
    with pytest.raises(ValueError, match="contiguous"):  # NHWC-shaped but not contiguous
        qmnblock(blk, sc, x.transpose(1, 2), 3, 1)
    with pytest.raises(ValueError, match="aligned"):
        qmnblock(blk, sc, flat[1:1 + x.numel()].view(x.shape), 3, 1)
    with pytest.raises(ValueError, match="on cuda"):  # a weight on another device
        qmnblock(dict(blk, w1=blk["w1"].cpu()), sc, x, 3, 1)
    blk24, sc24, x24 = _qmn_case(2, 8, 8, 24, 3, 2, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        qmnblock(blk24, sc24, x24, 3, 1)
    assert qmnblock.launches == before


def test_qmnblock_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    before = qmnblock.launches
    for k, d in ((3, 2), (7, 1)):
        blk, sc, x = _qmn_case(2, 5, 3, 24, k, k, "cpu")  # C = 24: the plain version takes any width
        got = qmnblock(blk, sc, x, k, d)
        assert torch.equal(got, qmnblock_plain(blk, sc, x, k, d)) and got.shape == x.shape
    assert qmnblock.launches == before
    with pytest.raises(ValueError, match="int8"):
        qmnblock(blk, sc, x.float(), 7, 1)
    with pytest.raises(ValueError, match="w2"):
        qmnblock(dict(blk, w2=blk["w2"][:8]), sc, x, 7, 1)
    with pytest.raises(ValueError, match="odd"):
        qmnblock(blk, sc, x, 4, 1)
    with pytest.raises(ValueError, match="s_out"):
        qmnblock(blk, dict(sc, s_out=0.06), x, 7, 1)


# ---------------------------------------------------------------------------
# training on the card: the GroupNorms take F.group_norm while autograd records
# ---------------------------------------------------------------------------
TRAIN_HW = (128, 128)
TRAIN_SHAPES = [(TRAIN_HW[0] // s, TRAIN_HW[1] // s) for s in (8, 16, 32, 64, 128)]
TRAIN_RANGES = [(-1, 32), (32, 96), (96, 192), (192, 384), (384, 9999999)]


def _train_state(device, seed=0):
    from pytorch_object_detection_tpu_torch.models.registry import build_model
    from pytorch_object_detection_tpu_torch.train import trainer

    model = build_model("HISFCOS", 5, 64, frozen_stages=1, device=device,
                        generator=torch.Generator().manual_seed(seed))
    return trainer.create_train_state(model, {"lr": 1e-2, "warmup_steps": 10}, True, 1)


def _train_batch(device, seed=1):
    from pytorch_object_detection_tpu_torch.data.synthetic import synthetic_batch

    images, boxes, labels = synthetic_batch(torch.Generator().manual_seed(seed), 2, TRAIN_HW, 5, max_boxes=8)
    return (images - 0.5).to(device) / 0.25, boxes.to(device), labels.to(device)


def _train_step(state, dtype):
    from pytorch_object_detection_tpu_torch.train import trainer

    return trainer.make_train_step(state.model, TRAIN_SHAPES, (8, 16, 32, 64, 128), TRAIN_RANGES, "giou", dtype)


@pytest.mark.cuda
def test_train_step_on_the_card_keeps_frozen_weights_and_launches_no_kernel_b(cuda):
    """A small f32 train step: finite losses on the card, the frozen weights
    and every buffer unchanged, kernel B launched no time in the step and 20
    times in an eval forward after it (the model left in train mode)."""
    state = _train_state(cuda)
    trainable = set(state.trainable_names())
    before = {k: v.clone() for k, v in state.model.state_dict().items() if k not in trainable}
    groupnorm_act.launches = 0
    losses = _train_step(state, torch.float32)(state, *_train_batch(cuda))
    torch.cuda.synchronize()
    assert groupnorm_act.launches == 0
    assert all(v.is_cuda and bool(torch.isfinite(v)) for v in losses.values())
    after = state.model.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())
    state.model.train()
    with torch.inference_mode():
        state.model(_train_batch(cuda)[0])
    torch.cuda.synchronize()
    assert groupnorm_act.launches == 20


@pytest.mark.cuda
def test_groupnorm_takes_the_autograd_path_and_kernel_b_raises_for_a_gradient(cuda):
    from pytorch_object_detection_tpu_torch.nn.layers import GroupNorm32

    x, scale, bias = _gn_inputs(256, 8, torch.float32, cuda, 0)
    with pytest.raises(RuntimeError, match="no backward"):
        groupnorm_act(x.clone().requires_grad_(), scale, bias)
    with pytest.raises(RuntimeError, match="no backward"):
        groupnorm_act(x, scale.clone().requires_grad_(), bias)
    gn = GroupNorm32(256, "silu").to(cuda)
    groupnorm_act.launches = 0
    y = gn(x.clone().requires_grad_())
    assert y.grad_fn is not None and groupnorm_act.launches == 0
    with torch.no_grad():
        gn(x)
    assert groupnorm_act.launches == 1


@pytest.mark.cuda
def test_bf16_train_step_against_f32(cuda):
    """The bf16 autocast step against the f32 step from the same weights and
    batch: the loss within 2 % and the gradients at cosine >= 0.98 (the
    bounds chip_smoke.py phase 5q holds at full size)."""
    s32, s16 = _train_state(cuda), _train_state(cuda)
    batch = _train_batch(cuda)
    m32 = _train_step(s32, torch.float32)(s32, *batch)
    m16 = _train_step(s16, torch.bfloat16)(s16, *batch)
    assert abs(float(m16["total"]) - float(m32["total"])) <= 2e-2 * abs(float(m32["total"]))
    g32 = torch.cat([p.grad.flatten() for p in s32.model.parameters() if p.grad is not None])
    g16 = torch.cat([p.grad.flatten() for p in s16.model.parameters() if p.grad is not None])
    assert float(g16 @ g32 / (g16.norm() * g32.norm())) >= 0.98
