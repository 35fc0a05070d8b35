"""The tile choosers of kernel C (``ops/qblock.pick_tile``), K4
(``ops/qconv.pick_qmm_tile``), K16 (``ops/fused.pick_k16_tile``), K7/K9
(``ops/qhead.pick_head_tile``), K5 (``ops/qhis.pick_his_tile``), K1
(``ops/qstem.pick_stem_tile``), K11 (``ops/qconv.pick_conv3_tile``) and
K13 (``ops/qchain.pick_chain_tile``), K15 (``ops/head.pick_fhead_tile``),
K12 (``ops/qmnblock.pick_mn_tile``), kernel B (``ops/gn.pick_gn_tile``) and
K17 (``ops/stem.pick_stem_tail_tile``) and K10 (``ops/qpool.pick_pool3_tile``),
in plain Python with an H100's
limits: 132 SMs and 232,448 bytes of shared memory a block may opt in to.

Kernel C at the 16 ResNet-50 bottlenecks of the 512x512 canvas, B = 1, 2, 8
and 64; K4 at the HisFPN's three laterals and the per-conv backend's 36
bottleneck 1x1 convs, B = 2, 8 and 64; K16 at the fused ResNet-50's 32
conv1/conv3 GEMMs, B = 2, 8 and 64, and odd shapes; K7 at the five head
levels of the 512x512 canvas and K7/K9 at those of the 896x1408 COCO
canvas, with narrow heads, 80 classes and 1x1 levels; K5 at the seven
HisBlocks of the 512x512 canvas, B = 1, 2, 8 and 64, narrow blocks, odd
sizes and 1x1 maps; K1 on the 512x512 and 896x1408 canvases and odd pooled
sizes, B = 1, 2, 8 and 64, and a plain-Python model of one K1 block's
implicit GEMM (its staged frame rows, s2d patch and K steps) against the
int32 conv; K11 at the four stages' conv2 shapes and odd ones, and K13 on
the three backbone segments and an odd chain, B = 1, 2, 8 and 64, with a
Python run of K13's persistent loop; K15 at the fused-head pipeline's five
levels and K12 at the MNFCOS ladder's ten call shapes, B = 1, 2, 8 and 64,
on 132 and 114 SMs, and odd maps; kernel B at the HISHead's ten
GroupNorm shapes, B = 1, 2, 8 and 64, the COCO canvas's P3 slab and odd
maps, bf16 and f32, with a plain-Python model of which slab units each
block of a launch stages; K17 on the 512x512 and COCO stem maps and odd
ones, B = 1, 2, 8 and 64; K10 (``ops/qpool.pick_pool3_tile``) on the same
maps, with a plain-Python model of one K10 block: its clamped staging, its
pool in the kernel's tap order against the plain pool, and its shared-memory
reads a quarter warp at a time.  No card and no JAX needed.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu_torch.ops.qblock import (
    SPLITS, TILE_ROWS, out_hw, pick_tile, recompute_factor, smem_bytes, tile_grid)
from pytorch_object_detection_tpu_torch.ops.fused import K16_BM, k16_smem_bytes, pick_k16_tile
from pytorch_object_detection_tpu_torch.ops.gn import (
    GN_BLOCK_CHUNKS, GN_CHUNK_UNITS, GN_MAX_WARPS, gn_blocks, gn_chunks, gn_geometry, gn_options, gn_smem_bytes,
    pick_gn_tile)
from pytorch_object_detection_tpu_torch.ops.head import (
    FHEAD_PASSES, FHEAD_PRED_NC, FHEAD_ROWS, FHEAD_TILE, fhead_blocks, fhead_options, fhead_pass_width,
    fhead_rows, fhead_smem_bytes, fhead_tile_dims, fhead_widths, pick_fhead_tile)
from pytorch_object_detection_tpu_torch.ops.qchain import chain_smem_bytes, pick_chain_tile, tile_blocks, two_per_sm
from pytorch_object_detection_tpu_torch.ops.qconv import (
    CONV3_SPLITS, CONV3_TILE_ROWS, CONV3_TILE_WIDTHS, QMM_BM, QMM_STEP, conv3_blocks, conv3_smem_bytes,
    pick_conv3_tile, pick_qmm_tile, qmm_smem_bytes)
from pytorch_object_detection_tpu_torch.ops.qhead import (
    HEAD_PASSES, HEAD_TILE, PRED_NC, head_blocks, head_ipbs, head_pass_width, head_slices, head_smem_bytes,
    head_tile_dims, pick_head_tile)
from pytorch_object_detection_tpu_torch.ops.qhis import (
    HIS_KERNELS, HIS_ROWS, HIS_TILE, his_blocks, his_chunk, his_ipbs, his_slices, his_smem_bytes, his_width,
    pick_his_tile)
from pytorch_object_detection_tpu_torch.ops.qmnblock import SPLITS as MN_SPLITS
from pytorch_object_detection_tpu_torch.ops.qmnblock import TILE_ROWS as MN_TILE_ROWS
from pytorch_object_detection_tpu_torch.ops.qmnblock import TILE_WIDTHS as MN_TILE_WIDTHS
from pytorch_object_detection_tpu_torch.ops.qmnblock import (
    mn_blocks, mn_cost, mn_ipbs, mn_options, mn_per_sm, mn_rows, mn_smem_bytes, mn_tiles, pick_mn_tile)
from pytorch_object_detection_tpu_torch.ops.qstem import (
    STEM_MC, STEM_TILES, pick_stem_tile, stem_blocks, stem_load, stem_recompute, stem_sizes, stem_smem_bytes,
    stem_tiles)
from pytorch_object_detection_tpu_torch.ops.qpool import (
    POOL3_COLS, POOL3_PER_SM, POOL3_ROWS, pick_pool3_tile, pool3_blocks, pool3_smem_bytes, qmaxpool3x3s2_plain)
from pytorch_object_detection_tpu_torch.ops.quant import conv_i8
from pytorch_object_detection_tpu_torch.ops.stem import (
    STEM_TAIL_COLS, STEM_TAIL_PER_SM, STEM_TAIL_ROWS, pick_stem_tail_tile, stem_tail_blocks, stem_tail_smem_bytes,
    stem_tail_staged)
from torch_port_fixtures import resnet50_block_shapes

SM_COUNT, SMEM_MAX = 132, 232448  # NVIDIA H100 SXM: SMs, shared memory per block (opt-in)


def tile_origins(batch, ho, wo, tw):
    """(image, first output row, first output column) of each kernel C
    tile, as csrc/qblock.cu's qblock_kernel derives them from its cluster
    index and the tile grid."""
    ty, tx = tile_grid(ho, wo, tw)
    return [(b, y * TILE_ROWS, x * tw) for b in range(batch) for y in range(ty) for x in range(tx)]


def qmm_blocks(m, n, k, bn, splits, steps_per):
    """(m0, n0, k0, k1) of each K4 thread block, as csrc/qconv.cu's
    qmm_kernel derives them from blockIdx: rows [m0, m0 + 128), columns
    [n0, n0 + bn), K bytes [k0, k1) clipped to the matrix's steps."""
    steps = -(-k // QMM_STEP)
    return [(x * QMM_BM, y * bn, z * steps_per * QMM_STEP, min(steps, (z + 1) * steps_per) * QMM_STEP)
            for z in range(splits) for y in range(-(-n // bn)) for x in range(-(-m // QMM_BM))]


BLOCK_CASES = [(shape, b) for shape in resnet50_block_shapes() for b in (1, 2, 8, 64)]
BLOCK_IDS = [f"{shape[0]}-B{b}" for shape, b in BLOCK_CASES]


def _gemms(batch):
    """(name, M, K, N) of the three laterals (C5, C4, C3 at 16, 32 and 64
    pixels a side) and the 36 1x1 convs of the per-conv backend: each
    block's conv1 on its input, conv3 and the projection shortcut on its
    output grid."""
    out = [(f"tf{i + 1}", batch * hw * hw, c, 256) for i, (hw, c) in enumerate(((16, 2048), (32, 1024), (64, 512)))]
    for scope, h, w, cin, cw, cout, stride in resnet50_block_shapes():
        ho, wo = out_hw(h, w, stride)
        out.append((f"{scope}.conv1", batch * h * w, cin, cw))
        out.append((f"{scope}.conv3", batch * ho * wo, cw, cout))
        if scope.endswith("_0"):
            out.append((f"{scope}.shortcut", batch * ho * wo, cin, cout))
    return out


GEMM_CASES = [(g, b) for b in (2, 8, 64) for g in _gemms(b)]
GEMM_IDS = [f"{g[0]}-B{b}" for g, b in GEMM_CASES]


def test_gemm_cases_are_the_paths_shapes():
    assert len(_gemms(8)) == 39  # 3 laterals + 36 bottleneck 1x1s (16 conv1, 16 conv3, 4 shortcuts)


def _block(case):
    (scope, h, w, cin, cw, cout, stride), b = case
    tw, split = pick_tile(b, h, w, cw, cout, stride, SM_COUNT, SMEM_MAX)
    return scope, b, h, w, cw, cout, stride, tw, split


@pytest.mark.parametrize("case", BLOCK_CASES, ids=BLOCK_IDS)
def test_kernel_c_tiles_cover_each_output_once(case):
    """Every (image, output row, column, output channel) belongs to exactly
    one thread block: the tiles partition the map, the cluster's blocks the
    channels."""
    scope, b, h, w, cw, cout, stride, tw, split = _block(case)
    ho, wo = out_hw(h, w, stride)
    seen = np.zeros((b, ho, wo, split), np.int32)
    for img, y0, x0 in tile_origins(b, ho, wo, tw):
        seen[img, y0:y0 + TILE_ROWS, x0:x0 + tw, :] += 1
    assert (seen == 1).all(), f"{scope}: some output position is covered {seen.min()} or {seen.max()} times"
    slices = [range(q * cout // split, (q + 1) * cout // split) for q in range(split)]
    assert sorted(c for s in slices for c in s) == list(range(cout))
    assert cw % (16 * split) == 0 and cout % (16 * split) == 0  # whole 16-byte chunks per block


@pytest.mark.parametrize("case", BLOCK_CASES, ids=BLOCK_IDS)
def test_kernel_c_tile_fits_shared_memory(case):
    scope, b, h, w, cw, cout, stride, tw, split = _block(case)
    assert tw in (8, 16) and split in (1, 2, 4, 8)
    assert smem_bytes(stride, tw, cw) <= SMEM_MAX


@pytest.mark.parametrize("case", BLOCK_CASES, ids=BLOCK_IDS)
def test_kernel_c_fills_the_card(case):
    """At least one block per SM wherever 8x8 tiles in clusters of 8 (the
    largest portable cluster) reach that many."""
    scope, b, h, w, cw, cout, stride, tw, split = _block(case)
    ho, wo = out_hw(h, w, stride)
    ty, tx = tile_grid(ho, wo, tw)
    ctas = b * ty * tx * split
    if b * ho * wo / 64 * 8 >= SM_COUNT:
        assert ctas >= SM_COUNT, f"{scope} B={b}: {ctas} blocks"
    if scope.startswith(("layer3", "layer4")) and b == 8:
        assert ctas >= SM_COUNT


@pytest.mark.parametrize("case", BLOCK_CASES, ids=BLOCK_IDS)
def test_kernel_c_conv1_recompute(case):
    """conv1 runs on each tile's halo: at most 1.6 times its positions at
    stride 1 for tiles of 8x8 or larger (1.5625 at 8x8, 1.40625 at 8x16)."""
    scope, b, h, w, cw, cout, stride, tw, split = _block(case)
    factor = recompute_factor(h, w, stride, tw)
    assert factor >= 1.0
    if stride == 1:
        assert factor <= 1.6, f"{scope} B={b}: conv1 computes {factor:.4f} times its positions"


@pytest.mark.parametrize("case", GEMM_CASES, ids=GEMM_IDS)
def test_k4_blocks_cover_each_output_once(case):
    """Every (m, n) in exactly one tile, and every 64-byte K step of it in
    exactly one split."""
    (name, m, k, n), _ = case
    bn, splits, per = pick_qmm_tile(m, n, k, SM_COUNT, SMEM_MAX)
    blocks = qmm_blocks(m, n, k, bn, splits, per)
    tiles = {}
    for m0, n0, k0, k1 in blocks:
        assert k0 < k1, f"{name}: an empty K slice"
        tiles.setdefault((m0, n0), []).append((k0, k1))
    mt, nt = -(-m // QMM_BM), -(-n // bn)
    assert sorted(tiles) == sorted((x * QMM_BM, y * bn) for x in range(mt) for y in range(nt))
    steps = -(-k // QMM_STEP)
    for ranges in tiles.values():
        covered = sorted(s for k0, k1 in ranges for s in range(k0 // QMM_STEP, k1 // QMM_STEP))
        assert covered == list(range(steps))
    assert len(blocks) == mt * nt * splits and nt <= 65535


@pytest.mark.parametrize("case", GEMM_CASES, ids=GEMM_IDS)
def test_k4_tile_fits_shared_memory(case):
    (name, m, k, n), _ = case
    bn, splits, per = pick_qmm_tile(m, n, k, SM_COUNT, SMEM_MAX)
    assert bn in (128, 64) and qmm_smem_bytes(bn) <= SMEM_MAX


@pytest.mark.parametrize("case", GEMM_CASES, ids=GEMM_IDS)
def test_k4_fills_the_card_with_k_slices_of_64_bytes(case):
    """At least one block per SM wherever 128 x 64 tiles times K's 64-byte
    steps reach that many; split K lands on multiples of 64 bytes."""
    (name, m, k, n), _ = case
    bn, splits, per = pick_qmm_tile(m, n, k, SM_COUNT, SMEM_MAX)
    tiles = -(-m // QMM_BM) * -(-n // bn)
    if -(-m // QMM_BM) * -(-n // 64) * -(-k // QMM_STEP) >= SM_COUNT:
        assert tiles * splits >= SM_COUNT, f"{name}: {tiles * splits} blocks"
    if splits > 1:
        assert bn == 64 and tiles < SM_COUNT
        for _, _, k0, k1 in qmm_blocks(m, n, k, bn, splits, per):
            assert k0 % 64 == 0 and (k1 % 64 == 0 or k1 >= k)


def _k16_gemms(batch):
    """(name, M, K, N) of the fused ResNet-50's 32 1x1 GEMMs: each block's
    conv1 on its input grid, conv3 on its output grid."""
    out = []
    for scope, h, w, cin, cw, cout, stride in resnet50_block_shapes():
        ho, wo = out_hw(h, w, stride)
        out += [(f"{scope}.conv1", batch * h * w, cin, cw), (f"{scope}.conv3", batch * ho * wo, cw, cout)]
    return out


K16_CASES = [(g, b) for b in (2, 8, 64) for g in _k16_gemms(b)] + [
    ((f"odd{i}", m, k, n), 1) for i, (m, k, n) in enumerate(((1000, 77, 130), (37, 24, 5), (129, 8, 65), (1, 32, 64),
                                                             (300, 72, 48), (4096, 64, 16384)))]
K16_IDS = [f"{g[0]}-B{b}" for g, b in K16_CASES]


def test_k16_cases_are_the_paths_shapes():
    assert len(_k16_gemms(8)) == 32


@pytest.mark.parametrize("case", K16_CASES, ids=K16_IDS)
def test_k16_tiles_cover_each_output_once_within_the_limits(case):
    """The 128 x bn tiles partition [M, N]; the grid and the block's shared
    memory stay within the card's limits."""
    (name, m, k, n), _ = case
    bn = pick_k16_tile(m, n, k, SM_COUNT, SMEM_MAX)
    assert bn in (128, 64) and k16_smem_bytes(bn) <= SMEM_MAX
    gx, gy = -(-m // K16_BM), -(-n // bn)
    assert gx <= 2**31 - 1 and gy <= 65535
    rows = np.concatenate([np.arange(x * K16_BM, min(m, (x + 1) * K16_BM)) for x in range(gx)])
    cols = np.concatenate([np.arange(y * bn, min(n, (y + 1) * bn)) for y in range(gy)])
    assert np.array_equal(rows, np.arange(m)) and np.array_equal(cols, np.arange(n))


@pytest.mark.parametrize("case", K16_CASES, ids=K16_IDS)
def test_k16_fills_the_card(case):
    """128 x 64 tiles where N <= 64 or where 128 x 128 tiles leave SMs
    idle; at least one block per SM wherever 128 x 64 tiles reach it."""
    (name, m, k, n), _ = case
    bn = pick_k16_tile(m, n, k, SM_COUNT, SMEM_MAX)
    if n <= 64:
        assert bn == 64
    if -(-m // K16_BM) * -(-n // 64) >= SM_COUNT:
        assert -(-m // K16_BM) * -(-n // bn) >= SM_COUNT, f"{name}: {bn}"
    if bn == 64 and n > 64:
        assert -(-m // K16_BM) * -(-n // 128) < SM_COUNT


def _head_levels(canvas):
    return [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in (8, 16, 32, 64, 128)]


# (batch, H, W, C, classes, pair): the default pipeline's five levels at
# 512x512, the COCO canvas's for K7 and K9, the narrow head, 1x1 and 2x2 levels
HEAD_CASES = (
    [(b, h, w, 256, 20, False) for b in (1, 2, 8, 64) for h, w in _head_levels((512, 512))]
    + [(b, h, w, 256, 80, pair) for b in (2, 8) for h, w in _head_levels((896, 1408)) for pair in (False, True)]
    + [(b, h, w, 64, 20, pair) for b in (2, 8, 64) for h, w in ((64, 64), (8, 8), (4, 4)) for pair in (False, True)]
    + [(b, 1, 1, 256, 80, pair) for b in (2, 8, 64) for pair in (False, True)]
    + [(64, 2, 2, 256, 20, False), (4, 7, 11, 32, 20, True), (3, 5, 3, 32, 20, False)]
)
HEAD_IDS = [f"B{b}-{h}x{w}-C{c}-{nc}cls-{'k9' if pair else 'k7'}" for b, h, w, c, nc, pair in HEAD_CASES]


@pytest.mark.parametrize("case", HEAD_CASES, ids=HEAD_IDS)
def test_head_tiles_fit_the_card(case):
    """Every pass's block fits the shared memory, its M rows the tile (64,
    or 128 for K9's image pairs), its slice whole 16-channel groups, and the
    grid's image groups grid.y."""
    b, h, w, c, nc, pair = case
    tile = pick_head_tile(b, h, w, c, nc, SM_COUNT, SMEM_MAX, pair=pair)
    assert tuple(tile) == HEAD_PASSES
    npos = head_tile_dims(h, w)[0]
    for pass_, (ipb, split) in tile.items():
        assert head_smem_bytes(pass_, ipb, h, w, c, nc, split, pair) <= SMEM_MAX, pass_
        assert ipb * npos <= (128 if pair else 64) and -(-b // ipb) <= 65535, pass_
        assert ipb in head_ipbs(b, h, w, pair) and split in head_slices(pass_, c, nc)
        if pair:
            assert ipb % 2 == 0
        if pass_ != "pred":
            assert head_pass_width(pass_, c, nc) % (16 * split) == 0


@pytest.mark.parametrize("case", HEAD_CASES, ids=HEAD_IDS)
def test_head_blocks_cover_each_output_once(case):
    """The blocks of each pass (tile x image group x slice, as
    csrc/qhead.cu's blk_of derives them from blockIdx) cover every (image,
    position, output channel) once: the tiles partition the map, the image
    groups the batch and the slices the channels, so each (image, tile,
    channel)'s GroupNorm sums have one writer."""
    b, h, w, c, nc, pair = case
    tile = pick_head_tile(b, h, w, c, nc, SM_COUNT, SMEM_MAX, pair=pair)
    tiles_x, tiles_y = -(-w // HEAD_TILE), -(-h // HEAD_TILE)
    seen = np.zeros((h, w), np.int32)
    for t in range(tiles_x * tiles_y):
        r0, c0 = (t // tiles_x) * HEAD_TILE, (t % tiles_x) * HEAD_TILE
        seen[r0:r0 + HEAD_TILE, c0:c0 + HEAD_TILE] += 1
    assert (seen == 1).all()
    for pass_, (ipb, split) in tile.items():
        images = sorted(i for grp in range(-(-b // ipb)) for i in range(grp * ipb, min(b, grp * ipb + ipb)))
        assert images == list(range(b)), pass_
        if pass_ == "pred":  # 32 classes a block, then one block of cnt|reg
            chans = [k for z in range(split - 1) for k in range(z * PRED_NC, min(nc, z * PRED_NC + PRED_NC))]
            assert split == -(-nc // PRED_NC) + 1 and chans == list(range(nc))
        else:
            n = head_pass_width(pass_, c, nc)
            chans = sorted(k for z in range(split) for k in range(z * (n // split), (z + 1) * (n // split)))
            assert chans == list(range(n)), pass_


@pytest.mark.parametrize("case", HEAD_CASES, ids=HEAD_IDS)
def test_head_fills_the_card(case):
    """Each pass reaches one block per SM wherever some choice that fits
    does, else takes the most blocks; where its largest image group already
    reaches it, it neither shrinks the group nor splits the channels."""
    b, h, w, c, nc, pair = case
    tile = pick_head_tile(b, h, w, c, nc, SM_COUNT, SMEM_MAX, pair=pair)
    for pass_, (ipb, split) in tile.items():
        options = [(i, s) for i in head_ipbs(b, h, w, pair) for s in head_slices(pass_, c, nc)
                   if head_smem_bytes(pass_, i, h, w, c, nc, s, pair) <= SMEM_MAX]
        most = max(head_blocks(b, h, w, i, s) for i, s in options)
        got = head_blocks(b, h, w, ipb, split)
        assert got >= min(SM_COUNT, most), f"{pass_}: {got} blocks of a possible {most}"
        top = head_ipbs(b, h, w, pair)[0]
        first = head_slices(pass_, c, nc)[0]
        if head_blocks(b, h, w, top, first) >= SM_COUNT and (top, first) in options:
            assert (ipb, split) == (top, first), pass_


def test_head_small_levels_pack_images_and_split_channels():
    """At B=64 the 4x4 and 1x1 levels put several images in a block; at B=8
    the 8x8 and 16x16 levels split the towers' channels across blocks."""
    for h in (4, 1):
        assert pick_head_tile(64, h, h, 256, 20, SM_COUNT, SMEM_MAX)["towers"][0] > 1
    for h in (16, 8):
        assert pick_head_tile(8, h, h, 256, 20, SM_COUNT, SMEM_MAX)["towers"][1] > 1
    assert pick_head_tile(8, 64, 64, 256, 20, SM_COUNT, SMEM_MAX)["towers"] == (1, 1)


# (batch, H, W, cin): the seven HisBlocks of the 512x512 canvas (his1 16x16,
# his2 32x32, his3 64x64, his4 32x32, his5 16x16, his6 8x8, his7 4x4), the
# narrow block, odd sizes, 1x1 and 2x2 maps, the narrowest width (half = 16)
HIS_SHAPES = [(16, 16), (32, 32), (64, 64), (8, 8), (4, 4)]
HIS_CASES = (
    [(b, h, w, 256) for b in (1, 2, 8, 64) for h, w in HIS_SHAPES]
    + [(b, h, w, 64) for b in (2, 8, 64) for h, w in ((64, 64), (13, 11), (4, 4), (1, 1))]
    + [(b, 1, 1, 256) for b in (2, 8, 64)] + [(64, 2, 2, 256), (3, 5, 3, 32), (4, 7, 11, 96), (5, 9, 7, 256)]
)
HIS_IDS = [f"B{b}-{h}x{w}-C{c}" for b, h, w, c in HIS_CASES]


@pytest.mark.parametrize("case", HIS_CASES, ids=HIS_IDS)
def test_his_tiles_fit_the_card(case):
    """Every kernel's block fits the shared memory; a consumer's M rows (ipb
    x a full tile's positions) stay within 64, the producer's are 64 or
    128; slices are whole 16-channel groups, walked in GEMM chunks of 32 to
    256 channels (256 only on out); image groups fit grid.y."""
    b, h, w, c = case
    tile = pick_his_tile(b, h, w, c, SM_COUNT, SMEM_MAX)
    assert tuple(tile) == HIS_KERNELS
    npos = min(HIS_TILE, h) * min(HIS_TILE, w)
    for kernel, (ipb, split) in tile.items():
        assert his_smem_bytes(kernel, ipb, h, w, c, split) <= SMEM_MAX, kernel
        assert ipb in his_ipbs(kernel, b, h, w) and split in his_slices(kernel, c)
        if kernel == "produce":
            assert ipb in (64, 128)
        else:
            assert ipb * npos <= HIS_ROWS and -(-b // ipb) <= 65535, kernel
        slice_ = his_width(kernel, c) // split
        assert slice_ % 16 == 0 and split * slice_ == his_width(kernel, c)
        chunk = his_chunk(kernel, slice_)
        assert chunk in (32, 64, 128, 256) and (chunk < 256 or kernel == "out") and (slice_ % chunk == 0 or chunk == 32)


@pytest.mark.parametrize("case", HIS_CASES, ids=HIS_IDS)
def test_his_blocks_cover_each_output_once(case):
    """The blocks of each kernel cover every (image, position, output
    channel) once: the producer's row blocks partition the batch's
    positions and its slices conv1|conv2's outputs; a consumer's tiles
    partition the map (as csrc/qhis.cu's blk_of derives them), its image
    groups the batch and its slices the channels."""
    b, h, w, c = case
    tile = pick_his_tile(b, h, w, c, SM_COUNT, SMEM_MAX)
    tiles_x, tiles_y = -(-w // HIS_TILE), -(-h // HIS_TILE)
    seen = np.zeros((h, w), np.int32)
    for t in range(tiles_x * tiles_y):
        r0, c0 = (t // tiles_x) * HIS_TILE, (t % tiles_x) * HIS_TILE
        seen[r0:r0 + HIS_TILE, c0:c0 + HIS_TILE] += 1
    assert (seen == 1).all()
    for kernel, (ipb, split) in tile.items():
        n = his_width(kernel, c)
        chans = sorted(k for z in range(split) for k in range(z * (n // split), (z + 1) * (n // split)))
        assert chans == list(range(n)), kernel
        if kernel == "produce":
            rows = [min(ipb, b * h * w - x * ipb) for x in range(-(-b * h * w // ipb))]
            assert sum(rows) == b * h * w and min(rows) > 0
            assert his_blocks(kernel, b, h, w, ipb, split) == len(rows) * split
        else:
            images = sorted(i for grp in range(-(-b // ipb)) for i in range(grp * ipb, min(b, grp * ipb + ipb)))
            assert images == list(range(b)), kernel
            assert his_blocks(kernel, b, h, w, ipb, split) == tiles_x * tiles_y * -(-b // ipb) * split


@pytest.mark.parametrize("case", HIS_CASES, ids=HIS_IDS)
def test_his_fills_the_card(case):
    """Each kernel reaches one block per SM wherever some choice that fits
    does, else takes the most blocks; where its largest rows or image
    group already reaches it, it neither shrinks them nor splits the
    channels."""
    b, h, w, c = case
    tile = pick_his_tile(b, h, w, c, SM_COUNT, SMEM_MAX)
    for kernel, (ipb, split) in tile.items():
        options = [(i, s) for i in his_ipbs(kernel, b, h, w) for s in his_slices(kernel, c)
                   if his_smem_bytes(kernel, i, h, w, c, s) <= SMEM_MAX]
        most = max(his_blocks(kernel, b, h, w, i, s) for i, s in options)
        got = his_blocks(kernel, b, h, w, ipb, split)
        assert got >= min(SM_COUNT, most), f"{kernel}: {got} blocks of a possible {most}"
        top, first = his_ipbs(kernel, b, h, w)[0], his_slices(kernel, c)[0]
        if his_blocks(kernel, b, h, w, top, first) >= SM_COUNT and (top, first) in options:
            assert (ipb, split) == (top, first), kernel


def test_his_small_levels_at_b8_split_channels():
    """At B=8 his5 (16x16) reaches one out block per SM by channel slices,
    his6 and his7 (8x8, 4x4) take the most blocks their shapes allow; his3
    (64x64) needs no slices; at B=64 the producer takes 128-row blocks on
    the large levels."""
    for h in (16, 8, 4):
        tile = pick_his_tile(8, h, h, 256, SM_COUNT, SMEM_MAX)
        assert all(split > 1 for _, split in tile.values()), (h, tile)
    assert his_blocks("out", 8, 16, 16, *pick_his_tile(8, 16, 16, 256, SM_COUNT, SMEM_MAX)["out"]) >= SM_COUNT
    assert pick_his_tile(8, 64, 64, 256, SM_COUNT, SMEM_MAX) == {"produce": (128, 1), "mid": (1, 1), "out": (1, 1)}
    assert pick_his_tile(64, 32, 32, 256, SM_COUNT, SMEM_MAX)["produce"] == (128, 1)


# (batch, H, W) frames of K1: the 512x512 and 896x1408 canvases, and frames
# whose conv or pooled maps are odd or smaller than one tile
STEM_FRAMES = [(512, 512), (896, 1408), (514, 770), (98, 130), (64, 96), (6, 10), (2, 6)]
STEM_CASES = [(b, h, w) for b in (1, 2, 8, 64) for h, w in STEM_FRAMES]
STEM_IDS = [f"B{b}-{h}x{w}" for b, h, w in STEM_CASES]


def _stem_live(n, pr):
    """Per tile along one axis of ``n`` conv rows (or columns) and tiles of
    ``pr`` pooled rows: the conv rows [first, last) it computes, inside the
    map (csrc/qstem.cu's ly0, ly1 from the tile origin 2 pr t - 1)."""
    hp = (n - 1) // 2 + 1
    return [(max(0, 2 * pr * t - 1), min(2 * pr * t - 1 + 2 * pr + 1, n)) for t in range(-(-hp // pr))]


@pytest.mark.parametrize("case", STEM_CASES, ids=STEM_IDS)
def test_stem_tiles_cover_each_pooled_output_once(case):
    """The chooser's tiles partition the pooled map; each pooled position's
    3x3/2 window (inside the conv map) lies in its tile's computed conv
    rows and columns; :func:`stem_recompute` is the count of positions the
    blocks compute over the conv map's."""
    b, h, w = case
    pr, pc = pick_stem_tile(b, h, w, SM_COUNT, SMEM_MAX)
    hc, wc, hp, wp = stem_sizes(h, w)
    ty, tx = stem_tiles(h, w, pr, pc)
    assert stem_blocks(b, h, w, pr, pc) == b * ty * tx
    seen = np.zeros((hp, wp), np.int32)
    for t in range(ty):
        for u in range(tx):
            seen[t * pr:(t + 1) * pr, u * pc:(u + 1) * pc] += 1
    assert (seen == 1).all()
    for n, p, live in ((hc, pr, _stem_live(hc, pr)), (wc, pc, _stem_live(wc, pc))):
        for t, (lo, hi) in enumerate(live):
            for q in range(t * p, min((t + 1) * p, (n - 1) // 2 + 1)):
                assert lo <= max(2 * q - 1, 0) and min(2 * q + 2, n) <= hi
    rows = sum(hi - lo for lo, hi in _stem_live(hc, pr))
    cols = sum(hi - lo for lo, hi in _stem_live(wc, pc))
    assert stem_recompute(h, w, pr, pc) == pytest.approx(rows * cols / (hc * wc) - 1.0, abs=1e-12)


@pytest.mark.parametrize("case", STEM_CASES, ids=STEM_IDS)
def test_stem_tile_fits_the_card(case):
    """Two blocks' shared memory on an SM (3- and 4-channel frames), the
    GEMM rows' table packing (conv tile and patch positions under 2^16),
    and the grid within CUDA's limits (tiles in grid.x, frames in grid.y)."""
    b, h, w = case
    pr, pc = pick_stem_tile(b, h, w, SM_COUNT, SMEM_MAX)
    assert (pr, pc) in STEM_TILES
    assert stem_smem_bytes(pr, pc, 3) <= stem_smem_bytes(pr, pc, 4)
    assert 2 * (stem_smem_bytes(pr, pc, 4) + 1024) <= SMEM_MAX + 1024
    assert (2 * pr + 4) * (2 * pc + 4) < 2 ** 16 and -(-(2 * pr + 1) * (2 * pc + 1) // STEM_MC) * STEM_MC < 2 ** 16
    ty, tx = stem_tiles(h, w, pr, pc)
    assert ty * tx <= 2 ** 31 - 1 and b <= 65535


@pytest.mark.parametrize("case", STEM_CASES, ids=STEM_IDS)
def test_stem_tile_least_load(case):
    """Of the tiles that fit two blocks an SM, the chooser's busiest SM
    computes the fewest conv positions (:func:`stem_load`: ceil(blocks /
    SMs) blocks of the mean size), and no tile of that load recomputes
    less; the load is at least the map's share of one SM."""
    b, h, w = case
    pr, pc = pick_stem_tile(b, h, w, SM_COUNT, SMEM_MAX)
    fits = [t for t in STEM_TILES if 2 * (stem_smem_bytes(*t) + 1024) <= SMEM_MAX + 1024]
    loads = {t: stem_load(b, h, w, *t, SM_COUNT) for t in fits}
    assert loads[(pr, pc)] <= min(loads.values()) * (1 + 1e-9)
    ties = [t for t in fits if loads[t] <= loads[(pr, pc)] * (1 + 1e-9)]
    assert min(stem_recompute(h, w, *t) for t in ties) >= stem_recompute(h, w, pr, pc) - 1e-12
    hc, wc, _, _ = stem_sizes(h, w)
    assert loads[(pr, pc)] >= b * hc * wc / SM_COUNT * (1 - 1e-9)


# the serving and COCO canvases at the batches that fill the card
STEM_FULL = [(b, h, w) for b in (2, 8, 64) for h, w in ((512, 512), (896, 1408))]


@pytest.mark.parametrize("case", STEM_FULL, ids=[f"B{b}-{h}x{w}" for b, h, w in STEM_FULL])
def test_stem_recompute_at_most_7_percent(case):
    """On the serving and COCO canvases from B=2 up, the chooser takes the
    tile that recomputes the least of all that fit (16 x 16): at most 7 %
    of the conv map (the 8x8 tiles of the direct-form kernel recomputed
    13 %)."""
    b, h, w = case
    pr, pc = pick_stem_tile(b, h, w, SM_COUNT, SMEM_MAX)
    got = stem_recompute(h, w, pr, pc)
    assert got <= 0.07
    fits = [t for t in STEM_TILES if 2 * (stem_smem_bytes(*t) + 1024) <= SMEM_MAX + 1024]
    assert min(stem_recompute(h, w, *t) for t in fits) >= got - 1e-12


@pytest.mark.parametrize("frame", [(512, 512), (896, 1408)], ids=["512", "coco"])
def test_stem_spreads_one_frame(frame):
    """At B=1 the least-recompute 16 x 16 tile leaves SMs idle or a third
    wave nearly empty (64 blocks at 512x512, 308 at the COCO canvas); the
    chooser takes twice the blocks, at 16 x 8 pooled positions, for a
    lighter busiest SM."""
    h, w = frame
    pr, pc = pick_stem_tile(1, h, w, SM_COUNT, SMEM_MAX)
    assert (pr, pc) == (16, 8) and stem_blocks(1, h, w, pr, pc) == 2 * stem_blocks(1, h, w, 16, 16)
    assert stem_load(1, h, w, pr, pc, SM_COUNT) < 0.9 * stem_load(1, h, w, 16, 16, SM_COUNT)
    assert stem_recompute(h, w, pr, pc) < 0.1


def test_stem_fills_the_card_at_b8():
    """At 512x512, B=8, the blocks fill every SM twice over (one wave of two
    blocks an SM), and 16x16 pooled tiles recompute 5.5 % of the conv map;
    at the COCO canvas, 6.0 %."""
    pr, pc = pick_stem_tile(8, 512, 512, SM_COUNT, SMEM_MAX)
    assert (pr, pc) == (16, 16) and stem_blocks(8, 512, 512, pr, pc) >= 2 * SM_COUNT
    assert round(stem_recompute(512, 512, pr, pc), 3) == 0.055
    assert round(stem_recompute(896, 1408, *pick_stem_tile(2, 896, 1408, SM_COUNT, SMEM_MAX)), 3) == 0.060


def _k1_block_sums(u, wt, pad, b, pr, pc, ty, tx):
    """One K1 block's int32 sums, built as csrc/qstem.cu builds them:
    ``{(cy, cx): [64] int32}`` over its live conv positions.

    u uint8 ``[B, H, W, cin]`` (its bytes from a 16-byte-aligned start),
    wt int8 ``[64, 256]`` (output channel, (ky, kx, c16)), pad int8 [16].
    Step 1 stages each frame row's bytes as the 16-byte chunks that cover
    them, loading only words inside the row's 4-byte-aligned cover; step 2
    builds the s2d patch from the staged bytes (v = u ^ 0x80, the fourth
    channel of a 3-channel frame 0, the border fill outside the frame);
    step 4 walks K as the kernel does: 4 steps of 64 bytes (ky), two k32
    slices a step (a kx pair), two 16-byte halves a slice (one s2d pixel
    each), every A row read from the patch at its position's table entry."""
    nb, h, w, cin = u.shape
    flat = u.reshape(-1)
    hc, wc, _, _ = stem_sizes(h, w)
    cr, cc = 2 * pr + 1, 2 * pc + 1
    prs, pcs = cr + 3, cc + 3
    pitch = 16 * ((2 * pcs * cin + 15) // 16 + 1)
    cy0, cx0 = 2 * ty * pr - 1, 2 * tx * pc - 1
    sy0, sx0 = cy0 - 2, cx0 - 2
    img = b * h * w * cin
    stage = np.full((2 * prs, pitch), 0x5A, np.uint8)  # bytes never loaded stay 0x5A
    y_lo, y_hi = max(2 * sy0, 0), min(2 * (sy0 + prs), h)
    x_lo, x_hi = max(2 * sx0, 0), min(2 * (sx0 + pcs), w)
    for y in range(y_lo, y_hi):
        s = img + (y * w + x_lo) * cin
        e = s + (x_hi - x_lo) * cin
        w_lo, w_hi = s & ~3, (e + 3) & ~3
        assert 0 <= w_lo and w_hi <= flat.size  # the loads stay inside the frames' bytes
        for k in range(pitch // 16):
            ca = (s & ~15) + 16 * k
            for j in range(4):
                if w_lo <= ca + 4 * j < w_hi:
                    stage[y - 2 * sy0, 16 * k + 4 * j:16 * k + 4 * j + 4] = flat[ca + 4 * j:ca + 4 * j + 4]
    patch = np.empty((prs * pcs, 16), np.int8)
    for si in range(prs):
        for sj in range(pcs):
            ys, xs = sy0 + si, sx0 + sj
            if not (0 <= ys < h // 2 and 0 <= xs < w // 2):
                patch[si * pcs + sj] = pad
                continue
            px = []
            for k in range(4):  # k = 2 dy + dx
                y, x = 2 * ys + k // 2, 2 * xs + k % 2
                off = ((img + (y * w + x_lo) * cin) & 15) + (x - x_lo) * cin
                px += list(stage[y - 2 * sy0, off:off + cin]) + [128] * (4 - cin)
            patch[si * pcs + sj] = (np.array(px, np.uint8) ^ 0x80).view(np.int8)
    ly0, ly1 = max(0, -cy0), min(cr, hc - cy0)
    lx0, lx1 = max(0, -cx0), min(cc, wc - cx0)
    live = [(ci, cj) for ci in range(ly0, ly1) for cj in range(lx0, lx1)]
    rows = np.array([ci * pcs + cj for ci, cj in live])  # the table's patch pixels
    acc = np.zeros((len(live), 64), np.int64)
    for ky in range(4):
        for kk in range(2):
            for half in range(2):
                c = 2 * kk + half
                a = patch[rows + ky * pcs + c].astype(np.int64)
                acc += a @ wt[:, ky * 64 + 16 * c:ky * 64 + 16 * c + 16].astype(np.int64).T
    return {(cy0 + ci, cx0 + cj): acc[i] for i, (ci, cj) in enumerate(live)}


# (B, H, W, cin, pr, pc): one tile over a whole 6x10 frame; tiles whose
# edges cut the map and reach past it; 3-channel rows that start 2 bytes
# past a 4-byte boundary (W = 30, 90 bytes a row); 1x1 pooled tiles
K1_MODEL_CASES = [(2, 6, 10, 3, 2, 4), (2, 22, 30, 3, 2, 3), (1, 22, 30, 4, 4, 2), (1, 18, 26, 3, 1, 1),
                  (1, 34, 42, 4, 8, 8)]


@pytest.mark.parametrize("case", K1_MODEL_CASES, ids=[f"{c[1]}x{c[2]}x{c[3]}-{c[4]}x{c[5]}" for c in K1_MODEL_CASES])
def test_k1_implicit_gemm_model_equals_the_int32_conv(case):
    """Every block's sums from the model of K1's addressing equal the int32
    conv of the padded s2d input (ops/qstem.qstem_plain's), frame edges and
    border fill included; the blocks' live positions cover the conv map."""
    nb, h, w, cin, pr, pc = case
    rng = np.random.default_rng(h * w + cin)
    u = rng.integers(0, 256, (nb, h, w, cin), dtype=np.uint8)
    wq = rng.integers(-127, 128, (256, 64), dtype=np.int8)
    pad = rng.integers(-128, 128, 16, dtype=np.int8)
    frames = torch.from_numpy(u if cin == 4 else np.concatenate([u, np.full((nb, h, w, 1), 128, np.uint8)], -1))
    xs = (frames.reshape(nb, h // 2, 2, w // 2, 2, 4).permute(0, 1, 3, 2, 4, 5).reshape(nb, h // 2, w // 2, 16)
          .to(torch.int16) - 128).to(torch.int8)
    xp = torch.from_numpy(np.pad(xs.numpy(), ((0, 0), (2, 1), (2, 1), (0, 0))))
    xp[:, :2], xp[:, -1:], xp[:, :, :2], xp[:, :, -1:] = (torch.from_numpy(pad),) * 4
    want = conv_i8(xp, torch.from_numpy(wq).reshape(4, 4, 16, 64).permute(3, 0, 1, 2).contiguous(), pad=0).numpy()
    hc, wc, hp, wp = stem_sizes(h, w)
    assert want.shape == (nb, hc, wc, 64)
    for b in range(nb):
        seen = np.zeros((hc, wc), np.int32)
        for ty in range(-(-hp // pr)):
            for tx in range(-(-wp // pc)):
                for (cy, cx), acc in _k1_block_sums(u, wq.T.copy(), pad, b, pr, pc, ty, tx).items():
                    np.testing.assert_array_equal(acc, want[b, cy, cx].astype(np.int64), err_msg=f"{(b, cy, cx)}")
                    seen[cy, cx] += 1
        assert (seen >= 1).all()


def test_k1_requant_without_conversions_is_exact():
    """csrc/qstem.cu's requant_relu_exact, modelled in f32 with numpy (each
    operation rounds half to even, as __fadd_rn / __fmul_rn do), equals the
    f32 epilogue and requant of ops/qstem.qstem_plain for every int32 sum a
    K1 position can have (|acc| <= 256 * 128 * 127 < 2^22) and for ties:
    float(acc) through acc + 1.5 * 2^23, rounding through + 1.5 * 2^23."""
    magic = np.float32(12582912.0)
    acc = np.arange(-256 * 128 * 127, 256 * 128 * 127 + 1, dtype=np.int32)
    x = (acc + np.int32(0x4B400000)).view(np.float32) - magic
    np.testing.assert_array_equal(x, acc.astype(np.float32))
    rng = np.random.default_rng(7)
    for a, b in [(3.7e-5, -3.2), (1e-4, 0.5), (2.9e-5, 12.3), (6e-5, 0.0)] + [tuple(rng.uniform(1e-5, 1e-4, 2))]:
        y = x * np.float32(a) + np.float32(b)
        want = np.minimum(np.rint(np.maximum(y, np.float32(0))), np.float32(127)).astype(np.int32)
        got = (np.minimum(np.maximum(y, np.float32(0)), np.float32(127)) + magic).view(np.int32) & 0xFF
        np.testing.assert_array_equal(got, want)
    y = np.concatenate([np.arange(-2, 130, 0.5, dtype=np.float32), np.float32([np.nan, np.inf, -np.inf])])
    want = np.nan_to_num(np.minimum(np.rint(np.fmax(y, np.float32(0))), np.float32(127))).astype(np.int32)
    got = (np.fmin(np.fmax(y, np.float32(0)), np.float32(127)) + magic).view(np.int32) & 0xFF
    np.testing.assert_array_equal(got, want)


# K11 (batch, H, W, Cin, Cout): conv2 of the four ResNet-50 stages at the
# 512x512 canvas, odd sizes and a Cout that is not a multiple of 32
K11_SHAPES = [(128, 128, 64, 64), (64, 64, 128, 128), (32, 32, 256, 256), (16, 16, 512, 512), (13, 11, 32, 48),
              (5, 7, 16, 80)]
K11_CASES = [(b, *s) for b in (1, 2, 8, 64) for s in K11_SHAPES]
K11_IDS = [f"B{b}-{h}x{w}-{cin}to{cout}" for b, h, w, cin, cout in K11_CASES]


@pytest.mark.parametrize("case", K11_CASES, ids=K11_IDS)
def test_k11_blocks_cover_each_output_once(case):
    """Every (image, output position, output channel) belongs to exactly one
    thread block, as csrc/qconv3.cu's qconv3_kernel derives its tile
    (blockIdx / split, image-major) and channel slice (blockIdx % split)."""
    b, h, w, cin, cout = case
    tw, split = pick_conv3_tile(b, h, w, cin, cout, SM_COUNT, SMEM_MAX)
    ty, tx = -(-h // CONV3_TILE_ROWS), -(-w // tw)
    seen = np.zeros((b, ty * CONV3_TILE_ROWS, tx * tw, cout), np.int32)
    nc = cout // split
    for blk in range(conv3_blocks(b, h, w, tw, split)):
        tile, q = divmod(blk, split)
        img, rem = divmod(tile, ty * tx)
        y0, x0 = (rem // tx) * CONV3_TILE_ROWS, (rem % tx) * tw
        seen[img, y0:y0 + CONV3_TILE_ROWS, x0:x0 + tw, q * nc:(q + 1) * nc] += 1
    assert (seen[:, :h, :w] == 1).all()
    assert nc % 16 == 0 and tw in CONV3_TILE_WIDTHS


@pytest.mark.parametrize("case", K11_CASES, ids=K11_IDS)
def test_k11_tile_fits_shared_memory_two_an_sm_where_it_fills(case):
    """The block fits; where some tile gives every SM a block with two
    blocks' shared memory on an SM, the chooser's does."""
    b, h, w, cin, cout = case
    tw, split = pick_conv3_tile(b, h, w, cin, cout, SM_COUNT, SMEM_MAX)
    assert conv3_smem_bytes(tw, cin) <= SMEM_MAX
    two = lambda t: 2 * (conv3_smem_bytes(t[0], cin) + 1024) <= SMEM_MAX + 1024
    options = [(t, s) for t in CONV3_TILE_WIDTHS for s in CONV3_SPLITS if cout % (16 * s) == 0]
    if any(conv3_blocks(b, h, w, *o) >= SM_COUNT and two(o) for o in options):
        assert conv3_blocks(b, h, w, tw, split) >= SM_COUNT and two((tw, split))


@pytest.mark.parametrize("shape", K11_SHAPES[:4], ids=["128", "64", "32", "16"])
def test_k11_fills_the_card_at_b8(shape):
    """At B=8 every stage shape gives each SM a block, two an SM where its
    shared memory allows: on the 32x32 and 16x16 maps by channel slices."""
    h, w, cin, cout = shape
    tw, split = pick_conv3_tile(8, h, w, cin, cout, SM_COUNT, SMEM_MAX)
    assert conv3_blocks(8, h, w, tw, split) >= SM_COUNT
    assert 2 * (conv3_smem_bytes(tw, cin) + 1024) <= SMEM_MAX + 1024
    assert (split > 1) == (h <= 32), (h, tw, split)


def _segments():
    """(name, input (H, W, Cin), convs) of the three backbone chains at the
    512x512 canvas (C3: layer1_0 .. layer2_3, C4: layer3_*, C5: layer4_*)
    and an odd-sized one with mixed splits; convs per block (H, W, Cw,
    Cout, stride)."""
    shapes = resnet50_block_shapes()
    segs = [("c3", shapes[:7]), ("c4", shapes[7:13]), ("c5", shapes[13:])]
    out = [(name, seg[0][1:4], tuple((h, w, cw, cout, s) for _, h, w, _, cw, cout, s in seg)) for name, seg in segs]
    odd = ((13, 11, 16, 64, 1), (13, 11, 16, 64, 1), (13, 11, 32, 96, 2), (7, 6, 32, 96, 1))
    return out + [("odd", (13, 11, 32), odd)]


K13_CASES = [(b, seg) for b in (1, 2, 8, 64) for seg in _segments()]
K13_IDS = [f"B{b}-{seg[0]}" for b, seg in K13_CASES]


def chain_residency(convs, tiles, cluster):
    """Clusters of K13 that can be resident at once, as counted by the SMs'
    shared memory (at most two blocks an SM, the registers' cap): an upper
    bound on what cudaOccupancyMaxActiveClusters gives csrc/qchain.cu."""
    per_sm = 2 if two_per_sm(chain_smem_bytes(convs, tiles), SMEM_MAX) else 1
    return per_sm * SM_COUNT // cluster


@pytest.mark.parametrize("case", K13_CASES, ids=K13_IDS)
def test_k13_work_items_cover_each_output_once(case):
    """csrc/qchain.cu's persistent loop, run in Python: each resident
    cluster walks its rounds of tiles, rank r of a cluster of S taking tile
    base + r // s and channel slice r % s of a block whose split is s;
    every (image, output position, slice) of every block is taken once, and
    the grid is no larger than what can be resident."""
    b, (_, _, convs) = case
    tiles, cluster = pick_chain_tile(b, convs, SM_COUNT, SMEM_MAX)
    assert all(cluster % split == 0 for _, split in tiles) and cluster in SPLITS
    rounds = [-(-b * tile_blocks(*out_hw(h, w, s), tw) // (cluster // sp))
              for (h, w, _, _, s), (tw, sp) in zip(convs, tiles)]
    clusters = min(max(rounds), chain_residency(convs, tiles, cluster))
    assert 1 <= clusters * cluster <= 2 * SM_COUNT
    for (h, w, cw, cout, s), (tw, sp) in zip(convs, tiles):
        ho, wo = out_hw(h, w, s)
        n, per = b * tile_blocks(ho, wo, tw), cluster // sp
        seen = np.zeros((n, sp), np.int32)
        for cid in range(clusters):
            for base in range(cid * per, n, clusters * per):
                for rank in range(cluster):
                    if base + rank // sp < n:
                        seen[base + rank // sp, rank % sp] += 1
        assert (seen == 1).all()
        assert cw % (16 * sp) == 0 and cout % (16 * sp) == 0
        covered = np.zeros((b, ho, wo), np.int32)  # the tiles partition each image's map
        ty, tx = tile_grid(ho, wo, tw)
        for t in range(n):
            img, rem = divmod(t, ty * tx)
            covered[img, (rem // tx) * TILE_ROWS:(rem // tx + 1) * TILE_ROWS, (rem % tx) * tw:(rem % tx + 1) * tw] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("case", K13_CASES, ids=K13_IDS)
def test_k13_tiles_fit_one_launch(case):
    """The launch's shared memory (its largest tile) fits a block; where
    every block has a kernel C tile that leaves room for two blocks an SM,
    the chooser's do; otherwise each block's tile is kernel C's rule under
    one block an SM."""
    b, (_, _, convs) = case
    tiles, _ = pick_chain_tile(b, convs, SM_COUNT, SMEM_MAX)
    nbytes = chain_smem_bytes(convs, tiles)
    assert nbytes <= SMEM_MAX
    fits_two = all(two_per_sm(smem_bytes(s, 8, cw), SMEM_MAX) for _, _, cw, _, s in convs)
    assert two_per_sm(nbytes, SMEM_MAX) == fits_two
    if fits_two:
        assert tiles == tuple(pick_tile(b, h, w, cw, cout, s, SM_COUNT, SMEM_MAX) for h, w, cw, cout, s in convs)


@pytest.mark.parametrize("seg", _segments()[:3], ids=["c3", "c4", "c5"])
def test_k13_fills_the_card_at_b8(seg):
    """At B=8 every bottleneck of the three segments gives each SM at
    least one work item (tiles x cluster blocks)."""
    _, _, convs = seg
    tiles, _ = pick_chain_tile(8, convs, SM_COUNT, SMEM_MAX)
    for (h, w, _, _, s), (tw, sp) in zip(convs, tiles):
        assert 8 * tile_blocks(*out_hw(h, w, s), tw) * sp >= SM_COUNT, (h, s, tw, sp)


# K15 (ops/head.pick_fhead_tile): (batch, H, W, f, classes) at the fused-head
# pipeline's five levels of the 512x512 canvas, B = 1, 2, 8 and 64, and odd
# levels (the narrow head, 80 classes, 7x11 and 1x1 maps); on an H100 SXM
# (132 SMs) and an H100 PCIe (114)
FHEAD_CASES = (
    [(b, s, s, 256, 20, sm) for b in (1, 2, 8, 64) for s in (64, 32, 16, 8, 4) for sm in (132, 114)]
    + [(b, h, w, f, nc, 132) for b in (2, 64) for h, w, f, nc in ((7, 11, 64, 80), (1, 1, 256, 80), (16, 16, 64, 20))]
)
FHEAD_IDS = [f"B{b}-{h}x{w}-f{f}-{nc}cls-{sm}sm" for b, h, w, f, nc, sm in FHEAD_CASES]


@pytest.mark.parametrize("case", FHEAD_CASES, ids=FHEAD_IDS)
def test_fhead_tiles_fit_the_card(case):
    """Every K15 pass's block fits the shared memory, its M rows (images x
    a tile's positions) the GEMM tile (64 rows; pred's and the towers' on
    tiles of 8 x 16 128), its slice whole 16-channel groups, and its image
    groups grid.y."""
    b, h, w, f, nc, sm = case
    tile = pick_fhead_tile(b, h, w, f, nc, sm, SMEM_MAX)
    assert tuple(tile) == FHEAD_PASSES
    for pass_, (ipb, split, tw) in tile.items():
        assert (ipb, split, tw) in fhead_options(pass_, b, h, w, f, nc, SMEM_MAX), pass_
        assert fhead_smem_bytes(pass_, ipb, h, w, f, nc, split, tw) <= SMEM_MAX, pass_
        npos = fhead_tile_dims(h, w, tw)[0]
        assert ipb * npos <= fhead_rows(pass_, tw) <= 2 * FHEAD_ROWS, pass_
        assert -(-b // ipb) <= 65535 and tw in fhead_widths(pass_, w), pass_
        if pass_ != "pred":
            assert fhead_pass_width(pass_, f, nc) % (16 * split) == 0


@pytest.mark.parametrize("case", FHEAD_CASES, ids=FHEAD_IDS)
def test_fhead_blocks_cover_each_output_once_and_keep_gn_partials_apart(case):
    """The blocks of each pass (tile x image group x slice, as
    csrc/head.cu's blk_of derives them from blockIdx) cover every (image,
    position, output channel) once; every block row's GroupNorm sums land
    in its own image's partial row of its tile, so an (image, tile,
    channel) has one writer however many images a block holds, and each
    image's counter reaches tiles x slices, the fold's target, exactly."""
    b, h, w, f, nc, sm = case
    tile = pick_fhead_tile(b, h, w, f, nc, sm, SMEM_MAX)
    for pass_, (ipb, split, tw) in tile.items():
        tiles_x, tiles_y = -(-w // tw), -(-h // FHEAD_TILE)
        seen = np.zeros((b, h, w), np.int32)
        writers = np.zeros((b, tiles_x * tiles_y), np.int32)
        for t in range(tiles_x * tiles_y):
            r0, c0 = (t // tiles_x) * FHEAD_TILE, (t % tiles_x) * tw
            th, twc = min(FHEAD_TILE, h - r0), min(tw, w - c0)
            for grp in range(-(-b // ipb)):
                b0, nimg = grp * ipb, min(ipb, b - grp * ipb)
                for r in range(nimg * th * twc):  # row_pixel(): image r / npos, position r % npos
                    i, p = divmod(r, th * twc)
                    seen[b0 + i, r0 + p // twc, c0 + p % twc] += 1
                writers[b0:b0 + nimg, t] += 1
        assert (seen == 1).all(), pass_
        assert (writers == 1).all(), pass_  # per slice: one partial row per (image, tile)
        assert tiles_x * tiles_y <= -(-h // FHEAD_TILE) * -(-w // FHEAD_TILE)  # within the partials' rows
        assert (writers.sum(axis=1) * split == tiles_x * tiles_y * split).all()  # the fold's target
        if pass_ == "pred":  # 32 classes a block, then one block of cnt|reg
            chans = [k for z in range(split - 1) for k in range(z * FHEAD_PRED_NC, min(nc, z * FHEAD_PRED_NC + 32))]
            assert split == -(-nc // FHEAD_PRED_NC) + 1 and chans == list(range(nc))
        else:
            n = fhead_pass_width(pass_, f, nc)
            chans = sorted(k for z in range(split) for k in range(z * (n // split), (z + 1) * (n // split)))
            assert chans == list(range(n)), pass_


@pytest.mark.parametrize("case", FHEAD_CASES, ids=FHEAD_IDS)
def test_fhead_fills_the_card(case):
    """Each pass reaches one block per SM wherever some choice that fits
    does, else takes the most blocks; where its first option (the widest
    tile, the largest image group, whole channels) already reaches it at
    two blocks an SM, it keeps it.  pw1 and the towers on maps wider than 8
    take their wgmma kernels' 8x16 tiles: nine tenths of the SMs, or the
    most blocks those give."""
    b, h, w, f, nc, sm = case
    tile = pick_fhead_tile(b, h, w, f, nc, sm, SMEM_MAX)
    for pass_, opt in tile.items():
        options = fhead_options(pass_, b, h, w, f, nc, SMEM_MAX)
        wgmma = [o for o in options if pass_ in ("pw1", "towers") and o[2] == 16]
        if wgmma:  # the wgmma kernels' 8x16 tiles: nine tenths of the SMs, or the most blocks they give
            most = max(fhead_blocks(b, h, w, *o) for o in wgmma)
            assert opt in wgmma and 10 * fhead_blocks(b, h, w, *opt) >= min(9 * sm, 10 * most), pass_
            continue
        most = max(fhead_blocks(b, h, w, i, s, t) for i, s, t in options)
        got = fhead_blocks(b, h, w, *opt)
        assert got >= min(sm, most), f"{pass_}: {got} blocks of a possible {most}"
        first = options[0]
        if fhead_blocks(b, h, w, *first) >= sm and 2 * fhead_smem_bytes(pass_, first[0], h, w, f, nc, *first[1:]) \
                + 1024 <= SMEM_MAX:
            assert opt == first, pass_


def test_fhead_small_levels_split_channels_and_pack_images():
    """At B=8 the 4x4 to 16x16 levels split the towers' channels; at B=64
    the 4x4 level puts several images in a block; P3 at B=8 keeps whole
    channels."""
    for s in (16, 8, 4):
        assert pick_fhead_tile(8, s, s, 256, 20, SM_COUNT, SMEM_MAX)["towers"][1] > 1
    assert pick_fhead_tile(64, 4, 4, 256, 20, SM_COUNT, SMEM_MAX)["towers"][0] > 1
    assert pick_fhead_tile(8, 64, 64, 256, 20, SM_COUNT, SMEM_MAX)["towers"][1] == 1


@pytest.mark.parametrize("smem_max", [4096, 20000], ids=["4k", "20k"])
def test_fhead_chooser_raises_where_nothing_fits(smem_max):
    with pytest.raises(ValueError, match="K15"):
        pick_fhead_tile(8, 64, 64, 256, 20, SM_COUNT, smem_max)


# K12 (ops/qmnblock.pick_mn_tile): the MNFCOS int8 ladder's ten call shapes
# ((H=W, kernel, dilation): the pyramid's five blocks, the head's block1 and
# block2 at the five levels) at 256 -> 512 channels, B = 1, 2, 8 and 64, on
# 132 and 114 SMs, and odd maps (28x44, 7x11, 1x1) at 64 and 256 channels
MN_CALLS = [(16, 5, 2), (32, 3, 2), (64, 3, 1), (8, 5, 1), (4, 7, 1), (64, 3, 2), (32, 3, 2), (16, 3, 2), (8, 3, 2),
            (4, 3, 2)]
MN_CASES = (
    [(b, s, s, 256, k, d, sm) for b in (1, 2, 8, 64) for s, k, d in dict.fromkeys(MN_CALLS) for sm in (132, 114)]
    + [(3, h, w, c, k, d, 132) for h, w in ((28, 44), (7, 11), (1, 1)) for c in (64, 256) for k, d in ((5, 2), (7, 1))]
)
MN_IDS = [f"B{b}-{h}x{w}-C{c}-k{k}d{d}-{sm}sm" for b, h, w, c, k, d, sm in MN_CASES]


@pytest.mark.parametrize("case", MN_CASES, ids=MN_IDS)
def test_mn_tile_fits_the_card(case):
    """K12's tile fits the shared memory, its block at most 128 GEMM rows,
    its cluster split whole 16-channel groups of C and cmid, its image
    groups grid.y."""
    b, h, w, c, k, d, sm = case
    tw, ipb, split = pick_mn_tile(b, h, w, c, 2 * c, k, d, sm, SMEM_MAX)
    assert tw in MN_TILE_WIDTHS and split in MN_SPLITS and ipb in mn_ipbs(b, h, w, tw)
    assert (tw, ipb, split) in mn_options(b, h, w, c, 2 * c, k, d, SMEM_MAX)
    assert mn_smem_bytes(h, w, c, 2 * c, k, d, tw, ipb, split) <= SMEM_MAX
    assert mn_rows(h, w, tw, ipb) <= 128 and -(-b // ipb) <= 65535
    assert c % (16 * split) == 0 and (2 * c) % (16 * split) == 0


@pytest.mark.parametrize("case", MN_CASES, ids=MN_IDS)
def test_mn_blocks_cover_each_output_once(case):
    """K12's clusters (tile x image group, as csrc/qmnblock.cu's blk_of
    derives them from blockIdx) cover every (image, position) once, each
    block's staged window holds its rows' k x k taps inside the map, and the
    cluster's ranks cut pw1's and pw2's output channels into disjoint
    slices that cover them."""
    b, h, w, c, k, d, sm = case
    tw, ipb, split = pick_mn_tile(b, h, w, c, 2 * c, k, d, sm, SMEM_MAX)
    hd = d * (k - 1) // 2
    ry, rx = min(h, min(MN_TILE_ROWS, h) + 2 * hd), min(w, min(tw, w) + 2 * hd)
    ty, tx = mn_tiles(h, w, tw)
    seen = np.zeros((b, h, w), np.int32)
    for tile in range(ty * tx):
        r0, c0 = (tile // tx) * MN_TILE_ROWS, (tile % tx) * tw
        th, twc = min(MN_TILE_ROWS, h - r0), min(tw, w - c0)
        y0, x0 = max(0, r0 - hd), max(0, c0 - hd)
        ny, nx = min(h, r0 + th + hd) - y0, min(w, c0 + twc + hd) - x0
        assert ny <= ry and nx <= rx  # the window fits the staged region
        for oy in range(r0, r0 + th):
            for ox in range(c0, c0 + twc):
                taps_y = [oy - hd + j * d for j in range(k) if 0 <= oy - hd + j * d < h]
                taps_x = [ox - hd + j * d for j in range(k) if 0 <= ox - hd + j * d < w]
                assert all(y0 <= y < y0 + ny for y in taps_y) and all(x0 <= x < x0 + nx for x in taps_x)
        for grp in range(-(-b // ipb)):
            b0, nimg = grp * ipb, min(ipb, b - grp * ipb)
            for r in range(nimg * th * twc):
                i, p = divmod(r, th * twc)
                seen[b0 + i, r0 + p // twc, c0 + p % twc] += 1
    assert (seen == 1).all()
    for n in (2 * c, c):
        assert sorted(ch for q in range(split) for ch in range(q * n // split, (q + 1) * n // split)) == list(range(n))


@pytest.mark.parametrize("case", [m for m in MN_CASES if m[1] <= 16 and m[0] <= 8], ids=lambda m: MN_IDS[
    MN_CASES.index(m)])
def test_mn_fills_the_card_on_small_maps(case):
    """On the 4x4 to 16x16 maps at B <= 8 K12 takes at least three quarters
    of the most blocks any tile gives in one wave (at most one a SM, and
    clusters within the room the model gives them: three quarters of the
    SMs at two blocks an SM, nine tenths at one; clusters of up to 8 blocks
    a tile, images a tile from one), and its modelled time is the least of
    the tiles that fit."""
    b, h, w, c, k, d, sm = case
    tw, ipb, split = pick_mn_tile(b, h, w, c, 2 * c, k, d, sm, SMEM_MAX)
    opts = mn_options(b, h, w, c, 2 * c, k, d, SMEM_MAX)
    room = lambda o: sm if o[2] == 1 else sm * (0.75 if mn_per_sm(h, w, c, 2 * c, k, d, *o, SMEM_MAX) == 2 else 0.9)
    one_wave = max(mn_blocks(b, h, w, *o) for o in opts if mn_blocks(b, h, w, *o) <= room(o))
    assert 4 * mn_blocks(b, h, w, tw, ipb, split) >= 3 * one_wave
    cost = lambda o: mn_cost(b, h, w, c, 2 * c, k, *o, sm, mn_per_sm(h, w, c, 2 * c, k, d, *o, SMEM_MAX))
    assert cost((tw, ipb, split)) == min(cost(o) for o in opts)


def test_mn_small_maps_use_clusters_and_the_largest_halo_fits():
    """At B=8 the 4x4 to 16x16 maps split each tile across a cluster; k=7 on
    a 4x4 map (the largest halo of the ladder) fits with 8 images a tile,
    and the 4x4 and 8x8 maps may pack images."""
    for s, k, d in ((16, 3, 2), (8, 3, 2), (4, 3, 2), (4, 7, 1), (8, 5, 1)):
        assert pick_mn_tile(8, s, s, 256, 512, k, d, SM_COUNT, SMEM_MAX)[2] > 1
    assert mn_smem_bytes(4, 4, 256, 512, 7, 1, 8, 8, 1) <= SMEM_MAX
    assert (8, 8, 1) in mn_options(64, 4, 4, 256, 512, 7, 1, SMEM_MAX)
    assert (8, 2, 1) in mn_options(64, 8, 8, 256, 512, 3, 2, SMEM_MAX)


@pytest.mark.parametrize("smem_max", [8192, 40000], ids=["8k", "40k"])
def test_mn_chooser_raises_where_nothing_fits(smem_max):
    with pytest.raises(ValueError, match="K12"):
        pick_mn_tile(8, 64, 64, 256, 512, 7, 2, SM_COUNT, smem_max)


# ---------------------------------------------------------------- kernel B (GroupNorm + act)

# (B, C, H, W): the HISHead's ten GroupNorm shapes at 512x512, the COCO
# canvas's P3 slab (a cluster of 8 holds it in bf16 and f32), odd maps whose
# slabs start off the 16-byte grid (C = 64: 2 channels a group), a 1x1 map
GN_SHAPES = ([(b, c, s, s) for b in (1, 2, 8, 64) for s in (64, 32, 16, 8, 4) for c in (512, 256)]
             + [(b, 512, 112, 176) for b in (1, 2, 8)]
             + [(3, 256, 7, 11), (2, 64, 7, 11), (2, 64, 3, 5), (1, 32, 1, 1)])
GN_CASES = [(shape, itemsize) for shape in GN_SHAPES for itemsize in (2, 4)]
GN_IDS = [f"B{b}-C{c}-{h}x{w}-{'bf16' if i == 2 else 'f32'}" for (b, c, h, w), i in GN_CASES]


def gn_staged_units(tile, batch, channels, hw, groups, itemsize):
    """{slab: [(first unit, end unit, units, chunks) of each block that
    stages part of it]}, as csrc/gn.cu's gn_act_kernel derives a team's
    slab and its rank's chunk range from blockIdx and threadIdx: slab s's
    unit 0 starts (s * n) % (16 / itemsize) elements before it (x 16-byte
    aligned)."""
    unit, n = 16 // itemsize, channels // groups * hw
    _, cpr = gn_geometry(tile, gn_chunks(channels, hw, groups, itemsize))
    _, split, per_block = tile
    out = {}
    for blk in range(gn_blocks(tile, batch, groups)):
        rank = blk % split
        for j in range(per_block):
            s = blk // split * per_block + j
            if s >= batch * groups:
                continue
            nu = -(-((s * n) % unit + n) // unit)
            nc = -(-nu // GN_CHUNK_UNITS)
            k0 = rank * cpr
            out.setdefault(s, []).append((min(nu, k0 * GN_CHUNK_UNITS), min(nu, min(nc, k0 + cpr) * GN_CHUNK_UNITS),
                                          nu, nc))
    return out


@pytest.mark.parametrize("shape,itemsize", GN_CASES, ids=GN_IDS)
def test_gn_tile_covers_each_slab_once_and_fits(shape, itemsize):
    """Under the chooser's tile and every tile it weighs: each (image,
    group) slab's 16-byte units are staged by exactly one block, in whole
    4 KB chunks that no slab exceeds the chooser's count of; shared memory
    fits, a block has 8 warps, a cluster is at most 8 blocks, every rank
    holds a chunk; the chooser's pick is resident wherever a cluster holds
    the slab, stages at most 64 KB a block where a cluster allows, and
    fills the card at B=8."""
    b, c, h, w = shape
    nc = gn_chunks(c, h * w, 32, itemsize)
    options = gn_options(b, c, h * w, 32, itemsize, SMEM_MAX)
    pick = pick_gn_tile(b, c, h * w, 32, itemsize, SM_COUNT, SMEM_MAX)
    assert pick in options and any(t[0] == "stream" for t in options)
    if b == 8:
        assert gn_blocks(pick, b, 32) >= SM_COUNT
    if any(t[0] == "resident" for t in options):
        assert pick[0] == "resident"
        if nc <= 8 * GN_BLOCK_CHUNKS:
            assert gn_geometry(pick, nc)[1] <= GN_BLOCK_CHUNKS
    for tile in options:
        path, split, per_block = tile
        warps, cpr = gn_geometry(tile, nc)
        assert split in (1, 2, 4, 8) and (split == 1 or per_block == 1)
        assert per_block * warps == GN_MAX_WARPS and gn_smem_bytes(tile, nc, c // 32) <= SMEM_MAX
        assert cpr * split >= nc and (split == 1 or cpr * (split - 1) < nc)
        staged = gn_staged_units(tile, b, c, h * w, 32, itemsize)
        assert sorted(staged) == list(range(b * 32))
        for parts in staged.values():
            nu, nc_s = parts[0][2], parts[0][3]
            assert nc_s <= nc
            spans = sorted((lo, hi) for lo, hi, _, _ in parts if hi > lo)
            assert spans[0][0] == 0 and spans[-1][1] == nu
            assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
            assert all(lo % GN_CHUNK_UNITS == 0 for lo, _ in spans)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_gn_tile_picks_clusters_on_the_large_slabs_and_raises_where_nothing_fits(itemsize):
    """The 64x64 level's 128-256 KB C=512 slabs split across a cluster; the
    4x4 level packs slabs into blocks at B=64 but not at B=8, where one a
    block fills the card; the chooser raises where not even a group's
    (mul, add) table fits, and takes the streaming path where no cluster
    holds a slab."""
    assert pick_gn_tile(64, 512, 4096, 32, itemsize, SM_COUNT, SMEM_MAX)[1] > 1
    assert pick_gn_tile(64, 256, 16, 32, itemsize, SM_COUNT, SMEM_MAX)[2] > 1
    assert pick_gn_tile(8, 256, 16, 32, itemsize, SM_COUNT, SMEM_MAX)[2] == 1
    assert pick_gn_tile(2, 512, 1 << 20, 32, itemsize, SM_COUNT, SMEM_MAX)[0] == "stream"
    with pytest.raises(ValueError):
        pick_gn_tile(1, 32 * 30000, 1, 32, itemsize, SM_COUNT, SMEM_MAX)

# ---------------------------------------------------------------- K17 (the bf16 stem tail)


# (B, H, W) of the stem conv's output: the 512x512 and 896x1408 canvases, odd maps, a 2x2 one
K17_CASES = [(b, h, w) for b in (1, 2, 8, 64) for h, w in ((256, 256), (448, 704), (129, 97), (15, 21), (2, 2))]


@pytest.mark.parametrize("b,h,w", K17_CASES, ids=[f"B{b}-{h}x{w}" for b, h, w in K17_CASES])
def test_stem_tail_tile_covers_each_pooled_position_once_and_fits(b, h, w):
    """The chooser's band: five blocks share an SM; the bands and spans
    cover each pooled row and column once; each block's staged input rows
    and columns hold every window of its outputs; the card is filled where
    the map allows; the staged pixels as the chooser counts them; 8 x 8
    on the 512x512 canvas from B=2 up."""
    rows, cols = pick_stem_tail_tile(b, h, w, SM_COUNT, SMEM_MAX)
    assert rows in STEM_TAIL_ROWS and cols in STEM_TAIL_COLS
    assert STEM_TAIL_PER_SM * (stem_tail_smem_bytes(64, rows, cols) + 1024) <= SMEM_MAX + 1024
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    for n, step in ((ho, rows), (wo, cols)):
        first = list(range(0, n, step))
        covered = [o for f in first for o in range(f, min(n, f + step))]
        assert covered == list(range(n))
        for f in first:  # staged input rows (or columns) 2 f - 1 .. 2 (last) + 1: every window's
            last = min(n, f + step) - 1
            assert all(2 * f - 1 <= 2 * o + d <= 2 * last + 1 for o in range(f, last + 1) for d in (-1, 0, 1))
    blocks = stem_tail_blocks(b, h, w, rows, cols)
    assert blocks == b * -(-ho // rows) * -(-wo // cols)
    most = max(stem_tail_blocks(b, h, w, r, c) for r in STEM_TAIL_ROWS for c in STEM_TAIL_COLS
               if STEM_TAIL_PER_SM * (stem_tail_smem_bytes(64, r, c) + 1024) <= SMEM_MAX + 1024)
    assert blocks >= min(2 * SM_COUNT, most)
    staged = sum((2 * (min(ho, y + rows) - y) + 1) * (2 * (min(wo, x + cols) - x) + 1)
                 for y in range(0, ho, rows) for x in range(0, wo, cols))
    assert stem_tail_staged(h, w, rows, cols) == staged
    if (h, w) == (256, 256) and b >= 2:
        assert (rows, cols) == (8, 8)
    with pytest.raises(ValueError):
        pick_stem_tail_tile(b, h, w, SM_COUNT, 20000)


# ---------------------------------------------------------------- K10 (the int8 3x3/2 pool of the direct stem)
K10_CASES = [(b, h, w, c) for b in (1, 2, 8, 64) for h, w in ((256, 256), (448, 704), (129, 97), (15, 21), (2, 2))
             for c in (64, 32)]


@pytest.mark.parametrize("b,h,w,c", K10_CASES, ids=[f"B{b}-{h}x{w}x{c}" for b, h, w, c in K10_CASES])
def test_pool3_tile_covers_each_output_once_and_fits(b, h, w, c):
    """The chooser's band: POOL3_PER_SM blocks share an SM; the bands and
    spans cover each output row and column once; each block's staged input
    rows and columns hold every window of its outputs; the card is filled
    where the map allows, with the widest span, then the most rows, among
    those; 2 x 64 on the 512x512 stem map from B=3 up."""
    rows, cols = pick_pool3_tile(b, h, w, SM_COUNT, SMEM_MAX, c)
    fits = [(r, cl) for r in POOL3_ROWS for cl in POOL3_COLS
            if POOL3_PER_SM * (pool3_smem_bytes(c, r, cl) + 1024) <= SMEM_MAX + 1024]
    assert (rows, cols) in fits
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    for n, step in ((ho, rows), (wo, cols)):
        first = list(range(0, n, step))
        covered = [o for f in first for o in range(f, min(n, f + step))]
        assert covered == list(range(n))
        for f in first:  # staged input rows (or columns) 2 f - 1 .. 2 (last) + 1: every window's
            last = min(n, f + step) - 1
            assert all(2 * f - 1 <= 2 * o + d <= 2 * last + 1 for o in range(f, last + 1) for d in (-1, 0, 1))
    blocks = pool3_blocks(b, h, w, rows, cols)
    assert blocks == b * -(-ho // rows) * -(-wo // cols)
    filled = min(2 * SM_COUNT, max(pool3_blocks(b, h, w, *t) for t in fits))
    assert min(blocks, 2 * SM_COUNT) == filled
    assert cols == max(t[1] for t in fits if min(pool3_blocks(b, h, w, *t), 2 * SM_COUNT) == filled)
    if (h, w, c) == (256, 256, 64) and b >= 3:
        assert (rows, cols) == (2, 64)
    with pytest.raises(ValueError):
        pick_pool3_tile(b, h, w, SM_COUNT, 5000, c)


def _k10_block_model(x: np.ndarray, rows: int, cols: int, c16: int) -> np.ndarray:
    """One K10 launch in plain Python over x [H, W, C] int8: per block, the
    staged rows and columns clamped into the map (``qpool3_band``'s step 1),
    then each output word as the max of its nine staged words, its columns in
    the rotated order of odd output columns (step 2)."""
    h, w, c = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = np.full((ho, wo, c), 99, np.int8)
    for oy0 in range(0, ho, rows):
        for ox0 in range(0, wo, cols):
            nro, nco = min(rows, ho - oy0), min(cols, wo - ox0)
            iy = [min(max(2 * oy0 - 1 + r, 0), h - 1) for r in range(2 * nro + 1)]
            ix = [min(max(2 * ox0 - 1 + col, 0), w - 1) for col in range(2 * nco + 1)]
            st = x[iy][:, ix]  # [2 nro + 1, 2 nco + 1, C]: the staged words
            for oyl in range(nro):
                for oxl in range(nco):
                    rot = oxl & 1
                    m = st[2 * oyl, 2 * oxl + rot]
                    for dy in range(3):
                        for k in range(3):
                            dx = k + rot if k + rot < 3 else k + rot - 3
                            m = np.maximum(m, st[2 * oyl + dy, 2 * oxl + dx])
                    out[oy0 + oyl, ox0 + oxl] = m
    return out


@pytest.mark.parametrize("shape,tile", [((9, 13, 32), (2, 8)), ((16, 16, 16), (1, 8)), ((7, 300, 16), (4, 64)),
                                        ((33, 5, 48), (8, 128)), ((1, 1, 16), (2, 64)), ((20, 22, 64), (2, 64))])
def test_k10_block_model_equals_the_plain_pool(shape, tile):
    """The clamped staging needs no pad value: a row or column outside the
    map is staged as its clamped neighbour, which lies in the same window,
    so the model of the kernel's blocks equals the plain pool with -128
    padding, bit for bit, on every band (odd and even sizes, 1x1)."""
    x = np.random.default_rng(sum(shape)).integers(-128, 128, shape).astype(np.int8)
    want = qmaxpool3x3s2_plain(torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_array_equal(_k10_block_model(x, *tile, shape[2] // 16), want)


@pytest.mark.parametrize("nco", [64, 16, 8])
def test_k10_quarter_warp_reads_cover_all_banks(nco):
    """At 64 channels (four 16-byte words a pixel) a quarter warp (8 threads)
    reads two output positions' words of a tap row at a time; with the odd
    column's rotated tap order its 16-byte reads fall on distinct 4-bank
    groups, or on the same word (a broadcast), at every step."""
    c16 = 4
    for o0 in range(0, 2 * nco * c16, 8):  # the quarter warps of two band rows
        for k in range(3):
            words = {}
            for o in range(o0, o0 + 8):
                p, q = divmod(o, c16)
                oxl = p % nco
                rot = oxl & 1
                dx = k + rot if k + rot < 3 else k + rot - 3
                word = (2 * oxl + dx) * c16 + q
                words.setdefault(word % 8, set()).add(word)
            assert all(len(ws) == 1 for ws in words.values()), (o0, k, words)
