"""The tile choosers of kernel C (``ops/qblock.pick_tile``), K4
(``ops/qconv.pick_qmm_tile``), K16 (``ops/fused.pick_k16_tile``), K7/K9
(``ops/qhead.pick_head_tile``) and K5 (``ops/qhis.pick_his_tile``), in
plain Python with an H100's limits: 132 SMs and 232,448 bytes of shared
memory a block may opt in to.

Kernel C at the 16 ResNet-50 bottlenecks of the 512x512 canvas, B = 1, 2, 8
and 64; K4 at the HisFPN's three laterals and the per-conv backend's 36
bottleneck 1x1 convs, B = 2, 8 and 64; K16 at the fused ResNet-50's 32
conv1/conv3 GEMMs, B = 2, 8 and 64, and odd shapes; K7 at the five head
levels of the 512x512 canvas and K7/K9 at those of the 896x1408 COCO
canvas, with narrow heads, 80 classes and 1x1 levels; K5 at the seven
HisBlocks of the 512x512 canvas, B = 1, 2, 8 and 64, narrow blocks, odd
sizes and 1x1 maps.  No card and no JAX needed.
"""
from __future__ import annotations

import numpy as np
import pytest

from pytorch_object_detection_tpu_torch.ops.qblock import (
    TILE_ROWS, out_hw, pick_tile, recompute_factor, smem_bytes, tile_grid)
from pytorch_object_detection_tpu_torch.ops.fused import K16_BM, k16_smem_bytes, pick_k16_tile
from pytorch_object_detection_tpu_torch.ops.qconv import QMM_BM, QMM_STEP, pick_qmm_tile, qmm_smem_bytes
from pytorch_object_detection_tpu_torch.ops.qhead import (
    HEAD_PASSES, HEAD_TILE, PRED_NC, head_blocks, head_ipbs, head_pass_width, head_slices, head_smem_bytes,
    head_tile_dims, pick_head_tile)
from pytorch_object_detection_tpu_torch.ops.qhis import (
    HIS_KERNELS, HIS_ROWS, HIS_TILE, his_blocks, his_chunk, his_ipbs, his_slices, his_smem_bytes, his_width,
    pick_his_tile)
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
