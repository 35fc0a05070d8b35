"""The tile choosers of kernel C (``ops/qblock.pick_tile``) and K4
(``ops/qconv.pick_qmm_tile``), in plain Python with an H100's limits: 132
SMs and 232,448 bytes of shared memory a block may opt in to.

Kernel C at the 16 ResNet-50 bottlenecks of the 512x512 canvas, B = 1, 2, 8
and 64; K4 at the HisFPN's three laterals and the per-conv backend's 36
bottleneck 1x1 convs, B = 2, 8 and 64.  No card and no JAX needed.
"""
from __future__ import annotations

import numpy as np
import pytest

from pytorch_object_detection_tpu_torch.ops.qblock import (
    TILE_ROWS, out_hw, pick_tile, recompute_factor, smem_bytes, tile_grid)
from pytorch_object_detection_tpu_torch.ops.qconv import QMM_BM, QMM_STEP, pick_qmm_tile, qmm_smem_bytes
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
