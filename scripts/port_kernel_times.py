"""Time the port's kernels C, K4, K16, K7, K9, K5, A, K1, K11, K13, K15, K12, B and K17 on one NVIDIA GPU.

Kernel C (``ops/qblock.qbottleneck`` / ``qbottleneck_s2``) at the 16
ResNet-50 bottlenecks of the 512x512 canvas, K4 (``ops/qconv.qmatmul``)
at the HisFPN's three laterals and the per-conv backend's 36 bottleneck 1x1
convs, K16 (``ops/fused.matmul_bn_act``) at the fused backbone's 32 conv1
and conv3 GEMMs beside ``torch.matmul`` on the same bf16 operands, and K7
(``ops/qhead.qhishead_level``) at the default pipeline's five head levels
(C=256, 20 classes), each at B=8 and B=64; then K9 (``qhishead_level2``)
against K7 at the COCO canvas's P3 (112x176, 80 classes), B=2 and B=8; K5
(``ops/qhis.qhisblock``) at the default pipeline's seven HisBlocks (his1
16x16, his2 32x32 and his3 64x64 with ``up_add``, his4 32x32 to his7 4x4
with ``add``; 256 channels), B=8 and B=64, with its T multiply-adds/s;
and kernel A (``ops/cuda_nms.cuda_nms_keep_mask``) on score-sorted,
class-shifted boxes at K=1000, B=8 and B=64; and K1
(``ops/qstem.qstem_conv``, the uint8 stem with its pool) on raw 3-channel
frames at 512x512, B=8 and B=64, and at the 896x1408 COCO canvas, B=2.
The inputs and weights are
random, from a seed; the head's qtree comes from a random
``models/heads.HISHead`` through ``models/head_int8``'s calibration and
quantization, the HisBlocks' from a random ``nn/fpn.HisFPN`` through
``nn/fpn_int8``'s, the stem's from a random ``nn/resnet.ResNet50`` through
``nn/resnet_int8``'s calibration and ``quantize_stem_s2d``.  For kernel C,
K7, K9, K5, K1, K11 and K13 the script prints a SHA-256 digest of the
output bytes, for kernel A
of the keep mask, so that two checkouts' outputs can be compared.
Only the wrappers' public arguments are used, so the same script times the
package of another checkout of the repository (``--root``), e.g. the parent
commit unpacked with ``git archive``; run the two in turns (a, b, b, a) in
one run on one card to compare them::

    python3 scripts/port_kernel_times.py --root . --out times.json

``--only his,nms`` times only the named sections (``c``, ``k4``, ``k16``,
``head``, ``his``, ``nms``, ``stem``; ``k11``: K11 (``ops/qconv.qconv3x3``)
at the per-conv backend's four conv2 stage shapes beside its plain version,
B=8 and B=64; ``k13``: K13 (``ops/qchain.qchain``) on the three backbone
segments beside kernel C's launches on the same input, in turns, B=8 and
B=64; each with digests of the outputs, kernel C's in section ``c`` too;
``k13blocks``, this tree's package only (it forces ``tile=``): K13 on
one bottleneck at a time against kernel C on the same tile, at the 16
block shapes, B=8 and B=64; ``k15``: K15 (``ops/head.hishead_level_fused``)
at the fused-head pipeline's five levels (256 features, 20 classes), B=8
and B=64, beside the bf16 float head at the same levels, with its device
time by CUDA kernel (``torch.profiler``), its error against the plain
version and, with ``--ref DIR``, the share of its values that moved from
the first run's (saved there); ``k12``: K12 (``ops/qmnblock.qmnblock``)
at the MNFCOS int8 ladder's 15 calls, B=8 and B=64, with digests; both
print their bound, rate and ptxas' registers and spills where this process
built the kernel; ``gn``: kernel B (``ops/gn.groupnorm_act``) at the
HISHead's 20 GroupNorm calls of a forward (bf16 maps, scale and bias),
B=8 and B=64, with its host time, bound and share of it, ``F.group_norm``
then the activation beside it, digests and (``--ref``) the share of values
moved; ``k17``: K17 (``ops/stem.stem_bn_pool_quant``) at [B, 256, 256, 64],
B=8 and B=64, and an odd map, and the stem-tail path's whole stem, with
digests; ``pipes``: img/s at B=8 and B=64 of the six pipelines that run B
or K17 and a B=64 profile of the stem-tail pipeline split into B, K17, the
copy kernels and the rest; ``gntile`` and ``k17tile``, this tree's package
only (they force ``tile=``): B at the head's shapes and the COCO canvas's
P3 under every tile of ``ops/gn.gn_options``, K17 under every band that
fits, the choosers' picks marked; ``k10``: K10 (``ops/qpool.qmaxpool3x3s2``)
at the direct stem's map [B, 256, 256, 64], B=8 and B=64, the COCO
canvas's [2, 448, 704, 64] and two odd maps (one with C = 24), back to back,
from a graph and its host time, with its bound and digests; ``k10tile``,
this tree's package only: K10 under every band that fits two blocks an SM,
``ops/qpool.pick_pool3_tile``'s marked, each output held equal to the
chooser's; and ``stemtile``, this tree's package
only, since it needs ``qstem_conv``'s ``tile=``: K1 at 512x512, B=1, 2 and
8, and at the COCO canvas, B=1 and 2, under ``ops/qstem.pick_stem_tile``'s
tile and forced smaller ones, its outputs held equal to the chooser's).

``--sweep`` (this tree's package only: it needs the ``tile=`` override of
``qbottleneck``) times kernel C instead at every (tile width, blocks per
tile) that fits, per block shape at B=8 and B=64, replayed from a CUDA
graph, and marks ``ops/qblock.pick_tile``'s choice with ``*``.

Each time is ms per call between CUDA events, median of 5 repetitions,
taken two ways: calls issued back to back from Python (the wrapper's host
time counts where the card waits for it), and the same calls replayed
from a CUDA graph (the card's time alone).  Prints one line per shape and,
last, a JSON object with every time and the card's name and power limit.
Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path


def cuda_ms(fn, iters: int, reps: int = 5) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def graph_ms(fn, iters: int, reps: int = 5) -> float:
    """ms per call of ``iters`` calls captured in one CUDA graph and
    replayed: device time, with no host launch cost between the calls;
    NaN where the calls cannot be captured."""
    import torch

    try:
        return _graph_ms(fn, iters, reps)
    except RuntimeError as err:
        print(f"  not measured: the calls could not be captured in a CUDA graph ({str(err).splitlines()[0]})")
        torch.cuda.synchronize()
        return float("nan")


def _graph_ms(fn, iters: int, reps: int) -> float:
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(per_call)


def block_shapes():
    """(scope, H, W, Cin, Cw, Cout, stride) of the 16 bottlenecks at 512x512 (the stem divides by 4)."""
    shapes, h, cin = [], 128, 64
    for stage, (blocks, cw) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            shapes.append((f"layer{stage + 1}_{b}", h, h, cin, cw, 4 * cw, stride))
            h, cin = (h - 1) // stride + 1, 4 * cw
    return shapes


def sweep(qblock, block_operands, card) -> int:
    """Kernel C at every tile width and cluster size that fits, per block
    shape, B=8 and B=64, replayed from CUDA graphs; ``*`` marks the
    chooser's pick.  Prints the sums of the fastest and of the picked."""
    import torch

    sm_count, smem_max = qblock.card_limits(torch.device("cuda"))
    best, picked = {8: 0.0, 64: 0.0}, {8: 0.0, 64: 0.0}
    with torch.inference_mode():
        for (scope, h, w, cin, cw, cout, stride), x64, call in block_operands():
            for b in (8, 64):
                x = x64[:b].contiguous()
                pick = qblock.pick_tile(b, h, w, cw, cout, stride, sm_count, smem_max)
                times = {}
                for tw in (16, 8):
                    for split in (1, 2, 4, 8):
                        if cw % (16 * split) or cout % (16 * split) or qblock.smem_bytes(stride, tw, cw) > smem_max:
                            continue
                        times[(tw, split)] = graph_ms(lambda: call(x, tile=(tw, split)), iters=10 if b == 8 else 3)
                line = ", ".join(f"8x{tw}/{split} {v:.4f}{'*' if (tw, split) == pick else ''}"
                                 for (tw, split), v in times.items())
                print(f"kernel C {scope} B={b}: {line}", flush=True)
                best[b] += min(times.values())
                picked[b] += times[pick]
    for b in (8, 64):
        print(f"kernel C, the 16 blocks at B={b}: fastest tiles {best[b]:.4f} ms, picked {picked[b]:.4f} ms {card}")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="checkout whose pytorch_object_detection_tpu_torch is timed")
    parser.add_argument("--out", default=None, help="also write the JSON object here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ref", default=None,
                        help="sections k15 and gn: a directory for the reference outputs (saved by the first run "
                             "that finds none, compared by the later ones)")
    parser.add_argument("--sweep", action="store_true", help="kernel C at every tile and cluster size that fits")
    parser.add_argument("--only", default="c,k4,k16,head,his,nms,stem",
                        help="comma-separated sections: c, k4, k16, head, his, nms, stem, stemtile, k11, k13, "
                             "k13blocks, k15, k12, gn, k17, pipes, gntile, k17tile, k10, k10tile")
    args = parser.parse_args()
    only = set(args.only.split(","))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_object_detection_tpu_torch.ops import qblock, qconv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0] if smi else "not measured"
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def i8(*shape):
        return torch.from_numpy(rng.integers(-16, 16, shape).astype(np.int8)).to(dev)

    def vec(n, k):
        a = torch.from_numpy((np.abs(rng.normal(size=n)) * 0.06 / np.sqrt(k) + 1e-4).astype(np.float32)).to(dev)
        return a, torch.from_numpy(rng.normal(0.0, 5.0, n).astype(np.float32)).to(dev)

    short_mul = torch.tensor(0.7, dtype=torch.float32, device=dev)

    def block_operands():
        """(shape, x [64, H, W, Cin], call(x, **kw)) of each bottleneck, weights from the seed."""
        for shape in block_shapes():
            scope, h, w, cin, cw, cout, stride = shape
            w1, w2, w3 = i8(cw, cin), i8(cw, 3, 3, cw), i8(cout, cw)
            (a1, b1), (a2, b2), (a3, b3) = vec(cw, cin), vec(cw, 9 * cw), vec(cout, cw)
            proj = scope.endswith("_0")
            wd = i8(cout, cin) if proj else None
            ad, bd = vec(cout, cin)
            x64 = torch.from_numpy(rng.integers(-127, 128, (64, h, w, cin)).astype(np.int8)).to(dev)
            if stride == 2:
                call = lambda x, wd=wd, **kw: qblock.qbottleneck_s2(x, w1, w2, w3, wd, a1, b1, a2, b2, a3, b3, ad, bd,
                                                                    **kw)
            elif proj:
                call = lambda x, wd=wd, **kw: qblock.qbottleneck(x, w1, w2, w3, a1, b1, a2, b2, a3, b3, wd=wd, ad=ad,
                                                                 bd=bd, **kw)
            else:
                call = lambda x, **kw: qblock.qbottleneck(x, w1, w2, w3, a1, b1, a2, b2, a3, b3, short_mul=short_mul,
                                                          **kw)
            yield shape, x64, call

    if args.sweep:
        return sweep(qblock, block_operands, card)
    result = {"root": str(Path(args.root).resolve()), "card": card, "kernel_c": {}, "k4": {}, "k16": {}, "k7": {},
              "k9": {}, "k5": {}, "nms": {}, "k1": {}, "k11": {}, "k13": {}, "digest": {}}
    with torch.inference_mode():
        if "c" in only:
            time_kernel_c(result, block_operands, card)
        if "k4" in only:
            time_k4(result, qconv, i8, vec, card)
        if "k16" in only:
            time_k16(result, dev, args.seed, card)
        if "head" in only:
            time_head(result, dev, args.seed, card)
        if "his" in only:
            time_his(result, dev, args.seed, card)
        if "nms" in only:
            time_nms(result, dev, args.seed, card)
        if "stem" in only:
            time_stem(result, dev, args.seed, card)
        if "stemtile" in only:
            time_stem_tiles(result, dev, args.seed, card)
        if "k11" in only:
            time_k11(result, qconv, i8, vec, card)
        if "k13" in only:
            time_k13(result, qblock, i8, vec, card)
        if "k13blocks" in only:
            time_k13_blocks(result, qblock, i8, vec, card)
        if "k15" in only:
            time_k15(result, dev, args.seed, card, args.ref)
        if "k12" in only:
            time_k12(result, dev, args.seed, card)
        if "gn" in only:
            time_gn(result, dev, args.seed, card, args.ref)
        if "k17" in only:
            time_k17(result, dev, args.seed, card)
        if "pipes" in only:
            time_pipes(result, dev, args.seed, card)
        if "gntile" in only:
            time_gn_tiles(result, dev, args.seed, card)
        if "k17tile" in only:
            time_k17_tiles(result, dev, args.seed, card)
        if "k10" in only:
            time_k10(result, dev, args.seed, card)
        if "k10tile" in only:
            time_k10_tiles(result, dev, args.seed, card)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


def time_kernel_c(result, block_operands, card) -> None:
    for (scope, *_), x64, call in block_operands():
        for b in (8, 64):
            x = x64[:b].contiguous()
            fn = lambda: call(x)
            result["digest"][f"c/{scope}/B{b}"] = digest([fn()])
            ms = cuda_ms(fn, iters=10 if b == 8 else 3)
            dev_ms = graph_ms(fn, iters=10 if b == 8 else 3)
            result["kernel_c"][f"{scope}/B{b}"] = ms
            result["kernel_c"][f"{scope}/B{b}/graph"] = dev_ms
            print(f"kernel C {scope} B={b} {tuple(x.shape)}: {ms:.4f} ms, graph {dev_ms:.4f} ms, digest "
                  f"{result['digest'][f'c/{scope}/B{b}']}", flush=True)
    for b in (8, 64):
        tot = [sum(v for k, v in result["kernel_c"].items() if k.endswith(f"/B{b}{sfx}")) for sfx in ("", "/graph")]
        print(f"kernel C, the 16 blocks at B={b}: {tot[0]:.4f} ms, graph {tot[1]:.4f} ms {card}")


def time_k4(result, qconv, i8, vec, card) -> None:
    import torch

    gemms = [(f"tf{i + 1}", hw * hw, c, 256) for i, (hw, c) in enumerate(((16, 2048), (32, 1024), (64, 512)))]
    for scope, h, w, cin, cw, cout, stride in block_shapes():
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        gemms += [(f"{scope}.conv1", h * w, cin, cw), (f"{scope}.conv3", ho * wo, cw, cout)]
        if scope.endswith("_0"):
            gemms.append((f"{scope}.shortcut", ho * wo, cin, cout))
    for b in (8, 64):
        for name, m_img, k, n in gemms:
            m = b * m_img
            x, wt = i8(m, k), i8(n, k)
            a, bb = vec(n, k)
            it = 10 if b == 8 else 3
            times = {"": cuda_ms(lambda: qconv.qmatmul(x, wt, a, bb), iters=it),
                     "/graph": graph_ms(lambda: qconv.qmatmul(x, wt, a, bb), iters=it),
                     "/int_mm": cuda_ms(lambda: torch._int_mm(x, wt.t()), iters=it),
                     "/int_mm/graph": graph_ms(lambda: torch._int_mm(x, wt.t()), iters=it)}
            for sfx, v in times.items():
                result["k4"][f"{name}/B{b}{sfx}"] = v
            print(f"K4 {name} B={b} [{m}, {k}] x [{k}, {n}]: {times['']:.4f} ms (graph {times['/graph']:.4f}), "
                  f"torch._int_mm {times['/int_mm']:.4f} ms (graph {times['/int_mm/graph']:.4f})", flush=True)
        for sfx in ("", "/graph"):
            lat = sum(result["k4"][f"tf{i}/B{b}{sfx}"] for i in (1, 2, 3))
            lib = sum(result["k4"][f"tf{i}/B{b}/int_mm{sfx}"] for i in (1, 2, 3))
            conv = sum(result["k4"][f"{g[0]}/B{b}{sfx}"] for g in gemms[3:])
            conv_lib = sum(result["k4"][f"{g[0]}/B{b}/int_mm{sfx}"] for g in gemms[3:])
            print(f"K4 at B={b}{' graph' if sfx else ''}: the 3 laterals {lat:.4f} ms (torch._int_mm {lib:.4f}), "
                  f"the 36 per-conv 1x1s {conv:.4f} ms (torch._int_mm {conv_lib:.4f}) {card}")


def full_i8(shape, seed):
    """int8 activations over the whole range, from a seed."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).cuda()


def time_k11(result, qconv, i8, vec, card) -> None:
    """K11 at the per-conv backend's 13 conv2 shapes (four stage shapes, run
    3, 3, 5 and 2 times a forward) beside its plain version, B=8 and B=64."""
    import torch

    for b in (8, 64):
        tot = {"": 0.0, "/graph": 0.0, "/plain": 0.0}
        for hw, c, n in ((128, 64, 3), (64, 128, 3), (32, 256, 5), (16, 512, 2)):
            x, wt = full_i8((b, hw, hw, c), hw), i8(c, 3, 3, c)
            a, bb = vec(c, 9 * c)
            fn = lambda: qconv.qconv3x3(x, wt, a, bb)
            key = f"{hw}x{hw}x{c}/B{b}"
            result["digest"][f"k11/{key}"] = digest([fn()])
            it = 10 if b == 8 else 3
            times = {"": cuda_ms(fn, iters=it), "/graph": graph_ms(fn, iters=it),
                     "/plain": cuda_ms(lambda: qconv.qconv3x3(x, wt, a, bb, plain=True), iters=2, reps=3)}
            for sfx, v in times.items():
                result["k11"][f"{key}{sfx}"] = v
                tot[sfx] += n * v
            macs = b * hw * hw * 9 * c * c
            print(f"K11 {key} ({n} a forward): {times['']:.4f} ms (graph {times['/graph']:.4f}, "
                  f"{macs / times['/graph'] / 1e9:.1f} T multiply-adds/s), plain {times['/plain']:.4f} ms, digest "
                  f"{result['digest'][f'k11/{key}']}, {float((fn() > 0).float().mean()):.3f} positive", flush=True)
        print(f"K11 per per-conv forward (13 launches) B={b}: {tot['']:.4f} ms, graph {tot['/graph']:.4f}, plain "
              f"{tot['/plain']:.4f} {card}")


def qtree_block(shape, i8, vec):
    """(blk, stride): a random bottleneck of ``block_shapes()``'s ``shape``
    in the backbone qtree's layout (the chain's input format)."""
    import torch

    scope, h, w, cin, cw, cout, stride = shape
    blk = dict(w1=i8(cw, cin), w2=i8(cw, 3, 3, cw), w3=i8(cout, cw))
    for k, (n, depth) in (("1", (cw, cin)), ("2", (cw, 9 * cw)), ("3", (cout, cw))):
        blk[f"A{k}"], blk[f"B{k}"] = vec(n, depth)
    if scope.endswith("_0"):
        blk["wd"] = i8(cout, cin)
        blk["Ad"], blk["Bd"] = vec(cout, cin)
    else:
        blk["short_mul"] = torch.tensor(0.7, dtype=torch.float32, device="cuda")
    return blk, stride


def kernel_c_chain(qblock, x, blocks, tiles=None):
    """The chain's bottlenecks as kernel C launches, one a block (``tiles``:
    each block's forced ``(tw, split)``)."""
    for i, (blk, stride) in enumerate(blocks):
        v = dict(a1=blk["A1"], b1=blk["B1"], a2=blk["A2"], b2=blk["B2"], a3=blk["A3"], b3=blk["B3"])
        if tiles is not None:
            v["tile"] = tiles[i]
        if stride == 2:
            x = qblock.qbottleneck_s2(x, blk["w1"], blk["w2"], blk["w3"], blk["wd"], ad=blk["Ad"], bd=blk["Bd"], **v)
        elif "wd" in blk:
            x = qblock.qbottleneck(x, blk["w1"], blk["w2"], blk["w3"], wd=blk["wd"], ad=blk["Ad"], bd=blk["Bd"], **v)
        else:
            x = qblock.qbottleneck(x, blk["w1"], blk["w2"], blk["w3"], short_mul=blk["short_mul"], **v)
    return x


def time_k13_blocks(result, qblock, i8, vec, card) -> None:
    """K13 on one bottleneck at a time against kernel C on the same tile
    (kernel C's chooser's, forced on both with ``tile=``), at the 16 block
    shapes, B=8 and B=64: the chain's cost a tile, apart from its
    residency and grid barriers; this tree's package only."""
    import torch
    from pytorch_object_detection_tpu_torch.ops import qchain

    sm_count, smem_max = qblock.card_limits(torch.device("cuda"))
    for shape in block_shapes():
        scope, h, w, cin, cw, cout, stride = shape
        blocks = [qtree_block(shape, i8, vec)]
        x64 = full_i8((64, h, w, cin), h)
        for b in (8, 64):
            x = x64[:b].contiguous()
            tile = qblock.pick_tile(b, h, w, cw, cout, stride, sm_count, smem_max)
            want = kernel_c_chain(qblock, x, blocks, [tile])
            got = qchain.qchain(x, blocks, tile=tile)
            it = 10 if b == 8 else 3
            kc = cuda_ms(lambda: kernel_c_chain(qblock, x, blocks, [tile]), iters=it)
            k13 = cuda_ms(lambda: qchain.qchain(x, blocks, tile=tile), iters=it)
            result["k13"][f"{scope}/B{b}/one"] = k13
            result["k13"][f"{scope}/B{b}/one/kernel_c"] = kc
            print(f"K13 one block {scope} B={b} tile {tile}: {k13:.4f} ms, kernel C {kc:.4f} ms (K13/C {k13 / kc:.3f}), "
                  f"grid {qchain.qchain.grid}, {'equal' if torch.equal(got, want) else 'DIFFERENT'} {card}",
                  flush=True)


def time_k13(result, qblock, i8, vec, card) -> None:
    """K13 on the three backbone segments beside kernel C's launches on the
    same input and weights, in turns (K13, C, C, K13), B=8 and B=64."""
    import torch
    from pytorch_object_detection_tpu_torch.ops import qchain

    shapes = block_shapes()
    segments = [("c3", shapes[:7]), ("c4", shapes[7:13]), ("c5", shapes[13:])]
    for name, seg in segments:
        blocks = [qtree_block(shape, i8, vec) for shape in seg]
        kernel_c = lambda x: kernel_c_chain(qblock, x, blocks)

        _, h, w, cin, *_ = seg[0]
        x64 = full_i8((64, h, w, cin), h)
        for b in (8, 64):
            x = x64[:b].contiguous()
            key = f"{name}/B{b}"
            got, want = qchain.qchain(x, blocks), kernel_c(x)
            result["digest"][f"k13/{key}"] = digest([got])
            result["digest"][f"k13/{key}/kernel_c"] = digest([want])
            it = 10 if b == 8 else 3
            k13 = lambda: qchain.qchain(x, blocks)
            kc = lambda: kernel_c(x)
            times = {"": [cuda_ms(k13, iters=it)], "/kernel_c": [cuda_ms(kc, iters=it), cuda_ms(kc, iters=it)]}
            times[""].append(cuda_ms(k13, iters=it))
            times["/graph"] = [graph_ms(k13, iters=it)]
            times["/kernel_c/graph"] = [graph_ms(kc, iters=it)]
            for sfx, v in times.items():
                result["k13"][f"{key}{sfx}"] = statistics.mean(v)
            print(f"K13 {key} ({len(blocks)} blocks) {tuple(x.shape)}: {times[''][0]:.4f}/{times[''][1]:.4f} ms "
                  f"(graph {times['/graph'][0]:.4f}), kernel C {times['/kernel_c'][0]:.4f}/"
                  f"{times['/kernel_c'][1]:.4f} ms (graph {times['/kernel_c/graph'][0]:.4f}); grid "
                  f"{qchain.qchain.grid}; digests {result['digest'][f'k13/{key}']} / kernel C "
                  f"{result['digest'][f'k13/{key}/kernel_c']}, {float((got > 0).float().mean()):.3f} positive",
                  flush=True)
    for b in (8, 64):
        for sfx in ("", "/graph"):
            k = sum(result["k13"][f"{n}/B{b}{sfx}"] for n, _ in segments)
            c = sum(result["k13"][f"{n}/B{b}/kernel_c{sfx}"] for n, _ in segments)
            print(f"K13 per forward (3 launches) B={b}{' graph' if sfx else ''}: {k:.4f} ms, kernel C's 16 launches "
                  f"{c:.4f} ms (K13/C {k / c:.3f}) {card}")


def k16_gemms():
    """(name, M per image, K, N, residual) of the fused ResNet-50's 32 1x1
    GEMMs at 512x512: each block's conv1 on its input grid, conv3 (with the
    shortcut as the residual) on its output grid."""
    out = []
    for scope, h, w, cin, cw, cout, stride in block_shapes():
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        out += [(f"{scope}.conv1", h * w, cin, cw, False), (f"{scope}.conv3", ho * wo, cw, cout, True)]
    return out


def time_k16(result, dev, seed, card) -> None:
    """K16 at the 32 GEMMs, B=8 and B=64, beside torch.matmul on the same
    bf16 operands (no epilogue); sums per forward, with the TFLOP/s."""
    import torch

    from pytorch_object_detection_tpu_torch.ops import fused

    g = torch.Generator(device=dev).manual_seed(seed)
    for b in (8, 64):
        flops = 0.0
        for name, m_img, k, n, res in k16_gemms():
            m = b * m_img
            x = torch.randn(m, k, device=dev, generator=g).bfloat16()
            w = (torch.randn(n, k, device=dev, generator=g) / k ** 0.5).bfloat16()
            scale = torch.rand(n, device=dev, generator=g) + 0.5
            shift = torch.randn(n, device=dev, generator=g) * 0.1
            r = torch.randn(m, n, device=dev, generator=g).bfloat16() if res else None
            it = 10 if b == 8 else 3
            call = lambda: fused.matmul_bn_act(x, w, scale, shift, r, True)
            lib = lambda: torch.matmul(x, w.t())
            times = {"": cuda_ms(call, iters=it), "/graph": graph_ms(call, iters=it),
                     "/matmul": cuda_ms(lib, iters=it), "/matmul/graph": graph_ms(lib, iters=it)}
            for sfx, v in times.items():
                result["k16"][f"{name}/B{b}{sfx}"] = v
            flops += 2.0 * m * k * n
            print(f"K16 {name} B={b} [{m}, {k}] x [{k}, {n}]: {times['']:.4f} ms (graph {times['/graph']:.4f}), "
                  f"torch.matmul {times['/matmul']:.4f} ms (graph {times['/matmul/graph']:.4f})", flush=True)
        for sfx in ("", "/graph"):
            tot = sum(v for key, v in result["k16"].items() if key.endswith(f"/B{b}{sfx}"))
            lib = sum(v for key, v in result["k16"].items() if key.endswith(f"/B{b}/matmul{sfx}"))
            print(f"K16, the 32 GEMMs at B={b}{' graph' if sfx else ''}: {tot:.4f} ms ({flops / tot / 1e9:.1f} TFLOP/s), "
                  f"torch.matmul {lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s) {card}")


def head_qtree(nc: int, seed: int, dev):
    """A random HISHead's int8 qtree (calibrated on small random levels), on ``dev``."""
    import torch

    from pytorch_object_detection_tpu_torch.models.head_int8 import calibrate_hishead, quantize_hishead
    from pytorch_object_detection_tpu_torch.models.heads import HISHead

    g = torch.Generator().manual_seed(seed)
    head = HISHead(nc, 256, generator=g).eval()
    levels = [torch.randn(1, s, s, 256, generator=g) for s in (16, 8, 4, 2, 1)]
    q = quantize_hishead(head, calibrate_hishead(head, levels), [lv.abs().max() / 127.0 for lv in levels], nc)

    def on(t):
        if isinstance(t, torch.Tensor):
            return t.to(dev)
        if isinstance(t, dict):
            return {k: on(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(on(v) for v in t)
        return t

    return on(q)


def head_input(b, h, w, seed, dev):
    import torch

    g = torch.Generator().manual_seed(seed * 1000 + b * 7 + h)
    return torch.clamp(torch.round(torch.randn(b, h, w, 256, generator=g) * 40), -127, 127).to(torch.int8).to(dev)


def digest(outs) -> str:
    import torch

    h = hashlib.sha256()
    for t in outs:
        t = t.contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_head(result, dev, seed, card) -> None:
    """K7 at the five levels of the default pipeline, B=8 and B=64; K9
    against K7 at the COCO P3 shape, B=2 and B=8; digests of every output."""
    from pytorch_object_detection_tpu_torch.ops import qhead

    q20 = head_qtree(20, seed, dev)
    result["digest"]["qtree20"] = digest([v for k, v in sorted(q20.items()) if hasattr(v, "numpy")])
    for b in (8, 64):
        for i, s in enumerate((64, 32, 16, 8, 4)):
            x = head_input(b, s, s, seed, dev)
            lv = q20["levels"][i]
            result["digest"][f"k7/P{i + 3}/B{b}"] = digest(qhead.qhishead_level(q20, lv, x))
            it = 10 if b == 8 else 3
            ms = cuda_ms(lambda: qhead.qhishead_level(q20, lv, x), iters=it)
            gms = graph_ms(lambda: qhead.qhishead_level(q20, lv, x), iters=it)
            result["k7"][f"P{i + 3}/B{b}"], result["k7"][f"P{i + 3}/B{b}/graph"] = ms, gms
            print(f"K7 P{i + 3} B={b} {tuple(x.shape)}: {ms:.4f} ms, graph {gms:.4f} ms, "
                  f"digest {result['digest'][f'k7/P{i + 3}/B{b}']}", flush=True)
        for sfx in ("", "/graph"):
            tot = sum(result["k7"][f"P{i + 3}/B{b}{sfx}"] for i in range(5))
            print(f"K7, the five levels at B={b}{' graph' if sfx else ''}: {tot:.4f} ms {card}")
    q80 = head_qtree(80, seed + 1, dev)
    lv = q80["levels"][0]
    for b in (2, 8):
        x = head_input(b, 112, 176, seed, dev)
        result["digest"][f"k7/coco/B{b}"] = digest(qhead.qhishead_level(q80, lv, x))
        result["digest"][f"k9/coco/B{b}"] = digest(qhead.qhishead_level2(q80, lv, x))
        t = {}
        for name, fn in (("k9", qhead.qhishead_level2), ("k7", qhead.qhishead_level), ("k7b", qhead.qhishead_level),
                         ("k9b", qhead.qhishead_level2)):
            t[name] = (cuda_ms(lambda: fn(q80, lv, x), iters=5), graph_ms(lambda: fn(q80, lv, x), iters=5))
        for name in ("k9", "k7"):
            ms = min(t[name][0], t[name + "b"][0])
            gms = min(t[name][1], t[name + "b"][1])
            result[name][f"coco/B{b}"], result[name][f"coco/B{b}/graph"] = ms, gms
        print(f"COCO P3 B={b} 112x176, 80 classes: K9 {t['k9'][0]:.4f}/{t['k9b'][0]:.4f} ms (graph "
              f"{t['k9'][1]:.4f}/{t['k9b'][1]:.4f}), K7 {t['k7'][0]:.4f}/{t['k7b'][0]:.4f} ms (graph "
              f"{t['k7'][1]:.4f}/{t['k7b'][1]:.4f}); digests K7 {result['digest'][f'k7/coco/B{b}']} "
              f"K9 {result['digest'][f'k9/coco/B{b}']} {card}", flush=True)


# (block, combine, H, W) of the default pipeline's seven HisBlocks at 512x512
HIS_BLOCKS = [("his1", None, 16, 16), ("his2", "up_add", 32, 32), ("his3", "up_add", 64, 64), ("his4", "add", 32, 32),
              ("his5", "add", 16, 16), ("his6", "add", 8, 8), ("his7", "add", 4, 4)]


def time_his(result, dev, seed, card) -> None:
    """K5 at the seven HisBlocks, B=8 and B=64, on a random HisFPN's int8
    qtree (256 channels) and random int8 inputs; digests of every output."""
    import torch

    from pytorch_object_detection_tpu_torch.nn.fpn import HisFPN
    from pytorch_object_detection_tpu_torch.nn.fpn_int8 import calibrate_hisfpn, quantize_hisfpn
    from pytorch_object_detection_tpu_torch.ops import qhis

    g = torch.Generator().manual_seed(seed)
    fpn = HisFPN((512, 1024, 2048), 256, generator=g).eval()
    feats = [torch.randn(2, s, s, c, generator=g).abs() for s, c in ((16, 512), (8, 1024), (4, 2048))]
    q = quantize_hisfpn(fpn, calibrate_hisfpn(fpn, feats), [f.abs().max() / 127.0 for f in feats])
    ca, cb = torch.tensor(0.6, device=dev), torch.tensor(0.7, device=dev)

    def draw(*shape):
        return torch.clamp(torch.round(torch.randn(*shape, generator=g) * 40), -127, 127).to(torch.int8).to(dev)

    for b in (8, 64):
        macs_all = 0.0
        for name, combine, h, w in HIS_BLOCKS:
            blk = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in q[name].items()}
            half, cin, r = blk["w1"].shape[0], blk["w1"].shape[1], blk["se_w1"].shape[1]
            xa = draw(b, h // 2, w // 2, cin) if combine == "up_add" else draw(b, h, w, cin)
            kw = dict(xb_q=draw(b, h, w, cin), combine=combine, ca=ca, cb=cb) if combine else {}
            key = f"{name}/B{b}"
            result["digest"][f"k5/{key}"] = digest([qhis.qhisblock(blk, xa, **kw)])
            it = 10 if b == 8 else 3
            ms = cuda_ms(lambda: qhis.qhisblock(blk, xa, **kw), iters=it)
            gms = graph_ms(lambda: qhis.qhisblock(blk, xa, **kw), iters=it)
            result["k5"][key], result["k5"][f"{key}/graph"] = ms, gms
            macs = b * h * w * (2 * cin * half + 9 * half + 9 * cin * half + 9 * cin * cin) + b * 2 * half * r
            macs_all += macs
            print(f"K5 {name} {combine} B={b} {h}x{w}x{cin}: {ms:.4f} ms, graph {gms:.4f} ms, "
                  f"{macs / gms / 1e9:.1f} T multiply-adds/s (graph), digest {result['digest'][f'k5/{key}']}",
                  flush=True)
        for sfx in ("", "/graph"):
            tot = sum(result["k5"][f"{n}/B{b}{sfx}"] for n, *_ in HIS_BLOCKS)
            print(f"K5, the seven HisBlocks at B={b}{' graph' if sfx else ''}: {tot:.4f} ms, "
                  f"{macs_all / tot / 1e9:.1f} T multiply-adds/s {card}")


def time_nms(result, dev, seed, card) -> None:
    """Kernel A at K=1000 (the decode's top-k), B=8 and B=64, on boxes
    clustered around 30 objects an image (20 classes), sorted by a random
    score, 10 % invalid, class-shifted as ops/nms.batched_class_nms shifts
    them; digests of the keep masks."""
    import numpy as np
    import torch

    from pytorch_object_detection_tpu_torch.ops import cuda_nms
    from pytorch_object_detection_tpu_torch.ops.nms import class_offset_boxes

    rng = np.random.default_rng(seed + 17)
    for b in (8, 64):
        k = 1000
        obj = rng.integers(0, 30, (b, k))
        centre, size = rng.uniform(40, 470, (b, 30, 2)), rng.uniform(16, 160, (b, 30, 2))
        pick = lambda a: np.take_along_axis(a, obj[..., None].repeat(2, -1), 1)
        c = pick(centre) + rng.normal(0, 6, (b, k, 2))
        half_wh = pick(size) / 2 * rng.uniform(0.8, 1.25, (b, k, 2))
        boxes = torch.from_numpy(np.concatenate([c - half_wh, c + half_wh], -1).astype(np.float32)).to(dev)
        classes = torch.from_numpy(np.take_along_axis(rng.integers(1, 21, (b, 30)), obj, 1).astype(np.int32)).to(dev)
        valid = torch.from_numpy(rng.uniform(size=(b, k)) > 0.1).to(dev)
        shifted = class_offset_boxes(boxes, classes, valid).contiguous()
        keep = cuda_nms.cuda_nms_keep_mask(shifted, valid, 0.6)
        result["digest"][f"nms/B{b}"] = digest([keep])
        ms = cuda_ms(lambda: cuda_nms.cuda_nms_keep_mask(shifted, valid, 0.6), iters=20)
        gms = graph_ms(lambda: cuda_nms.cuda_nms_keep_mask(shifted, valid, 0.6), iters=20)
        result["nms"][f"B{b}"], result["nms"][f"B{b}/graph"] = ms, gms
        print(f"kernel A B={b} K={k}: {ms:.4f} ms, graph {gms:.4f} ms, {int(keep.sum())} kept of {int(valid.sum())} "
              f"valid, digest {result['digest'][f'nms/B{b}']} {card}", flush=True)


def stem_entry(dev, seed):
    """The stem entry of a random ResNet-50, its scale calibrated on two random 64x64 frames."""
    import torch

    from pytorch_object_detection_tpu_torch.nn.resnet import ResNet50
    from pytorch_object_detection_tpu_torch.nn.resnet_int8 import calibrate_resnet50, quantize_stem_s2d

    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    g = torch.Generator().manual_seed(seed)
    backbone = ResNet50(generator=g).eval()
    calib = torch.randint(0, 256, (2, 64, 64, 3), generator=g).float()
    norm = (calib / 255.0 - torch.tensor(mean)) / torch.tensor(std)
    absmax = calibrate_resnet50(backbone, norm, torch.float32)["stem_out"]
    return {k: v.to(dev) for k, v in quantize_stem_s2d(backbone, mean, std, absmax).items()}


def time_stem(result, dev, seed, card) -> None:
    """K1 on random uint8 frames: 512x512 at B=8 and B=64, the COCO canvas
    896x1408 at B=2; the stem entry of a random ResNet-50, its scale
    calibrated on two random 64x64 frames; digests of every output."""
    import numpy as np
    import torch

    from pytorch_object_detection_tpu_torch.ops import qstem

    st = stem_entry(dev, seed)
    rng = np.random.default_rng(seed + 29)
    for b, h, w in ((8, 512, 512), (64, 512, 512), (2, 896, 1408)):
        u8 = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
        key = f"B{b}/{h}x{w}"
        result["digest"][f"k1/{key}"] = digest([qstem.qstem_conv(u8, st)])
        it = 20 if b < 64 else 5
        ms = cuda_ms(lambda: qstem.qstem_conv(u8, st), iters=it)
        gms = graph_ms(lambda: qstem.qstem_conv(u8, st), iters=it)
        result["k1"][key], result["k1"][f"{key}/graph"] = ms, gms
        print(f"K1 B={b} {h}x{w}x3: {ms:.4f} ms, graph {gms:.4f} ms, digest {result['digest'][f'k1/{key}']} {card}",
              flush=True)


def time_stem_tiles(result, dev, seed, card) -> None:
    """K1 at the small batches, where a tile of the least recompute may
    leave SMs idle: each tile's time beside its blocks and recompute, the
    chooser's marked with ``*``; every tile's output equal to the chooser's."""
    import numpy as np
    import torch

    from pytorch_object_detection_tpu_torch.ops import qblock, qstem

    st = stem_entry(dev, seed)
    sm_count, smem_max = qblock.card_limits(dev)
    rng = np.random.default_rng(seed + 31)
    result["k1_tiles"] = {}
    for b, h, w in ((1, 512, 512), (2, 512, 512), (8, 512, 512), (1, 896, 1408), (2, 896, 1408)):
        u8 = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
        pick = qstem.pick_stem_tile(b, h, w, sm_count, smem_max)
        want = qstem.qstem_conv(u8, st)
        cells = []
        for tile in dict.fromkeys([pick, (16, 16), (16, 8), (8, 16), (8, 8), (8, 4), (4, 8), (4, 4)]):
            got = qstem.qstem_conv(u8, st, tile=tile)
            if not torch.equal(got, want):
                raise SystemExit(f"K1 B={b} {h}x{w}: tile {tile} differs from the chooser's {pick} in "
                                 f"{int((got != want).sum())} elements")
            ms = cuda_ms(lambda: qstem.qstem_conv(u8, st, tile=tile), iters=20)
            gms = graph_ms(lambda: qstem.qstem_conv(u8, st, tile=tile), iters=20)
            result["k1_tiles"][f"B{b}/{h}x{w}/{tile[0]}x{tile[1]}"] = (ms, gms)
            cells.append(f"{'*' if tile == pick else ''}{tile[0]}x{tile[1]} {gms:.4f} ms (back to back {ms:.4f}, "
                         f"{qstem.stem_blocks(b, h, w, *tile)} blocks, recompute "
                         f"{qstem.stem_recompute(h, w, *tile):.4f})")
        print(f"K1 tiles B={b} {h}x{w}x3, graph: " + "; ".join(cells) + f" {card}", flush=True)


def kernel_split(fn, prefix: str, iters: int):
    """Device ms per call of each CUDA kernel whose name starts with
    ``prefix`` (its template arguments dropped), over ``iters`` calls under
    ``torch.profiler``; {} where the profiler sees no device time."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        m = re.search(r"\b" + prefix + r"\w*", e.key)
        if m:
            t = getattr(e, "self_device_time_total", None)
            t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
            parts[m.group(0)] = parts.get(m.group(0), 0.0) + t / 1000.0 / iters
    return parts


def ptxas_lines(build_log, source: str):
    """ptxas' registers and spills for ``source``'s build, one string."""
    out = []
    for name, (_, log) in build_log.items():
        if name.startswith(source):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    out.append(line.strip())
    return " | ".join(out) if out else "not in this process's build log (built earlier)"


def _ref_compare(ref_dir, name: str, outs, card) -> None:
    """Saves ``outs`` under ``ref_dir`` as the reference where none is
    there yet, else prints the share of their values that differ from it
    (the first run in a parent/this/this/parent call is the parent's)."""
    import torch

    if ref_dir is None:
        return
    path = Path(ref_dir) / f"{name}.pt"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in outs.items()}, path)
        print(f"{name}: outputs saved as the reference, {path}")
        return
    ref = torch.load(path)
    cells = []
    for k, v in outs.items():
        r = ref[k].to(v.device)
        cells.append(f"{k} {float((v != r).float().mean()):.5f}")
    print(f"{name}: share of values that differ from the reference run: " + ", ".join(cells) + f" {card}")


def k15_operands(seed: int, dev):
    """A random HISHead(20, 256) packed for K15 (bf16) and its bf16 float
    module, from ``seed``."""
    import torch

    from pytorch_object_detection_tpu_torch.models.heads import HISHead
    from pytorch_object_detection_tpu_torch.ops import head

    g = torch.Generator().manual_seed(seed + 41)
    module = HISHead(20, 256, generator=g).eval()
    with torch.no_grad():  # GroupNorm affine parameters off their defaults
        for name in ("stem_gn1", "stem_gn2", "cls_gn0", "reg_gn0"):
            gn = getattr(module, name)
            gn.weight.copy_(1.0 + 0.2 * torch.randn(gn.weight.shape, generator=g))
            gn.bias.copy_(0.2 * torch.randn(gn.bias.shape, generator=g))
    module = module.to(dev)
    packed = head.hishead_params_pack(module, 20)
    return packed, module.to(torch.bfloat16)


def time_k15(result, dev, seed, card, ref_dir=None) -> None:
    """K15 at the fused-head pipeline's five levels (256 features, 20
    classes), B=8 and B=64: ms back to back and from a graph, the device ms
    of each of its CUDA kernels (``fhead_*``), its error against the plain
    version, its bound and T FLOP/s; the bf16 float head at the same levels
    beside it; registers and spills from the build."""
    import torch

    from pytorch_object_detection_tpu_torch import _build
    from pytorch_object_detection_tpu_torch.ops import head

    packed, float_head = k15_operands(seed, dev)
    nc, f = 20, 256
    g = torch.Generator().manual_seed(seed + 43)
    result["k15"] = {}
    outs = {}
    for b in (8, 64):
        xs = [(torch.randn(b, s, s, f, generator=g) * 0.5).to(torch.bfloat16).to(dev) for s in (64, 32, 16, 8, 4)]
        tot = {"": 0.0, "/graph": 0.0, "/plain": 0.0}
        ops_all = bytes_all = 0.0
        for i, x in enumerate(xs):
            fn = lambda: head.hishead_level_fused(x, packed, nc)
            got = fn()
            want = head.hishead_level_fused(x, packed, nc, plain=True)
            errs = []
            for name, sl in (("cls", slice(0, nc)), ("cnt", slice(nc, nc + 1)), ("reg", slice(nc + 1, nc + 5))):
                a, w = got[..., sl].float(), want[..., sl].float()
                cos = float(torch.nn.functional.cosine_similarity(a.flatten(), w.flatten(), dim=0))
                errs.append(f"{name} {float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30):.4g} "
                            f"cos {cos:.6f}")
            key = f"P{i + 3}/B{b}"
            outs[key] = got
            result["digest"][f"k15/{key}"] = digest([got])
            it = 10 if b == 8 else 3
            times = {"": cuda_ms(fn, iters=it), "/graph": graph_ms(fn, iters=it)}
            if b == 8:
                times["/plain"] = cuda_ms(lambda: head.hishead_level_fused(x, packed, nc, plain=True), iters=2, reps=3)
            split = kernel_split(fn, "fhead_", it)
            for sfx, v in times.items():
                result["k15"][f"{key}{sfx}"] = v
                tot[sfx] += v
            result["k15"][f"{key}/split"] = split
            s = x.shape[1]
            macs = b * s * s * (f * 2 * f + 9 * 2 * f + 2 * f * f + 2 * 9 * f * f + 9 * f * (nc + 5))
            weights = sum(packed[k].numel() * packed[k].element_size() for k in (
                "k_pw1", "dw", "k_pw2", "k_tow", "k_cls", "k_cr", "gn", "bias"))
            nbytes = 2 * x.numel() + 2 * b * s * s * (nc + 5) + weights
            ops_all, bytes_all = ops_all + 2 * macs, bytes_all + nbytes
            bnd = max(nbytes / 3.35e12, 2 * macs / 989e12) * 1e3
            print(f"K15 {key} {tuple(x.shape)}: {times[''] :.4f} ms, graph {times['/graph']:.4f} ms, "
                  + (f"plain {times['/plain']:.4f} ms, " if b == 8 else "")
                  + f"bound {bnd:.5f} ms, {2 * macs / times['/graph'] / 1e9:.1f} TFLOP/s (graph); split "
                  + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
                  + f"; vs plain: {'; '.join(errs)}; digest {result['digest'][f'k15/{key}']}", flush=True)
        levels = [x.permute(0, 3, 1, 2).contiguous() for x in xs]
        tf = cuda_ms(lambda: float_head(levels), iters=10 if b == 8 else 3)
        result["k15"][f"float_head/B{b}"] = tf
        bnd = max(bytes_all / 3.35e12, ops_all / 989e12) * 1e3
        print(f"K15, the five levels at B={b}: {tot['']:.4f} ms, graph {tot['/graph']:.4f} ms"
              + (f", plain {tot['/plain']:.4f} ms" if b == 8 else "")
              + f", bound {bnd:.5f} ms (operations), {ops_all / tot['/graph'] / 1e9:.1f} TFLOP/s (graph); the bf16 "
              f"float head at the same levels {tf:.4f} ms {card}", flush=True)
    print(f"K15 build: {ptxas_lines(_build.build_log, 'head')}")
    _ref_compare(ref_dir, "k15", outs, card)


# K12: the 15 MNBlock calls of an MNFCOS(20, 256) forward at 512x512, in the
# order the ladder runs them: (name, H=W, kernel, dilation)
QMN_CALLS = [("mnb5", 16, 5, 2), ("mnb4", 32, 3, 2), ("mnb3", 64, 3, 1), ("mnb6", 8, 5, 1), ("mnb7", 4, 7, 1)] + [
    (f"P{i + 3}_{blk}", 64 >> i, 3, 2) for i in range(5) for blk in ("block1", "block2")]


def k12_operands(name: str, hw: int, k: int, b: int, seed: int, dev):
    """A random int8 MNBlock (256 -> 512 -> 256 channels), its scales and an
    int8 input [b, hw, hw, 256], from ``seed`` and the call's name."""
    import torch

    g = torch.Generator().manual_seed(seed * 1000 + sum(map(ord, name)) + b)
    c, cm = 256, 512
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)
    pos = lambda n: (torch.rand(n, generator=g) * 1e-3 + 1e-5).to(dev)
    nrm = lambda n: (torch.randn(n, generator=g) * 0.1).to(dev)
    blk = dict(wdw=i8(k, k, c), swdw=pos(c), bdw=nrm(c), w1=i8(cm, c), sw1=pos(cm), b1=nrm(cm), w2=i8(c, cm),
               sw2=pos(c), b2=nrm(c))
    sc = {n: torch.tensor(v, device=dev) for n, v in dict(s_in=0.05, s_a1=0.03, s_a2=0.04, s_out=0.06).items()}
    return blk, sc, i8(b, hw, hw, c)


def time_k12(result, dev, seed, card) -> None:
    """K12 at the MNFCOS int8 ladder's 15 calls, B=8 and B=64: ms back to
    back and from a graph, its plain version (B=8), bound and T
    multiply-adds/s, digests of every output; registers and spills."""
    from pytorch_object_detection_tpu_torch import _build
    from pytorch_object_detection_tpu_torch.ops import qmnblock

    result["k12"] = {}
    for b in (8, 64):
        tot = {"": 0.0, "/graph": 0.0, "/plain": 0.0}
        macs_all = 0.0
        for name, hw, k, d in QMN_CALLS:
            blk, sc, x = k12_operands(name, hw, k, b, seed, dev)
            fn = lambda: qmnblock.qmnblock(blk, sc, x, k, d)
            key = f"{name}/B{b}"
            out = fn()
            result["digest"][f"k12/{key}"] = digest([out])
            it = 10 if b == 8 else 3
            times = {"": cuda_ms(fn, iters=it), "/graph": graph_ms(fn, iters=it)}
            if b == 8:
                want = qmnblock.qmnblock(blk, sc, x, k, d, plain=True)
                times["/plain"] = cuda_ms(lambda: qmnblock.qmnblock(blk, sc, x, k, d, plain=True), iters=2, reps=3)
            for sfx, v in times.items():
                result["k12"][f"{key}{sfx}"] = v
                tot[sfx] += v
            macs = b * hw * hw * (k * k * 256 + 2 * 256 * 512)
            macs_all += macs
            print(f"K12 {key} {tuple(x.shape)} k{k} d{d}: {times['']:.4f} ms, graph {times['/graph']:.4f} ms, "
                  f"{macs / times['/graph'] / 1e9:.1f} T multiply-adds/s (graph)"
                  + (f", plain {times['/plain']:.4f} ms, {int((out != want).sum())} elements differ from it"
                     if b == 8 else "")
                  + f", digest {result['digest'][f'k12/{key}']}", flush=True)
        nbytes = sum(2 * b * hw * hw * 256 + k * k * 256 + 2 * 256 * 512 + 4 * (4 * 256 + 2 * 512) + 16
                     for _, hw, k, _ in QMN_CALLS)
        bnd = max(nbytes / 3.35e12, 2 * macs_all / 1979e12) * 1e3
        print(f"K12, the 15 calls at B={b}: {tot['']:.4f} ms, graph {tot['/graph']:.4f} ms"
              + (f", plain {tot['/plain']:.4f} ms" if b == 8 else "")
              + f", bound {bnd:.5f} ms, {macs_all / tot['/graph'] / 1e9:.1f} T multiply-adds/s (graph) {card}",
              flush=True)
    print(f"K12 build: {ptxas_lines(_build.build_log, 'qmnblock')}")



def host_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Milliseconds of host time per call of ``fn()``: ``iters`` calls back
    to back on the host clock, no wait for the card inside, median of
    ``reps``; where it exceeds the card's time per call, the host bounds
    back-to-back calls."""
    import time

    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per_call.append((time.perf_counter() - t0) * 1000.0 / iters)
        torch.cuda.synchronize()
    return statistics.median(per_call)


# kernel B: the HISHead's 20 GroupNorm calls of one forward at 512x512, in
# the head's order: per level stem_gn1 (2f, relu), stem_gn2 (2f, silu),
# cls_gn0 and reg_gn0 (f, relu); (C, H=W, act)
GN_CALLS = [(c, s, act) for s in (64, 32, 16, 8, 4) for c, act in ((512, "relu"), (512, "silu"), (256, "relu"),
                                                                     (256, "relu"))]


def gn_operands(c: int, s: int, b: int, seed: int, dev):
    """A bf16 map [b, c, s, s] with a per-channel offset, and bf16 scale and
    bias off their defaults, as the pipeline's bf16 model carries them."""
    import torch

    g = torch.Generator().manual_seed(seed * 1000 + c + s + b)
    x = torch.randn(b, c, s, s, generator=g) * 2.0 + torch.randn(1, c, 1, 1, generator=g)
    scale = 1.0 + 0.2 * torch.randn(c, generator=g)
    bias = 0.2 * torch.randn(c, generator=g)
    return [t.to(dev, torch.bfloat16) for t in (x, scale, bias)]


def time_gn(result, dev, seed, card, ref_dir=None) -> None:
    """Kernel B at the HISHead's 20 calls of one forward (bf16 maps, bf16
    scale and bias), B=8 and B=64: ms a call back to back and from a graph,
    the wrapper's host ms, the bound (bytes: the map read once and written
    once) and the share of it reached, ``F.group_norm`` then the activation
    beside it; per forward the sums; digests of the outputs and, with
    ``--ref``, the share of values that moved from the first run's (the
    first 8 images of each call); registers and spills from the build."""
    import torch
    import torch.nn.functional as F

    from pytorch_object_detection_tpu_torch import _build
    from pytorch_object_detection_tpu_torch.ops import gn

    acts = {"relu": F.relu, "silu": F.silu}
    result["gn"] = {}
    outs = {}
    for b in (8, 64):
        tot = dict.fromkeys(("", "/graph", "/host", "/library", "/bound"), 0.0)
        for i, (c, s, act) in enumerate(GN_CALLS):
            x, scale, bias = gn_operands(c, s, b, seed, dev)
            fn = lambda: gn.groupnorm_act(x, scale, bias, act=act)
            key = f"P{i // 4 + 3}/{i % 4}/C{c}/{act}/B{b}"
            out = fn()
            result["digest"][f"gn/{key}"] = digest([out])
            outs[key] = out[:8]
            it = 20 if b == 8 else 5
            times = {"": cuda_ms(fn, iters=it), "/graph": graph_ms(fn, iters=it), "/host": host_ms(fn),
                     "/library": cuda_ms(lambda: acts[act](F.group_norm(x, 32, scale, bias, 1e-5)), iters=it),
                     "/bound": (2 * x.numel() * 2 + 2 * c * 2) / 3.35e12 * 1e3}
            for sfx, v in times.items():
                result["gn"][f"{key}{sfx}"] = v
                tot[sfx] += v
            print(f"B {key} {tuple(x.shape)}: {times['']:.4f} ms, graph {times['/graph']:.4f} ms, host "
                  f"{times['/host']:.4f} ms, bound {times['/bound']:.5f} ms (bytes, "
                  f"{times['/bound'] / times['/graph']:.1%} of it from the graph), F.group_norm + {act} "
                  f"{times['/library']:.4f} ms, digest {result['digest'][f'gn/{key}']}", flush=True)
        for sfx, v in tot.items():
            result["gn"][f"forward/B{b}{sfx}"] = v
        print(f"B, the 20 calls of a forward at B={b}: {tot['']:.4f} ms, graph {tot['/graph']:.4f} ms, host "
              f"{tot['/host']:.4f} ms, bound {tot['/bound']:.5f} ms (bytes), {tot['/bound'] / tot['/graph']:.1%} "
              f"of it (graph), {tot['/bound'] / tot['']:.1%} (back to back); F.group_norm + act "
              f"{tot['/library']:.4f} ms {card}", flush=True)
    print(f"B build: {ptxas_lines(_build.build_log, 'gn')}")
    _ref_compare(ref_dir, "gn", outs, card)


# K17: the stem conv's output at 512x512 frames, B=8 and B=64, and an odd frame size
K17_SHAPES = ((8, 256, 256), (64, 256, 256), (8, 129, 97))
PIPE_CANVAS = (512, 512)


def k17_operands(b: int, h: int, w: int, seed: int, dev):
    """A bf16 stem-conv output [b, h, w, 64] (NHWC), the folded BN's f32
    mult and shift, and the stem's scale (a few values clip)."""
    import torch

    g = torch.Generator().manual_seed(seed * 1000 + 17 + b + h)
    x = (torch.randn(b, h, w, 64, generator=g) * 3.0).to(torch.bfloat16)
    mult, shift = torch.rand(64, generator=g) + 0.3, torch.randn(64, generator=g) * 0.5
    scale = torch.tensor(float(x[:1].float().abs().max()) / 127.0 * 0.8)
    return [t.to(dev) for t in (x, mult, shift, scale)]


def stem_qtree(seed: int, dev):
    """The float stem's part of a qtree: a random 7x7 conv and BN, and a scale."""
    import torch

    g = torch.Generator().manual_seed(seed + 171)
    bn = {"scale": torch.rand(64, generator=g) + 0.5, "bias": torch.randn(64, generator=g) * 0.2,
          "mean": torch.randn(64, generator=g) * 0.1, "var": torch.rand(64, generator=g) + 0.5}
    stem = {"kernel": torch.randn(64, 3, 7, 7, generator=g) * 0.1, "bn": bn}
    return {"stem": {"kernel": stem["kernel"].to(dev), "bn": {k: v.to(dev) for k, v in bn.items()}},
            "stem_scale": torch.tensor(0.05, device=dev)}


def time_k17(result, dev, seed, card) -> None:
    """K17 at the stem tail's shape [B, 256, 256, 64] (512x512 frames), B=8
    and B=64, and at an odd frame size (B=8, 129x97): ms a call back to back
    and from a graph, host ms, the bound (bytes) and the share of it reached,
    a digest of each output; then the stem-tail path's whole stem
    (``resnet50_int8_stem(..., "pallas_stem_tail")``: the bf16 conv, the
    BN fold and K17) back to back with its host ms; registers and spills."""
    import torch

    from pytorch_object_detection_tpu_torch import _build
    from pytorch_object_detection_tpu_torch.nn import resnet_int8
    from pytorch_object_detection_tpu_torch.ops import stem

    result["k17"] = {}
    for b, h, w in K17_SHAPES:
        x, mult, shift, scale = k17_operands(b, h, w, seed, dev)
        fn = lambda: stem.stem_bn_pool_quant(x, mult, shift, scale)
        key = f"B{b}/{h}x{w}"
        out = fn()
        result["digest"][f"k17/{key}"] = digest([out])
        it = 20 if b == 8 else 5
        times = {"": cuda_ms(fn, iters=it), "/graph": graph_ms(fn, iters=it), "/host": host_ms(fn),
                 "/bound": (x.numel() * 2 + out.numel() + 64 * 8 + 4) / 3.35e12 * 1e3}
        for sfx, v in times.items():
            result["k17"][f"{key}{sfx}"] = v
        print(f"K17 {key} {tuple(x.shape)}: {times['']:.4f} ms, graph {times['/graph']:.4f} ms, host "
              f"{times['/host']:.4f} ms, bound {times['/bound']:.5f} ms (bytes, "
              f"{times['/bound'] / times['/graph']:.1%} of it from the graph), digest "
              f"{result['digest'][f'k17/{key}']} {card}", flush=True)
    qtree = stem_qtree(seed, dev)
    for b in (8, 64):
        g = torch.Generator().manual_seed(seed + 173 + b)
        images = torch.randn(b, *PIPE_CANVAS, 3, generator=g).to(dev, torch.bfloat16)
        fn = lambda: resnet_int8.resnet50_int8_stem(qtree, images, torch.bfloat16, "pallas_stem_tail")
        out = fn()
        result["digest"][f"k17/stem/B{b}"] = digest([out])
        times = {"": cuda_ms(fn, iters=10 if b == 8 else 3), "/host": host_ms(fn, iters=10)}
        for sfx, v in times.items():
            result["k17"][f"stem/B{b}{sfx}"] = v
        print(f"K17's path, the bf16 stem with its tail, B={b} 512x512: {times['']:.4f} ms, host "
              f"{times['/host']:.4f} ms, digest {result['digest'][f'k17/stem/B{b}']} {card}", flush=True)
    print(f"K17 build: {ptxas_lines(_build.build_log, 'stem.cu')}")


def time_pipes(result, dev, seed, card) -> None:
    """The six pipelines that run kernel B or K17, HISFCOS(20, 256) and
    MNFCOS(20, 256) from a seed, bf16 512x512, calibrated on 8 seeded
    frames: img/s at B=8 and B=64 (float, int8-backbone, int8-FPN, stem
    tail, MNFCOS float, MNFCOS int8-backbone); then one B=64 call of the
    stem-tail pipeline under ``torch.profiler``: wall, device time, idle
    share, and the device ms of kernel B, K17, the dtype casts and copies,
    and the rest."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_object_detection_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
    from pytorch_object_detection_tpu_torch.eval.evaluator import make_eval_pipeline, make_eval_pipeline_int8
    from pytorch_object_detection_tpu_torch.models.fcos import default_strides
    from pytorch_object_detection_tpu_torch.models.registry import build_model

    canvas = PIPE_CANVAS
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    frames = torch.randint(0, 256, (8, *canvas, 3), generator=g, device=dev, dtype=torch.uint8)
    norm = (frames.float() / 255.0 - torch.tensor(IMAGENET_MEAN, device=dev)) / torch.tensor(IMAGENET_STD, device=dev)
    his = build_model("HISFCOS", 20, 256, device=dev, generator=torch.Generator().manual_seed(seed))
    mn = build_model("MNFCOS", 20, 256, device=dev, generator=torch.Generator().manual_seed(seed + 13))
    bf = dict(compute_dtype=torch.bfloat16)
    pipes = {
        "float": make_eval_pipeline(his, default_strides(), canvas, **bf),
        "int8-backbone": make_eval_pipeline_int8(his, norm, default_strides(), canvas, int8_fpn=False, **bf),
        "int8-FPN": make_eval_pipeline_int8(his, norm, default_strides(), canvas, int8_head=False, **bf),
        "stem tail": make_eval_pipeline_int8(his, norm, default_strides(), canvas, int8_fpn=False,
                                             backend="pallas_stem_tail", **bf),
        "MNFCOS float": make_eval_pipeline(mn, default_strides(), canvas, **bf),
        "MNFCOS int8-backbone": make_eval_pipeline_int8(mn, norm, default_strides(), canvas, **bf),
    }
    result["pipes"] = {}
    for b, iters in ((8, 10), (64, 3)):
        fr = frames.repeat(b // 8, 1, 1, 1)
        for name, p in pipes.items():
            ms = cuda_ms(lambda: p(fr), iters=iters, reps=3)
            result["pipes"][f"{name}/B{b}"] = b * 1000.0 / ms
            print(f"pipeline {name} B={b}: {ms:.3f} ms a batch, {b * 1000.0 / ms:.1f} img/s {card}", flush=True)
    fr, pipe = frames.repeat(8, 1, 1, 1), pipes["stem tail"]
    for _ in range(2):
        pipe(fr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            pipe(fr)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000.0 / 3
    events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not events:
        print("stem-tail profile: the profiler saw no device events: not measured")
        return
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    parts = {"B (gn_act*)": 0.0, "K17 (stem_tail*)": 0.0, "casts and copies": 0.0, "the rest": 0.0}
    counts = dict.fromkeys(parts, 0)
    for e in events:
        name = ("B (gn_act*)" if "gn_act" in e.key else "K17 (stem_tail*)" if "stem_tail" in e.key
                else "casts and copies" if "copy" in e.key.lower() else "the rest")
        parts[name] += getattr(e, attr) / 1000.0 / 3
        counts[name] += e.count
    device = sum(parts.values())
    result["pipes"]["stem tail profile"] = dict(parts, wall=wall, device=device)
    print(f"stem-tail pipeline, one B=64 call under torch.profiler: wall {wall:.3f} ms, device {device:.3f} ms, "
          f"idle share {max(0.0, 1.0 - device / wall):.3f}; " + ", ".join(
              f"{k} {v:.4f} ms ({counts[k] // 3} launches)" for k, v in parts.items()) + f" {card}", flush=True)
    ranked = sorted(events, key=lambda e: -getattr(e, attr))
    for e in ranked[:12]:
        print(f"    {getattr(e, attr) / 1000.0 / 3:9.4f} ms  {e.count // 3:5d}x  {e.key[:100]}")



def time_gn_tiles(result, dev, seed, card) -> None:
    """Kernel B at the HISHead's ten shapes (relu) and the COCO canvas's P3
    (C=512, 112x176, B=2), B=8 and B=64, from a graph, under every tile of
    ``ops/gn.gn_options``, the chooser's marked with ``*``; every tile's
    output held equal to the chooser's."""
    import torch

    from pytorch_object_detection_tpu_torch.ops import gn, qblock

    sm_count, smem_max = qblock.card_limits(dev)
    result["gn_tiles"] = {}
    shapes = [(b, c, s, s) for b in (8, 64) for s in (64, 32, 16, 8, 4) for c in (512, 256)] + [(2, 512, 112, 176)]
    for b, c, h, w in shapes:
        x, scale, bias = gn_operands(c, h, b, seed, dev)
        if (h, w) != (h, h):
            x = torch.randn(b, c, h, w, generator=torch.Generator().manual_seed(seed)).to(dev, torch.bfloat16)
        pick = gn.pick_gn_tile(b, c, h * w, 32, 2, sm_count, smem_max)
        want = gn.groupnorm_act(x, scale, bias, act="relu")
        cells = []
        for tile in gn.gn_options(b, c, h * w, 32, 2, smem_max):
            got = gn.groupnorm_act(x, scale, bias, act="relu", tile=tile)
            if not torch.equal(got, want):
                raise SystemExit(f"B {(b, c, h, w)}: tile {tile} differs from the chooser's {pick} in "
                                 f"{int((got != want).sum())} elements")
            ms = graph_ms(lambda: gn.groupnorm_act(x, scale, bias, act="relu", tile=tile), iters=20)
            result["gn_tiles"][f"B{b}/C{c}/{h}x{w}/{tile}"] = ms
            cells.append(f"{'*' if tile == pick else ''}{tile[0][0]}{tile[1]}x{tile[2]} {ms:.4f}")
        print(f"B tiles B={b} C={c} {h}x{w} bf16, graph ms: " + "; ".join(cells) + f" {card}", flush=True)


def time_k17_tiles(result, dev, seed, card) -> None:
    """K17 at B=1, 8 and 64 on the 512x512 stem map and at B=8 on an odd one,
    from a graph, under every band that fits two blocks an SM, the
    chooser's marked with ``*``; every band's output held equal to the
    chooser's."""
    import torch

    from pytorch_object_detection_tpu_torch.ops import qblock, stem

    sm_count, smem_max = qblock.card_limits(dev)
    result["k17_tiles"] = {}
    for b, h, w in ((1, 256, 256), (8, 256, 256), (64, 256, 256), (8, 129, 97)):
        x, mult, shift, scale = k17_operands(b, h, w, seed, dev)
        pick = stem.pick_stem_tail_tile(b, h, w, sm_count, smem_max)
        want = stem.stem_bn_pool_quant(x, mult, shift, scale)
        cells = []
        for tile in [(r, c) for r in stem.STEM_TAIL_ROWS for c in stem.STEM_TAIL_COLS
                     if 2 * (stem.stem_tail_smem_bytes(64, r, c) + 1024) <= smem_max + 1024]:
            got = stem.stem_bn_pool_quant(x, mult, shift, scale, tile=tile)
            if not torch.equal(got, want):
                raise SystemExit(f"K17 B={b} {h}x{w}: band {tile} differs from the chooser's {pick}")
            ms = graph_ms(lambda: stem.stem_bn_pool_quant(x, mult, shift, scale, tile=tile), iters=20 if b < 64 else 5)
            result["k17_tiles"][f"B{b}/{h}x{w}/{tile}"] = ms
            cells.append(f"{'*' if tile == pick else ''}{tile[0]}x{tile[1]} {ms:.4f}")
        print(f"K17 bands B={b} {h}x{w}, graph ms: " + "; ".join(cells) + f" {card}", flush=True)


# K10: the direct stem's pooled map at 512x512 (B=8, B=64), the COCO canvas
# (B=2), an odd map and an odd map with C % 16 != 0 (the one-byte form)
K10_SHAPES = ((8, 256, 256, 64), (64, 256, 256, 64), (2, 448, 704, 64), (8, 129, 97, 64), (8, 129, 97, 24))


def k10_input(b: int, h: int, w: int, c: int, seed: int, dev):
    import torch

    g = torch.Generator().manual_seed(seed * 1000 + 10 + b + h + c)
    return torch.randint(-128, 128, (b, h, w, c), generator=g, dtype=torch.int8).to(dev)


def time_k10(result, dev, seed, card) -> None:
    """K10 at ``K10_SHAPES``: ms a call back to back and from a graph, host
    ms, the bound (bytes: the map read once, the output written once) and
    the share of it reached from the graph, a digest of each output;
    registers and spills where this process built the kernel."""
    from pytorch_object_detection_tpu_torch import _build
    from pytorch_object_detection_tpu_torch.ops import qpool

    result["k10"] = {}
    for b, h, w, c in K10_SHAPES:
        x = k10_input(b, h, w, c, seed, dev)
        fn = lambda: qpool.qmaxpool3x3s2(x)
        key = f"B{b}/{h}x{w}x{c}"
        out = fn()
        result["digest"][f"k10/{key}"] = digest([out])
        it = 20 if b < 64 else 10
        times = {"": cuda_ms(fn, iters=it), "/graph": graph_ms(fn, iters=it), "/host": host_ms(fn),
                 "/bound": (x.numel() + out.numel()) / 3.35e12 * 1e3}
        for sfx, v in times.items():
            result["k10"][f"{key}{sfx}"] = v
        print(f"K10 {key}: {times['']:.4f} ms, graph {times['/graph']:.4f} ms, host {times['/host']:.4f} ms, "
              f"bound {times['/bound']:.5f} ms (bytes, {times['/bound'] / times['/graph']:.1%} of it from the "
              f"graph), digest {result['digest'][f'k10/{key}']} {card}", flush=True)
    print(f"K10 build: {ptxas_lines(_build.build_log, 'qpool.cu')}")


def time_k10_tiles(result, dev, seed, card) -> None:
    """K10 at the 64-channel shapes of ``K10_SHAPES`` from a graph under
    every band that fits two blocks an SM, the chooser's marked with ``*``;
    every band's output held equal to the chooser's."""
    import torch

    from pytorch_object_detection_tpu_torch.ops import qblock, qpool

    sm_count, smem_max = qblock.card_limits(dev)
    result["k10_tiles"] = {}
    for b, h, w, c in K10_SHAPES:
        if c % 16:
            continue
        x = k10_input(b, h, w, c, seed, dev)
        pick = qpool.pick_pool3_tile(b, h, w, sm_count, smem_max, c)
        want = qpool.qmaxpool3x3s2(x)
        cells = []
        for tile in [(r, cl) for r in qpool.POOL3_ROWS for cl in qpool.POOL3_COLS
                     if 2 * (qpool.pool3_smem_bytes(c, r, cl) + 1024) <= smem_max + 1024]:
            got = qpool.qmaxpool3x3s2(x, tile=tile)
            if not torch.equal(got, want):
                raise SystemExit(f"K10 B={b} {h}x{w}: band {tile} differs from the chooser's {pick}")
            ms = graph_ms(lambda: qpool.qmaxpool3x3s2(x, tile=tile), iters=20 if b < 64 else 10)
            result["k10_tiles"][f"B{b}/{h}x{w}/{tile}"] = ms
            cells.append(f"{'*' if tile == pick else ''}{tile[0]}x{tile[1]} {ms:.4f}")
        print(f"K10 bands B={b} {h}x{w}x{c}, graph ms: " + "; ".join(cells) + f" {card}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
