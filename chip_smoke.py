"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive, time.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints its results on its own lines):
  1. device: nvidia-smi name and power limit; exit 1 without a CUDA device;
  2. build: kernels A (csrc/nms.cu), B (csrc/gn.cu), C (csrc/qblock.cu), K1
     (csrc/qstem.cu), K4 (csrc/qconv.cu), K4' (csrc/qmm_variants.cu), K5
     (csrc/qhis.cu), K6 and K10 (csrc/qpool.cu), K7/K9 (csrc/qhead.cu), K11
     (csrc/qconv3.cu), K12 (csrc/qmnblock.cu), K13 (csrc/qchain.cu, built
     twice: for two blocks an SM and for one), K15 (csrc/head.cu), K16
     (csrc/fused.cu) and K17 (csrc/stem.cu) from the sources, one nvcc per
     library, all started together;
  3. kernel B vs its plain version at the head's shapes (B=8, C=512/256,
     H=W=64..4, relu/silu/none), bf16 and f32 maps, bf16 and f32 scale and
     bias, at the COCO canvas's P3 slab (C=512, 112x176, B=2: a cluster of
     8) and at odd H*W (7x11); each under every tile ops/gn.gn_options
     gives (the streaming path's among them), with the same bits as under
     ops/gn.pick_gn_tile's;
  4. kernel A vs its plain version: random [8,1000] and [64,1000] boxes, a
     [1,1000] chain in which each box suppresses the next (every other box
     kept), the adversarial case of tests/test_pallas_nms.py, and (after
     phase 5) the pipeline's own decoded boxes; exact equality;
  5. the float serving pipeline: full-width HISFCOS(20, 256) from a seed, 8
     seeded uint8 512x512 frames through make_eval_pipeline in bf16; shapes,
     finiteness, launch counters (20 GN launches per forward, 1 NMS launch per
     batch), and per-level maps against the same weights on the plain versions;
  5b. the int8-backbone serving pipeline: the same model through
     make_eval_pipeline_int8(int8_fpn=False) in bf16, calibrated on the same
     8 frames; launch counters (13 K2, 3 K3, 20 GN, 1 NMS per call), C3..C5
     int8 identical between kernel C and its plain version, per-level maps
     against the plain pipeline, cosine of the dequantized C3..C5 against
     the float backbone's (>= 0.99), finite detections;
  5c. kernel C vs its plain version at the 16 bottleneck shapes, B=8: on the
     ladder's own int8 activations and on random int8 inputs, with the
     calibrated weights; 0 differing elements;
  5d. the int8-FPN serving pipeline from raw uint8 frames: the same model
     through make_eval_pipeline_int8(int8_fpn=True, int8_head=False) in bf16;
     launch counters (1 K1, 13 K2, 3 K3, 3 K4, 7 K5 of which 4 with the level
     pool in their load, 1 K6 seeds launch for the two seeds and 0 of the
     standalone K6, 20 GN, 1 NMS per call), finite
     detections, per-level maps against the plain pipeline, the uint8 stem
     within one int8 step of the float stem (f32, TF32 off), cosine of each
     dequantized int8 level against the BN-folded float HisFPN on the same
     dequantized C3..C5 (>= 0.99);
  5e. K1, K4, K5 and K6 vs their plain versions at the shapes of that call,
     on its own inputs and on random ones: 0 differing elements for K1, K4
     (and its residual variant) and K6, at most one step and under 5 %
     differing for K5; K5 at its seven shapes bit for bit the same under
     forced tiles (one image and all channels a block; the most slices) as
     under ops/qhis.pick_his_tile's; K1 also on random frames at 512x512
     (B=8, B=64), the COCO canvas (B=2) and an odd size (98x130, 3 and 4
     channels), under its chooser's tile and forced ones; K6's seeds kernel
     and K6 alone on the four level pools' inputs; K5 with the pool in its
     load (his4..his7) bit for bit equal to K6 then K5 "add", under the
     chooser's and forced tiles;
  5f. the JAX default serving pipeline, the main path: the same model
     through make_eval_pipeline_int8(...) with its defaults (int8 FPN and
     int8 head) in bf16 on the 8 frames; launch counters (1 K1, 13 K2, 3 K3,
     3 K4, 7 K5 (4 pool_add), 1 K6, 5 K7, 0 K9, 0 GN, 1 NMS per call), finite
     detections, per-level maps against the plain pipeline, the int8 head
     against the bf16 float head on the same dequantized levels (cosine >=
     0.99);
  5g. K7 vs its plain version at the five levels of that call (its own
     inputs and random ones); the default pipeline of an 80-class
     HISFCOS(80, 256) on two 896x1408 COCO-canvas frames (K9 on P3 112x176
     and P4 56x88, K7 on P5-P7: counted), and K9 vs its plain version at
     the COCO P3 shape for B=8 and an odd B; K9 bit for bit equal to K7 on
     the pipeline's K9 calls and at the COCO P3 shape (B=8), and K7's
     outputs independent of its tiling (ops/qhead.pick_head_tile's choice
     against one image and all channels a block on every pass);
  5h. the int8 ResNet-50's other backends, each through
     make_eval_pipeline_int8 on the same model, qtree and 8 frames, counted:
     1. backend="pallas", the per-conv kernels (1 K1, 39 K4, 13 K11, 7 K5
        (4 pool_add), 1 K6, 5 K7, 1 A); its C3..C5 equal to its plain run, and against
        kernel C's the share of differing C5 values and the dequantized
        cosine (>= 0.99);
     2. fuse_strided=False (13 K2, 0 K3, 12 K4, 0 K11);
     3. direct_stem=True (0 K1, 1 K10): the pooled stem equal to K1's;
     4. int8_fpn=False, backend="pallas_stem_tail" (1 K17, 0 kernel C, 20
        B, 1 A): its int8 stem within one step of the float stem's;
     5. chain_segments=True (3 K13, 0 kernel C): C3..C5 equal to kernel C's;
     finite detections and per-level maps against each path's plain run
     (cosine >= 0.99);
  5i. K11 at the four stage shapes, K10, K17 and K13 (three segments) vs
     their plain versions on the paths' own inputs and on random ones, and
     K4 at the per-conv path's 36 1x1 convs on its own inputs; K11 at the
     four stage shapes, B=8 and B=64, under every tile it takes; K13 on the
     three segments, B=8 and B=64, against kernel C block after block,
     under its chooser's tiles, each (tw, split) every block takes and each
     block's largest cluster; K17 at B=8, B=64 and an odd frame size
     (129x97) under ops/stem.pick_stem_tail_tile's band and forced ones, and
     with f32 mult and shift; K10 also at B=64, the COCO canvas's stem map
     (2x448x704x64) and an odd one with C % 16 != 0 (3x129x97x24) under
     ops/qpool.pick_pool3_tile's band, and at B=8 under forced ones: 0
     differing elements;
  5j. the fused ResNet-50 (nn/fused_resnet.resnet50_fused_forward) on the
     same model and frames, bf16, B=8, counted (32 K16 launches); its C3..C5
     against the module forward (within LEVEL_TOL of the range, cosine >=
     0.999); K16 against its plain version at the 32 GEMMs of that call and
     at odd M, N and K (within one bf16 step);
  5k. the fused-head serving pipeline: make_eval_pipeline_int8(int8_fpn=False,
     fused_head=True) in bf16 on the 8 frames, counted (13 K2, 3 K3, 5 K15,
     0 kernel B, 1 A); finite detections; maps against its plain run; K15
     against its plain version at the five levels of that call and on random
     inputs (K15_MAX_ERR of each output's range, cosine >= K15_MIN_COS);
     K15's maps against the bf16 float head on the same levels; K15 at
     those levels, B=8 and repeated to B=64, under every block its chooser
     weighs for each pass (ops/head.fhead_options): within the same
     contract, and equal to its output under the chooser's tiles;
  5l. K4': the three epilogues of the timing harness at [1048576, 64] x
     [64, 256] against their plain versions (exact), counted (3);
  5m. the float MNFCOS pipeline: full-width MNFCOS(20, 256) from a seed
     through make_eval_pipeline in bf16 on the 8 frames, counted (10 B, 1
     A), finite detections, per-level maps against its plain run;
  5n. MNFCOS int8: (i) make_eval_pipeline_int8(MNFCOS), which keeps the JAX
     gate (no int8 FPN: a backbone-only qtree, normalized input), counted
     (13 K2, 3 K3, 10 B, 1 A, 0 K12), maps against its plain run; (ii) the
     full int8 ladder from raw uint8 frames, built as the JAX serving bench
     builds it (quantize_backbone, quantize_fpn, quantize_head and
     make_eval_forward_int8(int8_fpn=True, int8_head=True, u8_input=True)
     in an Int8EvalPipeline), counted (1 K1, 13 K2, 3 K3, 15 K12, 0 B, 1
     A), finite detections, its int8 levels against the plain ladder's on
     the same C3..C5 (at most one step on under 1e-3 of the elements) and
     against the f32 float LightweightFPN on the dequantized C3..C5
     (cosine >= 0.99), its maps against the plain pipeline's (cosine >=
     0.999); (iii) K12 against its plain version on the 15 calls' own
     inputs and on random blocks at 28x44, 7x11 and 1x1, C = 64 and 128
     (at most one step on under 1e-3 of the elements; the count printed);
     K12 on the 15 calls' inputs, B=8 and repeated to B=64, under every
     tile it takes (ops/qmnblock.mn_options), equal to its output under
     the chooser's tile bit for bit;
  5o. VOC evaluation from the dataset: 64 seeded frames of 300-500 px a
     side in raw 512x512 tiles with seeded GT boxes of every class, an
     in-memory dataset of Samples that serves them cycled as EVAL_IDS ids
     (a steady window the eight-image JPEG tree of 5p is too small to
     give): the device resize on the card against the same
     call on the CPU (scales and sizes equal, at most one step on
     RESIZE_SHARE of the values); evaluate_voc with a pipeline that
     returns each frame's GT at the device resize's scales (mAP 1: the
     loader, the scales, _collect and the native AP on the card); and
     evaluate_voc through DetectionLoader with the default int8 pipeline
     and device_resize=True (calibrated on the device-resized canvases of
     8 frames, as the CLI does) at B=16 and B=64, each counted (every
     kernel of the default pipeline, K1, C, K4, K5, K6, K7 and A, launched
     its per-call count once a batch), with its images_per_sec;
  5p. COCO evaluation from JPEGs on disk, over the committed fixture tree
     (tests/fixtures/port_eval: eight VOC images; six COCO frames, one
     grayscale and one CMYK, one crowd row, COCO 2017's category ids; a
     YCCK file): (a)
     every file through the native full, tile and batch decodes on the card
     machine's libjpeg, each equal to the manifest's SHA-256 of PIL's decode
     on the CPU; (b) evaluate_voc over the VOC tree through DetectionLoader
     and RingTileLoader: AP 1 on every class with GT from a GT pipeline, and
     the default int8 pipeline with the device resize, B=4, each kernel
     launched its per-call count once a batch; (c) the device resize at
     896x1408 on the card against the CPU (as 5o at 512x512), and its ms a
     B=4 batch from the tree's tiles and from 640x640 ones; (d) evaluate_coco
     over the COCO tree with raw tiles at 896x1408: AP, AP50, AP75 = 1 from
     a GT pipeline that also puts a top-scored detection on the crowd
     region, then the default int8 pipeline of HISFCOS(80, 256) (phase 5g's
     model) with the device resize, calibrated on device-resized canvases,
     B=4, each batch launching COCO_PIPELINE_LAUNCHES (K9 on P3 and P4),
     finite stats, results JSON records with the tree's image ids and
     category ids mapped back; (e) img/s of that evaluate_coco over the six
     frames served as COCO_EVAL_IDS ids, and the loader, the pipeline on
     tiles on the card and the pipeline with its copies over the same
     window; (f) the eval_coco CLI (--device-resize --int8) on the tree's
     config;
  5q. training (train/trainer.py, cli/train.py; the port's main path
     has no kernel in it: the GroupNorms take F.group_norm while autograd
     records): (a) one f32 step on the card against the same step on the
     CPU (HISFCOS(20, 256) at 256x256, B=2, TF32 off: loss, gradient
     cosine, updated parameters), the bf16 autocast step against the f32
     step at 512x512, B=16 (loss, gradient cosine of the backbone, the FPN
     and the head), the stem, layer1 and every BatchNorm buffer unchanged,
     kernel B launched no time in a step and 20 times in an eval forward
     right after it, groupnorm_act raising under autograd; (b) ms a step,
     img/s and the split into forward, targets + loss, backward and
     optimizer by CUDA events over TRAIN_WINDOW steps at 512x512, B=16,
     bf16, the peak memory, and a profile of 3 steps (the top kernels, the
     device's idle share); (c) learning on the committed VOC tree's
     eight frames until the loss is below 0.7 of its first value, on to
     TRAIN_FIT_STEPS steps, then evaluate_voc of the trained weights
     through the float pipeline and the default int8 pipeline, each batch
     counted, the float mAP above the untrained model's; (d) podt-torch-train on the tree's training config
     (DetectionLoader with HostAugment), --resume, --ring-loader;
  6. timing with CUDA events: kernel vs plain for A, B (on the float
     pipeline's 20 recorded calls, bf16 maps, scale and bias, at B=8 and
     repeated to B=64, beside F.group_norm then the activation), C (per block
     shape at B=8, and at B=64 the kernel alone: each with its bound, its
     rate, its tile, cluster split and conv1 recompute), K1 (B=8, and the
     kernel alone at B=64 and the COCO canvas), K4 (the
     laterals at B=8 and B=64; the per-conv path's 36 1x1 convs at B=8 and
     B=64, held exact there, each beside torch._int_mm), K5 (per HisBlock
     at B=8 and B=64, with its tile and T multiply-adds/s), K6 (its seeds
     launch, the level pools' cost inside K5: pool_add against add on the
     pooled map, and the standalone K6 on those four inputs), K7
     (per level, with its T multiply-adds/s, beside the bf16 float head at
     the same levels), K10 (B=8 back to back and from a CUDA graph, B=64
     both ways, each with its bound), K11, K13
     (beside kernel C's 16 launches on the same
     input, in turns, at B=8 and B=64), K15 (beside the bf16 float head),
     K16 (beside torch.matmul of the same GEMMs, epilogue not included,
     each with its TFLOP/s),
     K17 (B=8, and the kernel alone at B=64), K12 (its 15 calls of one B=8
     MNFCOS forward), K4''s three
     epilogues (K4 and K4' beside torch._int_mm of the same int8 GEMMs,
     epilogue not included), K9 against K7 at the COCO P3 shape, the
     library call where one PyTorch call computes the same function, each
     wrapper's host time, the fused backbone against the module forward
     (B=8 and B=64, in turns), and each pipeline's images/s at B=8 and B=64
     (paths 3 and 4 of 5h at B=64 only, path 2 not timed), the three
     MNFCOS pipelines' among them;
  6b-6j. torch.profiler breakdowns of one B=64 call of the float, the
     int8-backbone, the int8-FPN, the default, the per-conv, the
     fused-head, the MNFCOS int8-ladder, the chained and the stem-tail
     pipeline (a profile that raises
     fails the run; one whose profiler sees no device events prints "not
     measured"); 6e also splits K7's device time by its CUDA kernels
     (head_pw1, head_dw, head_pw2, head_towers, head_pred and the
     GroupNorm statistics) and K5's (his_produce, his_mid, his_out); 6g splits the fused head's device time at B=64
     into the NCHW -> NHWC copies of the levels, K15 and the output casts,
     beside the float head's, and K15's device time at each level by its
     CUDA kernels (fhead_pw1, fhead_dw, fhead_pw2, fhead_towers[_wg],
     fhead_pred); 6h times K12's 15 calls at B=64 one by one; 6j sums kernel
     B's, K17's and the copy kernels' device time.

Any failed check makes the script exit 1.  On success the last two lines
are the kernels JSON line and ``{"ok": true, "device": {...}}``, preceded by
the nvidia-smi line.  Imports no JAX.
"""
from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time
import traceback

CANVAS = (512, 512)
NUM_CLASSES = 20
FEATURES = 256
SEED = 0
# (C, H=W) of the head's GroupNorms at 512x512: stem_gn1/2 run on 2*256
# channels, cls/reg on 256; per level 2 GNs of each width
HEAD_SHAPES = [(c, h) for h in (64, 32, 16, 8, 4) for c in (512, 256)]
GN_ACTS = ("none", "relu", "silu")
GN_TOL_F32 = 1e-5
# bf16: kernel and plain version both compute in f32 from the same bf16
# input and round once; where the two f32 results straddle a bf16 rounding
# boundary they differ by one bf16 step, at most 2**-7 of the value
GN_TOL_BF16 = dict(rtol=2**-7, atol=1e-3)
# per-level maps, kernel run vs plain run, bf16: the GN outputs differ by
# single bf16 rounding flips, which then pass through up to three more bf16
# layers of the head (and the exp of ScaleExp); allow 2**-5 of the level
# range (about four bf16 steps at the top of the range)
LEVEL_TOL = 2**-5
# dequantized int8 C3..C5 against the float backbone's, bf16: per-tensor
# abs-max int8 keeps about two decimal digits of each activation
INT8_COS_MIN = 0.99
K2_PER_FORWARD, K3_PER_FORWARD = 13, 3
# phase 5o: distinct frames of the in-memory VOC-like dataset, and the ids
# it serves (the frames cycled: 16 batches at B=64, so the timed window
# holds a steady state of the loader and the pipeline overlapping); the
# device resize on the card against the CPU: at most one uint8 step on at
# most this share of the values (tests/test_torch_port_eval.py's tolerance
# against the JAX function: the f32 sums run in another order)
EVAL_FRAMES, EVAL_IDS, RESIZE_SHARE = 64, 1024, 2e-3
# phase 5p: the committed JPEG tree (scripts/make_port_fixtures.py), and the ids its six COCO frames are served
# as for the timed window (48 batches at B=4)
FIXTURE_TREE, COCO_EVAL_IDS = "tests/fixtures/port_eval", 192
# launches in one call of the int8-FPN pipeline, by wrapper
# (K6: one launch of its seeds kernel for the two seeds, none of the standalone 2x2 pool; the four level
# pools run inside K5's load, "qhisblock_pool_add")
FPN_PIPELINE_LAUNCHES = {"qstem_conv": 1, "qbottleneck": 13, "qbottleneck_s2": 3, "qmatmul": 3, "qhisblock": 7,
                         "qhisblock_pool_add": 4, "qmaxpool2x2": 0, "qmaxpool2x2_seeds": 1, "groupnorm_act": 20,
                         "cuda_nms_keep_mask": 1,
                         "qhishead_level": 0, "qhishead_level2": 0, "qconv3x3": 0, "qmaxpool3x3s2": 0,
                         "stem_bn_pool_quant": 0, "qchain": 0, "matmul_bn_act": 0, "hishead_level_fused": 0,
                         "qmm_variant": 0, "qmnblock": 0}
# launches in one call of the default pipeline (int8 FPN and head) at 512x512
DEFAULT_PIPELINE_LAUNCHES = dict(FPN_PIPELINE_LAUNCHES, groupnorm_act=0, qhishead_level=5)
# ... and at the 896x1408 COCO canvas: K9 on P3 (112x176) and P4 (56x88), above 64x64 pixels
COCO_CANVAS = (896, 1408)
COCO_PIPELINE_LAUNCHES = dict(DEFAULT_PIPELINE_LAUNCHES, qhishead_level=3, qhishead_level2=2)
# launches in one call of the float pipeline: kernel B on the head's 20 GroupNorms, kernel A
FLOAT_PIPELINE_LAUNCHES = dict({k: 0 for k in FPN_PIPELINE_LAUNCHES}, groupnorm_act=20, cuda_nms_keep_mask=1)
# phase 5q: config/voc.yaml's HISFCOS ranges; the optimizer of the timed and compared steps (the block's SGD)
# and of the learning run (tests/test_end_to_end.py's overfit: lr 5e-3, 50 steps of warm-up), its step cap
TRAIN_RANGES = [(-1, 32), (32, 96), (96, 192), (192, 384), (384, 9999999)]
TRAIN_OPT = {"name": "SGD", "lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-4, "warmup_steps": 500}
TRAIN_FIT_OPT = {"name": "SGD", "lr": 5e-3, "warmup_steps": 50, "milestones": (100000,)}
TRAIN_MAX_STEPS, TRAIN_FIT_STEPS, TRAIN_WARMUP, TRAIN_WINDOW = 300, 160, 10, 60
# the f32 step on the card against the CPU: the two sum the convolutions in another order, which the
# ResNet's backward amplifies (tests/test_torch_port_train.py: 3.3 % of a parameter's largest gradient
# between two f32 CPU runs, cosine 0.999998; the card against the CPU here: the updates 3.78 % of
# lr x max|g| apart, cosine 0.99999984); an update within 8 % of lr x max|g|
TRAIN_F32_LOSS_RTOL, TRAIN_F32_COS, TRAIN_F32_UPDATE = 1e-4, 0.9999, 0.08
# the bf16 autocast step against the f32 step: bf16 keeps 8 bits of each activation and weight (first card
# run: loss 2.65e-4 apart, gradient cosines 0.9958 backbone, 0.99972 FPN, 0.99986 head)
TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_COS = 2e-2, 0.98
# the int8 ResNet-50's other backends (phase 5h): make_eval_pipeline_int8 keywords, launches in one call
BACKEND_PATHS = {
    # 16 conv1 + 4 projection shortcuts + 16 conv3 on K4, and the 3 FPN laterals; 13 stride-1 conv2 on K11
    "per-conv": (dict(backend="pallas"),
                 dict(DEFAULT_PIPELINE_LAUNCHES, qbottleneck=0, qbottleneck_s2=0, qmatmul=39, qconv3x3=13)),
    # the 3 stride-2 blocks per conv: 3 conv1 + 3 shortcuts + 3 conv3 on K4
    "fuse_strided=False": (dict(fuse_strided=False), dict(DEFAULT_PIPELINE_LAUNCHES, qbottleneck_s2=0, qmatmul=12)),
    "direct stem": (dict(direct_stem=True), dict(DEFAULT_PIPELINE_LAUNCHES, qstem_conv=0, qmaxpool3x3s2=1)),
    # the float stem, the per-op oracle ladder, the folded float HisFPN and the float head
    "stem tail": (dict(int8_fpn=False, backend="pallas_stem_tail"),
                  dict({k: 0 for k in FPN_PIPELINE_LAUNCHES}, stem_bn_pool_quant=1, groupnorm_act=20,
                       cuda_nms_keep_mask=1)),
    "chained": (dict(chain_segments=True), dict(DEFAULT_PIPELINE_LAUNCHES, qbottleneck=0, qbottleneck_s2=0, qchain=3)),
}
# K5 against its plain version: SiLU/sigmoid through expf and the SE dots in
# another order move an element by one int8 step now and then
K5_MAX_STEP, K5_MAX_SHARE = 1, 0.05
# K7/K9 against their plain version: the JAX kernels' contract, max error
# under 0.05 of the range (here each output's own, stricter for cnt|reg
# than JAX's max|cls|) and cosine over 0.999, the cosine tightened to what
# the card shows with margin (worst seen 0.0114 of the range and cosine
# 0.9999993): exact GroupNorm statistics against f32 sums and SiLU through
# expf move an int8 intermediate by one step now and then
QHEAD_MAX_ERR, QHEAD_MIN_COS = 0.05, 0.99999
# K16 against its plain version: both round one f32 sum of the same exact
# bf16 products to bf16, summed in another order, so an output may be one
# bf16 step apart (at most 2**-7 of it); the atol (of the output's range)
# covers the order of the sums near 0
K16_RTOL, K16_ATOL = 2.0**-7, 2.0**-12
# K15 against its plain version: the same bf16 steps; the GroupNorm partial
# sums add in another order and expf is not torch's sigmoid, so a bf16
# value moves by a step now and then and the move passes through the later
# stages: max |diff| over each output's range, and cosine, tightened to what
# the card shows with margin (worst seen 0.0072 of the range and cosine
# 0.9999977 at the five levels and on random inputs)
K15_MAX_ERR, K15_MIN_COS = 2.0**-6, 0.99999
# one call of the fused-head pipeline (int8_fpn=False, fused_head=True)
FUSED_HEAD_LAUNCHES = dict({k: 0 for k in FPN_PIPELINE_LAUNCHES}, qbottleneck=13, qbottleneck_s2=3,
                           hishead_level_fused=5, cuda_nms_keep_mask=1)
# MNFCOS(20, 256), phases 5m and 5n: launches in one call of the float pipeline (the MNHead's 10 GroupNorms),
# of make_eval_pipeline_int8 (the JAX gate keeps the FPN and head float: kernel C and 10 B, no K12), and of the
# full int8 ladder from uint8 frames (K1, kernel C and 15 K12: 5 in the pyramid, 2 per head level)
MN_FLOAT_LAUNCHES = dict({k: 0 for k in FPN_PIPELINE_LAUNCHES}, groupnorm_act=10, cuda_nms_keep_mask=1)
MN_INT8_LAUNCHES = dict(MN_FLOAT_LAUNCHES, qbottleneck=13, qbottleneck_s2=3)
MN_LADDER_LAUNCHES = dict(MN_INT8_LAUNCHES, groupnorm_act=0, qstem_conv=1, qmnblock=15)
# K12 against its plain version: the JAX kernel's contract (tests/test_quant.py:1200-1254), at most one int8
# step on under 1e-3 of the elements; the ladder's maps, kernel run vs plain run, at cosine >= 0.999 (a step
# there would pass through the towers' GroupNorms)
K12_MAX_STEP, K12_MAX_SHARE, MN_LADDER_COS = 1, 1e-3, 0.999
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# device memory, int8 tensor-core operations, f32 on the CUDA cores
HBM_BYTES_S, INT8_OPS_S, F32_OPS_S, BF16_OPS_S = 3.35e12, 1979e12, 67e12, 989e12


def bound(nbytes: float, ops: float, peak_ops: float):
    """(ms, "bytes" or "operations"): the least time the card could take for
    work that moves ``nbytes`` and does ``ops`` operations at ``peak_ops``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Smoke:
    def __init__(self):
        self.failures = []
        self.t0 = time.perf_counter()

    def check(self, ok: bool, what: str) -> None:
        print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name, fn, *args):
        print(f"== {name} (at {time.perf_counter() - self.t0:.1f} s)", flush=True)
        try:
            return fn(*args)
        except Exception:  # a phase that raises is a failed phase; go on to the next
            traceback.print_exc()
            self.failures.append(f"{name}: raised")
            return None


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not measured"
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"


def smi_clocks() -> str:
    """The card's SM and memory clocks, temperature and power draw now, as
    nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,power.draw",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not measured"
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"


def cuda_ms(fn, iters: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn()``: ``iters`` calls back to back
    between two CUDA events, median over ``reps`` repetitions.  Calls queue
    as they do in the pipeline, so a call's host overhead counts only where
    the card waits for it."""
    import torch

    for _ in range(warmup):
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


def host_ms(fn, iters: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Milliseconds of host time per call of ``fn()``: ``iters`` calls
    back to back on the host clock, with no wait for the card inside (a
    few launches do not fill the launch queue), median over ``reps``
    repetitions.  Where it exceeds the card's time per call, the host
    bounds the calls."""
    import torch

    for _ in range(warmup):
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


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of ``fn()``: ``iters`` calls captured in one
    CUDA graph and replayed between two CUDA events, median over ``reps``
    replays: the card's time with no host launch cost between the calls."""
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


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    # the port itself: fails here when the script stands without the repo
    from pytorch_object_detection_tpu_torch import _build
    from pytorch_object_detection_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
    from pytorch_object_detection_tpu_torch.eval.evaluator import (
        Int8EvalPipeline, make_eval_pipeline, make_eval_pipeline_int8)
    from pytorch_object_detection_tpu_torch.models import head_int8, mnfcos_int8
    from pytorch_object_detection_tpu_torch.models.fcos import default_strides
    from pytorch_object_detection_tpu_torch.models.registry import build_model
    from pytorch_object_detection_tpu_torch.nn import fpn_int8, fused_resnet, layers, resnet_int8
    from pytorch_object_detection_tpu_torch.nn.fused_fpn import hisfpn_folded_forward
    from pytorch_object_detection_tpu_torch.ops import (
        cuda_nms, fused, gn, head, qblock, qchain, qconv, qhead, qhis, qmm_variants, qmnblock, qpool, qstem, stem)
    from pytorch_object_detection_tpu_torch.train import trainer
    from pytorch_object_detection_tpu_torch.ops.nms import batched_class_nms

    smoke = Smoke()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    card = f"[{smi}]"
    res = {}

    def phase1():
        print(f"  nvidia-smi: {smi}")
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
              f" count {torch.cuda.device_count()} python {sys.version.split()[0]}")
        # f32 comparisons below must not run convolutions/matmuls in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print("  TF32 off: torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False")

    def phase2():
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.perf_counter()
        libs = (gn._lib, cuda_nms._lib, qblock._lib, qstem._lib, qconv._lib, qpool._lib, qhis._lib, qhead._lib,
                qconv._lib3, qchain._lib, lambda: qchain._lib(1), stem._lib, fused._lib, head._lib, qmm_variants._lib,
                qmnblock._lib)
        with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per library (K13: two), all at once
            for fut in [pool.submit(lib) for lib in libs]:
                fut.result()  # a failed build raises here
        print(f"  build wall {time.perf_counter() - t0:.2f} s")
        for src, (secs, log) in _build.build_log.items():
            print(f"  {src}: nvcc {secs:.2f} s" + ("" if secs else " (already built)"))
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "error" in line.lower():
                    print(f"    {line.strip()}")

    def phase3():
        g = torch.Generator(device=dev).manual_seed(SEED)
        smem_max = qblock.card_limits(dev)[1]
        worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
        n_tiles = {"resident": 0, "stream": 0}

        def gn_case(b, c, h, w, dtype, pdtype, acts, what):
            """Kernel B within its contract against the plain version, and the
            same bits under every tile of gn_options (the chooser's weighs)."""
            x = (torch.randn(b, c, h, w, generator=g, device=dev) * 2.0 + torch.randn(
                1, c, 1, 1, generator=g, device=dev)).to(dtype)
            scale = (torch.rand(c, generator=g, device=dev) + 0.5).to(pdtype)
            bias = (torch.randn(c, generator=g, device=dev) * 0.3).to(pdtype)
            tiles = gn.gn_options(b, c, h * w, 32, x.element_size(), smem_max)
            for act in acts:
                with torch.inference_mode():
                    got = gn.groupnorm_act(x, scale, bias, act=act)
                    want = gn.groupnorm_act(x, scale, bias, act=act, plain=True)
                    differ = [t for t in tiles if not torch.equal(gn.groupnorm_act(x, scale, bias, act=act, tile=t),
                                                                  got)]
                torch.cuda.synchronize()
                for t in tiles:
                    n_tiles[t[0]] += 1
                err = float((got.float() - want.float()).abs().max())
                worst[dtype] = max(worst[dtype], err)
                if dtype == torch.float32:
                    ok = err <= GN_TOL_F32
                else:
                    ok = bool(torch.isclose(got.float(), want.float(), **GN_TOL_BF16).all())
                if not ok or differ or act == "relu":
                    smoke.check(ok and not differ and got.dtype == dtype,
                                f"GN {what} {str(dtype)[6:]} x, {str(pdtype)[6:]} scale B={b} C={c} {h}x{w} {act}: "
                                f"max abs err {err:.3g}; {len(tiles)} tiles, {len(differ)} differ from the chooser's "
                                f"{gn.pick_gn_tile(b, c, h * w, 32, x.element_size(), *qblock.card_limits(dev))}"
                                + (f" {differ}" if differ else ""))

        for dtype in (torch.bfloat16, torch.float32):
            for pdtype in (torch.bfloat16, torch.float32):
                for c, h in HEAD_SHAPES:
                    gn_case(8, c, h, h, dtype, pdtype, GN_ACTS, "head")
            # the COCO canvas's P3 slab (a cluster of 8 holds it), odd H*W (slabs off the 16-byte grid)
            gn_case(2, 512, 112, 176, dtype, torch.bfloat16, ("relu", "silu"), "COCO P3")
            gn_case(3, 256, 7, 11, dtype, torch.bfloat16, GN_ACTS, "odd")
            gn_case(2, 64, 7, 11, dtype, torch.float32, GN_ACTS, "odd")
        print(f"  GN max abs err: bf16 {worst[torch.bfloat16]:.6g} (tol rtol 2^-7 + atol 1e-3), "
              f"f32 {worst[torch.float32]:.6g} (tol {GN_TOL_F32}); outputs under forced tiles held equal to the "
              f"chooser's: {n_tiles['resident']} resident, {n_tiles['stream']} streaming")
        smoke.check(n_tiles["stream"] > 0, "GN: the streaming path forced by tile= at every shape")
        res["gn_err"] = worst[torch.bfloat16]

    def nms_compare(boxes, classes, valid, what):
        scores = torch.linspace(1.0, 0.0, boxes.shape[1], device=dev).expand(boxes.shape[0], -1)
        got = cuda_nms.cuda_batched_class_nms(boxes, scores, classes, valid, 0.6 if what != "adversarial" else 0.5)
        want = batched_class_nms(boxes, scores, classes, valid, 0.6 if what != "adversarial" else 0.5)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        smoke.check(n_diff == 0, f"NMS {what} {tuple(valid.shape)}: {n_diff} keep flags differ, "
                                 f"{int(want.sum())} kept of {int(valid.sum())} valid")
        res["nms_err"] = max(res.get("nms_err", 0.0), float(n_diff))

    def phase4():
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        xy = torch.rand(8, 1000, 2, generator=g, device=dev) * 400
        wh = torch.rand(8, 1000, 2, generator=g, device=dev) * 100 + 4
        classes = torch.randint(1, NUM_CLASSES + 1, (8, 1000), generator=g, device=dev, dtype=torch.int32)
        valid = torch.rand(8, 1000, generator=g, device=dev) > 0.1
        nms_compare(torch.cat([xy, xy + wh], -1), classes, valid, "random")
        xy = torch.rand(64, 1000, 2, generator=g, device=dev) * 400
        wh = torch.rand(64, 1000, 2, generator=g, device=dev) * 100 + 4
        classes = torch.randint(1, NUM_CLASSES + 1, (64, 1000), generator=g, device=dev, dtype=torch.int32)
        nms_compare(torch.cat([xy, xy + wh], -1), classes, torch.rand(64, 1000, generator=g, device=dev) > 0.1,
                    "random")
        # each box overlaps the next at IoU 2/3 and the one after at 3/7: the
        # longest chain of suppressions a 64-row tile can resolve
        x = torch.arange(1000, dtype=torch.float32, device=dev)[None, :, None] * 2.0
        chain = torch.cat([x, torch.zeros_like(x), x + 10.0, torch.full_like(x, 10.0)], -1)
        ones = torch.ones(1, 1000, dtype=torch.int32, device=dev)
        nms_compare(chain, ones, ones.bool(), "chain")
        got = cuda_nms.cuda_batched_class_nms(chain, ones.float(), ones, ones.bool(), 0.6)
        smoke.check(torch.equal(got[0].cpu(), torch.arange(1000) % 2 == 0), "NMS chain keeps every other box")
        adv = torch.tensor([[0, 0, 10, 10], [0, 0, 10, 10], [0, 0, 10, 10], [5, 5, 5, 5], [5, 5, 5, 5],
                            [20, 0, 24, 3], [20, 0, 22, 3], [20, 0, 23, 3], [50, 50, 60, 60]],
                           dtype=torch.float32, device=dev)[None]
        adv_valid = torch.tensor([[True] * 8 + [False]], device=dev)
        nms_compare(adv, torch.ones(1, 9, dtype=torch.int32, device=dev), adv_valid, "adversarial")
        got = cuda_nms.cuda_nms_keep_mask(adv, adv_valid, 0.5).cpu().tolist()
        smoke.check(got == [[True, False, False, True, True, True, True, False, False]],
                    "NMS adversarial keep == [1,0,0,1,1,1,1,0,0]")

    def phase5():
        gen = torch.Generator().manual_seed(SEED)
        t0 = time.perf_counter()
        model = build_model("HISFCOS", NUM_CLASSES, FEATURES, device=dev, generator=gen)
        pipe = make_eval_pipeline(model, default_strides(), CANVAS, compute_dtype=torch.bfloat16)
        plain_pipe = make_eval_pipeline(model, default_strides(), CANVAS, compute_dtype=torch.bfloat16,
                                        plain=True)
        frames_gen = torch.Generator(device=dev).manual_seed(SEED + 2)
        frames = torch.randint(0, 256, (8, *CANVAS, 3), generator=frames_gen, device=dev, dtype=torch.uint8)
        print(f"  model + pipelines built in {time.perf_counter() - t0:.2f} s; "
              f"{sum(p.numel() for p in model.parameters())} parameters")
        res.update(model=model, pipe=pipe, plain_pipe=plain_pipe)

        # the main path, counted: counters to 0 just before, read just after
        gn.groupnorm_act.launches = 0
        cuda_nms.cuda_nms_keep_mask.launches = 0
        dets = pipe(frames)
        torch.cuda.synchronize()
        res["launches"] = {"gn": gn.groupnorm_act.launches, "nms": cuda_nms.cuda_nms_keep_mask.launches}
        print(f"  launches in one pipeline call (B=8): {res['launches']}")
        smoke.check(res["launches"]["gn"] == 20, "kernel B launched 20 times per forward")
        smoke.check(res["launches"]["nms"] == 1, "kernel A launched once per batch")
        # kernel B's own operands on this path (bf16 maps, the bf16 model's scale and bias), for phase 6
        res["gn_calls"] = record_calls(layers, ("groupnorm_act",), lambda: pipe(frames))["groupnorm_act"]

        k = 1000
        smoke.check(tuple(dets.scores.shape) == (8, k) and tuple(dets.boxes.shape) == (8, k, 4)
                    and tuple(dets.classes.shape) == (8, k) and tuple(dets.valid.shape) == (8, k),
                    f"Detections shapes {tuple(dets.scores.shape)} {tuple(dets.boxes.shape)}")
        smoke.check(bool(torch.isfinite(dets.scores).all() and torch.isfinite(dets.boxes).all()),
                    "detections finite")
        n_valid = dets.valid.sum(dim=1).tolist()
        print(f"  valid detections per image: {n_valid}; top score {float(dets.scores[:, 0].max()):.4f}")
        smoke.check(all(0 < n <= k for n in n_valid), "every image has detections")

        levels = pipe.forward_levels(frames)
        print(f"  level shapes (cls): {[tuple(t.shape) for t in levels[0]]}")
        compare_levels(levels, plain_pipe.forward_levels(frames), "float pipeline")

        # phase 4, third input: the pipeline's own decoded boxes
        valid_in = dets.scores >= 0.05
        nms_compare(dets.boxes.contiguous(), dets.classes, valid_in, "pipeline boxes")
        res["nms_boxes"] = (dets.boxes.contiguous(), dets.classes, valid_in)
        res["frames"] = frames

    def compare_levels(levels, plain_levels, what):
        for name, got_b, want_b in zip(("cls", "cnt", "reg"), levels, plain_levels):
            scale = max(float(t.abs().max()) for t in want_b)
            err = max(float((a - b).abs().max()) for a, b in zip(got_b, want_b))
            finite = all(bool(torch.isfinite(t).all()) for t in got_b)
            smoke.check(finite and err <= LEVEL_TOL * scale,
                        f"{what} {name} levels: kernel vs plain max abs err {err:.4g} "
                        f"(range {scale:.4g}, tol {LEVEL_TOL * scale:.4g}), finite {finite}")

    def phase5b():
        model, frames = res["model"], res["frames"]
        mean = torch.tensor(IMAGENET_MEAN, device=dev)
        std = torch.tensor(IMAGENET_STD, device=dev)
        norm = (frames.float() / 255.0 - mean) / std
        t0 = time.perf_counter()
        ipipe = make_eval_pipeline_int8(model, norm, default_strides(), CANVAS, int8_fpn=False,
                                        compute_dtype=torch.bfloat16)
        iplain = make_eval_pipeline_int8(model, norm, default_strides(), CANVAS, int8_fpn=False,
                                         compute_dtype=torch.bfloat16, plain=True)
        # one calibration for both: two bf16 calibrations on cuDNN need not
        # give the same taps, and the comparison needs the same int8 weights
        iplain.qtree = ipipe.qtree
        torch.cuda.synchronize()
        print(f"  int8 pipelines built (calibration on the 8 frames, bf16) in {time.perf_counter() - t0:.2f} s")
        res.update(ipipe=ipipe, iplain=iplain, norm=norm)

        # the main path, counted: counters to 0 just before, read just after
        for counter in (qblock.qbottleneck, qblock.qbottleneck_s2, gn.groupnorm_act, cuda_nms.cuda_nms_keep_mask):
            counter.launches = 0
        dets = ipipe(frames)
        torch.cuda.synchronize()
        res["int8_launches"] = {"qbottleneck": qblock.qbottleneck.launches,
                                "qbottleneck_s2": qblock.qbottleneck_s2.launches,
                                "gn": gn.groupnorm_act.launches, "nms": cuda_nms.cuda_nms_keep_mask.launches}
        print(f"  launches in one int8 pipeline call (B=8): {res['int8_launches']}")
        smoke.check(res["int8_launches"] == {"qbottleneck": K2_PER_FORWARD, "qbottleneck_s2": K3_PER_FORWARD,
                                             "gn": 20, "nms": 1},
                    f"kernel C launched {K2_PER_FORWARD} (K2) + {K3_PER_FORWARD} (K3) times, kernel B 20, "
                    "kernel A once")
        smoke.check(tuple(dets.boxes.shape) == (8, 1000, 4) and bool(torch.isfinite(dets.scores).all())
                    and bool(torch.isfinite(dets.boxes).all()), "int8 detections [8, 1000] and finite")
        n_valid = dets.valid.sum(dim=1).tolist()
        print(f"  int8 valid detections per image: {n_valid}; top score {float(dets.scores[:, 0].max()):.4f}")
        smoke.check(all(0 < n <= 1000 for n in n_valid), "every image has int8 detections")

        with torch.inference_mode():
            feats = {}
            for plain in (False, True):
                feats[plain] = resnet_int8.resnet50_int8_forward(
                    ipipe.qtree, norm, torch.bfloat16, backend="pallas_block", fuse_strided=True,
                    dequant=False, plain=plain)
            float_feats = res["pipe"].model.backbone(norm.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous())
        torch.cuda.synchronize()
        cosines = []
        for i, (q, want, s, f) in enumerate(zip(feats[False][0], feats[True][0], feats[False][1], float_feats)):
            n_diff = int((q != want).sum())
            smoke.check(q.dtype == torch.int8 and n_diff == 0,
                        f"C{i + 3} int8 {tuple(q.shape)}: kernel vs plain ladder, {n_diff} elements differ")
            deq = (q.float() * s).permute(0, 3, 1, 2)
            ff = f.float()
            cos = float((deq * ff).sum() / (deq.norm() * ff.norm()))
            cosines.append(cos)
            smoke.check(cos >= INT8_COS_MIN, f"C{i + 3} cosine of the dequantized int8 vs the float backbone: "
                                             f"{cos:.6f} (min {INT8_COS_MIN})")
        res["int8_cos"] = cosines
        compare_levels(ipipe.forward_levels(frames), iplain.forward_levels(frames), "int8 pipeline")

    def phase5c():
        qtree, norm = res["ipipe"].qtree, res["norm"]
        g = torch.Generator(device=dev).manual_seed(SEED + 4)
        cases, worst = [], 0
        with torch.inference_mode():
            x = resnet_int8.resnet50_int8_stem(qtree, norm, torch.bfloat16, "pallas_block")
            for scope, stage, b in resnet_int8.block_scopes():
                stride = 2 if (b == 0 and stage > 0) else 1
                blk = qtree[scope]
                rand_x = torch.randint(-127, 128, x.shape, generator=g, device=dev, dtype=torch.int8)
                nxt = None
                for what, inp in (("ladder", x), ("random", rand_x)):
                    got = resnet_int8.bottleneck_int8(blk, inp, stride, "pallas_block")
                    want = resnet_int8.bottleneck_int8(blk, inp, stride, "pallas_block", plain=True)
                    torch.cuda.synchronize()
                    diff = (got.int() - want.int()).abs()
                    n_diff, worst = int((diff > 0).sum()), max(worst, int(diff.max()))
                    smoke.check(n_diff == 0 and got.shape == want.shape,
                                f"kernel C {scope} s{stride} {tuple(inp.shape)} -> {tuple(got.shape)} {what}: "
                                f"{n_diff} of {want.numel()} int8 elements differ, "
                                f"{float((want > 0).float().mean()):.3f} nonzero")
                    nxt = want if nxt is None else nxt
                cases.append((scope, stride, blk, x))
                x = nxt  # the plain ladder's output feeds the next block
        res["qblock_cases"], res["qblock_err"] = cases, float(worst)


    class PoolAddCount:
        """K5's count of its calls with the level pool in its load, as a counter."""
        launches = property(lambda self: qhis.qhisblock.pool_add_launches,
                            lambda self, n: setattr(qhis.qhisblock, "pool_add_launches", n))

    counters = {"qstem_conv": qstem.qstem_conv, "qbottleneck": qblock.qbottleneck,
                "qbottleneck_s2": qblock.qbottleneck_s2, "qmatmul": qconv.qmatmul, "qhisblock": qhis.qhisblock,
                "qhisblock_pool_add": PoolAddCount(),
                "qmaxpool2x2": qpool.qmaxpool2x2, "qmaxpool2x2_seeds": qpool.qmaxpool2x2_seeds,
                "groupnorm_act": gn.groupnorm_act,
                "cuda_nms_keep_mask": cuda_nms.cuda_nms_keep_mask, "qhishead_level": qhead.qhishead_level,
                "qhishead_level2": qhead.qhishead_level2, "qconv3x3": qconv.qconv3x3,
                "qmaxpool3x3s2": qpool.qmaxpool3x3s2, "stem_bn_pool_quant": stem.stem_bn_pool_quant,
                "qchain": qchain.qchain, "matmul_bn_act": fused.matmul_bn_act,
                "hishead_level_fused": head.hishead_level_fused, "qmm_variant": qmm_variants.qmm_variant,
                "qmnblock": qmnblock.qmnblock}

    def record_calls(module, names, run):
        """``run()`` with each of ``module``'s functions ``names`` wrapped to
        keep the arguments of every call: the kernels' real inputs."""
        calls = {name: [] for name in names}
        saved = {name: getattr(module, name) for name in names}

        def keep(name):
            def wrapper(*args, **kw):
                calls[name].append((args, kw))
                return saved[name](*args, **kw)
            return wrapper

        try:
            for name in names:
                setattr(module, name, keep(name))
            with torch.inference_mode():
                run()
        finally:
            for name, fn in saved.items():
                setattr(module, name, fn)
        return calls

    def record_fpn_calls(qtree_fpn, feats_q):
        """One int8 HisFPN forward on the kernels, keeping the arguments of
        each K4 (qconv1x1), K5 and K6 (the seeds) call."""
        return record_calls(fpn_int8, ("qconv1x1", "qhisblock", "qmaxpool2x2_seeds"),
                            lambda: fpn_int8.hisfpn_int8_forward(qtree_fpn, feats_q, backend="pallas", dequant=False))

    def count_launches(pipe, frames):
        """One pipeline call with every counter set to 0 just before and read just after."""
        for counter in counters.values():
            counter.launches = 0
        dets = pipe(frames)
        torch.cuda.synchronize()
        return dets, {k: c.launches for k, c in counters.items()}

    def cosine(a, b):
        a, b = a.float(), b.float()
        return float((a * b).sum() / (a.norm() * b.norm()))

    def phase5d():
        model, frames, norm = res["model"], res["frames"], res["norm"]
        args = (model, norm, default_strides(), CANVAS)
        t0 = time.perf_counter()
        fpipe = make_eval_pipeline_int8(*args, int8_fpn=True, int8_head=False, compute_dtype=torch.bfloat16)
        fplain = make_eval_pipeline_int8(*args, int8_fpn=True, int8_head=False, compute_dtype=torch.bfloat16,
                                         plain=True)
        fplain.qtree = fpipe.qtree  # one calibration for both, as in phase 5b
        torch.cuda.synchronize()
        print(f"  int8-FPN pipelines built (calibration on the 8 frames) in {time.perf_counter() - t0:.2f} s")
        res.update(fpipe=fpipe, fplain=fplain)

        dets, res["fpn_launches"] = count_launches(fpipe, frames)  # raw uint8 frames: no normalize pass
        print(f"  launches in one int8-FPN pipeline call (B=8): {res['fpn_launches']}")
        smoke.check(res["fpn_launches"] == FPN_PIPELINE_LAUNCHES,
                    "K1 1, K2 13, K3 3, K4 3, K5 7 (4 pool_add), K6 1, kernel B 20 and kernel A 1 launches "
                    "per call")
        smoke.check(tuple(dets.boxes.shape) == (8, 1000, 4) and bool(torch.isfinite(dets.scores).all())
                    and bool(torch.isfinite(dets.boxes).all()), "int8-FPN detections [8, 1000] and finite")
        n_valid = dets.valid.sum(dim=1).tolist()
        print(f"  int8-FPN valid detections per image: {n_valid}; top score {float(dets.scores[:, 0].max()):.4f}")
        smoke.check(all(0 < n <= 1000 for n in n_valid), "every image has int8-FPN detections")

        # kernel run vs plain run: K5's one-step flips pass through the later
        # blocks and the head, so the maps are held by cosine, not by a bound
        for name, got_b, want_b in zip(("cls", "cnt", "reg"), fpipe.forward_levels(frames),
                                       fplain.forward_levels(frames)):
            for i, (a, b) in enumerate(zip(got_b, want_b)):
                c = cosine(a, b)
                err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                smoke.check(bool(torch.isfinite(a).all()) and c >= INT8_COS_MIN,
                            f"int8-FPN {name} P{i + 3}: kernel vs plain pipeline cosine {c:.6f}, "
                            f"max abs err {err:.4g} of the range")

        qbb, qfpn = fpipe.qtree["backbone"], fpipe.qtree["fpn"]
        with torch.inference_mode():
            stem_q = qstem.qstem_conv(frames, qbb["stem_s2d"])
            stem_f = resnet_int8.resnet50_int8_stem(qbb, norm, torch.float32, "xla")  # f32, TF32 off
        d = (stem_q.int() - stem_f.int()).abs()
        smoke.check(stem_q.shape == stem_f.shape and int(d.max()) <= 1,
                    f"uint8 stem (K1) vs float stem (f32, pooled, quantized) {tuple(stem_q.shape)}: max "
                    f"{int(d.max())} step, {float((d > 0).float().mean()):.4%} of elements differ")

        with torch.inference_mode():
            feats_q, scales = resnet_int8.resnet50_int8_forward(qbb, frames, torch.float32, backend="pallas_block",
                                                                fuse_strided=True, dequant=False, u8_stem=True)
            levels = fpn_int8.hisfpn_int8_forward(qfpn, feats_q, torch.float32, backend="pallas")
            ref = hisfpn_folded_forward(model.fpn, [(q.float() * s).permute(0, 3, 1, 2).contiguous()
                                                    for q, s in zip(feats_q, scales)], torch.float32)
        cosines = []
        for i, (lv, r) in enumerate(zip(levels, ref)):
            c = cosine(lv, r.permute(0, 2, 3, 1))
            cosines.append(c)
            smoke.check(c >= INT8_COS_MIN, f"P{i + 3} {tuple(lv.shape)}: cosine of the dequantized int8 HisFPN "
                                           f"vs the BN-folded float HisFPN (f32) {c:.6f} (min {INT8_COS_MIN})")
        res["fpn_cos"] = cosines
        res["fpn_calls"] = record_fpn_calls(qfpn, feats_q)
        print(f"  recorded calls: {({k: len(v) for k, v in res['fpn_calls'].items()})}")

    def phase5e():
        frames, st = res["frames"], res["fpipe"].qtree["backbone"]["stem_s2d"]
        calls = res["fpn_calls"]
        g = torch.Generator(device=dev).manual_seed(SEED + 5)
        err = {"qstem": 0, "qmatmul": 0, "qhisblock": 0, "qmaxpool2x2": 0, "qmaxpool2x2_seeds": 0}

        def exact(key, got, want, what):
            torch.cuda.synchronize()
            n_diff = int((got != want).sum())
            err[key] = max(err[key], int((got.int() - want.int()).abs().max()) if got.numel() else 0)
            smoke.check(n_diff == 0 and got.shape == want.shape,
                        f"{what} -> {tuple(got.shape)}: {n_diff} of {want.numel()} int8 elements differ")

        with torch.inference_mode():
            rand = torch.randint(0, 256, frames.shape, generator=g, device=dev, dtype=torch.uint8)
            for what, fr in (("seeded frames", frames), ("random frames", rand)):
                exact("qstem", qstem.qstem_conv(fr, st), qstem.qstem_conv(fr, st, plain=True),
                      f"K1 {what} {tuple(fr.shape)}")
            # K1 at the throughput batch, the COCO canvas and an odd size (pooled 25x33), 3 and 4 channels,
            # under the chooser's tile and forced ones (the output does not depend on it)
            sm_count, smem_max = qblock.card_limits(dev)
            for shape in ((64, *CANVAS, 3), (2, *COCO_CANVAS, 3), (3, 98, 130, 3), (3, 98, 130, 4)):
                fr = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
                want = qstem.qstem_conv(fr, st, plain=True)
                pick = qstem.pick_stem_tile(shape[0], shape[1], shape[2], sm_count, smem_max)
                for tile in (None, (2, 3)) if shape[0] == 64 else (None, (2, 3), (8, 32), (32, 8)):
                    exact("qstem", qstem.qstem_conv(fr, st, tile=tile), want,
                          f"K1 random frames {shape}, tile {tile or pick}")
            t5 = calls["qmaxpool2x2_seeds"][0][0][0]
            for x in (t5, torch.randint(-128, 128, (3, 7, 11, 48), generator=g, device=dev, dtype=torch.int8)):
                got, want = qpool.qmaxpool2x2_seeds(x), qpool.qmaxpool2x2_seeds(x, plain=True)
                for i, (a, b) in enumerate(zip(got, want)):
                    exact("qmaxpool2x2_seeds", a, b, f"K6 seeds: seed{6 + i} of {tuple(x.shape)}")
            for (x, w, a, b), kw in calls["qconv1x1"]:
                exact("qmatmul", qconv.qconv1x1(x, w, a, b), qconv.qconv1x1(x, w, a, b, plain=True),
                      f"K4 lateral {tuple(x.shape)} x {tuple(w.shape)}")
            (x, w, a, b), _ = calls["qconv1x1"][-1]  # tf3, the largest
            r = torch.randint(-127, 128, (*x.shape[:3], w.shape[0]), generator=g, device=dev, dtype=torch.int8)
            for relu in (True, False):
                kw = dict(relu=relu, res=r, res_scale=torch.tensor(0.37, device=dev))
                exact("qmatmul", qconv.qconv1x1(x, w, a, b, **kw), qconv.qconv1x1(x, w, a, b, plain=True, **kw),
                      f"K4 residual variant relu={relu} {tuple(x.shape)}")
            pooled = [(blk, xa, kw) for (blk, xa), kw in calls["qhisblock"] if kw.get("combine") == "pool_add"]
            for _, x, _ in pooled:  # the four level pools' inputs, through K6 alone
                exact("qmaxpool2x2", qpool.qmaxpool2x2(x), qpool.qmaxpool2x2(x, plain=True), f"K6 {tuple(x.shape)}")
            for i, ((blk, xa), kw) in enumerate(calls["qhisblock"]):
                kw = {k: v for k, v in kw.items() if k != "plain"}
                rand_kw = dict(kw)
                if kw.get("xb_q") is not None:
                    rand_kw["xb_q"] = torch.randint(-127, 128, kw["xb_q"].shape, generator=g, device=dev,
                                                    dtype=torch.int8)
                rand_xa = torch.randint(-127, 128, xa.shape, generator=g, device=dev, dtype=torch.int8)
                for what, (x_in, k_in) in (("pipeline", (xa, kw)), ("random", (rand_xa, rand_kw))):
                    got = qhis.qhisblock(blk, x_in, **k_in)
                    want = qhis.qhisblock(blk, x_in, plain=True, **k_in)
                    torch.cuda.synchronize()
                    d = (got.int() - want.int()).abs()
                    step, share = int(d.max()), float((d > 0).float().mean())
                    err["qhisblock"] = max(err["qhisblock"], step)
                    smoke.check(step <= K5_MAX_STEP and share < K5_MAX_SHARE,
                                f"K5 his{i + 1} {kw.get('combine')} {what} {tuple(x_in.shape)} -> "
                                f"{tuple(got.shape)}: max {step} step, {share:.4%} of {want.numel()} differ, "
                                f"{float((want != 0).float().mean()):.3f} nonzero")
            sm_count, smem_max = qblock.card_limits(dev)
            for i, ((blk, xa), kw) in enumerate(calls["qhisblock"]):
                kw = {k: v for k, v in kw.items() if k != "plain"}
                b, h, w, cin = (kw["xb_q"] if kw.get("xb_q") is not None else xa).shape
                got = qhis.qhisblock(blk, xa, **kw)
                sliced = {k: (64 if k == "produce" else 1, qhis.his_slices(k, cin)[-1]) for k in qhis.HIS_KERNELS}
                for tile in ({"produce": (64, 1), "mid": (1, 1), "out": (1, 1)}, sliced):
                    forced = qhis.qhisblock(blk, xa, tile=tile, **kw)
                    torch.cuda.synchronize()
                    smoke.check(torch.equal(forced, got), f"K5 his{i + 1} {tuple(got.shape)}: tile {tile} equals the "
                                f"chooser's {qhis.pick_his_tile(b, h, w, cin, sm_count, smem_max)}")
            # the level pool in K5's load against K6, then K5 with "add", on his4..his7's own inputs
            smoke.check(len(pooled) == 4, f"{len(pooled)} K5 calls with pool_add recorded (his4..his7)")
            for i, (blk, xa, kw) in enumerate(pooled):
                kw = {k: v for k, v in kw.items() if k != "plain"}
                want = qhis.qhisblock(blk, qpool.qmaxpool2x2(xa), **dict(kw, combine="add"))
                b, h, w, cin = kw["xb_q"].shape
                sliced = {k: (64 if k == "produce" else 1, qhis.his_slices(k, cin)[-1]) for k in qhis.HIS_KERNELS}
                for tile in (None, {"produce": (64, 1), "mid": (1, 1), "out": (1, 1)}, sliced):
                    got = qhis.qhisblock(blk, xa, tile=tile, **kw)
                    torch.cuda.synchronize()
                    smoke.check(torch.equal(got, want), f"K5 his{i + 4} pool_add {tuple(xa.shape)} -> "
                                f"{tuple(got.shape)}, tile {tile or 'chooser'}: equal to K6 then K5 add "
                                f"({int((got != want).sum())} differ)")
        res["fpn_err"] = err

    def phase5f():
        model, frames, norm = res["model"], res["frames"], res["norm"]
        args = (model, norm, default_strides(), CANVAS)
        t0 = time.perf_counter()
        dpipe = make_eval_pipeline_int8(*args, compute_dtype=torch.bfloat16)  # the JAX defaults
        dplain = make_eval_pipeline_int8(*args, compute_dtype=torch.bfloat16, plain=True)
        dplain.qtree = dpipe.qtree  # one calibration for both, as in phase 5b
        torch.cuda.synchronize()
        print(f"  default pipelines built (calibration on the 8 frames) in {time.perf_counter() - t0:.2f} s; "
              f"qtree {sorted(dpipe.qtree)}")
        res.update(dpipe=dpipe, dplain=dplain)

        # the main path, counted: counters to 0 just before, read just after
        dets, launches = count_launches(dpipe, frames)  # raw uint8 frames
        res["default_launches"] = launches
        print(f"  launches in one default pipeline call (B=8): {launches}")
        smoke.check(launches == DEFAULT_PIPELINE_LAUNCHES,
                    "K1 1, K2 13, K3 3, K4 3, K5 7 (4 pool_add), K6 1, K7 5, K9 0, kernel B 0 and kernel A 1 "
                    "launches per call")
        smoke.check(tuple(dets.boxes.shape) == (8, 1000, 4) and bool(torch.isfinite(dets.scores).all())
                    and bool(torch.isfinite(dets.boxes).all()), "default-pipeline detections [8, 1000] and finite")
        n_valid = dets.valid.sum(dim=1).tolist()
        print(f"  default valid detections per image: {n_valid}; top score {float(dets.scores[:, 0].max()):.4f}")
        smoke.check(all(0 < n <= 1000 for n in n_valid), "every image has default-pipeline detections")

        # kernel run vs plain run: K5's and K7's one-step flips pass on, so the maps are held by cosine
        for name, got_b, want_b in zip(("cls", "cnt", "reg"), dpipe.forward_levels(frames),
                                       dplain.forward_levels(frames)):
            for i, (a, b) in enumerate(zip(got_b, want_b)):
                c = cosine(a, b)
                err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                smoke.check(bool(torch.isfinite(a).all()) and c >= INT8_COS_MIN,
                            f"default {name} P{i + 3}: kernel vs plain pipeline cosine {c:.6f}, "
                            f"max abs err {err:.4g} of the range")

        # the int8 head against the bf16 float head on the same dequantized int8 levels
        qbb, qfpn, qh = (dpipe.qtree[k] for k in ("backbone", "fpn", "head"))
        with torch.inference_mode():
            feats_q, _ = resnet_int8.resnet50_int8_forward(qbb, frames, torch.bfloat16, backend="pallas_block",
                                                           fuse_strided=True, dequant=False, u8_stem=True)
            levels_q, scales = fpn_int8.hisfpn_int8_forward(qfpn, feats_q, backend="pallas", dequant=False)
            int8_out = head_int8.hishead_int8_forward(qh, levels_q, backend="pallas")
            float_head = copy.deepcopy(model.head).to(torch.bfloat16).eval()
            deq = [(q.float() * s).to(torch.bfloat16).permute(0, 3, 1, 2).contiguous() for q, s in zip(levels_q, scales)]
            float_out = float_head(deq)
        cosines = []
        for name, a_b, f_b in zip(("cls", "cnt", "reg"), int8_out, float_out):
            for i, (a, f) in enumerate(zip(a_b, f_b)):
                c = cosine(a, f.permute(0, 2, 3, 1))
                cosines.append(c)
                smoke.check(c >= INT8_COS_MIN, f"{name} P{i + 3} {tuple(a.shape)}: int8 head vs bf16 float head on the "
                                               f"same dequantized levels, cosine {c:.6f} (min {INT8_COS_MIN})")
        res["head_cos"] = min(cosines)
        res["head_levels"] = (deq, float_head)
        res["head_calls"] = record_calls(head_int8, ("qhishead_level", "qhishead_level2"),
                                         lambda: head_int8.hishead_int8_forward(qh, levels_q, backend="pallas"))
        print(f"  recorded calls: {({k: len(v) for k, v in res['head_calls'].items()})}")

    def compare_head(key, got, want, what):
        """K7/K9 against the plain version: max error over the output's
        range and cosine, per output; the worst absolute error kept."""
        torch.cuda.synchronize()
        for name, a, b in zip(("cls", "cr"), got, want):
            abs_err = float((a - b).abs().max())
            err, c = abs_err / max(float(b.abs().max()), 1e-30), cosine(a, b)
            worst = res.setdefault("qhead_err", {}).setdefault(key, [0.0, 0.0, 1.0])
            worst[:] = [max(worst[0], abs_err), max(worst[1], err), min(worst[2], c)]
            smoke.check(bool(torch.isfinite(a).all()) and a.shape == b.shape and err <= QHEAD_MAX_ERR
                        and c >= QHEAD_MIN_COS,
                        f"{what} {name} {tuple(a.shape)}: max err {err:.4g} of the range ({abs_err:.4g}), "
                        f"cosine {c:.8f}")

    def phase5g():
        g = torch.Generator(device=dev).manual_seed(SEED + 6)
        with torch.inference_mode():
            for i, ((q, lv, x), kw) in enumerate(res["head_calls"]["qhishead_level"]):
                rand = torch.randint(-127, 128, x.shape, generator=g, device=dev, dtype=torch.int8)
                for what, inp in (("pipeline", x), ("random", rand)):
                    compare_head("qhishead_level", qhead.qhishead_level(q, lv, inp, **kw),
                                 qhead.qhishead_level(q, lv, inp, plain=True, **kw), f"K7 P{i + 3} {what}")

        # the COCO canvas: an 80-class model's default pipeline, counted
        t0 = time.perf_counter()
        model80 = build_model("HISFCOS", 80, FEATURES, device=dev, generator=torch.Generator().manual_seed(SEED + 7))
        res["model80"] = model80
        cframes = torch.randint(0, 256, (2, *COCO_CANVAS, 3), generator=torch.Generator(device=dev).manual_seed(
            SEED + 8), device=dev, dtype=torch.uint8)
        mean, std = torch.tensor(IMAGENET_MEAN, device=dev), torch.tensor(IMAGENET_STD, device=dev)
        cpipe = make_eval_pipeline_int8(model80, (cframes.float() / 255.0 - mean) / std, default_strides(),
                                        COCO_CANVAS, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        print(f"  HISFCOS(80, {FEATURES}) default pipeline at {COCO_CANVAS} built in {time.perf_counter() - t0:.2f} s")
        dets, launches = count_launches(cpipe, cframes)
        res["coco_launches"] = launches
        print(f"  launches in one default pipeline call (B=2, {COCO_CANVAS}): {launches}")
        smoke.check(launches == COCO_PIPELINE_LAUNCHES, "COCO canvas: K9 on P3 and P4, K7 on P5-P7, the rest as at 512")
        smoke.check(bool(torch.isfinite(dets.scores).all()) and bool(torch.isfinite(dets.boxes).all())
                    and all(n > 0 for n in dets.valid.sum(dim=1).tolist()), "COCO-canvas detections finite")
        qh80 = cpipe.qtree["head"]
        calls = record_calls(head_int8, ("qhishead_level2",), lambda: cpipe.forward_levels(cframes))
        with torch.inference_mode():
            for (q, lv, x), kw in calls["qhishead_level2"]:
                compare_head("qhishead_level2", qhead.qhishead_level2(q, lv, x, **kw),
                             qhead.qhishead_level2(q, lv, x, plain=True, **kw), f"K9 COCO pipeline {tuple(x.shape)}")
            for b in (8, 3):
                x = torch.clamp(torch.round(torch.randn(b, 112, 176, FEATURES, generator=g, device=dev) * 40),
                                -127, 127).to(torch.int8)
                before = (qhead.qhishead_level.launches, qhead.qhishead_level2.launches)
                got = qhead.qhishead_level2(qh80, qh80["levels"][0], x)
                torch.cuda.synchronize()
                moved = (qhead.qhishead_level.launches - before[0], qhead.qhishead_level2.launches - before[1])
                smoke.check(moved == ((0, 1) if b % 2 == 0 else (1, 0)),
                            f"qhishead_level2 B={b}: launches K7, K9 moved by {moved}")
                compare_head("qhishead_level2" if b % 2 == 0 else "qhishead_level", got,
                             qhead.qhishead_level2(qh80, qh80["levels"][0], x, plain=True),
                             f"K9 COCO P3 80 classes B={b}{' (odd: runs K7)' if b % 2 else ''}")
                if b == 8:
                    res["coco_p3"] = (qh80, qh80["levels"][0], x)
                    calls["qhishead_level2"].append(((qh80, qh80["levels"][0], x), {}))
            # K9 computes the same exact sums and f32 steps as K7 (pw1 recomputed
            # on the halo, no z1 map), and neither depends on its tiling: equal bits
            for (q, lv, x), kw in calls["qhishead_level2"]:
                k9, k7 = qhead.qhishead_level2(q, lv, x, **kw), qhead.qhishead_level(q, lv, x, **kw)
                one = qhead.qhishead_level(q, lv, x, tile={p: (1, 1) for p in qhead.HEAD_PASSES}, **kw)
                torch.cuda.synchronize()
                smoke.check(all(torch.equal(a, c) for a, c in zip(k9, k7)), f"K9 == K7 bit for bit {tuple(x.shape)}")
                smoke.check(all(torch.equal(a, c) for a, c in zip(one, k7)),
                            f"K7 with one image and all channels a block == the chooser's tiles {tuple(x.shape)}")

    def phase5h():
        model, frames, norm = res["model"], res["frames"], res["norm"]
        args = (model, norm, default_strides(), CANVAS)
        res["paths"], res["path_launches"] = {}, {}
        t0 = time.perf_counter()
        for name, (kw, want) in BACKEND_PATHS.items():
            pipe = make_eval_pipeline_int8(*args, compute_dtype=torch.bfloat16, **kw)
            plain = make_eval_pipeline_int8(*args, compute_dtype=torch.bfloat16, plain=True, **kw)
            # one qtree for all: the default pipeline's (the int8-backbone one's without the int8 FPN)
            pipe.qtree = plain.qtree = res["dpipe"].qtree if kw.get("int8_fpn", True) else res["ipipe"].qtree
            res["paths"][name] = (pipe, plain)
            dets, launches = count_launches(pipe, frames)
            res["path_launches"][name] = launches
            print(f"  {name}: launches in one pipeline call (B=8): {launches}")
            smoke.check(launches == want, f"{name}: launches per call as listed in BACKEND_PATHS")
            n_valid = dets.valid.sum(dim=1).tolist()
            smoke.check(tuple(dets.boxes.shape) == (8, 1000, 4) and bool(torch.isfinite(dets.scores).all())
                        and bool(torch.isfinite(dets.boxes).all()) and all(0 < n <= 1000 for n in n_valid),
                        f"{name}: detections [8, 1000], finite, {n_valid} valid")
            for branch, got_b, want_b in zip(("cls", "cnt", "reg"), pipe.forward_levels(frames),
                                             plain.forward_levels(frames)):
                worst = min(cosine(a, b) for a, b in zip(got_b, want_b))
                finite = all(bool(torch.isfinite(a).all()) for a in got_b)
                smoke.check(finite and worst >= INT8_COS_MIN,
                            f"{name} {branch} P3-P7: kernel vs plain pipeline, lowest cosine {worst:.6f}")
        torch.cuda.synchronize()
        print(f"  five backends' pipelines built and checked in {time.perf_counter() - t0:.2f} s")

        qbb, qi = res["dpipe"].qtree["backbone"], res["ipipe"].qtree
        bb = dict(compute_dtype=torch.bfloat16, dequant=False, u8_stem=True)
        with torch.inference_mode():
            block, scales = resnet_int8.resnet50_int8_forward(qbb, frames, backend="pallas_block", fuse_strided=True,
                                                              **bb)
            per_conv, per_conv_plain = (resnet_int8.resnet50_int8_forward(qbb, frames, backend="pallas", plain=plain,
                                                                          **bb)[0] for plain in (False, True))
            chained, _ = resnet_int8.resnet50_int8_forward(qbb, frames, backend="pallas_block", fuse_strided=True,
                                                           chain_segments=True, **bb)
            stem_k1 = qstem.qstem_conv(frames, qbb["stem_s2d"])
            stem_direct = qpool.qmaxpool3x3s2(resnet_int8.stem_direct_i8(qbb["stem_s2d"], qstem.to_rgbx(frames)))
            stem_float = resnet_int8.resnet50_int8_stem(qi, norm, torch.bfloat16, "pallas_block")
            stem_tail = resnet_int8.resnet50_int8_stem(qi, norm, torch.bfloat16, "pallas_stem_tail")
        torch.cuda.synchronize()
        for i, (k, p, b, c, s_) in enumerate(zip(per_conv, per_conv_plain, block, chained, scales)):
            n_diff = int((k != p).sum())
            smoke.check(n_diff == 0, f"per-conv C{i + 3} {tuple(k.shape)}: kernels vs plain, {n_diff} int8 differ")
            n_diff = int((c != b).sum())
            smoke.check(n_diff == 0, f"chained C{i + 3}: K13 vs kernel C, {n_diff} of {b.numel()} int8 differ")
            share, cos = float((k != b).float().mean()), cosine(k.float() * s_, b.float() * s_)
            smoke.check(cos >= INT8_COS_MIN, f"per-conv vs kernel C C{i + 3}: {share:.2%} of int8 values differ "
                                             f"(the shortcut requantized), dequantized cosine {cos:.6f}")
        n_diff = int((stem_direct != stem_k1).sum())
        smoke.check(n_diff == 0 and stem_direct.shape == stem_k1.shape,
                    f"direct stem (7x7/2 conv + K10) vs K1 {tuple(stem_k1.shape)}: {n_diff} int8 differ")
        d = (stem_tail.int() - stem_float.int()).abs()
        res["stem_tail_vs_float"] = (int((d > 0).sum()), d.numel())
        smoke.check(stem_tail.shape == stem_float.shape and int(d.max()) <= 1,
                    f"stem tail (K17) vs the float stem (bf16, quantize, int8 pool) {tuple(stem_tail.shape)}: "
                    f"{int((d > 0).sum())} of {d.numel()} differ, max {int(d.max())} step (x * (1 / s) vs x / s)")

        # the kernels' own inputs on these paths, for phases 5i and 6
        fwd = lambda **kw: resnet_int8.resnet50_int8_forward(qbb, frames, **bb, **kw)
        calls = record_calls(resnet_int8, ("qconv3x3", "qconv1x1"), lambda: fwd(backend="pallas"))
        calls.update(record_calls(resnet_int8, ("qmaxpool3x3s2",), lambda: fwd(backend="pallas_block",
                                                                                 direct_stem=True)))
        calls.update(record_calls(resnet_int8, ("qchain",), lambda: fwd(backend="pallas_block", fuse_strided=True,
                                                                          chain_segments=True)))
        calls.update(record_calls(resnet_int8, ("stem_bn_pool_quant",), lambda: resnet_int8.resnet50_int8_stem(
            qi, norm, torch.bfloat16, "pallas_stem_tail")))
        res["backend_calls"] = calls
        print(f"  recorded calls: {({k: len(v) for k, v in calls.items()})}")

    def phase5i():
        calls = res["backend_calls"]
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        err = {"qconv3x3": 0, "qmaxpool3x3s2": 0, "stem_bn_pool_quant": 0, "qchain": 0, "qconv1x1": 0}
        rand_i8 = lambda shape: torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

        def compare(key, got, want, what, max_step=0):
            torch.cuda.synchronize()
            d = (got.int() - want.int()).abs()
            step, n_diff = int(d.max()) if d.numel() else 0, int((d > 0).sum())
            err[key] = max(err[key], step)
            smoke.check(got.shape == want.shape and step <= max_step and (max_step or n_diff == 0),
                        f"{what} -> {tuple(got.shape)}: {n_diff} of {want.numel()} int8 elements differ, max "
                        f"{step} step, {float((want > 0).float().mean()):.3f} positive")

        with torch.inference_mode():
            seen = set()
            for (x, w, a, b), kw in calls["qconv3x3"]:
                inputs = [("pipeline", x)] + ([] if x.shape in seen else [("random", rand_i8(x.shape))])
                seen.add(x.shape)
                for what, inp in inputs:
                    compare("qconv3x3", qconv.qconv3x3(inp, w, a, b), qconv.qconv3x3(inp, w, a, b, plain=True),
                            f"K11 {what} {tuple(inp.shape)} x {tuple(w.shape)}")
            for (x, w, a, b), kw in calls["qconv1x1"]:  # K4 on the per-conv path's 36 1x1 convs
                kw = {key: v for key, v in kw.items() if key != "plain"}
                m, k, n = x.numel() // x.shape[-1], x.shape[-1], w.shape[0]
                compare("qconv1x1", qconv.qconv1x1(x, w, a, b, **kw), qconv.qconv1x1(x, w, a, b, plain=True, **kw),
                        f"K4 per-conv [{m}, {k}] x [{k}, {n}] res={kw.get('res') is not None} tile "
                        f"{qconv.pick_qmm_tile(m, n, k, *qblock.card_limits(dev))}")
            for (x,), _ in calls["qmaxpool3x3s2"]:
                for what, inp in (("pipeline", x), ("random", rand_i8(x.shape))):
                    compare("qmaxpool3x3s2", qpool.qmaxpool3x3s2(inp), qpool.qmaxpool3x3s2(inp, plain=True),
                            f"K10 {what} {tuple(inp.shape)}")
                # K10 at B=64, the COCO canvas's stem map and an odd one with C % 16 != 0 (the one-byte form),
                # under its chooser's band; at B=8 under forced ones
                for inp in (x.repeat(8, 1, 1, 1), rand_i8((2, 448, 704, 64)), rand_i8((3, 129, 97, 24))):
                    band = (qpool.pick_pool3_tile(*inp.shape[:3], *qblock.card_limits(dev), c=inp.shape[3])
                            if inp.shape[3] % 16 == 0 else "one-byte form")
                    compare("qmaxpool3x3s2", qpool.qmaxpool3x3s2(inp), qpool.qmaxpool3x3s2(inp, plain=True),
                            f"K10 random {tuple(inp.shape)} band {band}")
                want = qpool.qmaxpool3x3s2(x, plain=True)
                for tile in ((1, 8), (2, 64), (8, 16), (4, 128), (32, 8)):
                    compare("qmaxpool3x3s2", qpool.qmaxpool3x3s2(x, tile=tile), want,
                            f"K10 pipeline {tuple(x.shape)} band {tile}")
            for (x, mult, shift, scale), _ in calls["stem_bn_pool_quant"]:
                rand = (torch.randn(x.shape, generator=g, device=dev) * float(x.float().std())).to(x.dtype)
                for what, inp in (("pipeline", x), ("random", rand)):
                    compare("stem_bn_pool_quant", stem.stem_bn_pool_quant(inp, mult, shift, scale),
                            stem.stem_bn_pool_quant(inp, mult, shift, scale, plain=True), f"K17 {what} {tuple(inp.shape)}")
                # K17 at B=8, B=64 and an odd frame size under its chooser's band and forced ones, with the
                # cached bf16 mult and shift and with f32 ones
                for inp in (x, x.repeat(8, 1, 1, 1), x[:, :129, :97].contiguous()):
                    want = stem.stem_bn_pool_quant(inp, mult, shift, scale, plain=True)
                    for tile in (None, (1, 8), (4, 32), (16, 8), (2, 64)):
                        band = tile or stem.pick_stem_tail_tile(*inp.shape[:3], *qblock.card_limits(dev))
                        compare("stem_bn_pool_quant", stem.stem_bn_pool_quant(inp, mult, shift, scale, tile=tile),
                                want, f"K17 band {band} {tuple(inp.shape)}")
                    compare("stem_bn_pool_quant", stem.stem_bn_pool_quant(inp, mult.float(), shift.float(), scale),
                            want, f"K17 f32 mult and shift {tuple(inp.shape)}")
            for (x, blocks), _ in calls["qchain"]:
                for what, inp in (("pipeline", x), ("random", rand_i8(x.shape))):
                    compare("qchain", qchain.qchain(inp, blocks), qchain.qchain(inp, blocks, plain=True),
                            f"K13 {what} {len(blocks)} blocks {tuple(inp.shape)}, grid {qchain.qchain.grid}")
            # K11 at the four stage shapes, B=8 and B=64, under every tile it takes
            for x, w, a, b in {tuple(x.shape): (x, w, a, b) for (x, w, a, b), _ in calls["qconv3x3"]}.values():
                for bsz in (8, 64):
                    inp = rand_i8((bsz, *x.shape[1:]))
                    want = qconv.qconv3x3(inp, w, a, b, plain=True)
                    for tile in k11_tiles(inp, w):
                        compare("qconv3x3", qconv.qconv3x3(inp, w, a, b, tile=tile), want,
                                f"K11 B={bsz} {tuple(inp.shape)} x {tuple(w.shape)} tile "
                                f"{tile or qconv.pick_conv3_tile(*inp.shape, w.shape[0], *qblock.card_limits(dev))}")
            # K13 on each segment, B=8 and B=64, against kernel C block after
            # block and the plain chain, under the chooser's tiles and forced ones
            for (x, blocks), _ in calls["qchain"]:
                for bsz in (8, 64):
                    inp = rand_i8((bsz, *x.shape[1:]))
                    want = kernel_c_chain(inp, blocks)
                    compare("qchain", qchain.qchain(inp, blocks, plain=True), want,
                            f"K13's plain chain B={bsz} {len(blocks)} blocks vs kernel C")
                    for tile in chain_tiles(inp, blocks):
                        got = qchain.qchain(inp, blocks, tile=tile)
                        compare("qchain", got, want, f"K13 B={bsz} {len(blocks)} blocks {tuple(inp.shape)} vs kernel "
                                                     f"C, tile {tile or 'chosen'}, grid {qchain.qchain.grid}")
        res["backend_err"] = err

    def kernel_c_chain(xq, blocks):  # a chain's blocks, one kernel C launch each
        for blk, s in blocks:
            xq = resnet_int8.bottleneck_int8(blk, xq, s, "pallas_block")
        return xq

    def k11_tiles(x, w):
        """None (the chooser's tile) and every (tw, split) K11 takes on x, w."""
        smem_max = qblock.card_limits(dev)[1]
        return [None] + [(tw, sp) for tw in qconv.CONV3_TILE_WIDTHS for sp in qconv.CONV3_SPLITS
                         if w.shape[0] % (16 * sp) == 0 and qconv.conv3_smem_bytes(tw, x.shape[-1]) <= smem_max]

    def chain_convs(x, blocks):
        """Per block of the chain on x: (H, W, Cw, Cout, stride)."""
        return tuple((h, w, blk["w1"].shape[0], cout, s) for (blk, s), ((h, w, _), (_, _, cout))
                     in zip(blocks, qchain.chain_shapes(x.shape[1:], blocks)))

    def chain_tiles(x, blocks):
        """None (the chooser's tiles), each (tw, split) every block takes, and
        per block its largest cluster."""
        convs = chain_convs(x, blocks)
        smem_max = qblock.card_limits(dev)[1]
        takes = lambda t, c: c[2] % (16 * t[1]) == 0 and c[3] % (16 * t[1]) == 0
        uniform = [(tw, sp) for tw in qblock.TILE_WIDTHS for sp in qblock.SPLITS if (tw == 8 or sp == 1)
                   and all(takes((tw, sp), c) for c in convs)
                   and qchain.chain_smem_bytes(convs, [(tw, sp)] * len(convs)) <= smem_max]
        return [None] + uniform + [[(8, max(sp for sp in qblock.SPLITS if takes((8, sp), c))) for c in convs]]

    def normalized(frames):
        mean, std = torch.tensor(IMAGENET_MEAN, device=dev), torch.tensor(IMAGENET_STD, device=dev)
        return (frames.float() / 255.0 - mean) / std

    def k16_compare(got, want, what):
        """K16 against its plain version: within one bf16 step (K16_RTOL) plus
        K16_ATOL of the output's range; the worst step kept."""
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        scale = max(float(w.abs().max()), 1e-30)
        close = torch.isclose(g, w, rtol=K16_RTOL, atol=K16_ATOL * scale)
        err = float((g - w).abs().max())
        res["k16_err"] = max(res.get("k16_err", 0.0), err)
        smoke.check(got.shape == want.shape and got.dtype == want.dtype and bool(close.all()),
                    f"{what}: {int((~close).sum())} of {w.numel()} beyond one bf16 step, max abs err {err:.4g} "
                    f"(range {scale:.4g}), {float((g != w).float().mean()):.4%} differ")

    def phase5j():
        model, frames = res["model"], res["frames"]
        norm = normalized(frames)
        backbone = model.backbone
        t0 = time.perf_counter()
        folded = fused_resnet.fold_resnet50(backbone, torch.bfloat16)
        torch.cuda.synchronize()
        print(f"  BN folded once in {time.perf_counter() - t0:.2f} s")
        # the main path, counted: counters to 0 just before, read just after
        for counter in counters.values():
            counter.launches = 0
        with torch.inference_mode():
            feats = fused_resnet.resnet50_fused_forward(backbone, norm, torch.bfloat16, folded)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        res["fused_bb_launches"] = launches
        print(f"  launches in one fused backbone forward (B=8): {launches}")
        smoke.check(launches == dict({k: 0 for k in counters}, matmul_bn_act=32),
                    "K16 launched 32 times (conv1 and conv3 of 16 blocks), nothing else")
        with torch.inference_mode():
            module = res["pipe"].model.backbone(norm.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous())
        torch.cuda.synchronize()
        cosines = []
        for i, (f, m) in enumerate(zip(feats, module)):
            m = m.permute(0, 2, 3, 1)
            scale = float(m.float().abs().max())
            err = float((f.float() - m.float()).abs().max())
            c = cosine(f, m)
            cosines.append(c)
            smoke.check(f.shape == m.shape and f.dtype == torch.bfloat16 and bool(torch.isfinite(f).all())
                        and err <= LEVEL_TOL * scale and c >= 0.999,
                        f"fused C{i + 3} {tuple(f.shape)} vs the bf16 module forward: max abs err {err:.4g} "
                        f"(range {scale:.4g}, tol {LEVEL_TOL * scale:.4g}), cosine {c:.6f}")
        res["fused_bb_cos"] = cosines
        calls = record_calls(fused_resnet, ("conv1x1_bn_act",),
                             lambda: fused_resnet.resnet50_fused_forward(backbone, norm, torch.bfloat16, folded))
        res["k16_calls"], res["folded"], res["norm8"] = calls["conv1x1_bn_act"], folded, norm
        print(f"  recorded K16 calls: {len(res['k16_calls'])}")
        g = torch.Generator(device=dev).manual_seed(SEED + 10)
        with torch.inference_mode():
            for i, ((x, w, sc, sh), kw) in enumerate(res["k16_calls"]):
                kw = {k: v for k, v in kw.items() if k != "plain"}
                m, k, n = x.numel() // x.shape[-1], x.shape[-1], w.shape[0]
                k16_compare(fused.conv1x1_bn_act(x, w, sc, sh, **kw), fused.conv1x1_bn_act(x, w, sc, sh, plain=True,
                                                                                            **kw),
                            f"K16 call {i} [{m}, {k}] x [{k}, {n}] residual {kw.get('residual') is not None}")
            for m, k, n in ((1000, 77, 130), (37, 24, 5), (131073, 64, 257), (2049, 1031, 511)):
                x = torch.randn(m, k, generator=g, device=dev).bfloat16()
                w = (torch.randn(n, k, generator=g, device=dev) / k ** 0.5).bfloat16()
                sc, sh = torch.rand(n, generator=g, device=dev) + 0.5, torch.randn(n, generator=g, device=dev) * 0.1
                r = torch.randn(m, n, generator=g, device=dev).bfloat16()
                for act, rr in ((True, r), (False, None)):
                    k16_compare(fused.matmul_bn_act(x, w, sc, sh, rr, act),
                                fused.matmul_bn_act(x, w, sc, sh, rr, act, plain=True),
                                f"K16 random [{m}, {k}] x [{k}, {n}] act {act} residual {rr is not None}")

    def k15_errors(got, want, nc):
        """K15's worst max |diff| over the output's range and least cosine
        against its plain version, over the three outputs."""
        torch.cuda.synchronize()
        err, cos = 0.0, 1.0
        for sl in (slice(0, nc), slice(nc, nc + 1), slice(nc + 1, nc + 5)):
            a, b = got[..., sl].float(), want[..., sl].float()
            if not bool(torch.isfinite(a).all()):
                return float("inf"), 0.0
            err = max(err, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
            cos = min(cos, cosine(a, b))
        return err, cos

    def k15_compare(got, want, nc, what):
        """K15 against its plain version, per output: max |diff| over the
        output's range and cosine; the worst kept."""
        torch.cuda.synchronize()
        worst = res.setdefault("k15_err", [0.0, 0.0, 1.0])
        for name, sl in (("cls", slice(0, nc)), ("cnt", slice(nc, nc + 1)), ("reg", slice(nc + 1, nc + 5))):
            a, b = got[..., sl].float(), want[..., sl].float()
            abs_err = float((a - b).abs().max())
            err, c = abs_err / max(float(b.abs().max()), 1e-30), cosine(a, b)
            worst[:] = [max(worst[0], abs_err), max(worst[1], err), min(worst[2], c)]
            smoke.check(bool(torch.isfinite(a).all()) and got.shape == want.shape and err <= K15_MAX_ERR
                        and c >= K15_MIN_COS, f"{what} {name} {tuple(a.shape)}: max err {err:.4g} of the range "
                                              f"({abs_err:.4g}), cosine {c:.8f}")

    def phase5k():
        model, frames = res["model"], res["frames"]
        norm = res.get("norm8", normalized(frames))
        args = (model, norm, default_strides(), CANVAS)
        t0 = time.perf_counter()
        hpipe = make_eval_pipeline_int8(*args, int8_fpn=False, fused_head=True, compute_dtype=torch.bfloat16)
        hplain = make_eval_pipeline_int8(*args, int8_fpn=False, fused_head=True, compute_dtype=torch.bfloat16,
                                         plain=True)
        if "ipipe" in res:  # the int8-backbone pipeline's qtree: the same backbone, one calibration for all
            hpipe.qtree = res["ipipe"].qtree
        hplain.qtree = hpipe.qtree
        torch.cuda.synchronize()
        print(f"  fused-head pipelines built in {time.perf_counter() - t0:.2f} s")
        res.update(hpipe=hpipe, hplain=hplain)

        dets, launches = count_launches(hpipe, frames)
        res["fused_head_launches"] = launches
        print(f"  launches in one fused-head pipeline call (B=8): {launches}")
        smoke.check(launches == FUSED_HEAD_LAUNCHES, "K2 13, K3 3, K15 5, kernel B 0 and kernel A 1 launches per call")
        n_valid = dets.valid.sum(dim=1).tolist()
        smoke.check(tuple(dets.boxes.shape) == (8, 1000, 4) and bool(torch.isfinite(dets.scores).all())
                    and bool(torch.isfinite(dets.boxes).all()) and all(0 < n <= 1000 for n in n_valid),
                    f"fused-head detections [8, 1000], finite, {n_valid} valid")
        for name, got_b, want_b in zip(("cls", "cnt", "reg"), hpipe.forward_levels(frames),
                                       hplain.forward_levels(frames)):
            for i, (a, b) in enumerate(zip(got_b, want_b)):
                c = cosine(a, b)
                err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                smoke.check(bool(torch.isfinite(a).all()) and c >= 0.999,
                            f"fused-head {name} P{i + 3}: kernel vs plain pipeline cosine {c:.6f}, max abs err "
                            f"{err:.4g} of the range")

        nc = model.num_classes
        calls = record_calls(trainer, ("hishead_level_fused",), lambda: hpipe.forward_levels(frames))
        res["k15_calls"] = calls["hishead_level_fused"]
        print(f"  recorded K15 calls: {[tuple(a[0].shape) for a, _ in res['k15_calls']]}")
        g = torch.Generator(device=dev).manual_seed(SEED + 11)
        float_head = copy.deepcopy(model.head).to(torch.bfloat16).eval()
        levels_nchw = []
        cosines = []
        with torch.inference_mode():
            for i, ((x, packed, nc_), kw) in enumerate(res["k15_calls"]):
                rand = (torch.randn(x.shape, generator=g, device=dev) * float(x.float().std())).to(x.dtype)
                for what, inp in (("pipeline", x), ("random", rand)):
                    k15_compare(head.hishead_level_fused(inp, packed, nc_), head.hishead_level_fused(
                        inp, packed, nc_, plain=True), nc_, f"K15 P{i + 3} {what}")
                levels_nchw.append(x.permute(0, 3, 1, 2).contiguous())
            float_out = float_head(levels_nchw)
            for i, ((x, packed, nc_), _) in enumerate(res["k15_calls"]):
                out = head.hishead_level_fused(x, packed, nc_)
                scale_i = getattr(model.head, f"scale{i}").scale.float()
                mine = (out[..., :nc], out[..., nc:nc + 1], torch.exp(out[..., nc + 1:].float() * scale_i))
                for name, a, f in zip(("cls", "cnt", "reg"), mine, (o[i] for o in float_out)):
                    c = cosine(a, f.permute(0, 2, 3, 1))
                    cosines.append(c)
                    smoke.check(c >= INT8_COS_MIN, f"{name} P{i + 3}: K15 vs the bf16 float head on the same levels, "
                                                   f"cosine {c:.6f} (min {INT8_COS_MIN})")
        res["k15_vs_float_head"] = min(cosines)
        res["k15_float_head"] = (float_head, levels_nchw)

        # K15 under every tile its chooser weighs: each pass's options one at a
        # time (the chooser's for the others), at the five levels of that call,
        # B=8 and the levels repeated to B=64; within the contract against the
        # plain version, and equal to the output under the chooser's tiles
        smem_max = qblock.card_limits(dev)[1]
        with torch.inference_mode():
            for i, ((x, packed, nc_), _) in enumerate(res["k15_calls"]):
                for xb in (x, x.repeat(8, 1, 1, 1)):
                    b, h, w, f = xb.shape
                    base = head.hishead_level_fused(xb, packed, nc_)
                    want = head.hishead_level_fused(xb, packed, nc_, plain=True)
                    n = same = 0
                    worst = [0.0, 1.0]
                    for pass_ in head.FHEAD_PASSES:
                        for opt in head.fhead_options(pass_, b, h, w, f, nc_, smem_max):
                            got = head.hishead_level_fused(xb, packed, nc_, tile={pass_: opt})
                            err, c = k15_errors(got, want, nc_)
                            worst[:] = [max(worst[0], err), min(worst[1], c)]
                            n, same = n + 1, same + bool(torch.equal(got, base))
                    smoke.check(worst[0] <= K15_MAX_ERR and worst[1] >= K15_MIN_COS and same == n,
                                f"K15 P{i + 3} B={b} under {n} forced tiles: max err {worst[0]:.4g} of the range, "
                                f"cosine {worst[1]:.8f}, {same} of {n} equal to the chooser's tile's output")

    def phase5l():
        inp = qmm_variants.make_inputs(device=dev, seed=SEED + 12)
        for counter in counters.values():
            counter.launches = 0
        with torch.inference_mode():
            got = qmm_variants.run_variants(inp)  # the harness's path: one launch of each epilogue
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        res["k4p_launches"] = launches
        smoke.check(launches == dict({k: 0 for k in counters}, qmm_variant=3),
                    f"K4' launched 3 times by the harness, nothing else: {launches['qmm_variant']}")
        with torch.inference_mode():
            want = qmm_variants.run_variants(inp, plain=True)
        torch.cuda.synchronize()
        res["k4p_err"] = 0
        for v in qmm_variants.VARIANTS:
            n_diff = int((got[v] != want[v]).sum())
            res["k4p_err"] = max(res["k4p_err"], int((got[v].int() - want[v].int()).abs().max()))
            smoke.check(n_diff == 0 and got[v].shape == want[v].shape,
                        f"K4' {v} {tuple(inp['x'].shape)} x {tuple(inp['w'].shape)}: {n_diff} of {want[v].numel()} "
                        f"int8 elements differ, {float((want[v] != 0).float().mean()):.3f} nonzero")
        res["k4p_inputs"] = inp

    def check_dets(dets, what):
        n_valid = dets.valid.sum(dim=1).tolist()
        smoke.check(tuple(dets.boxes.shape) == (8, 1000, 4) and bool(torch.isfinite(dets.scores).all())
                    and bool(torch.isfinite(dets.boxes).all()) and all(0 < n <= 1000 for n in n_valid),
                    f"{what} detections [8, 1000], finite, {n_valid} valid")

    def phase5m():
        frames = res["frames"]
        t0 = time.perf_counter()
        model = build_model("MNFCOS", NUM_CLASSES, FEATURES, device=dev, generator=torch.Generator().manual_seed(
            SEED + 13))
        mn_pipe = make_eval_pipeline(model, default_strides(), CANVAS, compute_dtype=torch.bfloat16)
        mn_plain = make_eval_pipeline(model, default_strides(), CANVAS, compute_dtype=torch.bfloat16, plain=True)
        torch.cuda.synchronize()
        print(f"  MNFCOS({NUM_CLASSES}, {FEATURES}) and its pipelines built in {time.perf_counter() - t0:.2f} s; "
              f"{sum(p.numel() for p in model.parameters())} parameters")
        res.update(mn_model=model, mn_pipe=mn_pipe)
        # the main path, counted: counters to 0 just before, read just after
        dets, launches = count_launches(mn_pipe, frames)
        res["mn_float_launches"] = launches
        print(f"  launches in one MNFCOS float pipeline call (B=8): {launches}")
        smoke.check(launches == MN_FLOAT_LAUNCHES, "kernel B 10 (the MNHead's GroupNorms) and kernel A 1 per call")
        check_dets(dets, "MNFCOS float")
        compare_levels(mn_pipe.forward_levels(frames), mn_plain.forward_levels(frames), "MNFCOS float pipeline")

    def mn_forward(qfpn, qhead, feats_q, backend):
        """The int8 LightweightFPN and MNHead on int8 C3..C5: (levels_q, scales, maps)."""
        levels_q, scales = mnfcos_int8.lwfpn_int8_forward(qfpn, feats_q, dequant=False, backend=backend)
        return levels_q, scales, mnfcos_int8.mnhead_int8_forward(qhead, levels_q, backend=backend)

    def phase5n():
        model, frames = res["mn_model"], res["frames"]
        norm = res.get("norm8", normalized(frames))
        args = (model, norm, default_strides(), CANVAS)
        # (i) make_eval_pipeline_int8 keeps the JAX gate: the int8 backbone, then the float pyramid and head
        t0 = time.perf_counter()
        mn_pipe8 = make_eval_pipeline_int8(*args, compute_dtype=torch.bfloat16)
        mn_plain8 = make_eval_pipeline_int8(*args, compute_dtype=torch.bfloat16, plain=True)
        mn_plain8.qtree = mn_pipe8.qtree  # one calibration for both, as in phase 5b
        torch.cuda.synchronize()
        print(f"  MNFCOS int8 pipelines built (calibration on the 8 frames, bf16) in {time.perf_counter() - t0:.2f} s")
        smoke.check("fpn" not in mn_pipe8.qtree and "layer1_0" in mn_pipe8.qtree and not mn_pipe8.u8_input,
                    "make_eval_pipeline_int8(MNFCOS): a backbone-only qtree and normalized input (the JAX gate)")
        dets, launches = count_launches(mn_pipe8, frames)
        res["mn_int8_launches"] = launches
        print(f"  launches in one make_eval_pipeline_int8(MNFCOS) call (B=8): {launches}")
        smoke.check(launches == MN_INT8_LAUNCHES, "K2 13, K3 3, kernel B 10, kernel A 1 and K12 0 per call")
        check_dets(dets, "MNFCOS int8-backbone")
        compare_levels(mn_pipe8.forward_levels(frames), mn_plain8.forward_levels(frames), "MNFCOS int8-backbone")

        # (ii) the full int8 ladder from raw uint8 frames, as the JAX serving bench builds it
        t0 = time.perf_counter()
        qbb = mn_pipe8.qtree
        qfpn = trainer.quantize_fpn(model, qbb, norm)
        qhead = trainer.quantize_head(model, qbb, qfpn, norm)
        qtree = {"backbone": qbb, "fpn": qfpn, "head": qhead}
        kw = dict(int8_fpn=True, int8_head=True, u8_input=True)
        place = (dev, default_strides(), CANVAS, 0.05, 0.6, 1000)
        lpipe = Int8EvalPipeline(trainer.make_eval_forward_int8(model, torch.bfloat16, **kw), qtree, *place, False,
                                 IMAGENET_MEAN, IMAGENET_STD, u8_input=True)
        lplain = Int8EvalPipeline(trainer.make_eval_forward_int8(model, torch.bfloat16, plain=True, **kw), qtree,
                                  *place, True, IMAGENET_MEAN, IMAGENET_STD, u8_input=True)
        torch.cuda.synchronize()
        print(f"  MNFCOS int8 ladder quantized (FPN and head, f32 on the oracles) in {time.perf_counter() - t0:.2f} s")
        res.update(mn_pipe8=mn_pipe8, lpipe=lpipe)
        dets, launches = count_launches(lpipe, frames)  # raw uint8 frames
        res["mn_ladder_launches"] = launches
        print(f"  launches in one MNFCOS int8-ladder call (B=8): {launches}")
        smoke.check(launches == MN_LADDER_LAUNCHES, "K1 1, K2 13, K3 3, K12 15, kernel B 0 and kernel A 1 per call")
        check_dets(dets, "MNFCOS int8-ladder")

        with torch.inference_mode():
            feats_q, feat_scales = resnet_int8.resnet50_int8_forward(qbb, frames, torch.bfloat16, backend="pallas_block",
                                                                     fuse_strided=True, dequant=False, u8_stem=True)
            lv_k, lv_s, _ = mn_forward(qfpn, qhead, feats_q, "pallas")
            lv_p, _, _ = mn_forward(qfpn, qhead, feats_q, "xla")
            ref = model.fpn([(q.float() * s).permute(0, 3, 1, 2).contiguous() for q, s in zip(feats_q, feat_scales)])
        torch.cuda.synchronize()
        cosines = []
        for i, (k, p, s_, r) in enumerate(zip(lv_k, lv_p, lv_s, ref)):
            d = (k.int() - p.int()).abs()
            step, n_diff = int(d.max()), int((d > 0).sum())
            smoke.check(k.shape == p.shape and step <= K12_MAX_STEP and n_diff / d.numel() < K12_MAX_SHARE,
                        f"MNFCOS P{i + 3} int8 {tuple(k.shape)}: K12 ladder vs plain ladder, {n_diff} of {d.numel()} "
                        f"differ, max {step} step")
            c = cosine(k.float() * s_, r.permute(0, 2, 3, 1))
            cosines.append(c)
            smoke.check(c >= INT8_COS_MIN, f"MNFCOS P{i + 3}: cosine of the dequantized int8 level vs the float "
                                           f"LightweightFPN (f32) on the same C3..C5 {c:.6f} (min {INT8_COS_MIN})")
        res["mn_fpn_cos"] = cosines
        for name, got_b, want_b in zip(("cls", "cnt", "reg"), lpipe.forward_levels(frames),
                                       lplain.forward_levels(frames)):
            for i, (a, b) in enumerate(zip(got_b, want_b)):
                c = cosine(a, b)
                err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                smoke.check(bool(torch.isfinite(a).all()) and c >= MN_LADDER_COS,
                            f"MNFCOS ladder {name} P{i + 3}: kernel vs plain pipeline cosine {c:.8f}, max abs err "
                            f"{err:.4g} of the range")
        res["mn_calls"] = record_calls(mnfcos_int8, ("qmnblock",), lambda: mn_forward(qfpn, qhead, feats_q, "pallas"))
        print(f"  recorded K12 calls: {[tuple(a[2].shape) + a[3:] for a, _ in res['mn_calls']['qmnblock']]}")

    def random_mnblock(b, h, w, c, k, g):
        """A random int8 MNBlock on the card (tests/test_quant.py:1213-1226's draws), its scales and an input."""
        i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        pos = lambda n: torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-5
        nrm = lambda n: torch.randn(n, generator=g, device=dev) * 0.1
        cm = 2 * c
        blk = dict(wdw=i8(k, k, c), swdw=pos(c), bdw=nrm(c), w1=i8(cm, c), sw1=pos(cm), b1=nrm(cm), w2=i8(c, cm),
                   sw2=pos(c), b2=nrm(c))
        sc = {n: torch.tensor(v, device=dev) for n, v in dict(s_in=0.05, s_a1=0.03, s_a2=0.04, s_out=0.06).items()}
        return blk, sc, i8(b, h, w, c)

    def phase5n_k12():
        g = torch.Generator(device=dev).manual_seed(SEED + 14)
        total = [0, 0, 0]  # worst step, differing elements, elements

        def compare(args, what):
            got = qmnblock.qmnblock(*args)
            want = qmnblock.qmnblock(*args, plain=True)
            torch.cuda.synchronize()
            d = (got.int() - want.int()).abs()
            step, n_diff = int(d.max()), int((d > 0).sum())
            total[:] = [max(total[0], step), total[1] + n_diff, total[2] + d.numel()]
            _, _, x, k, dil = args
            smoke.check(got.shape == want.shape and step <= K12_MAX_STEP and n_diff / d.numel() < K12_MAX_SHARE,
                        f"K12 {what} {tuple(x.shape)} k{k} d{dil}: {n_diff} of {d.numel()} int8 elements differ, max "
                        f"{step} step, {float((want != 0).float().mean()):.3f} nonzero")

        with torch.inference_mode():
            for i, (args, _) in enumerate(res["mn_calls"]["qmnblock"]):
                compare(args, f"call {i + 1} of 15")
            for h, w in ((28, 44), (7, 11), (1, 1)):
                for c in (64, 128):
                    for k, dil in ((5, 2), (7, 1)):
                        blk, sc, x = random_mnblock(3, h, w, c, k, g)
                        compare((blk, sc, x, k, dil), "random")
        res["k12_err"] = total[0]
        print(f"  K12 vs plain: {total[1]} of {total[2]} int8 elements differ, max {total[0]} step {card}")

        # K12 under every tile it takes, at the 15 calls (B=8) and their inputs
        # repeated to B=64: equal to its output under the chooser's tile, bit for bit
        smem_max = qblock.card_limits(dev)[1]
        with torch.inference_mode():
            for i, ((blk, sc, x, k, dil), _) in enumerate(res["mn_calls"]["qmnblock"]):
                for xb in (x, x.repeat(8, 1, 1, 1)):
                    b, h, w, c = xb.shape
                    base = qmnblock.qmnblock(blk, sc, xb, k, dil)
                    opts = qmnblock.mn_options(b, h, w, c, blk["w1"].shape[0], k, dil, smem_max)
                    differ = [o for o in opts if not torch.equal(qmnblock.qmnblock(blk, sc, xb, k, dil, tile=o), base)]
                    pick = qmnblock.pick_mn_tile(b, h, w, c, blk["w1"].shape[0], k, dil, *qblock.card_limits(dev))
                    smoke.check(not differ, f"K12 call {i + 1} B={b} {h}x{w} k{k} d{dil}: under {len(opts)} forced "
                                            f"tiles (tw, ipb, split) equal to the chooser's {pick}"
                                            + (f"; differ under {differ}" if differ else ""))

    def phase5o():
        """VOC evaluation from the dataset on the card: an in-memory VOC-like
        dataset of seeded frames (sides 300-500 px) in raw 512x512 tiles with
        seeded GT boxes of every class; (1) the device resize against the
        same call on the CPU; (2) evaluate_voc with a pipeline that returns
        each frame's GT at the device resize's scales: mAP 1; (3) evaluate_voc
        through DetectionLoader with the default int8 pipeline and
        device_resize=True, calibrated as the CLI does on the device-resized
        canvases of the first 8 frames, at B=16 and B=64, counted."""
        import hashlib

        import numpy as np

        from pytorch_object_detection_tpu_torch.data.pipeline import (
            DetectionLoader, decode_to_tile, make_device_resize)
        from pytorch_object_detection_tpu_torch.data.voc import VOC_CLASSES, Sample
        from pytorch_object_detection_tpu_torch.eval.evaluator import _collect, evaluate_voc
        from pytorch_object_detection_tpu_torch.ops.postprocess import Detections

        class FrameSet:
            """Seeded frames and GT boxes (original coordinates) as raw-tile
            Samples; id ``i`` serves frame ``i % n``."""
            raw_tiles, class_names, canvas_hw, tile_hw = True, VOC_CLASSES, CANVAS, CANVAS

            def __init__(self, n, ids, seed):
                rng = np.random.default_rng(seed)
                self.ids = ids
                self.frames, self.gt = [], []
                for i in range(n):
                    h, w = (int(v) for v in rng.integers(300, 501, 2))
                    self.frames.append(rng.integers(0, 256, (h, w, 3), np.uint8))
                    k = int(rng.integers(1, 4))
                    x1, y1 = rng.uniform(0, w - 80, k), rng.uniform(0, h - 80, k)
                    x2, y2 = x1 + rng.uniform(40, w - x1), y1 + rng.uniform(40, h - y1)
                    labels = (3 * i + np.arange(k)) % len(VOC_CLASSES) + 1  # every class has GT
                    self.gt.append((np.stack([x1, y1, np.minimum(x2, w - 1), np.minimum(y2, h - 1)], 1)
                                    .astype(np.float32), labels.astype(np.int32)))

            def __len__(self):
                return self.ids

            def __getitem__(self, i):
                frame, (boxes, labels) = self.frames[i % len(self.frames)], self.gt[i % len(self.frames)]
                tile, (h, w) = decode_to_tile(frame, self.tile_hw)
                scale = min(self.canvas_hw[0] / h, self.canvas_hw[1] / w)
                return Sample(tile, boxes * scale, labels, scale, f"{i:06d}", (h, w))

        ds = FrameSet(EVAL_FRAMES, EVAL_IDS, SEED + 15)
        resize = make_device_resize(CANVAS)
        # (1) the device resize on the card against the same call on the CPU
        first = next(iter(DetectionLoader(ds, 16, shuffle=False, drop_last=False, num_workers=4)))
        tiles = torch.from_numpy(first.images)
        src_hw = torch.from_numpy(np.stack([first.content_h, first.content_w], 1).astype(np.int32))
        with torch.inference_mode():
            got = [t.cpu() for t in resize(tiles.to(dev), src_hw.to(dev))]
            want = resize(tiles, src_hw)
        d = (got[0].int() - want[0].int()).abs()
        share = float((d > 0).float().mean())
        smoke.check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]) and int(d.max()) <= 1
                    and share <= RESIZE_SHARE,
                    f"device resize B=16 {tuple(tiles.shape)} -> {tuple(got[0].shape)} on the card vs the CPU: "
                    f"scales and sizes equal, max {int(d.max())} step on {share:.3g} of the values "
                    f"(at most 1 on {RESIZE_SHARE})")

        # (2) a pipeline that returns each frame's GT at the device resize's scales: mAP 1
        gt_of = {hashlib.sha1(ds[i].image.tobytes()).hexdigest(): ds.gt[i] for i in range(EVAL_FRAMES)}

        def gt_pipeline(tiles_u8, src):
            scale = resize(tiles_u8.to(dev), src.to(dev))[1].cpu().numpy()
            boxes, classes = torch.zeros(len(tiles_u8), 4, 4), torch.ones(len(tiles_u8), 4, dtype=torch.int32)
            valid = torch.zeros(len(tiles_u8), 4, dtype=torch.bool)
            for i, t in enumerate(tiles_u8.numpy()):
                b, lab = gt_of[hashlib.sha1(t.tobytes()).hexdigest()]
                boxes[i, :len(b)] = torch.from_numpy(b * scale[i])
                classes[i, :len(b)] = torch.from_numpy(lab)
                valid[i, :len(b)] = True
            return Detections(*(t.to(dev) for t in (torch.full((len(tiles_u8), 4), 0.9), classes, boxes, valid)))

        with torch.inference_mode():
            gt_res = evaluate_voc(None, ds, batch_size=16, pipeline=gt_pipeline, verbose=False)
        smoke.check(abs(gt_res["mAP"] - 1.0) < 1e-9 and gt_res["num_images"] == EVAL_IDS,
                    f"evaluate_voc with the GT pipeline, device resize on the card: mAP {gt_res['mAP']!r} over "
                    f"{gt_res['num_images']} frames")

        # (3) the default int8 pipeline with the device resize, calibrated as the CLI does
        model = res["model"]
        calib_u8 = resize(tiles[:8].to(dev), src_hw[:8].to(dev))[0]
        calib = normalized(calib_u8)
        t0 = time.perf_counter()
        epipe = make_eval_pipeline_int8(model, calib, default_strides(), CANVAS, device_resize=True,
                                        compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        print(f"  default int8 pipeline with the device resize built (calibration on the device-resized canvases "
              f"of 8 frames) in {time.perf_counter() - t0:.2f} s")
        with torch.inference_mode():
            evaluate_voc(model, ds, batch_size=16, pipeline=epipe, verbose=False)  # warm-up
        for bsz in (16, 64):
            for counter in counters.values():  # the counted run: every counter to 0 just before, read just after
                counter.launches = 0
            with torch.inference_mode():
                r = evaluate_voc(model, ds, batch_size=bsz, pipeline=epipe, verbose=False)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
            calls = -(-EVAL_IDS // bsz)
            smoke.check(launches == {k: calls * n for k, n in DEFAULT_PIPELINE_LAUNCHES.items()},
                        f"evaluate_voc B={bsz}: {calls} calls of the default pipeline, each kernel of it launched "
                        f"{calls} times its per-call count (K1, C, K4, K5, K6, K7, A): {launches}")
            rates = [r["images_per_sec"]]
            with torch.inference_mode():
                for _ in range(4):
                    rates.append(evaluate_voc(model, ds, batch_size=bsz, pipeline=epipe, verbose=False)
                                 ["images_per_sec"])
            smoke.check(r["num_images"] == EVAL_IDS and np.isfinite(r["mAP"]),
                        f"evaluate_voc B={bsz}: {r['num_images']} frames, mAP {r['mAP']:.4f} (random weights)")
            print(f"  evaluate_voc, default int8 pipeline, device resize, B={bsz}: images_per_sec "
                  f"{', '.join(f'{v:.1f}' for v in rates)} (median {statistics.median(rates):.1f}; loader, "
                  f"resize, pipeline and fetch) {card}")
            # where the time goes, each over the same window of EVAL_IDS frames: the loader alone (host
            # threads), the pipeline alone on tiles already on the card, and the pipeline with its host copies
            # (the pageable H2D copy of the tiles, the fetch and _collect), that is evaluate_voc less the loader
            batches = EVAL_IDS // bsz
            big = next(iter(DetectionLoader(ds, bsz, shuffle=False, drop_last=False, num_workers=8)))
            tiles_host = torch.from_numpy(big.images)
            hw_host = torch.from_numpy(np.stack([big.content_h, big.content_w], 1).astype(np.int32))
            tiles_dev, hw_dev = tiles_host.to(dev), hw_host.to(dev)
            loader_rates, pipe_rates, copy_rates = [], [], []
            for _ in range(3):
                t0 = time.perf_counter()
                n = sum(len(b.image_ids) for b in DetectionLoader(ds, bsz, shuffle=False, drop_last=False,
                                                                  num_workers=8, pad_last=True))
                loader_rates.append(n / (time.perf_counter() - t0))
                with torch.inference_mode():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(batches):
                        epipe(tiles_dev, hw_dev)
                    torch.cuda.synchronize()
                    pipe_rates.append(batches * bsz / (time.perf_counter() - t0))
                    t0 = time.perf_counter()
                    for _ in range(batches):
                        _collect(epipe(tiles_host, hw_host), big.scales, big.n_valid)
                    copy_rates.append(batches * bsz / (time.perf_counter() - t0))
            with torch.inference_mode():
                rs = cuda_ms(lambda: resize(tiles_dev, hw_dev), iters=5, reps=3)
            lo, pc = statistics.median(loader_rates), statistics.median(copy_rates)
            print(f"  B={bsz}, {batches} batches a window: DetectionLoader alone "
                  f"{', '.join(f'{v:.1f}' for v in loader_rates)} img/s; the pipeline alone on tiles on the card "
                  f"{', '.join(f'{v:.1f}' for v in pipe_rates)} img/s; the pipeline with the H2D copy, the fetch "
                  f"and _collect {', '.join(f'{v:.1f}' for v in copy_rates)} img/s; the two stages one after the "
                  f"other would give {1 / (1 / lo + 1 / pc):.1f} img/s, fully overlapped {min(lo, pc):.1f}; the "
                  f"device resize {rs:.4f} ms a batch {card}")

    def phase5p():
        """COCO evaluation from JPEGs on disk: the committed fixture tree
        (tests/fixtures/port_eval, scripts/make_port_fixtures.py). (a) the
        card machine's libjpeg through the native full, tile and batch
        decodes of every file (RGB, gray, CMYK, YCCK) against the manifest's
        PIL decodes; (b) evaluate_voc over the VOC tree through DetectionLoader
        and RingTileLoader: AP 1 on every class with GT from a GT pipeline,
        the default int8 pipeline counted once a batch; (c) the device resize
        at 896x1408 on the card against the CPU; (d) evaluate_coco over the
        COCO tree with raw tiles at 896x1408: AP, AP50, AP75 = 1 from a GT
        pipeline with the crowd row present, and the default int8 pipeline
        of HISFCOS(80, 256) with the device resize at B=4, counted once a
        batch, finite stats, category ids mapped back; (e) img/s over the
        tree cycled, split as in 5o; (f) the eval_coco CLI on the tree's
        config."""
        import hashlib
        import os
        import tempfile

        import numpy as np

        from pytorch_object_detection_tpu_torch.cli import eval_coco
        from pytorch_object_detection_tpu_torch.cli.eval_voc import first_batch_calib
        from pytorch_object_detection_tpu_torch.data import decode
        from pytorch_object_detection_tpu_torch.data.coco import COCODataset
        from pytorch_object_detection_tpu_torch.data.pipeline import DetectionLoader, make_device_resize
        from pytorch_object_detection_tpu_torch.data.voc import VOCDataset
        from pytorch_object_detection_tpu_torch.eval.evaluator import _collect, evaluate_coco, evaluate_voc
        from pytorch_object_detection_tpu_torch.native import lib as native
        from pytorch_object_detection_tpu_torch.ops.postprocess import Detections

        sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
        # (a) every fixture file through the three native decodes, against PIL's decode on the CPU
        with open(os.path.join(FIXTURE_TREE, "manifest.json")) as f:
            files = sorted(json.load(f)["files"].items())
        print(f"  libjpeg: {native.jpeg_link()[1]}")
        blobs = [open(os.path.join(FIXTURE_TREE, rel), "rb").read() for rel, _ in files]
        tiles, hws, ok = native.jpeg_decode_batch_native(blobs, (800, 1280), 8)
        for (rel, info), data, tile, (h, w), good in zip(files, blobs, tiles, hws, ok):
            full = decode.decode_image(data)
            one, (th, tw) = decode.decode_image_to_tile(data, (800, 1280))
            same = [sha(full) == info["sha256"], sha(one[:th, :tw]) == info["sha256"],
                    bool(good) and sha(tile[:h, :w]) == info["sha256"]]
            smoke.check(all(same) and list(full.shape) == info["shape"],
                        f"decode {rel} ({info['mode']}, {full.shape[0]}x{full.shape[1]}): full, tile, batch "
                        f"equal to the manifest's PIL decode: {same}")
        kinds = {"YCCK" if info.get("adobe_transform") == 2 else info["mode"] for _, info in files}
        smoke.check(kinds == {"RGB", "L", "CMYK", "YCCK"}, f"the tree holds RGB, gray, CMYK and YCCK JPEGs: {kinds}")

        # (b) evaluate_voc over the VOC tree, through both loaders
        voc = VOCDataset(os.path.join(FIXTURE_TREE, "voc"), "test", CANVAS, raw_tiles=True)
        resize = make_device_resize(CANVAS)
        table = {}
        for i in range(len(voc)):
            s = voc[i]
            table[sha(s.image)] = (s.boxes / s.scale, s.labels)

        def voc_gt(tiles_u8, src):
            scale = resize(tiles_u8.to(dev), src.to(dev))[1].cpu().numpy()
            n, k = len(tiles_u8), 8
            boxes, classes = torch.zeros(n, k, 4), torch.ones(n, k, dtype=torch.int32)
            valid = torch.zeros(n, k, dtype=torch.bool)
            for i, t in enumerate(tiles_u8.numpy()):
                b, lab = table[sha(t)]
                boxes[i, :len(b)], classes[i, :len(b)] = torch.from_numpy(b * scale[i]), torch.from_numpy(lab)
                valid[i, :len(b)] = True
            return Detections(*(t.to(dev) for t in (torch.full((n, k), 0.9), classes, boxes, valid)))

        with_gt = sorted({int(c) for _, lab in table.values() for c in lab})
        for ring in (False, True):
            with torch.inference_mode():
                r = evaluate_voc(None, voc, batch_size=4, pipeline=voc_gt, verbose=False, use_ring_loader=ring)
            aps = r["per_class_ap"]
            smoke.check(all(aps[c] == 1.0 for c in with_gt) and r["num_images"] == len(voc),
                        f"evaluate_voc, VOC tree ({len(voc)} JPEGs), {'RingTileLoader' if ring else 'DetectionLoader'}"
                        f", GT pipeline: AP 1 on the {len(with_gt)} classes with GT: "
                        f"{[aps[c] for c in with_gt]}, mAP {r['mAP']:.4f} over 20")
        vpipe = make_eval_pipeline_int8(res["model"], first_batch_calib(voc, 8, CANVAS, dev), default_strides(),
                                        CANVAS, device_resize=True, compute_dtype=torch.bfloat16)
        for ring in (False, True):
            for counter in counters.values():  # the counted run: every counter to 0 just before, read just after
                counter.launches = 0
            with torch.inference_mode():
                r = evaluate_voc(res["model"], voc, batch_size=4, pipeline=vpipe, verbose=False,
                                 use_ring_loader=ring)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
            calls = -(-len(voc) // 4)
            smoke.check(launches == {k: calls * n for k, n in DEFAULT_PIPELINE_LAUNCHES.items()}
                        and np.isfinite(r["mAP"]),
                        f"evaluate_voc, VOC tree, {'RingTileLoader' if ring else 'DetectionLoader'}, default int8 "
                        f"pipeline with the device resize, B=4: {calls} calls, each kernel launched {calls} times "
                        f"its per-call count; mAP {r['mAP']:.4f} (random weights): {launches}")

        # (c) the device resize at the COCO canvas, on the card against the CPU
        coco_dir = os.path.join(FIXTURE_TREE, "coco")
        coco = COCODataset(os.path.join(coco_dir, "val"), os.path.join(coco_dir, "instances_val.json"), COCO_CANVAS,
                           filter_empty=False, raw_tiles=True)
        big = next(iter(DetectionLoader(coco, len(coco), shuffle=False, drop_last=False, num_workers=4)))
        ctiles = torch.from_numpy(big.images)
        chw = torch.from_numpy(np.stack([big.content_h, big.content_w], 1).astype(np.int32))
        cresize = make_device_resize(COCO_CANVAS)
        with torch.inference_mode():
            got = [t.cpu() for t in cresize(ctiles.to(dev), chw.to(dev))]
            want = cresize(ctiles, chw)
        d = (got[0].int() - want[0].int()).abs()
        share = float((d > 0).float().mean())
        smoke.check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]) and int(d.max()) <= 1
                    and share <= RESIZE_SHARE,
                    f"device resize B={len(coco)} {tuple(ctiles.shape)} -> {tuple(got[0].shape)} on the card vs the "
                    f"CPU: scales {[round(float(v), 4) for v in got[1]]} and sizes equal, max {int(d.max())} step on "
                    f"{share:.3g} of the values (at most 1 on {RESIZE_SHARE})")
        with torch.inference_mode():
            tiles_dev, hw_dev = ctiles[:4].to(dev), chw[:4].to(dev)
            rs = cuda_ms(lambda: cresize(tiles_dev, hw_dev), iters=5, reps=3)
            t640, hw640 = torch.zeros(4, 640, 640, 3, dtype=torch.uint8, device=dev), hw_dev.clamp(max=640)
            rs640 = cuda_ms(lambda: cresize(t640, hw640), iters=5, reps=3)
        print(f"  device resize to {COCO_CANVAS}, B=4: {rs:.4f} ms from {tuple(ctiles.shape[1:3])} tiles, "
              f"{rs640:.4f} ms from 640x640 tiles (COCO val2017's largest side) {card}")

        # (d) evaluate_coco over the COCO tree: a GT pipeline, then the default int8 pipeline of HISFCOS(80, 256)
        ctable = {}
        for i in range(len(coco)):
            s = coco[i]
            ctable[sha(s.image)] = (s.boxes / s.scale, s.labels, *coco.eval_crowds(s.image_id))

        def coco_gt(tiles_u8, src):
            """Each frame's GT at the device resize's scales (score 0.5), and a
            detection on each crowd region scored above them, which the crowd
            row must absorb."""
            scale = cresize(tiles_u8.to(dev), src.to(dev))[1].cpu().numpy()
            n, k = len(tiles_u8), 12
            boxes, classes = torch.zeros(n, k, 4), torch.ones(n, k, dtype=torch.int32)
            scores, valid = torch.zeros(n, k), torch.zeros(n, k, dtype=torch.bool)
            for i, t in enumerate(tiles_u8.numpy()):
                b, lab, cb, cl = ctable[sha(t)]
                b, lab = np.concatenate([b, cb]), np.concatenate([lab, cl])
                boxes[i, :len(b)], classes[i, :len(b)] = torch.from_numpy(b * scale[i]), torch.from_numpy(lab)
                scores[i, :len(b)] = torch.where(torch.arange(len(b)) < len(b) - len(cl), 0.5, 0.9)
                valid[i, :len(b)] = True
            return Detections(*(t.to(dev) for t in (scores, classes, boxes, valid)))

        n_crowds = sum(len(v[3]) for v in ctable.values())
        with torch.inference_mode():
            r = evaluate_coco(None, coco, batch_size=4, pipeline=coco_gt, verbose=False)
        smoke.check(r["AP"] == r["AP50"] == r["AP75"] == 1.0 and n_crowds == 1 and r["num_images"] == len(coco),
                    f"evaluate_coco, COCO tree ({len(coco)} JPEGs, {n_crowds} crowd row) at {COCO_CANVAS}, GT "
                    f"pipeline with a top-scored detection on the crowd: AP {r['AP']!r}, AP50 {r['AP50']!r}, "
                    f"AP75 {r['AP75']!r}")
        t0 = time.perf_counter()
        model80 = res["model80"]
        cpipe = make_eval_pipeline_int8(model80, first_batch_calib(coco, 4, COCO_CANVAS, dev), default_strides(),
                                        COCO_CANVAS, device_resize=True, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        print(f"  HISFCOS(80, {FEATURES}) default int8 pipeline with the device resize built (calibration on the "
              f"device-resized canvases of 4 frames) in {time.perf_counter() - t0:.2f} s")
        out = tempfile.mkdtemp()
        for counter in counters.values():  # the counted run: every counter to 0 just before, read just after
            counter.launches = 0
        with torch.inference_mode():
            r = evaluate_coco(model80, coco, batch_size=4, pipeline=cpipe, verbose=False,
                              results_json=os.path.join(out, "results.json"))
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        calls = -(-len(coco) // 4)
        smoke.check(launches == {k: calls * n for k, n in COCO_PIPELINE_LAUNCHES.items()},
                    f"evaluate_coco B=4: {calls} calls of the default pipeline at {COCO_CANVAS}, each kernel launched "
                    f"{calls} times its per-call count (K9 on P3 and P4 from frames on disk): {launches}")
        with open(os.path.join(out, "results.json")) as f:
            records = json.load(f)
        ids = {im["id"] for im in coco.images}
        cats = {rec["category_id"] for rec in records}
        smoke.check(all(np.isfinite(v) for v in r.values()) and r["num_images"] == len(coco) and len(records) > 0
                    and {rec["image_id"] for rec in records} <= ids and cats <= set(coco.contig_to_cat.values())
                    and any(c != coco.cat_to_contig[c] for c in cats),
                    f"evaluate_coco, default int8 pipeline: finite stats (AP {r['AP']:.4f}, random weights), "
                    f"{len(records)} records, image ids of the tree, category ids mapped back "
                    f"({len(cats)} ids, {sum(c != coco.cat_to_contig[c] for c in cats)} of them off the contiguous "
                    f"labels)")

        # (e) img/s over the tree cycled to a steady window, and its split
        class Cycled:
            """The tree's samples served as ``n`` ids (id i is sample i % len)."""

            def __init__(self, ds, n):
                self.ds, self.n = ds, n

            def __len__(self):
                return self.n

            def __getitem__(self, i):
                return self.ds[i % len(self.ds)]

            def __getattr__(self, name):
                return getattr(self.ds, name)

        cyc = Cycled(coco, COCO_EVAL_IDS)
        with torch.inference_mode():
            evaluate_coco(model80, Cycled(coco, 16), batch_size=4, pipeline=cpipe, verbose=False)  # warm-up
            rates = [evaluate_coco(model80, cyc, batch_size=4, pipeline=cpipe, verbose=False)["images_per_sec"]
                     for _ in range(3)]
        print(f"  evaluate_coco, HISFCOS(80, {FEATURES}) default int8 pipeline, device resize, {COCO_CANVAS}, B=4, "
              f"{COCO_EVAL_IDS} ids: images_per_sec {', '.join(f'{v:.1f}' for v in rates)} (median "
              f"{statistics.median(rates):.1f}) {card}")
        batches = COCO_EVAL_IDS // 4
        first4 = next(iter(DetectionLoader(coco, 4, shuffle=False, drop_last=False, num_workers=4)))
        th, hh = torch.from_numpy(first4.images), torch.from_numpy(
            np.stack([first4.content_h, first4.content_w], 1).astype(np.int32))
        td, hd = th.to(dev), hh.to(dev)
        loader_rates, pipe_rates, copy_rates = [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            n = sum(len(b.image_ids) for b in DetectionLoader(cyc, 4, shuffle=False, drop_last=False, num_workers=8,
                                                              pad_last=True))
            loader_rates.append(n / (time.perf_counter() - t0))
            with torch.inference_mode():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(batches):
                    cpipe(td, hd)
                torch.cuda.synchronize()
                pipe_rates.append(batches * 4 / (time.perf_counter() - t0))
                t0 = time.perf_counter()
                for _ in range(batches):
                    _collect(cpipe(th, hh), first4.scales, first4.n_valid)
                copy_rates.append(batches * 4 / (time.perf_counter() - t0))
        lo, pc = statistics.median(loader_rates), statistics.median(copy_rates)
        print(f"  B=4, {batches} batches a window: DetectionLoader alone {', '.join(f'{v:.1f}' for v in loader_rates)}"
              f" img/s; the pipeline alone on tiles on the card {', '.join(f'{v:.1f}' for v in pipe_rates)} img/s; "
              f"the pipeline with the H2D copy, the fetch and _collect {', '.join(f'{v:.1f}' for v in copy_rates)} "
              f"img/s; one after the other {1 / (1 / lo + 1 / pc):.1f}, fully overlapped {min(lo, pc):.1f} {card}")

        # (f) the CLI on the tree's config (PyYAML is on the card machine)
        t0 = time.perf_counter()
        rc = eval_coco.main(["--config", os.path.join(FIXTURE_TREE, "coco.yaml"), "--device-resize", "--int8",
                             "--batch-size", "4", "--results-json", os.path.join(out, "cli.json")])
        smoke.check(rc == 0 and os.path.getsize(os.path.join(out, "cli.json")) > 2,
                    f"podt-torch-eval-coco --config {FIXTURE_TREE}/coco.yaml --device-resize --int8: exit {rc} in "
                    f"{time.perf_counter() - t0:.1f} s")

    def phase5q():
        """Training (train/trainer.py, cli/train.py): (a) correctness on seeded
        weights and batches: one f32 step on the card against the same step on
        the CPU (TF32 off), the bf16 autocast step against the f32 step (loss,
        gradient cosine of the backbone, the FPN and the head), the stem,
        layer1 and every BatchNorm buffer bit-identical after the steps,
        kernel B launched no time in a train step and 20 times in an eval
        forward right after it (the model left in train mode), groupnorm_act
        raising when asked for a gradient; (b) the time of a step at
        HISFCOS(20, 256), 512x512, B=16, over a steady window, split into
        forward, targets + loss, backward and optimizer by CUDA events, and
        the peak memory; (c) learning: the eight frames of the committed VOC
        tree, no augmentation, until the loss is below 0.7 of its first value
        (at most TRAIN_MAX_STEPS steps), on to TRAIN_FIT_STEPS steps (the
        JAX overfit test's 160), then evaluate_voc of the trained
        weights through the float pipeline and the default int8 pipeline,
        each batch counted; the float mAP above the untrained model's; (d)
        podt-torch-train on the tree's training config (DetectionLoader and
        HostAugment), --resume from its checkpoint, and --ring-loader."""
        import os
        import tempfile

        import numpy as np

        from pytorch_object_detection_tpu_torch.cli.eval_voc import first_batch_calib
        from pytorch_object_detection_tpu_torch.data.pipeline import DetectionLoader, make_device_preprocess
        from pytorch_object_detection_tpu_torch.data.synthetic import synthetic_batch
        from pytorch_object_detection_tpu_torch.data.voc import VOCDataset
        from pytorch_object_detection_tpu_torch.eval.evaluator import evaluate_voc

        strides = default_strides()

        def train_setup(canvas, seed=SEED, device=dev, cfg=None):
            model = build_model("HISFCOS", NUM_CLASSES, FEATURES, frozen_stages=1, device=device,
                                generator=torch.Generator().manual_seed(seed))
            state = trainer.create_train_state(model, cfg or TRAIN_OPT, freeze_bn=True, frozen_stages=1)
            shapes = [(canvas[0] // st, canvas[1] // st) for st in strides]
            return state, shapes

        def seeded_batch(canvas, b, seed, device):
            g = torch.Generator().manual_seed(seed)
            images, boxes, labels = synthetic_batch(g, b, canvas, NUM_CLASSES, max_boxes=32)
            mean, std = torch.tensor(IMAGENET_MEAN), torch.tensor(IMAGENET_STD)
            return (((images - mean) / std).to(device), boxes.to(device), labels.to(device))

        def grads_of(state):
            return {k: p.grad.detach().float() for k, p in state.model.named_parameters() if p.grad is not None}

        def cos64(a, b):  # in f64: the sums run over 30 M gradients
            a, b = a.double(), b.double()
            return float((a @ b) / (a.norm() * b.norm()))

        def group_cos(a, b, prefix):
            keys = [k for k in a if k.startswith(prefix)]
            return cos64(torch.cat([a[k].flatten() for k in keys]), torch.cat([b[k].flatten() for k in keys]))

        # (a) one f32 step on the card against the CPU, full width at 256x256, B=2
        small = (256, 256)
        cpu_state, shapes = train_setup(small, device="cpu")
        card_state, _ = train_setup(small)
        frozen_before = {k: v.clone() for k, v in card_state.model.state_dict().items()
                         if k not in set(card_state.trainable_names())}
        batch_cpu = seeded_batch(small, 2, SEED + 5, "cpu")
        t0 = time.perf_counter()
        want = trainer.make_train_step(cpu_state.model, shapes, strides, TRAIN_RANGES, "giou",
                                       torch.float32)(cpu_state, *batch_cpu)
        cpu_s = time.perf_counter() - t0
        gn.groupnorm_act.launches = 0
        got = trainer.make_train_step(card_state.model, shapes, strides, TRAIN_RANGES, "giou", torch.float32)(
            card_state, *(t.to(dev) for t in batch_cpu))
        torch.cuda.synchronize()
        step_gn = gn.groupnorm_act.launches
        loss_err = abs(float(got["total"]) - float(want["total"])) / abs(float(want["total"]))
        g_card, g_cpu = grads_of(card_state), grads_of(cpu_state)
        g_cos = cos64(torch.cat([g_card[k].cpu().flatten() for k in g_cpu]),
                      torch.cat([g_cpu[k].flatten() for k in g_cpu]))
        lr0 = cpu_state.schedule(0)
        g_all = max(float(g.abs().max()) for g in g_cpu.values())
        p_card = dict(card_state.model.named_parameters())
        worst = 0.0  # each updated parameter's distance over lr0 x (its largest gradient + 1e-4 of the model's)
        for k, p in cpu_state.model.named_parameters():
            if p.requires_grad:
                d = float((p_card[k].detach().cpu() - p.detach()).abs().max())
                worst = max(worst, d / (lr0 * (float(g_cpu[k].abs().max()) + 1e-4 * g_all)))
        print(f"  f32 step, HISFCOS({NUM_CLASSES}, {FEATURES}) 256x256 B=2, TF32 off: loss card "
              f"{float(got['total']):.7f} CPU {float(want['total']):.7f} (CPU step {cpu_s:.1f} s); gradient cosine "
              f"{g_cos:.8f}; updated parameters within {worst:.4f} of lr x max|g| of the CPU's")
        smoke.check(loss_err <= TRAIN_F32_LOSS_RTOL and g_cos >= TRAIN_F32_COS and worst <= TRAIN_F32_UPDATE,
                    f"f32 train step on the card vs the CPU: loss rel err {loss_err:.3g} (tol {TRAIN_F32_LOSS_RTOL}), "
                    f"gradient cosine {g_cos:.8f} (>= {TRAIN_F32_COS}), updates within {worst:.4f} "
                    f"(<= {TRAIN_F32_UPDATE}) of lr x max|g|")
        smoke.check(step_gn == 0, f"kernel B: {step_gn} launches in a train step (0 by design: autograd records)")

        # the bf16 autocast step against the f32 step, from the same weights and batch, full size
        f32_state, shapes = train_setup(CANVAS, seed=SEED + 1)
        bf_state, _ = train_setup(CANVAS, seed=SEED + 1)
        big = seeded_batch(CANVAS, 16, SEED + 6, dev)
        m32 = trainer.make_train_step(f32_state.model, shapes, strides, TRAIN_RANGES, "giou", torch.float32)(
            f32_state, *big)
        m16 = trainer.make_train_step(bf_state.model, shapes, strides, TRAIN_RANGES, "giou", torch.bfloat16)(
            bf_state, *big)
        g32, g16 = grads_of(f32_state), grads_of(bf_state)
        coses = {part: group_cos(g16, g32, part + ".") for part in ("backbone", "fpn", "head")}
        bf_err = abs(float(m16["total"]) - float(m32["total"])) / abs(float(m32["total"]))
        print(f"  bf16 autocast vs f32 step, 512x512 B=16: loss {float(m16['total']):.6f} vs "
              f"{float(m32['total']):.6f} (rel {bf_err:.3g}); gradient cosines "
              f"{', '.join(f'{k} {v:.6f}' for k, v in coses.items())}")
        smoke.check(bf_err <= TRAIN_BF16_LOSS_RTOL and min(coses.values()) >= TRAIN_BF16_COS,
                    f"bf16 step vs f32 step: loss rel err {bf_err:.3g} (tol {TRAIN_BF16_LOSS_RTOL}), gradient "
                    f"cosines >= {TRAIN_BF16_COS}: {coses}")
        frozen_after = card_state.model.state_dict()
        same = all(torch.equal(v, frozen_after[k]) for k, v in frozen_before.items())
        bn_buffers = [k for k in frozen_after if k.endswith("running_var")]
        smoke.check(same and "backbone.conv1.weight" in frozen_before and "backbone.layer1_2.conv3.weight"
                    in frozen_before and all(k in frozen_before for k in bn_buffers),
                    f"after the step: the stem, layer1 and every BatchNorm buffer ({len(bn_buffers)} BatchNorms) "
                    f"bit-identical, {len(frozen_before)} tensors")
        card_state.model.train()  # the mode does not choose the GroupNorm path: autograd does
        gn.groupnorm_act.launches = 0
        with torch.inference_mode():
            card_state.model(big[0][:2, :256, :256].contiguous())
        torch.cuda.synchronize()
        smoke.check(gn.groupnorm_act.launches == 20,
                    f"kernel B: {gn.groupnorm_act.launches} launches in an eval forward right after the step, the "
                    f"model in train mode (20)")
        x = torch.randn(2, 256, 16, 16, device=dev, requires_grad=True)
        w = torch.ones(256, device=dev)
        raised = []
        for args in ((x, w, torch.zeros_like(w)), (x.detach(), w.clone().requires_grad_(), torch.zeros_like(w))):
            try:
                gn.groupnorm_act(*args)
            except RuntimeError:
                raised.append(True)
        smoke.check(len(raised) == 2, "groupnorm_act raises on a CUDA tensor when asked to record a gradient "
                                      "(input or scale requiring grad)")
        del cpu_state, card_state, f32_state, bf_state, g32, g16

        # (b) the step's time at HISFCOS(20, 256), 512x512, B=16, bf16, over a steady window
        state, shapes = train_setup(CANVAS)
        step = trainer.make_train_step(state.model, shapes, strides, TRAIN_RANGES, "giou", torch.bfloat16)
        for _ in range(TRAIN_WARMUP):
            step(state, *big)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        phases = ("forward", "loss", "backward", "optimizer")
        marks = []

        def record(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[-1][name] = ev

        gn.groupnorm_act.launches = 0
        t0 = time.perf_counter()
        for _ in range(TRAIN_WINDOW):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            marks.append({"start": start})
            last = step(state, *big, record=record)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000.0 / TRAIN_WINDOW
        split = {ph: statistics.median(m[prev].elapsed_time(m[ph]) for m in marks)
                 for prev, ph in zip(("start",) + phases[:-1], phases)}
        per_step = [m["start"].elapsed_time(m["optimizer"]) for m in marks]
        device_ms = statistics.median(per_step)
        between = [a["start"].elapsed_time(b["start"]) for a, b in zip(marks, marks[1:])]
        ms = statistics.median(between)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        res["train"] = {"ms": ms, "img_s": 16 * 1000.0 / ms, "split": split, "peak_gib": peak}
        print(f"  train step HISFCOS({NUM_CLASSES}, {FEATURES}) bf16 512x512 B=16, {TRAIN_WINDOW} steps after "
              f"{TRAIN_WARMUP} of warm-up: {ms:.3f} ms a step start to start (median; host clock {wall:.3f}), "
              f"{16 * 1000.0 / ms:.1f} img/s; a step's own span {device_ms:.3f} ms: "
              + ", ".join(f"{ph} {split[ph]:.3f}" for ph in phases)
              + f"; peak memory allocated {peak:.2f} GiB; kernel B launches {gn.groupnorm_act.launches}; "
              f"loss {float(last['total']):.4f}; clocks {smi_clocks()} {card}")
        smoke.check(bool(torch.isfinite(last["total"])) and gn.groupnorm_act.launches == 0,
                    f"timed steps: finite loss, kernel B launched no time in {TRAIN_WINDOW} steps")
        print("  the step's kernels (torch.profiler, 3 steps):")
        profile_calls(lambda: step(state, *big), top=20)
        del state, step, big

        # (c) learning on the committed VOC tree's eight frames, no augmentation
        root = os.path.join(FIXTURE_TREE, "voc")
        train_ds = VOCDataset([root], "test", CANVAS)
        batch = next(iter(DetectionLoader(train_ds, 8, shuffle=False, drop_last=False, num_workers=4)))
        pp = make_device_preprocess(train=False)
        imgs, bxs = pp(None, torch.from_numpy(batch.images).to(dev), torch.from_numpy(batch.boxes),
                       torch.from_numpy(batch.content_w))
        lbls = torch.from_numpy(batch.labels).to(dev)
        state, shapes = train_setup(CANVAS, cfg=TRAIN_FIT_OPT)
        untrained = copy.deepcopy(state.model)
        step = trainer.make_train_step(state.model, shapes, strides, TRAIN_RANGES, "giou", torch.bfloat16)
        t0 = time.perf_counter()
        first = float(step(state, imgs, bxs, lbls)["total"])
        last, n_steps = first, 1
        while last >= 0.7 * first and n_steps < TRAIN_MAX_STEPS:
            last = float(step(state, imgs, bxs, lbls)["total"])
            n_steps += 1
        print(f"  learning: loss {first:.4f} -> {last:.4f} in {n_steps} steps ({time.perf_counter() - t0:.1f} s), "
              f"HISFCOS({NUM_CLASSES}, {FEATURES}) bf16 on the tree's 8 frames at B=8")
        smoke.check(last < 0.7 * first, f"learning: the loss below 0.7 of its first value within {TRAIN_MAX_STEPS} "
                                        f"steps (the JAX bar): {n_steps} steps")
        while n_steps < TRAIN_FIT_STEPS:  # on to tests/test_end_to_end.py's 160 steps before the evaluation
            last = float(step(state, imgs, bxs, lbls)["total"])
            n_steps += 1
        print(f"  then to {n_steps} steps: loss {last:.4f}")
        voc = VOCDataset(root, "test", CANVAS, raw_tiles=True)
        maps = {}
        for what, model in (("untrained", untrained), ("trained", state.model)):
            fpipe = make_eval_pipeline(model, strides, CANVAS, compute_dtype=torch.bfloat16, device_resize=True)
            for counter in counters.values():
                counter.launches = 0
            with torch.inference_mode():
                r = evaluate_voc(model, voc, batch_size=4, pipeline=fpipe, verbose=False)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
            calls = -(-len(voc) // 4)
            maps[what] = r["mAP"]
            smoke.check(launches == {k: calls * n for k, n in FLOAT_PIPELINE_LAUNCHES.items()},
                        f"evaluate_voc, {what} weights, float pipeline, B=4: {calls} calls, kernels B and A "
                        f"launched {calls} times their per-call count: mAP {r['mAP']:.4f}")
        ipipe = make_eval_pipeline_int8(state.model, first_batch_calib(voc, 8, CANVAS, dev), strides, CANVAS,
                                        device_resize=True, compute_dtype=torch.bfloat16)
        for counter in counters.values():
            counter.launches = 0
        with torch.inference_mode():
            r = evaluate_voc(state.model, voc, batch_size=4, pipeline=ipipe, verbose=False)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        maps["int8"] = r["mAP"]
        smoke.check(launches == {k: calls * n for k, n in DEFAULT_PIPELINE_LAUNCHES.items()} and np.isfinite(r["mAP"]),
                    f"evaluate_voc, trained weights, default int8 pipeline (calibrated on the tree's frames), B=4: "
                    f"each kernel launched {calls} times its per-call count: mAP {r['mAP']:.4f}")
        smoke.check(maps["trained"] > maps["untrained"],
                    f"trained float mAP {maps['trained']:.4f} above the untrained model's {maps['untrained']:.4f} "
                    f"(int8 {maps['int8']:.4f})")
        res["train_fit"] = {"steps": n_steps, "first": first, "last": last, **maps}
        del state, step, untrained, ipipe

        # (d) the CLI on the tree's training config: the loader with HostAugment, --resume, --ring-loader
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [sys.executable, "-m", "pytorch_object_detection_tpu_torch.cli.train", "--config",
                   os.path.join(FIXTURE_TREE, "voc_train.yaml"), "--checkpoint-dir", tmp, "--log-every", "1"]
            runs = (("DetectionLoader + HostAugment", []), ("--resume", ["--resume", os.path.join(tmp, "port_train")]),
                    ("--ring-loader", ["--ring-loader", "--checkpoint-dir", os.path.join(tmp, "ring")]))
            for what, extra in runs:
                t0 = time.perf_counter()
                out = subprocess.run(cmd + extra, capture_output=True, text=True, timeout=600)
                lines = [ln for ln in out.stdout.splitlines() if ln.startswith(("step ", "resumed", "training done"))]
                for ln in lines:
                    print(f"    {ln}")
                ok = out.returncode == 0 and any(ln.startswith("training done") for ln in lines)
                if what == "--resume":
                    ok = ok and "resumed from" in out.stdout and "training done: step 6" in out.stdout
                smoke.check(ok, f"podt-torch-train {what}: exit {out.returncode} in {time.perf_counter() - t0:.1f} s"
                                + ("" if ok else f"\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}"))

    def phase6():
        pipe, plain_pipe, frames = res["pipe"], res["plain_pipe"], res["frames"]
        print(f"  card {card}; ms per call, back-to-back calls between CUDA events, median of 5")
        # kernel B on the float pipeline's 20 recorded calls, B=8 and repeated to B=64, beside its plain
        # version (B=8) and F.group_norm then the activation
        acts = {"none": lambda t: t, "relu": F.relu, "silu": F.silu}
        for b in (8, 64):
            gn_k = gn_p = gn_l = gn_h = gn_bytes = gn_ops = 0.0
            for (x, scale, bias), kw in res["gn_calls"]:
                x = x.repeat(b // x.shape[0], 1, 1, 1)
                act, it = kw["act"], 20 if b == 8 else 5
                with torch.inference_mode():
                    tk = cuda_ms(lambda: gn.groupnorm_act(x, scale, bias, act=act), iters=it)
                    th = host_ms(lambda: gn.groupnorm_act(x, scale, bias, act=act))
                    tl = cuda_ms(lambda: acts[act](F.group_norm(x, 32, scale, bias, 1e-5)), iters=it)
                    tp = 0.0 if b == 64 else cuda_ms(lambda: gn.groupnorm_act(x, scale, bias, act=act, plain=True),
                                                     iters=5)
                gn_k, gn_h, gn_p, gn_l = gn_k + tk, gn_h + th, gn_p + tp, gn_l + tl
                # the map in and out once, scale and bias; sum, sum of squares, normalize, affine, act: ~8 f32 ops
                gn_bytes += 2 * x.numel() * x.element_size() + 2 * scale.numel() * scale.element_size()
                gn_ops += 8 * x.numel()
                _, c, h, w = x.shape
                tile = gn.pick_gn_tile(b, c, h * w, 32, x.element_size(), *qblock.card_limits(dev))
                print(f"  GN {str(x.dtype)[6:]} B={b} C={c} {h}x{w} {act}: kernel {tk:.4f} ms, "
                      + (f"plain {tp:.4f} ms, " if b == 8 else "") + f"F.group_norm + {act} {tl:.4f} ms, host "
                      f"{th:.4f} ms, tile {tile}")
            bnd = bound(gn_bytes, gn_ops, F32_OPS_S)
            print(f"  GN per forward (20 launches, B={b}, the pipeline's operands): kernel {gn_k:.4f} ms, "
                  + (f"plain {gn_p:.4f} ms, " if b == 8 else "") + f"F.group_norm + act {gn_l:.4f} ms, wrapper host "
                  f"time {gn_h:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}, {bnd[0] / gn_k:.1%} of it) {card}")
            if b == 8:
                res["gn_ms"], res["gn_plain_ms"], res["gn_lib_ms"], res["gn_bound"] = gn_k, gn_p, gn_l, bnd

        boxes, classes, valid = res["nms_boxes"]
        scores = torch.linspace(1.0, 0.0, boxes.shape[1], device=dev).expand(boxes.shape[0], -1)
        for b in (8, 64):
            rep = b // boxes.shape[0]
            bx, cl, va = boxes.repeat(rep, 1, 1), classes.repeat(rep, 1), valid.repeat(rep, 1)
            sc = scores.repeat(rep, 1)
            tk = cuda_ms(lambda: cuda_nms.cuda_batched_class_nms(bx, sc, cl, va, 0.6))
            th = host_ms(lambda: cuda_nms.cuda_batched_class_nms(bx, sc, cl, va, 0.6))
            tp = cuda_ms(lambda: batched_class_nms(bx, sc, cl, va, 0.6), iters=5)
            print(f"  NMS B={b} K=1000 (pipeline boxes): kernel {tk:.4f} ms, plain {tp:.4f} ms, "
                  f"wrapper host time {th:.4f} ms {card}")
            if b == 8:
                res["nms_ms"], res["nms_plain_ms"] = tk, tp
                k = bx.shape[1]
                # boxes, scores, classes, valid in, keep out; ~12 f32 ops per IoU pair
                res["nms_bound"] = bound(b * k * (16 + 4 + 4 + 1 + 1), b * k * (k - 1) / 2 * 12, F32_OPS_S)

        qk = {1: 0.0, 2: 0.0}
        qp = {1: 0.0, 2: 0.0}
        qh = {1: 0.0, 2: 0.0}
        qwork = {1: [0.0, 0.0], 2: [0.0, 0.0]}  # bytes, operations
        sm_count, smem_max = qblock.card_limits(dev)
        c64 = b64 = 0.0
        with torch.inference_mode():
            for scope, stride, blk, x in res.get("qblock_cases", []):
                for b in (8, 64):
                    xb = x.repeat(b // x.shape[0], 1, 1, 1)
                    tk = cuda_ms(lambda: resnet_int8.bottleneck_int8(blk, xb, stride, "pallas_block"),
                                 iters=20 if b == 8 else 5)
                    nbytes, ops = block_work(blk, xb, stride)
                    bnd = bound(nbytes, ops, INT8_OPS_S)
                    _, h, w, _ = xb.shape
                    cw, cout = blk["w1"].shape[0], blk["w3"].shape[0]
                    tw, split = qblock.pick_tile(b, h, w, cw, cout, stride, sm_count, smem_max)
                    ho, wo = qblock.out_hw(h, w, stride)
                    ty, tx = qblock.tile_grid(ho, wo, tw)
                    line = (f"  kernel C {scope} s{stride} B={b} {tuple(xb.shape)}: kernel {tk:.4f} ms, bound "
                            f"{bnd[0]:.5f} ms ({bnd[1]}), {ops / 2 / tk / 1e9:.1f} T multiply-adds/s, tile 8x{tw}, "
                            f"split {split}, {b * ty * tx * split} blocks, conv1 recompute "
                            f"{qblock.recompute_factor(h, w, stride, tw):.4f}")
                    if b == 64:
                        c64, b64 = c64 + tk, b64 + bnd[0]
                        print(line)
                        continue
                    qh[stride] += host_ms(lambda: resnet_int8.bottleneck_int8(blk, x, stride, "pallas_block"))
                    tp = cuda_ms(lambda: resnet_int8.bottleneck_int8(blk, x, stride, "pallas_block", plain=True))
                    qk[stride] += tk
                    qp[stride] += tp
                    qwork[stride][0] += nbytes
                    qwork[stride][1] += ops
                    print(f"{line}; plain {tp:.4f} ms")
        print(f"  kernel C per forward (B=8): K2 13 blocks kernel {qk[1]:.4f} ms, plain {qp[1]:.4f} ms, host "
              f"{qh[1]:.4f} ms; K3 3 blocks kernel {qk[2]:.4f} ms, plain {qp[2]:.4f} ms, host {qh[2]:.4f} ms {card}")
        print(f"  kernel C per forward (B=64): the 16 blocks {c64:.4f} ms, bound {b64:.4f} ms {card}")
        res["qblock_ms"], res["qblock_plain_ms"] = qk, qp
        res["qblock_bound"] = {st: bound(nb, ops, INT8_OPS_S) for st, (nb, ops) in qwork.items()}

        if "fpn_calls" in res:
            time_fpn_kernels()
        if "head_calls" in res:
            time_head_kernels()
        if "backend_calls" in res:
            time_backend_kernels()
        if "k16_calls" in res:
            time_fused_backbone()
        if "k15_calls" in res:
            time_fused_head()
        if "k4p_inputs" in res:
            time_k4_prime()
        if "mn_calls" in res:
            time_k12()

        pipes = [("float kernels", pipe), ("float plain", plain_pipe)]
        if "ipipe" in res:
            pipes += [("int8 kernels", res["ipipe"]), ("int8 plain", res["iplain"])]
        if "fpipe" in res:
            pipes += [("int8-FPN u8 kernels", res["fpipe"]), ("int8-FPN u8 plain", res["fplain"])]
        if "dpipe" in res:
            pipes += [("default u8 int8 head kernels", res["dpipe"]), ("default u8 int8 head plain", res["dplain"])]
        if "hpipe" in res:
            pipes += [("int8 fused-head kernels", res["hpipe"]), ("int8 fused-head plain", res["hplain"])]
        pipes += [(name, res[key]) for name, key in (("MNFCOS float kernels", "mn_pipe"),
                                                     ("MNFCOS int8-backbone kernels", "mn_pipe8"),
                                                     ("MNFCOS int8 ladder u8 kernels", "lpipe")) if key in res]
        for b, iters in ((8, 10), (64, 3)):
            fr = frames.repeat(b // frames.shape[0], 1, 1, 1)
            for name, p in pipes:
                ms = cuda_ms(lambda: p(fr), iters=iters, reps=3)
                print(f"  pipeline B={b} bf16 512x512 ({name}): {ms:.3f} ms/batch, "
                      f"{b * 1000.0 / ms:.1f} img/s {card}")
        # the other backends of phase 5h: the per-conv and chained paths at both batches, the two stems at B=64
        for name, batches in (("per-conv", (8, 64)), ("chained", (8, 64)), ("direct stem", (64,)),
                              ("stem tail", (64,))):
            if name not in res.get("paths", {}):
                continue
            p = res["paths"][name][0]
            for b in batches:
                fr = frames.repeat(b // frames.shape[0], 1, 1, 1)
                ms = cuda_ms(lambda: p(fr), iters=10 if b == 8 else 3, reps=3)
                print(f"  pipeline B={b} bf16 512x512 ({name} kernels): {ms:.3f} ms/batch, "
                      f"{b * 1000.0 / ms:.1f} img/s {card}")
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def time_fpn_kernels():
        """K1, K4, K5, K6 per B=8 forward of the int8-FPN pipeline, on the
        inputs phase 5d recorded, against their plain versions and, where one
        PyTorch call computes the same function, that call; each one's bound
        from these inputs; and the wrappers' host time per forward."""
        frames, st = res["frames"], res["fpipe"].qtree["backbone"]["stem_s2d"]
        calls = res["fpn_calls"]
        t, work, host = {}, {}, {}
        with torch.inference_mode():
            tk = cuda_ms(lambda: qstem.qstem_conv(frames, st))
            host["qstem"] = host_ms(lambda: qstem.qstem_conv(frames, st))
            tp = cuda_ms(lambda: qstem.qstem_conv(frames, st, plain=True))

            def stem_work(fr):  # frames in, pooled map out, the weights; the function's 7x7 taps over 3 channels
                b, h, w, _ = fr.shape
                hc, wc, hp, wp = qstem.stem_sizes(h, w)
                return fr.numel() + b * hp * wp * 64 + st["wt"].numel() + 8 * 64, 2 * b * hc * wc * 64 * 147

            t["qstem"] = (tk, tp, None)
            work["qstem"] = (*stem_work(frames), INT8_OPS_S)
            sm_count, smem_max = qblock.card_limits(dev)
            print(f"  K1 u8 stem B=8 {tuple(frames.shape)}: kernel {tk:.4f} ms, plain {tp:.4f} ms, tile "
                  f"{qstem.pick_stem_tile(*frames.shape[:3], sm_count, smem_max)}")
            g = torch.Generator(device=dev).manual_seed(SEED + 11)
            for shape in ((64, *CANVAS, 3), (2, *COCO_CANVAS, 3)):  # the kernel alone
                fr = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
                k1 = cuda_ms(lambda: qstem.qstem_conv(fr, st), iters=10)
                bnd = bound(*stem_work(fr), INT8_OPS_S)
                tile = qstem.pick_stem_tile(*shape[:3], sm_count, smem_max)
                macs = stem_work(fr)[1] / 2
                print(f"  K1 u8 stem {shape}: kernel {k1:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}), "
                      f"{macs / k1 / 1e9:.1f} T multiply-adds/s (the 147 taps; on the s2d GEMM's 256, "
                      f"{macs * 256 / 147 / k1 / 1e9:.1f}), tile {tile}, "
                      f"{qstem.stem_blocks(*shape[:3], *tile)} blocks, recompute "
                      f"{qstem.stem_recompute(*shape[1:3], *tile):.4f} {card}")

            tk = tp = tl = th = nbytes = ops = 0.0
            for (x, wt, a, bb), _ in calls["qconv1x1"]:
                k1 = cuda_ms(lambda: qconv.qconv1x1(x, wt, a, bb))
                th += host_ms(lambda: qconv.qconv1x1(x, wt, a, bb))
                p1 = cuda_ms(lambda: qconv.qconv1x1(x, wt, a, bb, plain=True))
                m, k, n = x.numel() // x.shape[-1], x.shape[-1], wt.shape[0]
                x2 = x.reshape(m, k)
                l1 = cuda_ms(lambda: torch._int_mm(x2, wt.t()))  # the library GEMM, epilogue not included
                tk, tp, tl = tk + k1, tp + p1, tl + l1
                nbytes, ops = nbytes + m * k + n * k + m * n + 8 * n, ops + 2 * m * k * n
                bn, splits, _ = qconv.pick_qmm_tile(m, n, k, *qblock.card_limits(dev))
                print(f"  K4 lateral [{m}, {k}] x [{k}, {n}]: kernel {k1:.4f} ms, plain {p1:.4f} ms, torch._int_mm "
                      f"{l1:.4f} ms, tile 128x{bn}, split {splits}, {m * n * k / k1 / 1e9:.1f} T multiply-adds/s")
            t["qmatmul"], work["qmatmul"], host["qmatmul"] = (tk, tp, tl), (nbytes, ops, INT8_OPS_S), th
            print(f"  K4 laterals per forward (B=8): kernel {tk:.4f} ms, torch._int_mm {tl:.4f} ms "
                  f"(K4 / _int_mm {tk / tl:.3f}) {card}")
            t64 = l64 = 0.0
            for (x, wt, a, bb), _ in calls["qconv1x1"]:
                x8 = x.repeat(8, 1, 1, 1)
                got, want = qconv.qconv1x1(x8, wt, a, bb), qconv.qconv1x1(x8, wt, a, bb, plain=True)
                torch.cuda.synchronize()
                smoke.check(torch.equal(got, want), f"K4 lateral B=64 {tuple(x8.shape)}: "
                                                    f"{int((got != want).sum())} int8 differ")
                x2 = x8.reshape(-1, x8.shape[-1])
                t64 += cuda_ms(lambda: qconv.qconv1x1(x8, wt, a, bb), iters=5)
                l64 += cuda_ms(lambda: torch._int_mm(x2, wt.t()), iters=5)
            print(f"  K4 laterals per forward (B=64): kernel {t64:.4f} ms, torch._int_mm {l64:.4f} ms "
                  f"(K4 / _int_mm {t64 / l64:.3f}) {card}")

            tk = tp = th = nbytes = ops = t64 = 0.0
            sm_count, smem_max = qblock.card_limits(dev)
            for i, ((blk, xa), kw) in enumerate(calls["qhisblock"]):
                kw = {k: v for k, v in kw.items() if k != "plain"}
                k1 = cuda_ms(lambda: qhis.qhisblock(blk, xa, **kw), iters=10)
                th += host_ms(lambda: qhis.qhisblock(blk, xa, **kw), iters=10)
                p1 = cuda_ms(lambda: qhis.qhisblock(blk, xa, plain=True, **kw), iters=5)
                xb = kw.get("xb_q")
                b, h, w, cin = (xb if xb is not None else xa).shape
                half, r = blk["w1"].shape[0], blk["se_w1"].shape[1]
                macs = b * h * w * (2 * cin * half + 9 * half + 9 * cin * half + 9 * cin * cin) + b * 2 * half * r
                weights = sum(blk[k].numel() for k in ("w1", "w2", "wdw", "w3", "w4"))
                nbytes += xa.numel() + (xb.numel() if xb is not None else 0) + b * h * w * cin + weights
                tk, tp, ops = tk + k1, tp + p1, ops + 2 * macs
                # the same block at B=64, the kernel alone
                kw64 = dict(kw, xb_q=xb.repeat(8, 1, 1, 1)) if xb is not None else kw
                xa64 = xa.repeat(8, 1, 1, 1)
                k64 = cuda_ms(lambda: qhis.qhisblock(blk, xa64, **kw64), iters=5)
                t64 += k64
                tiles = [qhis.pick_his_tile(n, h, w, cin, sm_count, smem_max) for n in (b, 8 * b)]
                print(f"  K5 his{i + 1} {kw.get('combine')} {h}x{w}x{cin}: B=8 kernel {k1:.4f} ms, plain {p1:.4f} ms, "
                      f"{macs / k1 / 1e9:.1f} T multiply-adds/s, tile {tiles[0]}; B=64 kernel {k64:.4f} ms, "
                      f"{8 * macs / k64 / 1e9:.1f} T multiply-adds/s, tile {tiles[1]}")
            print(f"  K5 per forward, the kernel alone: B=8 {tk:.4f} ms ({ops / 2 / tk / 1e9:.1f} T multiply-adds/s), "
                  f"B=64 {t64:.4f} ms ({4 * ops / t64 / 1e9:.1f} T multiply-adds/s) {card}")
            t["qhisblock"], work["qhisblock"], host["qhisblock"] = (tk, tp, None), (nbytes, ops, INT8_OPS_S), th

            # K6: its one launch a forward, the two seeds from t5
            (x,), _ = calls["qmaxpool2x2_seeds"][0]
            tk = cuda_ms(lambda: qpool.qmaxpool2x2_seeds(x))
            th = host_ms(lambda: qpool.qmaxpool2x2_seeds(x))
            tp = cuda_ms(lambda: qpool.qmaxpool2x2_seeds(x, plain=True))
            try:  # the library call, where PyTorch takes int8 on the card
                xc = x.permute(0, 3, 1, 2)
                tl = cuda_ms(lambda: F.max_pool2d(F.max_pool2d(xc, 2, 2), 2, 2))
            except (RuntimeError, NotImplementedError) as e:
                print(f"  F.max_pool2d refuses int8 on the card: {str(e).splitlines()[0]}")
                tl = None
            s6, s7 = qpool.qmaxpool2x2_seeds(x)
            t["qmaxpool2x2_seeds"] = (tk, tp, tl)
            work["qmaxpool2x2_seeds"] = (x.numel() + s6.numel() + s7.numel(), 3 * (s6.numel() + s7.numel()),
                                         F32_OPS_S)
            host["qmaxpool2x2_seeds"] = th
            print(f"  K6 seeds {tuple(x.shape)} -> {tuple(s6.shape)}, {tuple(s7.shape)}: kernel {tk:.4f} ms, plain "
                  f"{tp:.4f} ms, F.max_pool2d twice {'none' if tl is None else f'{tl:.4f} ms'}")
            # the four level pools inside K5's load: K5 with pool_add against K5 with add on the pooled map;
            # and the standalone K6 (no launch on the main path) on those four inputs, as the parent ran them
            prologue = t6 = p6 = th6 = nbytes = ops = 0.0
            l6 = 0.0 if tl is not None else None
            for i, ((blk, xa), kw) in enumerate(calls["qhisblock"]):
                if kw.get("combine") != "pool_add":
                    continue
                kw = {k: v for k, v in kw.items() if k != "plain"}
                xp = qpool.qmaxpool2x2(xa)
                t_pool = cuda_ms(lambda: qhis.qhisblock(blk, xa, **kw), iters=10)
                t_add = cuda_ms(lambda: qhis.qhisblock(blk, xp, **dict(kw, combine="add")), iters=10)
                k6 = cuda_ms(lambda: qpool.qmaxpool2x2(xa))
                t6, p6 = t6 + k6, p6 + cuda_ms(lambda: qpool.qmaxpool2x2(xa, plain=True))
                th6 += host_ms(lambda: qpool.qmaxpool2x2(xa))
                if l6 is not None:
                    xc = xa.permute(0, 3, 1, 2)
                    l6 += cuda_ms(lambda: F.max_pool2d(xc, 2, 2))
                nbytes, ops = nbytes + xa.numel() + xp.numel(), ops + 3 * xp.numel()
                prologue += t_pool - t_add
                print(f"  K5 his{i + 1} pool_add {tuple(xa.shape)}: {t_pool:.4f} ms, add on the pooled map "
                      f"{t_add:.4f} ms (the pool in the load {t_pool - t_add:+.4f} ms), K6 alone {k6:.4f} ms")
            t["qmaxpool2x2"], work["qmaxpool2x2"], host["qmaxpool2x2"] = (t6, p6, l6), (nbytes, ops, F32_OPS_S), th6
            print(f"  K6 per forward (B=8): the seeds launch {tk:.4f} ms + the level pools in K5's load "
                  f"{prologue:+.4f} ms = {tk + prologue:.4f} ms; the standalone K6 on the four level pools "
                  f"{t6:.4f} ms {card}")
        for key, (tk, tp, tl) in t.items():
            b_ms, b_by = bound(*work[key])
            print(f"  {key} per forward (B=8): kernel {tk:.4f} ms, plain {tp:.4f} ms, library "
                  f"{'none' if tl is None else f'{tl:.4f} ms'}, bound {b_ms:.5f} ms ({b_by}), "
                  f"wrapper host time {host[key]:.4f} ms {card}")
        res["fpn_ms"], res["fpn_bound"] = t, {k: bound(*v) for k, v in work.items()}

    def block_work(blk, x, stride):
        """(bytes, int8 operations) of one int8 bottleneck on ``x``: input,
        weights and output once each; its multiply-adds, twice."""
        b, h, w, cin = x.shape
        cw, cout = blk["w1"].shape[0], blk["w3"].shape[0]
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        macs = b * (h * w * cin * cw + ho * wo * (9 * cw * cw + cw * cout + (cin * cout if "wd" in blk else 0)))
        weights = sum(blk[k].numel() for k in ("w1", "w2", "w3", "wd") if k in blk)
        return x.numel() + b * ho * wo * cout + weights + 4 * (2 * cw * 2 + 4 * cout), 2 * macs

    def time_backend_kernels():
        """K11, K10, K17 and K13 per B=8 forward of their paths, on the
        inputs phase 5h recorded, against their plain versions, with each
        one's bound from these inputs and the wrappers' host time; K13 beside
        kernel C's launches on the same input, in turns (K13, C, C, K13)."""
        calls = res["backend_calls"]
        t = {}  # key: (card ms, plain ms, host ms, (bytes, operations, peak))
        with torch.inference_mode():
            tk = tp = th = nbytes = ops = 0.0
            for (x, w, a, b), _ in calls["qconv3x3"]:
                k1 = cuda_ms(lambda: qconv.qconv3x3(x, w, a, b))
                th += host_ms(lambda: qconv.qconv3x3(x, w, a, b))
                p1 = cuda_ms(lambda: qconv.qconv3x3(x, w, a, b, plain=True), iters=5)
                bsz, h, wd, cin = x.shape
                cout = w.shape[0]
                tk, tp = tk + k1, tp + p1
                nbytes += x.numel() + w.numel() + bsz * h * wd * cout + 8 * cout
                ops += 2 * bsz * h * wd * 9 * cin * cout
                print(f"  K11 {tuple(x.shape)} x {tuple(w.shape)}: kernel {k1:.4f} ms, plain {p1:.4f} ms")
            t["qconv3x3"] = (tk, tp, th, (nbytes, ops, INT8_OPS_S))
            # K11 per stage shape at B=8 and B=64 beside its plain version; the
            # per-conv forward's sum weighs each shape by its calls (3, 3, 5, 2)
            stage = {}
            for (x, w, a, b), _ in calls["qconv3x3"]:
                stage.setdefault(tuple(x.shape), [x, w, a, b, 0])[4] += 1
            for bsz in (8, 64):
                fk = fp = 0.0
                for x, w, a, b, n in stage.values():
                    xb = x.repeat(bsz // x.shape[0], 1, 1, 1)
                    k1 = cuda_ms(lambda: qconv.qconv3x3(xb, w, a, b), iters=20 if bsz == 8 else 5)
                    p1 = cuda_ms(lambda: qconv.qconv3x3(xb, w, a, b, plain=True), iters=5 if bsz == 8 else 2)
                    fk, fp = fk + n * k1, fp + n * p1
                    macs = xb.numel() * 9 * w.shape[0]
                    tile = qconv.pick_conv3_tile(*xb.shape, w.shape[0], *qblock.card_limits(dev))
                    print(f"  K11 stage shape B={bsz} {tuple(xb.shape)} x {tuple(w.shape)} ({n} calls): kernel "
                          f"{k1:.4f} ms, plain {p1:.4f} ms, tile {tile}, {macs / k1 / 1e9:.1f} T multiply-adds/s")
                print(f"  K11 per per-conv forward (B={bsz}, 13 launches): kernel {fk:.4f} ms, plain {fp:.4f} ms {card}")

            # K4 at the per-conv path's 36 1x1 convs, B=8 and B=64, beside
            # torch._int_mm of the same GEMMs (int32 out, epilogue not included)
            for b in (8, 64):
                tk = tl = 0.0
                for (x, w, a, bb), kw in calls["qconv1x1"]:
                    kw = {key: v for key, v in kw.items() if key != "plain"}
                    rep = b // x.shape[0]
                    xb = x.repeat(rep, 1, 1, 1)
                    kwb = dict(kw, res=kw["res"].repeat(rep, 1, 1, 1)) if kw.get("res") is not None else kw
                    m, k, n = xb.numel() // xb.shape[-1], xb.shape[-1], w.shape[0]
                    if b == 64:  # B=8 is held in phase 5i
                        got = qconv.qconv1x1(xb, w, a, bb, **kwb)
                        want = qconv.qconv1x1(xb, w, a, bb, plain=True, **kwb)
                        torch.cuda.synchronize()
                        smoke.check(torch.equal(got, want), f"K4 per-conv B=64 [{m}, {k}] x [{k}, {n}]: "
                                                            f"{int((got != want).sum())} int8 differ")
                    k1 = cuda_ms(lambda: qconv.qconv1x1(xb, w, a, bb, **kwb), iters=20 if b == 8 else 5)
                    x2 = xb.reshape(m, k)
                    l1 = cuda_ms(lambda: torch._int_mm(x2, w.t()), iters=20 if b == 8 else 5)
                    tk, tl = tk + k1, tl + l1
                    bn, splits, _ = qconv.pick_qmm_tile(m, n, k, *qblock.card_limits(dev))
                    print(f"  K4 per-conv B={b} [{m}, {k}] x [{k}, {n}]: kernel {k1:.4f} ms, torch._int_mm {l1:.4f} ms, "
                          f"tile 128x{bn}, split {splits}, {m * n * k / k1 / 1e9:.1f} T multiply-adds/s")
                print(f"  K4 per-conv (36 launches, B={b}): kernel {tk:.4f} ms, torch._int_mm {tl:.4f} ms "
                      f"(K4 / _int_mm {tk / tl:.3f}) {card}")

            (x,), _ = calls["qmaxpool3x3s2"][0]
            tk, th = cuda_ms(lambda: qpool.qmaxpool3x3s2(x)), host_ms(lambda: qpool.qmaxpool3x3s2(x))
            tp = cuda_ms(lambda: qpool.qmaxpool3x3s2(x, plain=True))
            out = x.shape[0] * ((x.shape[1] - 1) // 2 + 1) * ((x.shape[2] - 1) // 2 + 1) * x.shape[3]
            t["qmaxpool3x3s2"] = (tk, tp, th, (x.numel() + out, 8 * out, F32_OPS_S))  # 8 compares per output
            tg = graph_ms(lambda: qpool.qmaxpool3x3s2(x))
            b8 = bound(x.numel() + out, 8 * out, F32_OPS_S)
            print(f"  K10 {tuple(x.shape)}: kernel {tk:.4f} ms back to back, {tg:.4f} ms from a graph, host {th:.4f} "
                  f"ms, plain {tp:.4f} ms, bound {b8[0]:.5f} ms ({b8[1]}, {b8[0] / tg:.1%} of it from the graph), "
                  f"band {qpool.pick_pool3_tile(*x.shape[:3], *qblock.card_limits(dev), c=x.shape[3])} {card}")
            x64 = x.repeat(8, 1, 1, 1)
            t64, g64 = cuda_ms(lambda: qpool.qmaxpool3x3s2(x64), iters=10), graph_ms(lambda: qpool.qmaxpool3x3s2(x64),
                                                                                     iters=10)
            b64 = bound(x64.numel() + 8 * out, 64 * out, F32_OPS_S)
            print(f"  K10 B=64 {tuple(x64.shape)}: kernel {t64:.4f} ms back to back, {g64:.4f} ms from a graph, "
                  f"bound {b64[0]:.5f} ms ({b64[1]}, {b64[0] / g64:.1%} of it from the graph), band "
                  f"{qpool.pick_pool3_tile(*x64.shape[:3], *qblock.card_limits(dev), c=x.shape[3])} {card}")
            # the same shape on scripts/port_kernel_times.py's random input (uniform int8), in turn with the
            # pipeline's map, the random one first, with the card's clocks and temperature read between the graphs
            g = torch.Generator(device=dev).manual_seed(SEED + 10)
            xr = torch.randint(-128, 128, x64.shape, generator=g, device=dev, dtype=torch.int8)
            turns = []
            for name, inp in 3 * (("random", xr), ("map", x64)):
                turns.append(f"{name} {graph_ms(lambda: qpool.qmaxpool3x3s2(inp), iters=10):.4f} ({smi_clocks()})")
            print(f"  K10 B=64 from a graph, the pipeline's map and a random one in turn: {'; '.join(turns)} "
                  f"(SM MHz, memory MHz, deg C, W) {card}")

            (x, mult, shift, scale), _ = calls["stem_bn_pool_quant"][0]
            tk = cuda_ms(lambda: stem.stem_bn_pool_quant(x, mult, shift, scale))
            th = host_ms(lambda: stem.stem_bn_pool_quant(x, mult, shift, scale))
            tp = cuda_ms(lambda: stem.stem_bn_pool_quant(x, mult, shift, scale, plain=True))
            out = x.shape[0] * ((x.shape[1] - 1) // 2 + 1) * ((x.shape[2] - 1) // 2 + 1) * x.shape[3]
            # bf16 in, int8 out; BN, ReLU per input, 8 compares and the quantize's 4 ops per output
            t["stem_bn_pool_quant"] = (tk, tp, th, (2 * x.numel() + out + 4 * (2 * x.shape[3] + 1),
                                                    3 * x.numel() + 12 * out, F32_OPS_S))
            print(f"  K17 {tuple(x.shape)}: kernel {tk:.4f} ms, plain {tp:.4f} ms, host {th:.4f} ms, band "
                  f"{stem.pick_stem_tail_tile(*x.shape[:3], *qblock.card_limits(dev))}")
            x64 = x.repeat(8, 1, 1, 1)
            t64 = cuda_ms(lambda: stem.stem_bn_pool_quant(x64, mult, shift, scale), iters=5)
            b64 = bound(2 * x64.numel() + 8 * out + 4 * (2 * x.shape[3] + 1), 3 * x64.numel() + 96 * out, F32_OPS_S)
            band = stem.pick_stem_tail_tile(*x64.shape[:3], *qblock.card_limits(dev))
            print(f"  K17 B=64 {tuple(x64.shape)}: kernel {t64:.4f} ms, bound {b64[0]:.5f} ms ({b64[1]}, "
                  f"{b64[0] / t64:.1%} of it), band {band} {card}")

            def k13_vs_c(x, blocks, iters, reps):
                """K13 and kernel C on one segment in turns (K13, C, C, K13): their mean ms."""
                k13 = [cuda_ms(lambda: qchain.qchain(x, blocks), iters=iters, reps=reps)]
                kc = [cuda_ms(lambda: kernel_c_chain(x, blocks), iters=iters, reps=reps) for _ in range(2)]
                k13.append(cuda_ms(lambda: qchain.qchain(x, blocks), iters=iters, reps=reps))
                print(f"  K13 B={x.shape[0]} {len(blocks)} blocks {tuple(x.shape)}: kernel {k13[0]:.4f}/"
                      f"{k13[1]:.4f} ms, kernel C ({len(blocks)} launches) {kc[0]:.4f}/{kc[1]:.4f} ms, grid "
                      f"{qchain.qchain.grid} blocks, tiles and cluster "
                      f"{qchain.pick_chain_tile(x.shape[0], chain_convs(x, blocks), *qblock.card_limits(dev))}")
                return statistics.mean(k13), statistics.mean(kc)

            tk = tp = th = tc = nbytes = ops = 0.0
            for (x, blocks), _ in calls["qchain"]:
                k1, c1 = k13_vs_c(x, blocks, 10, 5)
                th += host_ms(lambda: qchain.qchain(x, blocks), iters=10)
                p1 = cuda_ms(lambda: qchain.qchain(x, blocks, plain=True), iters=3, reps=3)
                tk, tp, tc = tk + k1, tp + p1, tc + c1
                xin = x
                for blk, s in blocks:
                    ops += block_work(blk, xin, s)[1]
                    nbytes += sum(blk[k].numel() for k in ("w1", "w2", "w3", "wd") if k in blk)
                    b, h, w, _ = xin.shape
                    xin = xin.new_empty((b, (h - 1) // s + 1, (w - 1) // s + 1, blk["w3"].shape[0]))
                nbytes += x.numel() + xin.numel()  # the segment's input and output; the weights above
                print(f"  K13 plain {p1:.4f} ms")
            t["qchain"] = (tk, tp, th, (nbytes, ops, INT8_OPS_S))
            print(f"  K13 per forward (B=8, 3 launches) {tk:.4f} ms against kernel C's 16 launches on the same "
                  f"inputs {tc:.4f} ms (K13/C {tk / tc:.3f}) {card}")
            # the same at B=64, the throughput point: the tiles, and so the grid, depend on the batch
            t64 = [k13_vs_c(x.repeat(8, 1, 1, 1), blocks, 3, 3) for (x, blocks), _ in calls["qchain"]]
            k64, c64 = sum(k for k, _ in t64), sum(c for _, c in t64)
            print(f"  K13 per forward (B=64) {k64:.4f} ms against kernel C's {c64:.4f} ms (K13/C {k64 / c64:.3f}) "
                  f"{card}")
        res["backend_ms"] = {k: (tk, tp, th, bound(*w)) for k, (tk, tp, th, w) in t.items()}
        for key, (tk, tp, th, (b_ms, b_by)) in res["backend_ms"].items():
            print(f"  {key} per forward (B=8): kernel {tk:.4f} ms, plain {tp:.4f} ms, library none, bound "
                  f"{b_ms:.5f} ms ({b_by}), wrapper host time {th:.4f} ms {card}")

    def time_fused_backbone():
        """K16 per B=8 forward of the fused backbone on the inputs phase 5j
        recorded, against its plain version and torch.matmul of the same
        bf16 GEMMs (the library column: the epilogue not included), with its
        bound and the wrapper's host time; then the fused backbone against
        the module forward at B=8 and B=64, in turns (fused, module, module,
        fused)."""
        tk = tp = tl = th = nbytes = ops = 0.0
        with torch.inference_mode():
            for (x, w, sc, sh), kw in res["k16_calls"]:
                kw = {k: v for k, v in kw.items() if k != "plain"}
                m, k, n = x.numel() // x.shape[-1], x.shape[-1], w.shape[0]
                x2, w2 = x.reshape(m, k), w.reshape(n, k)
                tk += cuda_ms(lambda: fused.conv1x1_bn_act(x, w, sc, sh, **kw))
                th += host_ms(lambda: fused.conv1x1_bn_act(x, w, sc, sh, **kw))
                tp += cuda_ms(lambda: fused.conv1x1_bn_act(x, w, sc, sh, plain=True, **kw), iters=5, reps=3)
                tl += cuda_ms(lambda: torch.matmul(x2, w2.t()))
                nbytes += 2 * (m * k + n * k + m * n * (2 if kw.get("residual") is not None else 1)) + 8 * n
                ops += 2 * m * n * k
        b_k16 = bound(nbytes, ops, BF16_OPS_S)
        print(f"  matmul_bn_act per forward (B=8, 32 launches): kernel {tk:.4f} ms ({ops / tk / 1e9:.1f} TFLOP/s), "
              f"plain {tp:.4f} ms, torch.matmul (bf16, no epilogue) {tl:.4f} ms ({ops / tl / 1e9:.1f} TFLOP/s), bound "
              f"{b_k16[0]:.5f} ms ({b_k16[1]}; {nbytes / 1e9:.3f} GB, {ops / 2e9:.1f} G multiply-adds), wrapper host "
              f"time {th:.4f} ms {card}")
        res["k16"] = dict(ms=tk, plain_ms=tp, library_ms=tl, host_ms=th, bound=b_k16)

        backbone, folded = res["model"].backbone, res["folded"]
        bb16 = res["pipe"].model.backbone
        for b, iters in ((8, 10), (64, 3)):
            norm = res["norm8"].repeat(b // 8, 1, 1, 1)
            fused_fn = lambda: fused_resnet.resnet50_fused_forward(backbone, norm, torch.bfloat16, folded)
            module_fn = lambda: bb16(norm.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous())
            with torch.inference_mode():
                tf = [cuda_ms(fused_fn, iters=iters, reps=3)]
                tm = [cuda_ms(module_fn, iters=iters, reps=3) for _ in range(2)]
                tf.append(cuda_ms(fused_fn, iters=iters, reps=3))
            print(f"  fused backbone B={b}: {tf[0]:.3f}/{tf[1]:.3f} ms, module forward (bf16) {tm[0]:.3f}/{tm[1]:.3f} "
                  f"ms (fused/module {statistics.mean(tf) / statistics.mean(tm):.3f}) {card}")

    def time_fused_head():
        """K15 per B=8 forward on the five levels phase 5k recorded, against
        its plain version and the bf16 float head on the same levels (convs
        and kernel B: the head K15 replaces, not a library call), with its
        bound and the wrapper's host time."""
        tk = tp = th = nbytes = ops = 0.0
        with torch.inference_mode():
            for i, ((x, packed, nc), _) in enumerate(res["k15_calls"]):
                k1 = cuda_ms(lambda: head.hishead_level_fused(x, packed, nc), iters=10)
                th += host_ms(lambda: head.hishead_level_fused(x, packed, nc), iters=10)
                p1 = cuda_ms(lambda: head.hishead_level_fused(x, packed, nc, plain=True), iters=3, reps=3)
                b, h, w, f = x.shape
                macs = b * h * w * (f * 2 * f + 9 * 2 * f + 2 * f * f + 2 * 9 * f * f + 9 * f * (nc + 5))
                weights = sum(packed[k].numel() * packed[k].element_size() for k in (
                    "k_pw1", "dw", "k_pw2", "k_tow", "k_cls", "k_cr", "gn", "bias"))
                nbytes += 2 * x.numel() + 2 * b * h * w * (nc + 5) + weights
                ops += 2 * macs
                tk, tp = tk + k1, tp + p1
                print(f"  K15 P{i + 3} {tuple(x.shape)}: kernel {k1:.4f} ms, plain {p1:.4f} ms")
            float_head, levels_nchw = res["k15_float_head"]
            tf = cuda_ms(lambda: float_head(levels_nchw), iters=10)
        b_k15 = bound(nbytes, ops, BF16_OPS_S)
        print(f"  hishead_level_fused per forward (B=8, 5 launches): kernel {tk:.4f} ms, plain {tp:.4f} ms, bound "
              f"{b_k15[0]:.5f} ms ({b_k15[1]}; {ops / 2e9:.1f} G multiply-adds), {ops / tk / 1e9:.1f} TFLOP/s, "
              f"wrapper host time {th:.4f} ms; the bf16 float head at the same levels {tf:.4f} ms {card}")
        res["k15"] = dict(ms=tk, plain_ms=tp, host_ms=th, bound=b_k15, float_head_ms=tf)

    def time_k4_prime():
        """K4''s three epilogues at the harness's shape against their plain
        versions, each one's bound, and the epilogue's share of ``full``."""
        inp = res["k4p_inputs"]
        m, k = inp["x"].shape
        n = inp["w"].shape[0]
        t = {}
        with torch.inference_mode():
            for v in qmm_variants.VARIANTS:
                r = inp["res"] if v == "full" else None
                args = (v, inp["x"], inp["w"], inp["a"], inp["b"], r)
                tk = cuda_ms(lambda: qmm_variants.qmm_variant(*args))
                th = host_ms(lambda: qmm_variants.qmm_variant(*args))
                tp = cuda_ms(lambda: qmm_variants.qmm_variant(*args, plain=True), iters=5, reps=3)
                nbytes = m * k + n * k + m * n * (2 if v == "full" else 1) + 8 * n
                t[v] = (tk, tp, th, bound(nbytes, 2 * m * n * k, INT8_OPS_S))
                print(f"  K4' {v} [{m}, {k}] x [{k}, {n}]: kernel {tk:.4f} ms, plain {tp:.4f} ms, bound "
                      f"{t[v][3][0]:.5f} ms ({t[v][3][1]}), {m * n * k / tk / 1e9:.2f} T multiply-adds/s, "
                      f"wrapper host time {th:.4f} ms {card}")
        with torch.inference_mode():  # the library GEMM of each launch, epilogue not included
            tl = cuda_ms(lambda: torch._int_mm(inp["x"], inp["w"].t()))
        print(f"  K4' [{m}, {k}] x [{k}, {n}]: torch._int_mm (int32 out, no epilogue) {tl:.4f} ms {card}")
        res["k4p_lib_ms"] = tl
        share = (t["full"][0] - t["shift"][0]) / t["full"][0]
        print(f"  K4' epilogue share of full: {share:.3f} (full - shift over full); nores - shift "
              f"{t['nores'][0] - t['shift'][0]:.4f} ms {card}")
        res["k4p"] = t

    def time_k12():
        """K12 per B=8 forward of the MNFCOS int8 ladder, on the 15 calls
        phase 5n recorded, against its plain version, with its bound from
        these inputs and the wrapper's host time; no one PyTorch call
        computes the block."""
        tk = tp = th = nbytes = ops = 0.0
        with torch.inference_mode():
            for i, (args, _) in enumerate(res["mn_calls"]["qmnblock"]):
                blk, _, x, k, dil = args
                k1 = cuda_ms(lambda: qmnblock.qmnblock(*args))
                th += host_ms(lambda: qmnblock.qmnblock(*args))
                p1 = cuda_ms(lambda: qmnblock.qmnblock(*args, plain=True), iters=3, reps=3)
                b, h, w, c = x.shape
                cm = blk["w1"].shape[0]
                nbytes += 2 * x.numel() + sum(blk[n].numel() * blk[n].element_size() for n in blk) + 4 * 4
                ops += 2 * b * h * w * (k * k * c + 2 * c * cm)
                tk, tp = tk + k1, tp + p1
                print(f"  K12 call {i + 1} {tuple(x.shape)} k{k} d{dil}: kernel {k1:.4f} ms, plain {p1:.4f} ms")
        b12 = bound(nbytes, ops, INT8_OPS_S)
        print(f"  qmnblock per forward (B=8, 15 launches): kernel {tk:.4f} ms, plain {tp:.4f} ms, library none, bound "
              f"{b12[0]:.5f} ms ({b12[1]}; {nbytes / 1e6:.1f} MB, {ops / 2e9:.2f} G multiply-adds), "
              f"{ops / 2 / tk / 1e9:.2f} T multiply-adds/s, wrapper host time {th:.4f} ms {card}")
        res["k12"] = dict(ms=tk, plain_ms=tp, host_ms=th, bound=b12)

    def head_work(q, x):
        """(bytes, int8 operations) of one head level: input, weights and
        f32 outputs once each; the multiply-adds of pw1, dw, pw2, the two
        towers and the two pred convs, twice."""
        b, h, w, c = x.shape
        nc = q["wpc"].shape[0]
        macs = b * h * w * (c * 2 * c + 9 * 2 * c + 2 * c * c + 2 * 9 * c * c + 9 * c * (nc + 5))
        weights = sum(q[k].numel() for k in ("w1", "wdw", "w2", "wc", "wr", "wpc", "wcr"))
        return x.numel() + weights + 4 * b * h * w * (nc + 5), 2 * macs

    def time_head_kernels():
        """K7 per B=8 forward of the default pipeline, on the inputs phase 5f
        recorded, against its plain version, its bound and the wrappers'
        host time, beside the bf16 float head at the same levels (convs and
        kernel B: the head K7 replaces, not a library call); then K9 against
        K7 at the COCO P3 shape, in turns (K9, K7, K7, K9)."""
        tk = tp = th = nbytes = ops = 0.0
        with torch.inference_mode():
            for i, ((q, lv, x), kw) in enumerate(res["head_calls"]["qhishead_level"]):
                k1 = cuda_ms(lambda: qhead.qhishead_level(q, lv, x, **kw), iters=10)
                th += host_ms(lambda: qhead.qhishead_level(q, lv, x, **kw), iters=10)
                p1 = cuda_ms(lambda: qhead.qhishead_level(q, lv, x, plain=True, **kw), iters=3, reps=3)
                nb, op = head_work(q, x)
                tk, tp, nbytes, ops = tk + k1, tp + p1, nbytes + nb, ops + op
                tile = qhead.pick_head_tile(*x.shape, q["wpc"].shape[0], *qblock.card_limits(dev))
                print(f"  K7 P{i + 3} {tuple(x.shape)}: kernel {k1:.4f} ms ({op / 2 / k1 / 1e9:.2f} T multiply-adds/s), "
                      f"plain {p1:.4f} ms; tiles (images, slices) {tile}")
            deq, float_head = res["head_levels"]
            tf = cuda_ms(lambda: float_head(deq), iters=10)
        b_k7 = bound(nbytes, ops, INT8_OPS_S)
        print(f"  qhishead_level per forward (B=8, 5 launches): kernel {tk:.4f} ms, plain {tp:.4f} ms, bound "
              f"{b_k7[0]:.5f} ms ({b_k7[1]}), {ops / 2 / tk / 1e9:.2f} T multiply-adds/s, wrapper host time "
              f"{th:.4f} ms; the bf16 float head at the same levels {tf:.4f} ms {card}")
        res["k7"] = dict(ms=tk, plain_ms=tp, host_ms=th, bound=b_k7, float_head_ms=tf)

        if "coco_p3" not in res:
            return
        q, lv, x = res["coco_p3"]
        with torch.inference_mode():
            k9 = [cuda_ms(lambda: qhead.qhishead_level2(q, lv, x), iters=5)]
            k7 = [cuda_ms(lambda: qhead.qhishead_level(q, lv, x), iters=5) for _ in range(2)]
            k9.append(cuda_ms(lambda: qhead.qhishead_level2(q, lv, x), iters=5))
            h9 = host_ms(lambda: qhead.qhishead_level2(q, lv, x), iters=5)
            p9 = cuda_ms(lambda: qhead.qhishead_level2(q, lv, x, plain=True), iters=2, reps=3)
        b_k9 = bound(*head_work(q, x), INT8_OPS_S)
        t9, t7 = statistics.mean(k9), statistics.mean(k7)
        print(f"  COCO P3 {tuple(x.shape)}, 80 classes: K9 {k9[0]:.4f}/{k9[1]:.4f} ms, K7 {k7[0]:.4f}/{k7[1]:.4f} ms "
              f"(K9/K7 {t9 / t7:.3f}), plain {p9:.4f} ms, bound {b_k9[0]:.5f} ms ({b_k9[1]}), K9 wrapper host time "
              f"{h9:.4f} ms {card}")
        res["k9"] = dict(ms=t9, k7_ms=t7, plain_ms=p9, host_ms=h9, bound=b_k9)

    def phase6_profile(pipe, ours=("gn_act_kernel", "nms_"), split=()):
        """Where the time goes in one B=64 pipeline call (torch.profiler)."""
        fr = res["frames"].repeat(8, 1, 1, 1)
        profile_calls(lambda: pipe(fr), ours, split)

    def profile_calls(fn, ours=(), split=(), top=15):
        """Where the time goes in 3 calls of ``fn`` after 2 of warm-up
        (torch.profiler): the device's kernel time and idle share, the
        ``top`` kernels and those named in ``ours``; ``split``: kernel name
        prefixes whose kernels are also summed by name (their template
        arguments dropped), one line a prefix."""
        from torch.profiler import ProfilerActivity, profile

        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000.0
        # kernels only (device-side events), so no time is counted twice
        events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if not events:
            print("  profiler saw no device events: device breakdown not measured")
            return
        attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
        total_us = sum(getattr(e, attr) for e in events)
        print(f"  3 calls: wall {wall_ms:.2f} ms, device kernel time {total_us / 1000.0:.2f} ms, "
              f"device idle share {max(0.0, 1.0 - total_us / 1000.0 / wall_ms):.3f} {card}")
        ranked = sorted(events, key=lambda e: -getattr(e, attr))
        mine = [e for e in ranked[top:] if any(k in e.key for k in ours)]
        for e in ranked[:top] + mine:
            print(f"    {getattr(e, attr) / 1000.0:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
        for prefix in split:
            parts = {}
            for e in events:
                m = re.search(prefix + r"\w*", e.key)
                if m:
                    parts[m.group(0)] = parts.get(m.group(0), 0.0) + getattr(e, attr) / 1000.0
            print(f"  {prefix}* kernels, 3 calls: {sum(parts.values()):.3f} ms = "
                  + " + ".join(f"{k} {v:.3f}" for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))

    def phase6g():
        """The fused-head profile, then the head's share of it at B=64 on the
        five levels phase 5k recorded (repeated to 64 images), split as the
        pipeline runs it (``make_eval_forward_int8``): the NCHW -> NHWC bf16
        copies that feed K15, K15's five launches, and the casts and
        ScaleExp after them; beside the bf16 float head with kernel B and
        its NCHW -> NHWC f32 outputs, the head it replaces."""
        phase6_profile(res["hpipe"], ("qblock_kernel", "fhead_", "nms_"), ("fhead_",))
        model, nc = res["model"], res["model"].num_classes
        float_head, levels8 = res["k15_float_head"]
        levels = [lv.repeat(8, 1, 1, 1) for lv in levels8]
        packed = res["k15_calls"][0][0][1]
        scales = [getattr(model.head, f"scale{i}").scale.detach().float() for i in range(5)]
        with torch.inference_mode():
            nhwc = [lv.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous() for lv in levels]
            outs = [head.hishead_level_fused(x, packed, nc) for x in nhwc]

            def tail():
                for out, scale in zip(outs, scales):
                    out[..., :nc].float(), out[..., nc:nc + 1].float(), torch.exp(out[..., nc + 1:].float() * scale)

            t_seam = cuda_ms(lambda: [lv.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous() for lv in levels],
                             iters=10)
            t_k15 = cuda_ms(lambda: [head.hishead_level_fused(x, packed, nc) for x in nhwc], iters=10)
            t_tail = cuda_ms(tail, iters=10)
            t_float = cuda_ms(lambda: float_head(levels), iters=10)
            f_outs = float_head(levels)
            t_ftail = cuda_ms(lambda: [[o.permute(0, 2, 3, 1).float() for o in b] for b in f_outs], iters=10)
            splits = [kernel_split(lambda: head.hishead_level_fused(x, packed, nc), "fhead_", 3) for x in nhwc]
        fused, floated = t_seam + t_k15 + t_tail, t_float + t_ftail
        print(f"  the head per B=64 call: fused {fused:.4f} ms = NCHW -> NHWC copies {t_seam:.4f} + K15 {t_k15:.4f} "
              f"+ casts and ScaleExp {t_tail:.4f}; float head {floated:.4f} ms = convs and kernel B {t_float:.4f} "
              f"+ NHWC f32 outputs {t_ftail:.4f}; fused - float {fused - floated:+.4f} ms {card}")
        for i, (x, split) in enumerate(zip(nhwc, splits)):
            print(f"  K15 P{i + 3} {tuple(x.shape)} by CUDA kernel, device ms a call: "
                  + (", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items())) or "not measured"))

    def phase6h():
        """The MNFCOS int8-ladder profile, then K12's time by call at B=64 (one
        CUDA kernel a call: CUDA events over back-to-back launches), on the
        15 calls phase 5n recorded (inputs repeated to 64 images), each under
        its chooser's tile."""
        phase6_profile(res["lpipe"], ("qstem_kernel", "qblock_kernel", "qmnblock_kernel", "nms_"),
                       ("qmnblock_kernel",))
        sm_count, smem_max = qblock.card_limits(dev)
        total = 0.0
        with torch.inference_mode():
            for i, ((blk, sc, x, k, dil), _) in enumerate(res["mn_calls"]["qmnblock"]):
                xb = x.repeat(8, 1, 1, 1)
                b, h, w, c = xb.shape
                ms = cuda_ms(lambda: qmnblock.qmnblock(blk, sc, xb, k, dil), iters=10, reps=3)
                total += ms
                tile = qmnblock.pick_mn_tile(b, h, w, c, blk["w1"].shape[0], k, dil, sm_count, smem_max)
                print(f"  K12 call {i + 1} {tuple(xb.shape)} k{k} d{dil} tile {tile}: {ms:.4f} ms")
        print(f"  K12, the 15 calls at B=64: {total:.4f} ms {card}")

    def kernel_split(fn, prefix, iters):
        """Device ms per call of each CUDA kernel whose name starts with
        ``prefix`` (template arguments dropped), over ``iters`` calls under
        torch.profiler; {} where the profiler sees no device time."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            m = re.search(r"\b" + prefix + r"\w*", e.key)
            if m and str(getattr(e, "device_type", "")).endswith("CUDA"):
                t = getattr(e, "self_device_time_total", None)
                t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
                parts[m.group(0)] = parts.get(m.group(0), 0.0) + t / 1000.0 / iters
        return parts

    smoke.phase("phase 1: device", phase1)
    smoke.phase("phase 2: build", phase2)
    smoke.phase("phase 3: kernel B (GroupNorm) vs plain", phase3)
    smoke.phase("phase 4: kernel A (NMS) vs plain", phase4)
    smoke.phase("phase 5: float serving pipeline, HISFCOS(20, 256) bf16 512x512 B=8", phase5)
    if "pipe" in res:
        smoke.phase("phase 5b: int8-backbone serving pipeline, HISFCOS(20, 256) bf16 512x512 B=8", phase5b)
    if "ipipe" in res:
        smoke.phase("phase 5c: kernel C (int8 bottleneck) vs plain at the 16 block shapes, B=8", phase5c)
    if "pipe" in res:
        smoke.phase("phase 5d: int8-FPN serving pipeline from uint8 frames, HISFCOS(20, 256) bf16 512x512 B=8",
                    phase5d)
    if "fpn_calls" in res:
        smoke.phase("phase 5e: K1, K4, K5, K6 vs plain at the pipeline's shapes, B=8; K1 at 512x512 B=64, "
                    "the COCO canvas and odd sizes; K5 pool_add vs K6 + K5 add", phase5e)
    if "pipe" in res:
        smoke.phase("phase 5f: the default serving pipeline (int8 FPN and head) from uint8 frames, "
                    "HISFCOS(20, 256) bf16 512x512 B=8", phase5f)
    if "head_calls" in res:
        smoke.phase("phase 5g: K7 vs plain at the pipeline's levels; the COCO canvas and K9", phase5g)
    if "dpipe" in res and "ipipe" in res:
        smoke.phase("phase 5h: the int8 ResNet-50's other backends through make_eval_pipeline_int8, "
                    "HISFCOS(20, 256) bf16 512x512 B=8", phase5h)
    if "backend_calls" in res:
        smoke.phase("phase 5i: K11, K10, K17, K13 vs plain at the paths' shapes, B=8; K11 and K13 under forced "
                    "tiles at B=8 and B=64, K13 vs kernel C", phase5i)
    if "pipe" in res:
        smoke.phase("phase 5j: the fused ResNet-50 (K16), HISFCOS(20, 256) bf16 512x512 B=8", phase5j)
        smoke.phase("phase 5k: the fused-head serving pipeline (int8 backbone, K15), HISFCOS(20, 256) bf16 "
                    "512x512 B=8", phase5k)
    smoke.phase("phase 5l: K4' (the three qmatmul epilogues) vs plain at [1048576, 64] x [64, 256]", phase5l)
    if "pipe" in res:
        smoke.phase("phase 5m: the float MNFCOS pipeline, MNFCOS(20, 256) bf16 512x512 B=8", phase5m)
    if "mn_model" in res:
        smoke.phase("phase 5n: MNFCOS int8: make_eval_pipeline_int8 (the JAX gate) and the full ladder from uint8 "
                    "frames (K12), bf16 512x512 B=8", phase5n)
    if "mn_calls" in res:
        smoke.phase("phase 5n (iii): K12 vs plain at the ladder's 15 calls and odd shapes", phase5n_k12)
    if "pipe" in res:
        smoke.phase(f"phase 5o: VOC evaluation from the dataset: {EVAL_FRAMES} seeded frames in raw tiles served as "
                    f"{EVAL_IDS} ids, the "
                    "device resize, evaluate_voc through the loader at B=16 and B=64", phase5o)
    if "pipe" in res and "model80" in res:
        smoke.phase("phase 5p: COCO evaluation from JPEGs: the committed fixture tree's decodes, evaluate_voc, the "
                    "device resize at 896x1408, evaluate_coco of HISFCOS(80, 256) at B=4, the CLI", phase5p)
    smoke.phase("phase 5q: training: the f32 step against the CPU, bf16 against f32, kernel B's path, the step's "
                "time at HISFCOS(20, 256) 512x512 B=16, learning on the VOC tree, the CLI", phase5q)
    if "pipe" in res:
        smoke.phase("phase 6: timing", phase6)
        smoke.phase("phase 6b: profile, float pipeline", phase6_profile, res["pipe"])
    if "ipipe" in res:
        smoke.phase("phase 6c: profile, int8 pipeline", phase6_profile, res["ipipe"],
                    ("qblock_kernel", "gn_act_kernel", "nms_"))
    if "fpipe" in res:
        smoke.phase("phase 6d: profile, int8-FPN pipeline", phase6_profile, res["fpipe"],
                    ("qstem_kernel", "qblock_kernel", "qmm_", "his_", "qpool_", "gn_act_kernel", "nms_"))
    if "dpipe" in res:
        smoke.phase("phase 6e: profile, default pipeline; K7's and K5's split", phase6_profile, res["dpipe"],
                    ("qstem_kernel", "qblock_kernel", "qmm_", "his_", "qpool_", "head_", "nms_"), ("head_", "his_"))
    if "per-conv" in res.get("paths", {}):
        smoke.phase("phase 6f: profile, per-conv pipeline", phase6_profile, res["paths"]["per-conv"][0],
                    ("qstem_kernel", "qconv3_kernel", "qmm_", "his_", "qpool_", "head_", "nms_"))
    if "hpipe" in res:
        smoke.phase("phase 6g: profile, fused-head pipeline; the head's split, K15 by CUDA kernel", phase6g)
    if "lpipe" in res:
        smoke.phase("phase 6h: profile, MNFCOS int8-ladder pipeline; K12 by call", phase6h)
    if "chained" in res.get("paths", {}):
        smoke.phase("phase 6i: profile, chained pipeline", phase6_profile, res["paths"]["chained"][0],
                    ("qstem_kernel", "qchain_kernel", "qmm_", "his_", "qpool_", "head_", "nms_"))
    if "stem tail" in res.get("paths", {}):
        smoke.phase("phase 6j: profile, stem-tail pipeline; kernel B, K17 and the copy kernels", phase6_profile,
                    res["paths"]["stem tail"][0], ("stem_tail_kernel", "gn_act_kernel", "nms_"),
                    ("gn_act_kernel", "stem_tail_kernel", "copy"))
    print(f"chip_smoke: all phases done in {time.perf_counter() - smoke.t0:.1f} s")
    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} check(s) failed: {smoke.failures}", file=sys.stderr)
        return 1
    # each kernel's launches on its path's counted call: the default pipeline's
    # at 512x512; kernel B's on the int8-FPN pipeline's (none on the default
    # path); K9's on the COCO canvas (at 512x512 no level exceeds 64x64); K11,
    # K10, K17 and K13 on their backends' calls (phase 5h)
    paths = res["path_launches"]
    launches = dict(res["default_launches"], groupnorm_act=res["fpn_launches"]["groupnorm_act"],
                    qhishead_level2=res["coco_launches"]["qhishead_level2"],
                    qconv3x3=paths["per-conv"]["qconv3x3"], qmaxpool3x3s2=paths["direct stem"]["qmaxpool3x3s2"],
                    stem_bn_pool_quant=paths["stem tail"]["stem_bn_pool_quant"], qchain=paths["chained"]["qchain"],
                    matmul_bn_act=res["fused_bb_launches"]["matmul_bn_act"],
                    hishead_level_fused=res["fused_head_launches"]["hishead_level_fused"],
                    qmm_variant=res["k4p_launches"]["qmm_variant"],
                    qmnblock=res["mn_ladder_launches"]["qmnblock"])
    bk, bk_err = res["backend_ms"], res["backend_err"]
    fpn_ms, fpn_bound, fpn_err = res["fpn_ms"], res["fpn_bound"], res["fpn_err"]
    k7, k9, qhead_err = res["k7"], res["k9"], res["qhead_err"]
    pkg, tpu = "pytorch_object_detection_tpu_torch/csrc/", "pytorch_object_detection_tpu/ops/"

    def entry(name, source, replaces, counter, err, ms, plain_ms, bnd, library_ms=None):
        replaces = replaces if replaces.startswith("scripts/") else tpu + replaces
        return {"name": name, "route": "cuda", "source": pkg + source, "replaces": replaces,
                "launches": launches[counter], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}

    # ms: all launches of one B=8 forward (kernel C: 13 K2 blocks, 3 K3 blocks;
    # K7: five levels); K9: one B=8 call at the COCO P3 shape
    kernels = [
        entry("groupnorm_act", "gn.cu", "pallas_gn.py:66", "groupnorm_act", res["gn_err"], res["gn_ms"],
              res["gn_plain_ms"], res["gn_bound"], res["gn_lib_ms"]),
        entry("nms_keep_mask", "nms.cu", "pallas_nms.py:66", "cuda_nms_keep_mask", res["nms_err"], res["nms_ms"],
              res["nms_plain_ms"], res["nms_bound"]),
        entry("qbottleneck", "qblock.cu", "pallas_qblock.py:393", "qbottleneck", res["qblock_err"],
              res["qblock_ms"][1], res["qblock_plain_ms"][1], res["qblock_bound"][1]),
        entry("qbottleneck_s2", "qblock.cu", "pallas_qblock.py:275", "qbottleneck_s2", res["qblock_err"],
              res["qblock_ms"][2], res["qblock_plain_ms"][2], res["qblock_bound"][2]),
        entry("qstem_conv", "qstem.cu", "pallas_qstem.py:322", "qstem_conv", fpn_err["qstem"], *fpn_ms["qstem"][:2],
              fpn_bound["qstem"]),
        entry("qmatmul", "qconv.cu", "pallas_qconv.py:64", "qmatmul", max(fpn_err["qmatmul"], bk_err["qconv1x1"]),
              *fpn_ms["qmatmul"][:2],
              fpn_bound["qmatmul"], fpn_ms["qmatmul"][2]),
        entry("qhisblock", "qhis.cu", "pallas_qhis.py:196", "qhisblock", fpn_err["qhisblock"],
              *fpn_ms["qhisblock"][:2], fpn_bound["qhisblock"]),
        entry("qmaxpool2x2", "qpool.cu", "pallas_pool.py:113", "qmaxpool2x2", fpn_err["qmaxpool2x2"],
              *fpn_ms["qmaxpool2x2"][:2], fpn_bound["qmaxpool2x2"], fpn_ms["qmaxpool2x2"][2]),
        entry("qmaxpool2x2_seeds", "qpool.cu", "pallas_pool.py:113", "qmaxpool2x2_seeds",
              fpn_err["qmaxpool2x2_seeds"], *fpn_ms["qmaxpool2x2_seeds"][:2], fpn_bound["qmaxpool2x2_seeds"],
              fpn_ms["qmaxpool2x2_seeds"][2]),
        entry("qhishead_level", "qhead.cu", "pallas_qhead.py:259", "qhishead_level",
              qhead_err["qhishead_level"][0], k7["ms"], k7["plain_ms"], k7["bound"]),
        entry("qhishead_level2", "qhead.cu", "pallas_qhead.py:646", "qhishead_level2",
              qhead_err["qhishead_level2"][0], k9["ms"], k9["plain_ms"], k9["bound"]),
    ] + [entry(key, source, replaces, key, bk_err[key], bk[key][0], bk[key][1], bk[key][3])
         for key, source, replaces in (("qconv3x3", "qconv3.cu", "pallas_qconv.py:149"),
                                       ("qmaxpool3x3s2", "qpool.cu", "pallas_pool.py:68"),
                                       ("stem_bn_pool_quant", "stem.cu", "pallas_stem.py:70"),
                                       ("qchain", "qchain.cu", "pallas_qchain.py:289"))]
    # K16: the 32 launches of one B=8 fused backbone forward; K15: the five
    # levels of one B=8 fused-head forward; K4': the harness's three launches
    # (library: one torch._int_mm of its GEMM per launch); K12: the 15 calls
    # of one B=8 MNFCOS int8-ladder forward
    k16, k15, k4p, k12 = res["k16"], res["k15"], res["k4p"], res["k12"]
    k4p_bound = (sum(t[3][0] for t in k4p.values()), "bytes")
    kernels += [
        entry("matmul_bn_act", "fused.cu", "pallas_fused.py:47", "matmul_bn_act", res["k16_err"], k16["ms"],
              k16["plain_ms"], k16["bound"], k16["library_ms"]),
        entry("hishead_level_fused", "head.cu", "pallas_head.py:243", "hishead_level_fused", res["k15_err"][0],
              k15["ms"], k15["plain_ms"], k15["bound"]),
        entry("qmm_variants", "qmm_variants.cu", "scripts/dev_qmm_variants.py:47", "qmm_variant", res["k4p_err"],
              sum(t[0] for t in k4p.values()), sum(t[1] for t in k4p.values()), k4p_bound,
              len(k4p) * res["k4p_lib_ms"]),
        entry("qmnblock", "qmnblock.cu", "pallas_qmnblock.py:130", "qmnblock", res["k12_err"], k12["ms"],
              k12["plain_ms"], k12["bound"]),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
