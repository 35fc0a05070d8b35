"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive, time.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints its results on its own lines):
  1. device: nvidia-smi name and power limit; exit 1 without a CUDA device;
  2. build: kernels A (csrc/nms.cu), B (csrc/gn.cu) and C (csrc/qblock.cu)
     from the sources, one nvcc per source, all started together;
  3. kernel B vs its plain version at the head's shapes (B=8, C=512/256,
     H=W=64..4, relu/silu/none), bf16 and f32;
  4. kernel A vs its plain version: random [8,1000] boxes, the adversarial
     case of tests/test_pallas_nms.py, and (after phase 5) the pipeline's own
     decoded boxes; exact equality;
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
  6. timing with CUDA events: kernel vs plain for A, B and C (per block
     shape), float and int8 pipeline images/s at B=8 and B=64;
  6b/6c. torch.profiler breakdowns of one B=64 float and int8 pipeline call.

Any failed check makes the script exit 1.  On success the last two lines
are the kernels JSON line and ``{"ok": true, "device": {...}}``, preceded by
the nvidia-smi line.  Imports no JAX.
"""
from __future__ import annotations

import json
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


class Smoke:
    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str) -> None:
        print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    # the port itself: fails here when the script stands without the repo
    from pytorch_object_detection_tpu_torch import _build
    from pytorch_object_detection_tpu_torch.eval.evaluator import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        make_eval_pipeline,
        make_eval_pipeline_int8,
    )
    from pytorch_object_detection_tpu_torch.models.fcos import default_strides
    from pytorch_object_detection_tpu_torch.models.registry import build_model
    from pytorch_object_detection_tpu_torch.nn import resnet_int8
    from pytorch_object_detection_tpu_torch.ops import cuda_nms, gn, qblock
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
        libs = (gn._lib, cuda_nms._lib, qblock._lib)
        with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, all at once
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
        worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
        for dtype in (torch.bfloat16, torch.float32):
            for c, h in HEAD_SHAPES:
                x = torch.randn(8, c, h, h, generator=g, device=dev) * 2.0 + torch.randn(
                    1, c, 1, 1, generator=g, device=dev)
                x = x.to(dtype)
                scale = torch.rand(c, generator=g, device=dev) + 0.5
                bias = torch.randn(c, generator=g, device=dev) * 0.3
                for act in GN_ACTS:
                    with torch.inference_mode():
                        got = gn.groupnorm_act(x, scale, bias, act=act)
                        want = gn.groupnorm_act(x, scale, bias, act=act, plain=True)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    worst[dtype] = max(worst[dtype], err)
                    if dtype == torch.float32:
                        ok = err <= GN_TOL_F32
                    else:
                        ok = bool(torch.isclose(got.float(), want.float(), **GN_TOL_BF16).all())
                    if not ok or act == "relu":
                        smoke.check(ok and got.dtype == dtype,
                                    f"GN {str(dtype)[6:]} C={c} {h}x{h} {act}: max abs err {err:.3g}")
        print(f"  GN max abs err: bf16 {worst[torch.bfloat16]:.6g} (tol rtol 2^-7 + atol 1e-3), "
              f"f32 {worst[torch.float32]:.6g} (tol {GN_TOL_F32})")
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

    def phase6():
        pipe, plain_pipe, frames = res["pipe"], res["plain_pipe"], res["frames"]
        print(f"  card {card}; ms per call, back-to-back calls between CUDA events, median of 5")
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        gn_k = gn_p = 0.0
        for c, h in HEAD_SHAPES:
            x = torch.randn(8, c, h, h, generator=g, device=dev).to(torch.bfloat16)
            scale, bias = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            with torch.inference_mode():
                tk = cuda_ms(lambda: gn.groupnorm_act(x, scale, bias, act="relu"))
                tp = cuda_ms(lambda: gn.groupnorm_act(x, scale, bias, act="relu", plain=True))
            gn_k += 2 * tk  # two GNs of this width per level
            gn_p += 2 * tp
            print(f"  GN bf16 B=8 C={c} {h}x{h}: kernel {tk:.4f} ms, plain {tp:.4f} ms")
        print(f"  GN per forward (20 launches, B=8): kernel {gn_k:.4f} ms, plain {gn_p:.4f} ms {card}")
        res["gn_ms"], res["gn_plain_ms"] = gn_k, gn_p

        boxes, classes, valid = res["nms_boxes"]
        scores = torch.linspace(1.0, 0.0, boxes.shape[1], device=dev).expand(boxes.shape[0], -1)
        for b in (8, 64):
            rep = b // boxes.shape[0]
            bx, cl, va = boxes.repeat(rep, 1, 1), classes.repeat(rep, 1), valid.repeat(rep, 1)
            sc = scores.repeat(rep, 1)
            tk = cuda_ms(lambda: cuda_nms.cuda_batched_class_nms(bx, sc, cl, va, 0.6))
            tp = cuda_ms(lambda: batched_class_nms(bx, sc, cl, va, 0.6), iters=5)
            print(f"  NMS B={b} K=1000 (pipeline boxes): kernel {tk:.4f} ms, plain {tp:.4f} ms {card}")
            if b == 8:
                res["nms_ms"], res["nms_plain_ms"] = tk, tp

        qk = {1: 0.0, 2: 0.0}
        qp = {1: 0.0, 2: 0.0}
        with torch.inference_mode():
            for scope, stride, blk, x in res.get("qblock_cases", []):
                tk = cuda_ms(lambda: resnet_int8.bottleneck_int8(blk, x, stride, "pallas_block"))
                tp = cuda_ms(lambda: resnet_int8.bottleneck_int8(blk, x, stride, "pallas_block", plain=True))
                qk[stride] += tk
                qp[stride] += tp
                print(f"  kernel C {scope} s{stride} B=8 {tuple(x.shape)}: kernel {tk:.4f} ms, plain {tp:.4f} ms")
        print(f"  kernel C per forward (B=8): K2 13 blocks kernel {qk[1]:.4f} ms, plain {qp[1]:.4f} ms; "
              f"K3 3 blocks kernel {qk[2]:.4f} ms, plain {qp[2]:.4f} ms {card}")
        res["qblock_ms"], res["qblock_plain_ms"] = qk, qp

        pipes = [("float kernels", pipe), ("float plain", plain_pipe)]
        if "ipipe" in res:
            pipes += [("int8 kernels", res["ipipe"]), ("int8 plain", res["iplain"])]
        for b, iters in ((8, 10), (64, 3)):
            fr = frames.repeat(b // frames.shape[0], 1, 1, 1)
            for name, p in pipes:
                ms = cuda_ms(lambda: p(fr), iters=iters, reps=3)
                print(f"  pipeline B={b} bf16 512x512 ({name}): {ms:.3f} ms/batch, "
                      f"{b * 1000.0 / ms:.1f} img/s {card}")
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def phase6_profile(pipe, ours=("gn_act_kernel", "nms_")):
        """Where the time goes in one B=64 pipeline call (torch.profiler)."""
        from torch.profiler import ProfilerActivity, profile

        fr = res["frames"].repeat(8, 1, 1, 1)
        for _ in range(2):
            pipe(fr)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                pipe(fr)
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
        mine = [e for e in ranked[15:] if any(k in e.key for k in ours)]
        for e in ranked[:15] + mine:
            print(f"    {getattr(e, attr) / 1000.0:9.3f} ms  {e.count:5d}x  {e.key[:90]}")

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
        smoke.phase("phase 6: timing", phase6)
        smoke.phase("phase 6b: profile, float pipeline (not a pass/fail check)", phase6_profile, res["pipe"])
    if "ipipe" in res:
        smoke.phase("phase 6c: profile, int8 pipeline (not a pass/fail check)", phase6_profile, res["ipipe"],
                    ("qblock_kernel", "gn_act_kernel", "nms_"))
    smoke.failures = [f for f in smoke.failures if not f.startswith(("phase 6b", "phase 6c"))]
    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} check(s) failed: {smoke.failures}", file=sys.stderr)
        return 1
    kernels = [
        {"name": "groupnorm_act", "route": "cuda",
         "source": "pytorch_object_detection_tpu_torch/csrc/gn.cu",
         "replaces": "pytorch_object_detection_tpu/ops/pallas_gn.py:66",
         "launches": res["launches"]["gn"], "max_abs_err": res["gn_err"],
         "ms": res["gn_ms"], "plain_ms": res["gn_plain_ms"]},
        {"name": "nms_keep_mask", "route": "cuda",
         "source": "pytorch_object_detection_tpu_torch/csrc/nms.cu",
         "replaces": "pytorch_object_detection_tpu/ops/pallas_nms.py:66",
         "launches": res["launches"]["nms"], "max_abs_err": res["nms_err"],
         "ms": res["nms_ms"], "plain_ms": res["nms_plain_ms"]},
        # kernel C serves both; ms: all blocks of one forward at B=8
        {"name": "qbottleneck", "route": "cuda",
         "source": "pytorch_object_detection_tpu_torch/csrc/qblock.cu",
         "replaces": "pytorch_object_detection_tpu/ops/pallas_qblock.py:393",
         "launches": res["int8_launches"]["qbottleneck"], "max_abs_err": res["qblock_err"],
         "ms": res["qblock_ms"][1], "plain_ms": res["qblock_plain_ms"][1]},
        {"name": "qbottleneck_s2", "route": "cuda",
         "source": "pytorch_object_detection_tpu_torch/csrc/qblock.cu",
         "replaces": "pytorch_object_detection_tpu/ops/pallas_qblock.py:275",
         "launches": res["int8_launches"]["qbottleneck_s2"], "max_abs_err": res["qblock_err"],
         "ms": res["qblock_ms"][2], "plain_ms": res["qblock_plain_ms"][2]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
