"""Config-driven training of the port on the card (the port's ``cli/train.py``).

    podt-torch-train --config config/main.yaml [--steps N] [--synthetic] [--ring-loader]
    python -m pytorch_object_detection_tpu_torch.cli.train --config ... --device cpu

Builds the config's model (HISFCOS or MNFCOS; random weights from seed 0,
``--pretrained-backbone`` grafts a torchvision ResNet-50 ``.pth``), the
train state (the config's optimizer block and optional ``schedule``
block, every BatchNorm frozen, HISFCOS with stage 1 frozen as in the JAX
CLI) and ``train/trainer.make_train_step`` (bf16 autocast where the config
says ``amp`` and the device is the card, f32 otherwise), then trains over
one of three inputs:

  * the dataset: ``DetectionLoader`` over the config's train split with
    ``HostAugment`` (rotation, crop), then the device preprocess (flip,
    colour jitter, normalize);
  * ``--synthetic``: the JAX CLI's numpy generator (``default_rng(0)``),
    byte for byte;
  * ``--ring-loader`` (VOC): ``RingTileLoader``'s raw tiles, the device
    resize, then the device preprocess (no host augment).

Checkpoints (``train/checkpoints.py``) go to ``--checkpoint-dir/<savename>``
every ``--ckpt-every`` epochs and at the end; ``--resume`` continues from
one at its step.  SIGTERM or SIGINT saves a checkpoint after the current
step and exits 0.  A non-finite loss, fetched one step behind so the card
keeps working, stops the run with exit code 1 and no checkpoint of the
diverged weights.  ``--eval-every N`` runs ``evaluate_voc`` (mAP) or
``evaluate_coco`` (AP) on the test split every N epochs and keeps the best
under ``<savename>_best``.  ``--log-every`` prints the losses and img/s
and writes them to TensorBoard under ``runs/<savename>``.

The JAX CLI's flags less ``--model-parallel``, ``--layout``,
``--coordinator``, ``--num-processes``, ``--process-id`` (ROADMAP.md queue 1
item 11) and ``--swa*`` (item 12), plus ``--device``.  Without a card it
exits 1 unless ``--device cpu``; RETINANET and SSD300 exit 2 (item 10).
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time


def build_dataset(cfg, train: bool = True, cache_decoded: bool = False, raw_tiles: bool = False):
    """The config's train split with ``HostAugment`` (``train``), or its test split."""
    from pytorch_object_detection_tpu_torch.core.config import canvas_hw
    from pytorch_object_detection_tpu_torch.data.augment import HostAugment

    canvas = canvas_hw(cfg)
    ds_cfg = cfg["dataset_setting"]
    augment = HostAugment() if train and not raw_tiles else None
    if cfg["model"]["dataset"] == "VOC":
        from pytorch_object_detection_tpu_torch.data.voc import VOCDataset

        if train:
            roots = [p for p in (ds_cfg.get("train_07"), ds_cfg.get("train_12")) if p]
            return VOCDataset(roots, ds_cfg.get("type", "trainval"), canvas, augment=augment,
                              cache_decoded=cache_decoded, raw_tiles=raw_tiles)
        return VOCDataset([ds_cfg.get("test_07", ds_cfg.get("train_07"))], "test", canvas)
    from pytorch_object_detection_tpu_torch.data.coco import COCODataset

    if train:
        return COCODataset(ds_cfg["TrainData"], ds_cfg["TrainAnnotation"], canvas, augment=augment)
    return COCODataset(ds_cfg["ValData"], ds_cfg["ValAnnotation"], canvas, filter_empty=False)


def synthetic_batches(batch_size: int, canvas, n_classes: int):
    """The JAX CLI's ``--synthetic`` batches: one fixed random uint8 image
    batch, and 1-7 random boxes an image each step, from ``default_rng(0)``."""
    import numpy as np

    rng_np = np.random.default_rng(0)
    imgs = rng_np.integers(0, 255, (batch_size, *canvas, 3), np.uint8)
    while True:
        n = rng_np.integers(1, 8)
        boxes = np.full((batch_size, 32, 4), -1.0, np.float32)
        labels = np.full((batch_size, 32), -1, np.int32)
        cxy = rng_np.uniform(0.1, 0.9, (batch_size, n, 2)) * np.array(canvas[::-1])
        wh = rng_np.uniform(0.05, 0.4, (batch_size, n, 2)) * np.array(canvas[::-1])
        boxes[:, :n, :2] = np.maximum(cxy - wh / 2, 0)
        boxes[:, :n, 2:] = np.minimum(cxy + wh / 2, np.array(canvas[::-1]) - 1)
        labels[:, :n] = rng_np.integers(1, n_classes + 1, (batch_size, n))
        yield (imgs, boxes, labels, np.ones(batch_size, np.float32), np.full(batch_size, canvas[1], np.int32),
               [str(i) for i in range(batch_size)])


def run_eval(cfg, model, compute_dtype) -> float:
    """Evaluation on the config's test split: VOC mAP or COCO AP."""
    from pytorch_object_detection_tpu_torch.core import config as C
    from pytorch_object_detection_tpu_torch.eval.evaluator import evaluate_coco, evaluate_voc, make_eval_pipeline

    dataset = build_dataset(cfg, train=False)
    strides = C.strides(cfg)
    pipeline = make_eval_pipeline(model, strides, dataset.canvas_hw, compute_dtype=compute_dtype)
    if cfg["model"]["dataset"] == "VOC":
        return float(evaluate_voc(model, dataset, strides=strides, num_classes=C.num_classes(cfg), verbose=False,
                                  pipeline=pipeline)["mAP"])
    return float(evaluate_coco(model, dataset, strides=strides, verbose=False, pipeline=pipeline)["AP"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the PyTorch port's FCOS detectors")
    ap.add_argument("--config", default="config/main.yaml")
    ap.add_argument("--steps", type=int, default=0, help="stop after N steps (0 = full epochs)")
    ap.add_argument("--synthetic", action="store_true", help="train on synthetic data (no dataset needed)")
    ap.add_argument("--checkpoint-dir", default="./checkpoint")
    ap.add_argument("--resume", default="", help="checkpoint dir/path to resume from")
    ap.add_argument("--pretrained-backbone", default="", help="torchvision resnet50 .pth to graft")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="run VOC/COCO eval every N epochs (0 = off); tracks best mAP")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="save the rolling checkpoint every N epochs (signal checkpoints are always written)")
    ap.add_argument("--cache-decoded", action="store_true",
                    help="cache decoded images in memory across epochs (small datasets; augmentation still "
                         "randomizes per epoch)")
    ap.add_argument("--ring-loader", action="store_true",
                    help="batched native host loader (data/pipeline.RingTileLoader): raw tiles, the resize on the "
                         "device; the host rotate/crop augment is replaced by the device flip and jitter (VOC only)")
    ap.add_argument("--nan-check-every", type=int, default=1,
                    help="fetch the previous step's loss every N steps (each fetch waits for that step)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains: the card (bf16 autocast where the config says amp) or the CPU "
                         "(f32)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from pytorch_object_detection_tpu_torch.core import config as C
    from pytorch_object_detection_tpu_torch.data.pipeline import DetectionLoader, make_device_preprocess
    from pytorch_object_detection_tpu_torch.models.registry import build_model
    from pytorch_object_detection_tpu_torch.train import checkpoints as ckpt
    from pytorch_object_detection_tpu_torch.train.trainer import create_train_state, make_train_step
    from pytorch_object_detection_tpu_torch.utils.metrics import MetricWriter

    if args.device == "cuda" and not torch.cuda.is_available():
        print("train: no CUDA device (torch.cuda.is_available() is false); --device cpu trains on the CPU",
              file=sys.stderr)
        return 1
    cfg = C.load_config(args.config)
    name = cfg["model"]["name"]
    if name not in ("HISFCOS", "MNFCOS"):
        print(f"train: {name} does not train in the port yet: ROADMAP.md queue 1 item 10 (the anchor train "
              f"step and the other families)", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    block = C.model_block(cfg)
    canvas = C.canvas_hw(cfg)
    n_classes = C.num_classes(cfg)
    strides, ranges, shapes = C.strides(cfg), C.limit_ranges(cfg), C.level_shapes(cfg)
    batch_size = int(block["batch_size"])
    compute_dtype = torch.bfloat16 if cfg["model"].get("amp", True) and dev.type == "cuda" else torch.float32

    # the reference trains HISFCOS with stage 1 frozen; frozen_stages both
    # freezes those parameters and puts the gradient barrier after them
    frozen_stages = 1 if name == "HISFCOS" else 0
    model = build_model(name, n_classes, int(block["channel"]), frozen_stages=frozen_stages, device=dev,
                        generator=torch.Generator().manual_seed(0))
    sched = block.get("schedule", {})
    opt_cfg = block["optimizer"]
    state = create_train_state(model, {
        "name": opt_cfg["name"],
        "lr": float(opt_cfg["lr"]),
        "momentum": float(opt_cfg.get("momentum", 0.9)),
        "weight_decay": float(opt_cfg.get("weight_decay", 1e-4)),
        "warmup_steps": int(sched.get("warmup_steps", 500)),
        "warmup_factor": float(sched.get("warmup_factor", 1.0 / 3.0)),
        "milestones": tuple(sched.get("milestones", (120000, 160000))),
        "gamma": float(sched.get("gamma", 0.1)),
    }, freeze_bn=True, frozen_stages=frozen_stages)
    if args.pretrained_backbone:
        ckpt.load_pretrained_backbone(state, args.pretrained_backbone)
    if args.resume:
        ckpt.restore_checkpoint(args.resume, state)
        print(f"resumed from {args.resume} at step {state.step}", flush=True)
    train_step = make_train_step(model, shapes, strides, ranges, block.get("criterion", "giou"), compute_dtype)
    preprocess = make_device_preprocess(train=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    writer = MetricWriter(os.path.join("runs", cfg["savename"]))
    run_dir = os.path.join(args.checkpoint_dir, cfg["savename"])

    ring_resize = None
    if args.synthetic:
        epochs, loader = 1, synthetic_batches(batch_size, canvas, n_classes)
    elif args.ring_loader:
        from pytorch_object_detection_tpu_torch.data.pipeline import RingTileLoader, make_device_resize

        if cfg["model"]["dataset"] != "VOC":
            print("train: --ring-loader reads VOC trees only", file=sys.stderr)
            return 2
        ds_cfg = cfg["dataset_setting"]
        loader = RingTileLoader(build_dataset(cfg, raw_tiles=True), batch_size,
                                max_boxes=int(ds_cfg.get("max_boxes", 64)),
                                decode_threads=int(ds_cfg.get("num_workers", 0)))
        ring_resize = make_device_resize(canvas)
        epochs = int(block["Epoch"])
    else:
        ds_cfg = cfg["dataset_setting"]
        loader = DetectionLoader(build_dataset(cfg, cache_decoded=args.cache_decoded), batch_size,
                                 max_boxes=int(ds_cfg.get("max_boxes", 64)),
                                 num_workers=int(ds_cfg.get("num_workers", 8)))
        epochs = int(block["Epoch"])

    interrupted = []

    def on_signal(signum, _frame):
        interrupted.append(signum)
        print(f"signal {signum}: checkpointing and exiting after this step", flush=True)

    previous = {sig: signal.signal(sig, on_signal) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        print(f"training {name} on {dev} ({str(compute_dtype)[6:]}) from step {state.step}", flush=True)
        step_count = state.step
        t0 = time.perf_counter()
        prev_total = None
        best_map = -1.0
        done = False
        for epoch in range(epochs):
            for batch in (loader if args.synthetic else iter(loader)):
                images_u8, boxes, labels, _scales, content_w = batch[:5]
                images_u8 = torch.from_numpy(images_u8).to(dev)
                if ring_resize is not None:
                    src_hw = torch.from_numpy(np.stack([batch.content_h, batch.content_w], 1).astype(np.int32))
                    images_u8, _s, content_hw = ring_resize(images_u8, src_hw)
                    content_w = content_hw[:, 1]
                else:
                    content_w = torch.from_numpy(content_w)
                imgs, bxs = preprocess(gen, images_u8, torch.from_numpy(boxes), content_w)
                metrics = train_step(state, imgs, bxs, torch.from_numpy(labels).to(dev))
                step_count += 1
                # the previous step's loss, fetched while this one runs
                if (prev_total is not None and step_count % args.nan_check_every == 0
                        and not np.isfinite(float(prev_total))):
                    print(f"NON-FINITE loss at step {step_count - 1}: stopping without a checkpoint", flush=True)
                    return 1
                prev_total = metrics["total"]
                if step_count % args.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    if not np.isfinite(m["total"]):
                        print(f"NON-FINITE loss at step {step_count}: {m}: stopping without a checkpoint",
                              flush=True)
                        return 1
                    rate = args.log_every * batch_size / (time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    writer.write(step_count, {**m, "images_per_sec": rate})
                    print(f"step {step_count} epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                          + f" ({rate:.1f} img/s)", flush=True)
                if interrupted or (args.steps and step_count >= args.steps):
                    done = True
                    break
            if interrupted:
                break
            if not args.synthetic and ((epoch + 1) % args.ckpt_every == 0 or done or epoch + 1 == epochs):
                ckpt.save_checkpoint(run_dir, state)
            if args.eval_every and not args.synthetic and (epoch + 1) % args.eval_every == 0:
                score = run_eval(cfg, model, compute_dtype)
                writer.write(step_count, {"mAP": score})
                if score > best_map:
                    best_map = score
                    ckpt.save_checkpoint(run_dir + "_best", state, keep=1)
                    print(f"new best mAP {score:.4f} at epoch {epoch}", flush=True)
            if done:
                break
        if prev_total is not None and not np.isfinite(float(prev_total)):
            print(f"NON-FINITE loss at step {step_count}: stopping without a checkpoint", flush=True)
            return 1
        path = ckpt.save_checkpoint(run_dir, state)
        print(f"checkpoint {path}", flush=True)
        print("training done: step", step_count, flush=True)
        return 0
    finally:
        writer.close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)


if __name__ == "__main__":
    sys.exit(main())
