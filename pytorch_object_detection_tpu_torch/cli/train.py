"""Config-driven training of the port on the card (the port's ``cli/train.py``).

    podt-torch-train --config config/main.yaml [--steps N] [--synthetic] [--ring-loader]
    python -m pytorch_object_detection_tpu_torch.cli.train --config ... --device cpu

Builds the config's model (FCOS, HISFCOS, MNFCOS or MC_FCOS, its strides and
ranges from the config's block: MC_FCOS has four; or RETINANET or SSD300;
random weights from seed 0, ``--pretrained-backbone`` grafts a torchvision
ResNet-50 ``.pth``), the train state (the config's optimizer block and
optional ``schedule`` block, every BatchNorm frozen, HISFCOS with stage 1
frozen as in the JAX CLI, the others with none) and the train step (bf16
autocast where the config says ``amp`` and the device is the card, f32
otherwise): ``train/trainer.make_train_step`` for the FCOS families,
``make_anchor_train_step`` for the anchor families, as the JAX CLI picks it
(RETINANET: the anchors of its five levels on the canvas, 0.5/0.4 from the
block's ``pos_iou``/``neg_iou``, the focal loss; SSD300: the default boxes
at 300x300, 0.5/0.5, the MultiBox loss), then trains over one of three
inputs:

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
``evaluate_coco`` (AP) on the test split every N epochs, prints each score
and keeps the best under ``<savename>_best``.  ``--log-every`` prints the
losses, img/s and (on the card) the peak memory allocated, and writes the
losses and img/s to TensorBoard under ``runs/<savename>``.

Data parallelism (the reference's DDP launch, its ``train.py:43-58``):
one process a device, joined by ``--coordinator host:port --num-processes N
--process-id I`` (the JAX CLI's flags) or by a launcher that sets ``RANK``
and ``WORLD_SIZE`` (``torchrun --nproc-per-node N -m
pytorch_object_detection_tpu_torch.cli.train ...``); NCCL where each rank
has a card of its own, gloo on the CPU or where ranks share a card
(``parallel/mesh.initialize_distributed`` prints the choice).  With more
than one rank: the ``(data, model)`` mesh, rank 0's state replicated (after
``--resume``, which every rank loads), the batch size per rank, each rank
its shard of the dataset (``--synthetic``: the same generated batches on
every rank, as in JAX), the gradients and losses averaged over the ranks
in each step (so every rank prints the same losses and a non-finite loss
stops them all), evaluation served by all ranks together; rank 0 alone
writes TensorBoard and the checkpoints while the others wait at a barrier.

Tensor parallelism and spatial partitioning (``--model-parallel N
--layout tp|sp``): the mesh's model dimension of N ranks carries the
channel shards of the state (``parallel/tp.py``) or the row bands of each
image (``parallel/sp.py``), and the data dimension the rest.  Unlike the
JAX CLI, whose layouts are one process over many devices, the port runs
one process a device, so a layout takes a ``--coordinator`` or
``torchrun`` launch of ``data_parallel x N`` processes (it exits 2 with
fewer, or a count N does not divide).  The N ranks of a model group
(consecutive ranks) read the same shard of the dataset and the batch size
is per data shard; rank 0's state is replicated over the whole mesh, then
sharded for tp; a tp checkpoint is gathered, and world rank 0 writes the
whole state, which resumes in one process or under either layout.

Stochastic weight averaging (``--swa``, ``--swa-start-step``,
``--swa-every``, ``--swa-decay``, ``--swa-lr``, as in the JAX CLI;
``train/swa.py``): a running average of the weights from
``--swa-start-step``, taken every ``--swa-every`` steps or at each epoch's
end, the learning rate then ``--swa-lr`` where given; at the end it
prints ``swa: averaged N snapshots`` and saves the average under
``<savename>_swa`` (under tp kept on the shards and gathered there).

The JAX CLI's flags, plus ``--device``.  Without a card it exits 1 unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
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


def run_eval(cfg, model, compute_dtype, mesh=None) -> float:
    """Evaluation on the config's test split: VOC mAP or COCO AP (the anchor
    families through their anchor pipeline, as the JAX dispatch does); with
    ``mesh`` served by its ranks together, each getting the whole score."""
    from pytorch_object_detection_tpu_torch.core import config as C
    from pytorch_object_detection_tpu_torch.eval.evaluator import evaluate_coco, evaluate_voc, make_default_pipeline

    dataset = build_dataset(cfg, train=False)
    strides = C.strides(cfg) if "stride" in C.model_block(cfg) else (8, 16, 32, 64, 128)
    pipeline = make_default_pipeline(model, strides, dataset.canvas_hw, compute_dtype=compute_dtype)
    if cfg["model"]["dataset"] == "VOC":
        return float(evaluate_voc(model, dataset, strides=strides, num_classes=C.num_classes(cfg), verbose=False,
                                  mesh=mesh, pipeline=pipeline)["mAP"])
    return float(evaluate_coco(model, dataset, strides=strides, verbose=False, mesh=mesh, pipeline=pipeline)["AP"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the PyTorch port's detectors")
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
    ap.add_argument("--coordinator", default="",
                    help="multi-process launch: the coordinator's host:port (rank 0's; any free port). Start one "
                         "process a device with the same --coordinator and --num-processes and its own "
                         "--process-id; torchrun's environment needs none of these")
    ap.add_argument("--num-processes", type=int, default=0, help="the number of processes of a --coordinator launch")
    ap.add_argument("--process-id", type=int, default=-1, help="this process's rank in a --coordinator launch")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="size of the mesh's 'model' axis (devices per model-parallel group); data axis gets the "
                         "rest")
    ap.add_argument("--layout", default="tp", choices=("tp", "sp"),
                    help="what the 'model' axis carries when --model-parallel > 1: tp = tensor parallelism "
                         "(parallel/tp.py, params+optimizer channel-sharded), sp = spatial partitioning "
                         "(parallel/sp.py, image rows sharded; params replicated)")
    ap.add_argument("--swa", action="store_true",
                    help="stochastic weight averaging: keep a running average of params (train/swa.py) and save it "
                         "as <savename>_swa at the end (the reference's dead swa_enabled flag, made real)")
    ap.add_argument("--swa-start-step", type=int, default=0,
                    help="step to start averaging (and to drop to --swa-lr)")
    ap.add_argument("--swa-every", type=int, default=0,
                    help="also average every N steps (0 = at epoch ends only)")
    ap.add_argument("--swa-decay", type=float, default=0.0,
                    help="EMA decay in (0,1); 0 = uniform average (torch AveragedModel default)")
    ap.add_argument("--swa-lr", type=float, default=0.0,
                    help="SWALR constant learning rate after --swa-start-step (0 = keep the base schedule)")
    args = ap.parse_args(argv)

    import torch

    from pytorch_object_detection_tpu_torch.parallel import mesh as pmesh

    if args.device == "cuda" and not torch.cuda.is_available():
        print("train: no CUDA device (torch.cuda.is_available() is false); --device cpu trains on the CPU",
              file=sys.stderr)
        return 1
    if args.coordinator:
        pmesh.initialize_distributed(args.coordinator, args.num_processes or None,
                                     args.process_id if args.process_id >= 0 else None, device=args.device)
    else:
        pmesh.initialize_distributed(device=args.device)
    try:
        return _train(args)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args) -> int:
    """The run of :func:`main` once this process is in its group."""
    import numpy as np
    import torch

    from pytorch_object_detection_tpu_torch.core import config as C
    from pytorch_object_detection_tpu_torch.data.pipeline import DetectionLoader, make_device_preprocess
    from pytorch_object_detection_tpu_torch.models.registry import build_model
    from pytorch_object_detection_tpu_torch.parallel import mesh as pmesh
    from pytorch_object_detection_tpu_torch.parallel.collectives import model_axis
    from pytorch_object_detection_tpu_torch.train import checkpoints as ckpt
    from pytorch_object_detection_tpu_torch.train.trainer import (
        create_train_state,
        make_anchor_train_step,
        make_train_step,
    )
    from pytorch_object_detection_tpu_torch.utils.metrics import MetricWriter

    dist = torch.distributed
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mp = max(1, args.model_parallel)
    if mp > 1 and (world < mp or world % mp):
        print(f"train: --model-parallel {mp} takes a launch of data_parallel x {mp} processes (--coordinator or "
              f"torchrun, one process a device); this one has {world}", file=sys.stderr)
        return 2
    cfg = C.load_config(args.config)
    name = cfg["model"]["name"]
    dev = pmesh.rank_device(args.device)
    block = C.model_block(cfg)
    canvas = C.canvas_hw(cfg)
    n_classes = C.num_classes(cfg)
    anchor_based = name in ("RETINANET", "SSD300")
    strides = C.strides(cfg) if "stride" in block else ()
    ranges = C.limit_ranges(cfg) if "range" in block else ()
    shapes = C.level_shapes(cfg) if "stride" in block else ()
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
        "swa_lr": args.swa_lr if args.swa else 0.0,
        "swa_start_step": args.swa_start_step,
    }, freeze_bn=True, frozen_stages=frozen_stages)
    if args.pretrained_backbone:
        ckpt.load_pretrained_backbone(state, args.pretrained_backbone)
    if args.resume:
        ckpt.restore_checkpoint(args.resume, state)
        print(f"resumed from {args.resume} at step {state.step}", flush=True)
    # more than one rank needs the mesh: each rank would otherwise train alone (the JAX CLI's use_mesh)
    mesh = pmesh.create_mesh(model_parallel=mp, device_type=dev.type) if world > 1 else None
    if mesh is not None:
        pmesh.replicate_state(mesh, state)
    tp_layout, sp_layout = mp > 1 and args.layout == "tp", mp > 1 and args.layout == "sp"
    if tp_layout:
        from pytorch_object_detection_tpu_torch.parallel.tp import shard_state_tp

        shard_state_tp(mesh, state)
    shard = dict(process_count=world // mp, process_index=rank // mp) if mp > 1 else {}
    if name == "SSD300":
        from pytorch_object_detection_tpu_torch.models.ssd import default_boxes

        train_step = make_anchor_train_step(model, default_boxes(canvas[0], dev), n_classes, compute_dtype,
                                            pos_iou=float(block.get("pos_iou", 0.5)),
                                            neg_iou=float(block.get("neg_iou", 0.5)), loss="multibox", mesh=mesh)
    elif anchor_based:
        from pytorch_object_detection_tpu_torch.ops.anchors import generate_anchors

        train_step = make_anchor_train_step(model, generate_anchors(model.level_shapes(canvas), strides, device=dev),
                                            n_classes, compute_dtype, pos_iou=float(block.get("pos_iou", 0.5)),
                                            neg_iou=float(block.get("neg_iou", 0.4)), loss="focal", mesh=mesh)
    else:
        train_step = make_train_step(model, shapes, strides, ranges, block.get("criterion", "giou"), compute_dtype,
                                     mesh=mesh)
    preprocess = make_device_preprocess(train=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    writer = MetricWriter(os.path.join("runs", cfg["savename"])) if rank == 0 else None
    run_dir = os.path.join(args.checkpoint_dir, cfg["savename"])

    def save(path, **kw):
        """Rank 0 writes the checkpoint (under tp every rank gives its
        shards to it); the other ranks wait for it."""
        out = ckpt.save_checkpoint(path, state, **kw) if rank == 0 or tp_layout else None
        if world > 1:
            dist.barrier()
        return out if rank == 0 else None

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
                                decode_threads=int(ds_cfg.get("num_workers", 0)), **shard)
        ring_resize = make_device_resize(canvas)
        epochs = int(block["Epoch"])
    else:
        ds_cfg = cfg["dataset_setting"]
        loader = DetectionLoader(build_dataset(cfg, cache_decoded=args.cache_decoded), batch_size,
                                 max_boxes=int(ds_cfg.get("max_boxes", 64)),
                                 num_workers=int(ds_cfg.get("num_workers", 8)), **shard)
        epochs = int(block["Epoch"])

    interrupted = []

    def on_signal(signum, _frame):
        interrupted.append(signum)
        print(f"signal {signum}: checkpointing and exiting after this step", flush=True)

    swa_state = swa_decay = None
    if args.swa:
        from pytorch_object_detection_tpu_torch.train.swa import averaged, swa_init, swa_params, swa_update

        swa_state = swa_init(swa_params(model))
        swa_decay = args.swa_decay if args.swa_decay > 0 else None

    previous = {sig: signal.signal(sig, on_signal) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        print(f"training {name} on {dev} ({str(compute_dtype)[6:]}) from step {state.step}"
              + (f", rank {rank} of {world}" if world > 1 else "")
              + (f", {args.layout} over {mp} ranks" if mp > 1 else ""), flush=True)
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
                lbls = torch.from_numpy(labels).to(dev)
                if sp_layout:
                    from pytorch_object_detection_tpu_torch.parallel.sp import shard_batch_spatial

                    imgs, bxs, lbls = shard_batch_spatial(mesh, imgs, bxs, lbls)
                metrics = train_step(state, imgs, bxs, lbls)
                step_count += 1
                if (args.swa and args.swa_every and step_count >= args.swa_start_step
                        and step_count % args.swa_every == 0):
                    swa_state = swa_update(swa_state, swa_params(model), swa_decay)
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
                    if writer:
                        writer.write(step_count, {**m, "images_per_sec": rate})
                    peak = (f"; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB" if dev.type == "cuda"
                            else "")
                    print(f"step {step_count} epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                          + f" ({rate:.1f} img/s{peak})", flush=True)
                if world > 1:  # a signal to one rank stops them all after the same step
                    flag = torch.tensor([float(bool(interrupted))], device=dev)
                    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                    if float(flag) and not interrupted:
                        interrupted.append("another rank's")
                if interrupted or (args.steps and step_count >= args.steps):
                    done = True
                    break
            if interrupted:
                break
            if args.swa and not args.swa_every and step_count >= args.swa_start_step:
                swa_state = swa_update(swa_state, swa_params(model), swa_decay)
            if not args.synthetic and ((epoch + 1) % args.ckpt_every == 0 or done or epoch + 1 == epochs):
                save(run_dir)
            if args.eval_every and not args.synthetic and (epoch + 1) % args.eval_every == 0:
                # under a layout every rank serves the whole split (tp: in its model group, for the shards)
                with model_axis(pmesh.model_group(mesh)) if tp_layout else contextlib.nullcontext():
                    score = run_eval(cfg, model, compute_dtype, None if mp > 1 else mesh)
                if writer:
                    writer.write(step_count, {"mAP": score})
                print(f"eval {'mAP' if cfg['model']['dataset'] == 'VOC' else 'AP'} {score:.4f} at epoch {epoch}, "
                      f"step {step_count}", flush=True)
                if score > best_map:
                    best_map = score
                    save(run_dir + "_best", keep=1)
                    print(f"new best mAP {score:.4f} at epoch {epoch}", flush=True)
            if done:
                break
        if prev_total is not None and not np.isfinite(float(prev_total)):
            print(f"NON-FINITE loss at step {step_count}: stopping without a checkpoint", flush=True)
            return 1
        path = save(run_dir)
        if path:
            print(f"checkpoint {path}", flush=True)
        if args.swa and swa_state.count > 0:
            # the average as a run of its own (the frozen BatchNorms' statistics never moved: no re-estimation)
            with averaged(model, swa_state):
                save(run_dir + "_swa", keep=1)
            print(f"swa: averaged {swa_state.count} snapshots", flush=True)
        print("training done: step", step_count, flush=True)
        return 0
    finally:
        if writer:
            writer.close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)


if __name__ == "__main__":
    sys.exit(main())
