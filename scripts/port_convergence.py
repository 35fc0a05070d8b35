#!/usr/bin/env python
"""The convergence recipes of the PyTorch port on the card, through its CLIs.

    python3 scripts/port_convergence.py [--only coco,voc] [--out runs/convergence]

Run from the repository root on a machine with a CUDA card.  It reads the
repository's configs as they are and writes the corpora under ``runs/``
(git-ignored) with the port's own generator
(``pytorch_object_detection_tpu_torch.data.synthetic_corpus``):

  * ``coco``: ``write_synthetic_coco(runs/synth_coco_data, 240, 48, 0)``;
    then the loader's img/s alone (``DetectionLoader`` with ``HostAugment``
    over the train split, the config's workers) and the train step's ms
    alone (HISFCOS(80, 256) at 896x1408, B=8, bf16, on one loader batch,
    CUDA events, and its peak memory);
    ``podt-torch-train --config config/synth_coco.yaml --steps 1200
    --eval-every 20 --ckpt-every 20``; then ``podt-torch-eval-coco`` of
    the final checkpoint, float, ``--int8``, ``--device-resize`` and
    ``--device-resize --int8``;
  * ``voc``: ``write_synthetic_voc(runs/synth_voc_data, 320, 64, 0)``;
    the same two timings at 512x512 (HISFCOS(20, 256));
    ``podt-torch-train --config config/synth_voc_long.yaml --steps 10000
    --eval-every 8 --ckpt-every 20``; then ``podt-torch-eval-voc`` of the
    best checkpoint, float and ``--int8``.

Each command's standard output and errors go to ``OUT/<recipe>_<step>.log``;
the script prints the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``), each
command, its exit code and seconds, and the timing lines.  Checkpoints go
to ``./checkpoint`` (git-ignored).  Exit code 1 if any command fails.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {
    "coco": {
        "config": "config/synth_coco.yaml",
        "corpus": ("coco", "runs/synth_coco_data", 240, 48),
        "train": ["--steps", "1200", "--eval-every", "20", "--ckpt-every", "20"],
        "checkpoint": "checkpoint/hisfcos_synth_coco",
        "eval": ("eval_coco", [[], ["--int8"], ["--device-resize"], ["--device-resize", "--int8"]]),
    },
    "voc": {
        "config": "config/synth_voc_long.yaml",
        "corpus": ("voc", "runs/synth_voc_data", 320, 64),
        "train": ["--steps", "10000", "--eval-every", "8", "--ckpt-every", "20"],
        "checkpoint": "checkpoint/hisfcos_synth_long_best",
        "eval": ("eval_voc", [[], ["--int8"]]),
    },
}


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not measured"
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"


def run(name: str, args, out_dir: str) -> int:
    """``python -m pytorch_object_detection_tpu_torch.<args>`` with its output in ``out_dir/name.log``."""
    cmd = [sys.executable, "-m", *args]
    print(f"$ {' '.join(cmd[2:])}", flush=True)
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, f"{name}.log"), "w") as log:
        rc = subprocess.run(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT).returncode
    print(f"  exit {rc} in {time.perf_counter() - t0:.1f} s -> {name}.log", flush=True)
    return rc


def time_loader_and_step(config: str, batches: int = 12, warmup: int = 5, window: int = 20) -> None:
    """The train split's loader alone (img/s over ``batches`` batches after
    the first), then the recipe's bf16 train step alone on one of its
    batches: ms a step (median of ``window`` CUDA-event intervals after
    ``warmup``) and the peak memory allocated."""
    import torch

    from pytorch_object_detection_tpu_torch.cli.train import build_dataset
    from pytorch_object_detection_tpu_torch.core import config as C
    from pytorch_object_detection_tpu_torch.data.pipeline import DetectionLoader, make_device_preprocess
    from pytorch_object_detection_tpu_torch.models.registry import build_model
    from pytorch_object_detection_tpu_torch.train.trainer import create_train_state, make_train_step

    cfg = C.load_config(os.path.join(REPO, config))
    block, ds_cfg = C.model_block(cfg), cfg["dataset_setting"]
    b = int(block["batch_size"])
    loader = DetectionLoader(build_dataset(cfg), b, max_boxes=int(ds_cfg.get("max_boxes", 64)),
                             num_workers=int(ds_cfg.get("num_workers", 8)))
    it = iter(loader)
    first = next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    rate = batches * b / (time.perf_counter() - t0)
    del it

    dev = torch.device("cuda")
    model = build_model(cfg["model"]["name"], C.num_classes(cfg), int(block["channel"]), frozen_stages=1, device=dev,
                        generator=torch.Generator().manual_seed(0))
    sched, opt = block.get("schedule", {}), block["optimizer"]
    state = create_train_state(model, {"name": opt["name"], "lr": float(opt["lr"]),
                                       "momentum": float(opt.get("momentum", 0.9)),
                                       "weight_decay": float(opt.get("weight_decay", 1e-4)),
                                       "warmup_steps": int(sched.get("warmup_steps", 500)),
                                       "milestones": tuple(sched.get("milestones", (120000, 160000)))},
                               freeze_bn=True, frozen_stages=1)
    step = make_train_step(model, C.level_shapes(cfg), C.strides(cfg), C.limit_ranges(cfg),
                           block.get("criterion", "giou"), torch.bfloat16)
    images, boxes = make_device_preprocess(train=True)(torch.Generator(device=dev).manual_seed(0),
                                                       torch.from_numpy(first.images).to(dev),
                                                       torch.from_numpy(first.boxes), torch.from_numpy(first.content_w))
    labels = torch.from_numpy(first.labels).to(dev)
    for _ in range(warmup):
        step(state, images, boxes, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(window + 1)]
    events[0].record()
    for i in range(window):
        step(state, images, boxes, labels)
        events[i + 1].record()
    torch.cuda.synchronize()
    ms = statistics.median(a.elapsed_time(c) for a, c in zip(events, events[1:]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"  {cfg['model']['name']}({C.num_classes(cfg)}, {block['channel']}) at {C.canvas_hw(cfg)} B={b}: loader "
          f"alone {rate:.1f} img/s ({ds_cfg.get('num_workers', 8)} workers, HostAugment); train step alone (bf16, one "
          f"batch repeated) {ms:.3f} ms median of {window}, {b * 1000.0 / ms:.1f} img/s, peak memory allocated "
          f"{peak:.2f} GiB [{nvidia_smi()}]", flush=True)
    del state, model, step
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="coco,voc", help="recipes to run, in order (coco, voc)")
    ap.add_argument("--out", default="runs/convergence", help="directory of the logs")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("port_convergence: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    os.chdir(REPO)  # the configs name their corpora relative to the repository root
    from pytorch_object_detection_tpu_torch.data.synthetic_corpus import write_synthetic_coco, write_synthetic_voc

    out_dir = os.path.join(REPO, args.out)
    os.makedirs(out_dir, exist_ok=True)
    print(nvidia_smi(), flush=True)
    failed = []
    for name in args.only.split(","):
        recipe = RECIPES[name]
        kind, root, n_train, n_val = recipe["corpus"]
        t0 = time.perf_counter()
        (write_synthetic_coco if kind == "coco" else write_synthetic_voc)(os.path.join(REPO, root), n_train, n_val, 0)
        print(f"== {name}: {n_train} train + {n_val} val images under {root} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        time_loader_and_step(recipe["config"])
        pkg = "pytorch_object_detection_tpu_torch.cli."
        if run(f"{name}_train", [pkg + "train", "--config", recipe["config"], *recipe["train"]], out_dir):
            failed.append(f"{name}_train")
            continue
        cli, variants = recipe["eval"]
        for flags in variants:
            tag = "_".join(f.lstrip("-").replace("-", "_") for f in flags) or "float"
            if run(f"{name}_eval_{tag}", [pkg + cli, "--config", recipe["config"], "--checkpoint",
                                          recipe["checkpoint"], *flags], out_dir):
                failed.append(f"{name}_eval_{tag}")
    print(f"port_convergence: {'failed: ' + ', '.join(failed) if failed else 'all commands exit 0'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
