"""VOC evaluation of the port on the card (the port's ``cli/eval_voc.py``).

    podt-torch-eval-voc --config config/main.yaml --checkpoint model.pt --device-resize
    python -m pytorch_object_detection_tpu_torch.cli.eval_voc --config ... --device cpu

Loads the config, builds the model (random weights from seed 0 unless
``--checkpoint`` names a ``podt-torch-train`` checkpoint or a port state dict,
``torch.save(model.state_dict())``),
and runs ``eval/evaluator.evaluate_voc`` over the config's VOC tree: per-class
AP@0.5, mAP and images/sec, the JAX CLI's lines.  RETINANET and SSD300 serve
through the anchor pipelines (``make_eval_pipeline_anchor``, ``--int8``:
``make_eval_pipeline_anchor_int8``, the oracle backbone on the CPU as the JAX
CLI picks it); ``--ref-4stride`` and ``--device-resize`` are refused for
them with exit code 2, as the JAX CLI asserts against the first and its
default pipeline against the second.  The JAX CLI's flags, and
``--device``.  What each path needs on the machine: PyYAML (the config),
g++ (the native matching and JPEG libraries, built at first use), libjpeg
(decode); ``cv2`` only without ``--device-resize`` (the host resize).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="VOC evaluation of the PyTorch port (per-class AP@0.5, mAP, img/s)")
    ap.add_argument("--config", default="config/main.yaml")
    ap.add_argument("--checkpoint", default="",
                    help="a podt-torch-train checkpoint (a step_XXXXXXXX.pt file, or the newest under a directory) "
                         "or a port state dict (torch.save(model.state_dict())); the JAX package's orbax "
                         "checkpoints need jax to read")
    ap.add_argument("--torch-checkpoint", default="",
                    help="a reference .pth detector checkpoint: refused (the JAX CLI takes the flag and does not "
                         "use it); load_pretrained_backbone grafts a torchvision ResNet-50 for training")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--split", default="test")
    ap.add_argument("--int8", action="store_true",
                    help="serve through the int8-PTQ pipeline (make_eval_pipeline_int8's defaults); calibrates on "
                         "the first eval batch")
    ap.add_argument("--device-resize", action="store_true",
                    help="the host only decodes JPEGs into fixed uint8 tiles; the aspect-preserving resize runs "
                         "batched on the device (data/pipeline.make_device_resize); --int8 then calibrates on the "
                         "device-resized canvases of the first batch (the JAX CLI on cv2's)")
    ap.add_argument("--ref-4stride", action="store_true",
                    help="eval-compat mode: decode only the first 4 pyramid levels, reproducing the reference's "
                         "zip-truncation (test.py:176 passes strides=[8,16,32,64] for a 5-level model)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs: the card (bf16, the kernels) or the CPU (f32, their plain versions)")
    args = ap.parse_args(argv)
    if args.torch_checkpoint:
        ap.error("--torch-checkpoint is not supported: the JAX CLI takes the flag and does not use it")

    import torch

    from pytorch_object_detection_tpu_torch.core import config as C
    from pytorch_object_detection_tpu_torch.data.voc import VOCDataset
    from pytorch_object_detection_tpu_torch.eval.evaluator import (
        evaluate_voc,
        make_eval_pipeline,
        make_eval_pipeline_int8,
    )
    from pytorch_object_detection_tpu_torch.models.registry import build_model
    from pytorch_object_detection_tpu_torch.train.checkpoints import load_model_checkpoint

    if args.device == "cuda" and not torch.cuda.is_available():
        print("eval_voc: no CUDA device (torch.cuda.is_available() is false); --device cpu runs on the CPU",
              file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    compute_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cfg = C.load_config(args.config)
    block = C.model_block(cfg)
    canvas = C.canvas_hw(cfg)
    name = cfg["model"]["name"]
    anchor_based = name in ("RETINANET", "SSD300")
    if anchor_based and (args.ref_4stride or args.device_resize):
        flag = "--ref-4stride is a FCOS-family eval-compat mode" if args.ref_4stride else \
            "--device-resize is for the FCOS families"
        print(f"eval_voc: {flag}; {name} decodes through its anchors", file=sys.stderr)
        return 2
    model = build_model(name, C.num_classes(cfg), int(block["channel"]), device=dev,
                        generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        load_model_checkpoint(model, args.checkpoint)
    model.eval()

    ds_root = cfg["dataset_setting"].get("test_07", cfg["dataset_setting"].get("train_07"))
    dataset = VOCDataset([ds_root], args.split, canvas, raw_tiles=args.device_resize)
    eval_cfg = block.get("eval", {})  # optional overrides of the reference defaults
    score_threshold = float(eval_cfg.get("score_threshold", 0.05))
    nms_iou = float(eval_cfg.get("nms_iou", 0.6))
    max_detections = int(eval_cfg.get("max_detections", 1000))
    strides = C.strides(cfg) if "stride" in block else (8, 16, 32, 64, 128)
    if args.ref_4stride:
        strides = tuple(strides)[:4]
    if anchor_based:
        pipeline = anchor_pipeline(model, dataset, args.int8, args.batch_size, canvas, dev, compute_dtype, eval_cfg)
    elif args.int8:
        calib = first_batch_calib(dataset, args.batch_size, canvas, dev)
        pipeline = make_eval_pipeline_int8(model, calib, strides, canvas, score_threshold, nms_iou, max_detections,
                                           device_resize=args.device_resize, compute_dtype=compute_dtype)
    else:
        pipeline = make_eval_pipeline(model, strides, canvas, score_threshold, nms_iou, max_detections,
                                      compute_dtype=compute_dtype, device_resize=args.device_resize)
    evaluate_voc(model, dataset, strides=strides, batch_size=args.batch_size, num_classes=C.num_classes(cfg),
                 score_threshold=score_threshold, nms_iou=nms_iou, max_detections=max_detections, pipeline=pipeline)
    return 0


def anchor_pipeline(model, dataset, int8: bool, batch_size: int, canvas_hw, device, compute_dtype, eval_cfg):
    """The eval CLIs' pipeline of a RetinaNet or an SSD300: the float anchor
    pipeline, or with ``int8`` the int8 one calibrated on the first batch
    (:func:`first_batch_calib`; the oracle backbone on the CPU, as the JAX
    CLIs pick it).  The block's ``eval`` gives the thresholds; the JAX CLIs'
    NMS IoU default is 0.6 for the float pipeline and 0.5 for the int8 one."""
    from pytorch_object_detection_tpu_torch.eval.evaluator import (
        make_eval_pipeline_anchor,
        make_eval_pipeline_anchor_int8,
    )

    score, max_det = float(eval_cfg.get("score_threshold", 0.05)), int(eval_cfg.get("max_detections", 1000))
    if not int8:
        return make_eval_pipeline_anchor(model, canvas_hw, score, float(eval_cfg.get("nms_iou", 0.6)), max_det,
                                         compute_dtype)
    calib = first_batch_calib(dataset, batch_size, canvas_hw, device)
    return make_eval_pipeline_anchor_int8(model, calib, canvas_hw, score, float(eval_cfg.get("nms_iou", 0.5)), max_det,
                                          backend="xla" if device.type == "cpu" else "pallas_block",
                                          compute_dtype=compute_dtype)


def first_batch_calib(dataset, batch_size: int, canvas_hw, device):
    """The calibration batch of ``--int8``: the first ``min(batch_size, 8)``
    images of ``dataset`` on ``device``, resized onto the canvas on the
    device where the dataset has ``raw_tiles`` (the JAX CLIs calibrate on
    cv2's canvases), normalized (:func:`calib_images`)."""
    import numpy as np
    import torch

    from pytorch_object_detection_tpu_torch.data.pipeline import DetectionLoader, make_device_resize

    batch = next(iter(DetectionLoader(dataset, min(batch_size, 8), shuffle=False, drop_last=False, num_workers=2)))
    canvas_u8 = torch.from_numpy(batch.images).to(device)
    if getattr(dataset, "raw_tiles", False):
        src_hw = torch.from_numpy(np.stack([batch.content_h, batch.content_w], 1).astype(np.int32))
        canvas_u8 = make_device_resize(canvas_hw)(canvas_u8, src_hw)[0]
    return calib_images(canvas_u8)


def calib_images(canvas_u8):
    """The normalized f32 calibration batch of uint8 canvas frames (ImageNet statistics)."""
    import torch

    from pytorch_object_detection_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD

    mean = torch.tensor(IMAGENET_MEAN, device=canvas_u8.device)
    std = torch.tensor(IMAGENET_STD, device=canvas_u8.device)
    return (canvas_u8.float() / 255.0 - mean) / std


if __name__ == "__main__":
    sys.exit(main())
