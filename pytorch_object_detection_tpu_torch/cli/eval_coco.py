"""COCO evaluation of the port on the card (the port's ``cli/eval_coco.py``).

    podt-torch-eval-coco --config config/coco.yaml --checkpoint model.pt --device-resize --int8
    python -m pytorch_object_detection_tpu_torch.cli.eval_coco --config ... --device cpu

Loads the config, builds the model (random weights from seed 0 unless
``--checkpoint`` names a ``podt-torch-train`` checkpoint or a port state dict,
``torch.save(model.state_dict())``),
and runs ``eval/evaluator.evaluate_coco`` over the config's ``ValData`` /
``ValAnnotation``: the 12-number COCO summary and images/sec, the JAX CLI's
lines, and the results JSON (``--results-json``).  The official numbers
follow where pycocotools imports, as in the JAX CLI.  The JAX CLI's flags,
plus ``--device-resize`` and ``--device``.  What each path needs on the
machine: PyYAML (the config), g++ (the native matching and JPEG libraries,
built at first use), libjpeg (decode); ``cv2`` only without
``--device-resize`` (the host resize).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="COCO evaluation of the PyTorch port (COCO AP summary, img/s)")
    ap.add_argument("--config", default="config/main.yaml")
    ap.add_argument("--checkpoint", default="",
                    help="a podt-torch-train checkpoint (a step_XXXXXXXX.pt file, or the newest under a directory) "
                         "or a port state dict (torch.save(model.state_dict())); the JAX package's orbax "
                         "checkpoints need jax to read")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--results-json", default="coco_bbox_results.json")
    ap.add_argument("--int8", action="store_true",
                    help="serve through the int8-PTQ pipeline (make_eval_pipeline_int8's defaults); calibrates on "
                         "the first eval batch")
    ap.add_argument("--device-resize", action="store_true",
                    help="the host only decodes JPEGs into fixed uint8 tiles; the aspect-preserving resize runs "
                         "batched on the device (data/pipeline.make_device_resize); --int8 then calibrates on the "
                         "device-resized canvases of the first batch (the JAX CLI on cv2's)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs: the card (bf16, the kernels) or the CPU (f32, their plain versions)")
    args = ap.parse_args(argv)

    import torch

    from pytorch_object_detection_tpu_torch.cli.eval_voc import first_batch_calib
    from pytorch_object_detection_tpu_torch.core import config as C
    from pytorch_object_detection_tpu_torch.data.coco import COCODataset
    from pytorch_object_detection_tpu_torch.eval.evaluator import (
        evaluate_coco,
        make_eval_pipeline,
        make_eval_pipeline_int8,
    )
    from pytorch_object_detection_tpu_torch.models.registry import build_model
    from pytorch_object_detection_tpu_torch.train.checkpoints import load_model_checkpoint

    if args.device == "cuda" and not torch.cuda.is_available():
        print("eval_coco: no CUDA device (torch.cuda.is_available() is false); --device cpu runs on the CPU",
              file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    compute_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cfg = C.load_config(args.config)
    block = C.model_block(cfg)
    canvas = C.canvas_hw(cfg)
    try:
        model = build_model(cfg["model"]["name"], C.num_classes(cfg), int(block["channel"]), device=dev,
                            generator=torch.Generator().manual_seed(0))
    except NotImplementedError as err:  # RetinaNet, SSD300: ROADMAP.md queue 1 item 10
        print(f"eval_coco: {err}", file=sys.stderr)
        return 2
    if args.checkpoint:
        load_model_checkpoint(model, args.checkpoint)
    model.eval()

    ds_cfg = cfg["dataset_setting"]
    dataset = COCODataset(ds_cfg["ValData"], ds_cfg["ValAnnotation"], canvas, filter_empty=False,
                          raw_tiles=args.device_resize)
    eval_cfg = block.get("eval", {})
    score_threshold = float(eval_cfg.get("score_threshold", 0.05))
    nms_iou = float(eval_cfg.get("nms_iou", 0.6))
    max_detections = int(eval_cfg.get("max_detections", 1000))
    strides = C.strides(cfg) if "stride" in block else (8, 16, 32, 64, 128)
    if args.int8:
        calib = first_batch_calib(dataset, args.batch_size, canvas, dev)
        pipeline = make_eval_pipeline_int8(model, calib, C.strides(cfg), canvas, score_threshold, nms_iou,
                                           max_detections, device_resize=args.device_resize,
                                           compute_dtype=compute_dtype)
    else:
        pipeline = make_eval_pipeline(model, strides, canvas, score_threshold, nms_iou, max_detections,
                                      compute_dtype=compute_dtype, device_resize=args.device_resize)
    evaluate_coco(model, dataset, strides=strides, batch_size=args.batch_size, results_json=args.results_json,
                  score_threshold=score_threshold, nms_iou=nms_iou, max_detections=max_detections,
                  pipeline=pipeline)
    # official numbers where pycocotools exists (metric parity)
    try:
        from pytorch_object_detection_tpu_torch.eval.coco_map import evaluate_coco_official

        print("pycocotools:", evaluate_coco_official(args.results_json, ds_cfg["ValAnnotation"]))
    except ImportError:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
