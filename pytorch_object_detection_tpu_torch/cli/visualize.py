"""Detections and GradCAM on one image (the port's ``cli/visualize.py``).

    podt-torch-visualize --config config/main.yaml --image path.jpg [--checkpoint dir] [--out overlay.jpg]
    python -m pytorch_object_detection_tpu_torch.cli.visualize --config ... --image ... --device cpu

The config gives the model; its weights are random, from a
``torch.Generator`` seeded 0 (not the JAX CLI's ``PRNGKey(0)`` weights),
unless ``--checkpoint`` names a ``podt-torch-train`` checkpoint.  The image
goes onto the config's canvas (``data/voc.resize_to_canvas``) and through
the default serving pipeline (``eval/evaluator.make_default_pipeline``:
bf16 and the kernels on the card, f32 on the CPU); the FCOS families get
the GradCAM heatmap of the float model under the boxes
(``utils/gradcam.py``), RETINANET and SSD300 the plain canvas.  The overlay
is written to ``--out``; the last line says how many detections it holds.
PIL reads the image and cv2 draws, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import sys


def build(config: str, checkpoint: str, device):
    """(config, model, canvas_hw, strides) of a visualize run: the config's
    model with seeded random weights, or ``checkpoint``'s restored through
    ``create_train_state`` and ``train/checkpoints.restore_checkpoint``."""
    import torch

    from pytorch_object_detection_tpu_torch.core import config as C
    from pytorch_object_detection_tpu_torch.models.registry import build_model
    from pytorch_object_detection_tpu_torch.train import checkpoints as ckpt
    from pytorch_object_detection_tpu_torch.train.trainer import create_train_state

    cfg = C.load_config(config)
    block = C.model_block(cfg)
    model = build_model(cfg["model"]["name"], C.num_classes(cfg), int(block["channel"]), device=device,
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(model)
    if checkpoint:
        state = ckpt.restore_checkpoint(checkpoint, state)
    model = state.model.eval()
    strides = C.strides(cfg) if "stride" in block else (8, 16, 32, 64, 128)
    return cfg, model, C.canvas_hw(cfg), strides


def detect(model, canvas_img, canvas_hw, strides, score_threshold: float):
    """The default pipeline's detections of one uint8 canvas frame (``[1, ...]`` tensors on the model's device)."""
    import torch

    from pytorch_object_detection_tpu_torch.eval.evaluator import make_default_pipeline

    device = next(model.parameters()).device
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    pipeline = make_default_pipeline(model, strides, canvas_hw, score_threshold, 0.6, 1000,
                                     compute_dtype=compute_dtype)
    return pipeline(torch.from_numpy(canvas_img[None]).to(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="detections and GradCAM of the PyTorch port on one image")
    ap.add_argument("--config", default="config/main.yaml")
    ap.add_argument("--image", required=True)
    ap.add_argument("--checkpoint", default="",
                    help="a podt-torch-train checkpoint directory or step file; without it the weights are random "
                         "from torch.Generator().manual_seed(0), not the JAX CLI's PRNGKey(0) weights")
    ap.add_argument("--out", default="overlay.jpg")
    ap.add_argument("--score-threshold", type=float, default=0.3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs: the card (bf16 serving, the kernels) or the CPU (f32, their plain "
                         "versions)")
    args = ap.parse_args(argv)

    import cv2
    import numpy as np
    import torch
    from PIL import Image

    from pytorch_object_detection_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
    from pytorch_object_detection_tpu_torch.data.voc import resize_to_canvas
    from pytorch_object_detection_tpu_torch.utils.gradcam import gradcam_fcos, overlay_heatmap

    if args.device == "cuda" and not torch.cuda.is_available():
        print("visualize: no CUDA device (torch.cuda.is_available() is false); --device cpu runs on the CPU",
              file=sys.stderr)
        return 1
    cfg, model, canvas, strides = build(args.config, args.checkpoint, torch.device(args.device))

    raw = np.asarray(Image.open(args.image).convert("RGB"))
    canvas_img, _, scale, _ = resize_to_canvas(raw, None, canvas)
    det = detect(model, canvas_img, canvas, strides, args.score_threshold)

    if cfg["model"]["name"] in ("RETINANET", "SSD300"):
        # GradCAM targets the FCOS-family heads; anchor models get the detection overlay
        overlay = canvas_img.copy()
    else:
        norm = (canvas_img.astype(np.float32) / 255.0 - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(
            IMAGENET_STD, np.float32)
        cam = gradcam_fcos(model, torch.from_numpy(np.ascontiguousarray(norm[None], np.float32)))[0]
        overlay = overlay_heatmap(canvas_img, cam)

    names = cfg["dataset_setting"].get("class", ())  # without names, the class ids
    valid = det.valid[0].cpu().numpy()
    boxes = det.boxes[0].cpu().numpy()[valid]
    classes = det.classes[0].cpu().numpy()[valid]
    scores = det.scores[0].float().cpu().numpy()[valid]
    for b, c, s in zip(boxes, classes, scores):
        x1, y1, x2, y2 = [int(v) for v in b]
        cv2.rectangle(overlay, (x1, y1), (x2, y2), (0, 255, 0), 2)
        label = names[int(c) - 1] if int(c) - 1 < len(names) else str(int(c))
        cv2.putText(overlay, f"{label} {s:.2f}", (x1, max(y1 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
    cv2.imwrite(args.out, cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
    print(f"{len(boxes)} detections -> {args.out} (scale {scale:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
