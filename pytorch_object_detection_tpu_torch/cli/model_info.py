"""Model summary of the port: params, per-module breakdown, output shapes, FLOPs.

    podt-torch-model-info --model HISFCOS [--classes 20] [--features 256] [--size 512] [--batch 1]
    python -m pytorch_object_detection_tpu_torch.cli.model_info --model FCOS --size 128

The port's counterpart of the JAX ``cli/model_info.py``: the same flags and
the same printed lines, from ``utils/model_info.model_info`` on the ``meta``
device (shapes only: no card, no weights).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="params, per-module breakdown, output shapes and FLOPs of a detector")
    ap.add_argument("--model", default="HISFCOS")
    ap.add_argument("--classes", type=int, default=20)
    ap.add_argument("--features", type=int, default=256)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args(argv)

    from pytorch_object_detection_tpu_torch.utils.model_info import model_info

    info = model_info(args.model, (args.batch, args.size, args.size, 3), num_classes=args.classes,
                      features=args.features)
    print(f"{args.model} @ {args.batch}x{args.size}x{args.size}x3")
    print(f"  total params: {info['params']:,}")
    for mod, n in info["params_by_module"].items():
        print(f"    {mod}: {n:,}")
    if "batch_stats" in info:
        print(f"  batch_stats (BN moments): {info['batch_stats']:,}")
    if info.get("flops"):
        print(f"  forward FLOPs: {info['flops'] / 1e9:.2f} G  (mult-adds ~{info['flops'] / 2e9:.2f} G)")
    print("  output shapes:", info["output_shapes"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
