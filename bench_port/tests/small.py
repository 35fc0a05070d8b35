"""Cells and configurations cut to a size the CPU runs in seconds: a 128x128 canvas, two images a batch.
Widths stay as the configurations state them."""
import types

import torch

from bench_port import harness

CANVAS = [128, 128]
RANGES = [[-1, 16], [16, 32], [32, 64], [64, 128], [128, 99999]]


def small(cell_name: str, **cell_changes):
    cell, cfg = harness.load_cell(cell_name)
    cfg = dict(cfg, canvas=CANVAS, ranges=RANGES)
    cell = dict(cell, batch=2, pool_batches=4, **cell_changes)
    cell["check"] = dict(cell["check"], chunk=2)
    if cell["kind"] == "serve":
        cell["check"]["sample_batches"] = 1
        cell["trace_batches"] = 2
    else:
        cell["trace_steps"] = 2
        cell["chips"] = min(cell["chips"], 2)
        cell["batch"] = 2 if cell["chips"] == 1 else 1
        cell["rank_timeout_s"] = 240
        # the CPU program in float32, the reference's precision, so that a sound run passes at this size
        cfg["train"] = dict(cfg["train"], autocast="float32")
    return cell, cfg


def args(cell_name: str, seed: int = 2 ** 31 + 11, trace: int = 0):
    return types.SimpleNamespace(workload=cell_name, seed=seed, seconds=0.3, trace=trace)


CPU = torch.device("cpu")
