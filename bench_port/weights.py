"""Seeded weights of a configuration, drawn on the device in two calls.

One standard-normal and one uniform vector as long as all the weights
together come from a ``torch.Generator`` on the device; each weight takes
its slice and is scaled by the rule of its kind (``reference/models.
weight_specs``) and the configuration's ``init`` block.  The same seed
gives the same weights on the same kind of device.  The program under test
gets a copy (``load_state_dict``); the reference draws them again.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from bench_port.reference.models import weight_specs


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one use of a run's seed (weights 0,
    frames 1, calibration 2, sampling 3, ...)."""
    return torch.Generator(device=device).manual_seed((int(seed) << 4) | stream)


def draw(config: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    specs = weight_specs(config["family"], config["num_classes"], config["features"])
    init = config["init"]
    total = sum(math.prod(shape) for shape, _ in specs.values())
    g = generator(device, seed, 0)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)

    def span(lo_hi, u):
        lo, hi = lo_hi
        return lo + (hi - lo) * u

    out, at = {}, 0
    for name, (shape, kind) in specs.items():
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "conv":  # He normal: the second moment kept through a ReLU
            t = z * (init["conv_gain"] * math.sqrt(2.0 / math.prod(shape[1:])))
        elif kind.startswith("pred_"):  # the output's spread set by the gain
            t = z * (init[f"{kind}_gain"] / math.sqrt(math.prod(shape[1:])))
        elif kind == "conv_bias":
            t = z * init["conv_bias_std"]
        elif kind in ("bn_weight", "bn_last_weight", "bn_var", "gn_weight"):
            t = span(init[kind], u)
        elif kind in ("bn_bias", "bn_mean", "gn_bias"):
            t = z * init[f"{kind}_std"]
        elif kind == "cls_bias":
            t = init["cls_bias"] + z * init["cls_bias_std"]
        elif kind == "reg_bias":
            t = init["reg_bias"] + z * init["reg_bias_std"]
        elif kind == "scale":
            t = torch.full(shape, float(init["scale"]), device=device)
        else:
            raise ValueError(f"{name}: no rule for kind {kind!r}")
        out[name] = t.contiguous()
    return out
