"""YAML config loading: the port's copy of ``pytorch_object_detection_tpu/core/config.py``.

The two-level scheme (``config/main.yaml`` selects the dataset, the model
and runtime flags, and points at ``config/{voc,coco}.yaml`` with the
dataset paths and per-model hyperparameter blocks), the injected
``config['model']`` keys and the key names are the JAX package's, so the
same YAML files load to the same dicts (held by a CPU test on every file
under ``config/``).

Two differences, both about where files are found: ``yaml`` is imported
inside :func:`load_config` only, so nothing on the serving path needs
PyYAML at import; and a path that does not exist is not looked up in the
JAX package's bundled ``configs/`` (the port imports nothing of it): the
dataset file is tried as given, then next to the main file.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple


def load_config(cfg_path: str = "config/main.yaml") -> Dict[str, Any]:
    import yaml

    with open(cfg_path) as f:
        main = yaml.safe_load(f)
    dataset = main["dataset"]
    dataset_cfg_path = main[dataset]
    if not os.path.exists(dataset_cfg_path):
        # reference paths are repo-root-relative; also try next to main.yaml
        alt = os.path.join(os.path.dirname(os.path.abspath(cfg_path)), os.path.basename(dataset_cfg_path))
        dataset_cfg_path = alt if os.path.exists(alt) else dataset_cfg_path
    with open(dataset_cfg_path) as f:
        config = yaml.safe_load(f)
    config["model"] = {
        "dataset": dataset,
        "name": main["model"],
        "amp": main.get("amp", True),
        "ddp": main.get("ddp_enabled", True),
        "persistent": main.get("persistent_workers", False),
        "prefetch": main.get("prefetch_factor", 2),
    }
    config["savename"] = main.get("savename", "run")
    return config


def model_block(config: Dict[str, Any]) -> Dict[str, Any]:
    """The per-model hyperparameter block selected by main.yaml."""
    return config[config["model"]["name"]]


def limit_ranges(config: Dict[str, Any]) -> List[Tuple[float, float]]:
    return [tuple(r) for r in model_block(config)["range"]]


def strides(config: Dict[str, Any]) -> List[int]:
    return list(model_block(config)["stride"])


def input_hw(config: Dict[str, Any]) -> Tuple[int, int]:
    """Input size; a model block may override the dataset default (SSD300
    is defined at a fixed 300x300 regardless of dataset)."""
    size = model_block(config).get("input", config["dataset_setting"]["input"])
    return int(size[0]), int(size[1])


def num_classes(config: Dict[str, Any]) -> int:
    return int(config["dataset_setting"]["class_num"])


def level_shapes(config: Dict[str, Any]) -> List[Tuple[int, int]]:
    """Per-level feature shapes on the fixed input canvas."""
    h, w = canvas_hw(config)
    return [(_ceil_div(h, s), _ceil_div(w, s)) for s in strides(config)]


def canvas_hw(config: Dict[str, Any]) -> Tuple[int, int]:
    # canvas_align=1 keeps exact sizes for models defined at a fixed
    # resolution (SSD300); FPN models align to the 128 max stride
    align = int(model_block(config).get("canvas_align", 128))
    h, w = input_hw(config)
    return _round_up(h, align), _round_up(w, align)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
