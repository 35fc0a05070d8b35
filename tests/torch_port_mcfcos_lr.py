"""MC_FCOS under config/voc.yaml's SGD from random weights: the JAX train step beside the port's.

Not a test (pytest does not collect it): a witness, run by hand on the CPU,
that MC_FCOS's divergence at the config's lr 1e-2 is the model's and not
the port's.  Both modes print each step's losses.

  JAX_PLATFORMS=cpu python tests/torch_port_mcfcos_lr.py
      MC_FCOS(20, 256) at 256x256, B=4, from the flax init (seed 0), 16 f32
      steps of SGD lr 1e-2 (momentum 0.9, weight decay 1e-4, warm-up 500
      from a third), JAX and then the port on the same weights and batch.
      About 5 minutes and 8 GB on eight cores.
  JAX_PLATFORMS=cpu python tests/torch_port_mcfcos_lr.py --small
      test_torch_port_mcfcos.py's train-step case: MC_FCOS(5, 64) at
      128x128 from its perturbed weights, 3 JAX steps at each lr of 1e-2,
      1e-4, 1e-6 and 1e-8 (warm-up 10).
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytorch_object_detection_tpu.models import mcfcos as jax_mcfcos  # noqa: E402
from pytorch_object_detection_tpu.train import schedules as jax_schedules  # noqa: E402
from pytorch_object_detection_tpu.train import trainer as jax_trainer  # noqa: E402
from pytorch_object_detection_tpu_torch.models.registry import build_model  # noqa: E402
from pytorch_object_detection_tpu_torch.train import trainer  # noqa: E402
from pytorch_object_detection_tpu_torch.train.checkpoints import load_flax_variables  # noqa: E402

STRIDES = (8, 16, 32, 64)
RANGES = [(-1, 64), (64, 128), (128, 256), (256, 99999999)]  # config/voc.yaml's MC_FCOS block
OPT = {"name": "SGD", "lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-4, "warmup_steps": 500}


def _line(who: str, i: int, metrics) -> str:
    return f"{who} step {i:2d}: " + " ".join(f"{k} {float(v):.6g}" for k, v in sorted(metrics.items()))


def _batch(hw, nboxes, num_classes: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    images = rng.normal(0.0, 1.0, (len(nboxes), *hw, 3)).astype(np.float32)
    boxes = np.full((len(nboxes), 16, 4), -1.0, np.float32)
    labels = np.full((len(nboxes), 16), -1, np.int32)
    for b, n in enumerate(nboxes):
        cxy = rng.uniform(0.25, 0.75, (n, 2)) * np.array(hw[::-1])
        wh = rng.uniform(0.15, 0.6, (n, 2)) * np.array(hw[::-1])
        boxes[b, :n, :2] = np.maximum(cxy - wh / 2, 0)
        boxes[b, :n, 2:] = np.minimum(cxy + wh / 2, np.array(hw[::-1]) - 1)
        labels[b, :n] = rng.integers(1, num_classes + 1, n)
    return images, boxes, labels


def full(steps: int = 16) -> None:
    hw, num_classes, features = (256, 256), 20, 256
    shapes = [(hw[0] // s, hw[1] // s) for s in STRIDES]
    images, boxes, labels = _batch(hw, (3, 1, 2, 4), num_classes)
    model = jax_mcfcos.MC_FCOS(num_classes=num_classes, features=features)
    var = jax.jit(lambda k, x: model.init(k, x, False))(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3), jnp.float32))
    params, stats = jax.device_get(var["params"]), jax.device_get(var["batch_stats"])

    sched = jax_schedules.warmup_step_decay(OPT["lr"], OPT["warmup_steps"])
    tx = jax_trainer.make_optimizer("SGD", sched, OPT["momentum"], OPT["weight_decay"], params=params,
                                    freeze_bn=True, frozen_stages=0)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tx.init(p), tx=tx,
                                   batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    step = jax_trainer.make_train_step(model, shapes, STRIDES, RANGES, "giou", jnp.float32, donate=False)
    for i in range(steps):
        state, m = step(state, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(labels))
        print(_line("jax ", i + 1, m), flush=True)

    port = build_model("MC_FCOS", num_classes, features, device="cpu")
    load_flax_variables(port, params, stats)
    pstate = trainer.create_train_state(port, OPT, freeze_bn=True, frozen_stages=0)
    pstep = trainer.make_train_step(pstate.model, shapes, STRIDES, RANGES, "giou", torch.float32)
    batch = tuple(torch.from_numpy(a) for a in (images, boxes, labels))
    for i in range(steps):
        print(_line("port", i + 1, pstep(pstate, *batch)), flush=True)


def small() -> None:
    from test_torch_port_mcfcos import CANVAS
    from test_torch_port_train import jax_capture_state, numpy_batch
    from torch_port_fixtures import jax_model, perturbed_variables

    shapes = [(CANVAS // s, CANVAS // s) for s in STRIDES]
    params, stats = perturbed_variables(43, "MC_FCOS", 5)
    step = jax_trainer.make_train_step(jax_model("MC_FCOS", 5), shapes, STRIDES, RANGES, "giou", jnp.float32,
                                       donate=False)
    images, boxes, labels = numpy_batch()
    for lr in (1e-2, 1e-4, 1e-6, 1e-8):
        state = jax_capture_state("MC_FCOS", 0, params, stats, {"lr": lr, "warmup_steps": 10})
        for i in range(3):
            state, m = step(state, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(labels))
            print(_line(f"jax lr {lr:g}", i + 1, m), flush=True)


if __name__ == "__main__":
    small() if "--small" in sys.argv[1:] else full()
