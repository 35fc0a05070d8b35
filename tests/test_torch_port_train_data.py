"""Training's inputs, checkpoints and CLI: the port against the JAX package (CPU).

  * the device preprocess: ``color_jitter``/``hflip`` cores fed the JAX
    functions' own draws, and the eval preprocess;
  * ``HostAugment``: the same bytes and boxes as the JAX class at one seed;
  * ``synthetic_batch``: the JAX layout;
  * checkpoints: save and restore of the full state (weights, buffers,
    optimizer, step), resume continuity (2 steps, save, restore, 2 steps
    equal 4 straight steps bit for bit), ``keep``, a checkpoint saved with
    other freeze masks, and ``load_pretrained_backbone`` on a torchvision
    state dict against the JAX converter's tree;
  * ``podt-torch-train`` by subprocess with ``--device cpu`` on a small
    config (HISFCOS(20, 64), 128x128, B=2): ``--synthetic`` (its batches
    the JAX CLI's, byte for byte), ``--resume``, checkpoint-and-exit on
    SIGTERM, the NaN halt, the dataset and ring-loader paths on the
    committed VOC tree, and the refusals.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.data import augment as jax_augment
from pytorch_object_detection_tpu.data import pipeline as jax_pipeline
from pytorch_object_detection_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from pytorch_object_detection_tpu.train.checkpoints import torchvision_resnet50_to_pytree
from pytorch_object_detection_tpu_torch.cli.train import synthetic_batches
from pytorch_object_detection_tpu_torch.core import config as port_config
from pytorch_object_detection_tpu_torch.data import augment, pipeline
from pytorch_object_detection_tpu_torch.data.synthetic import synthetic_batch
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.train import checkpoints, trainer
from torch_port_fixtures import one_torch_thread, perturbed_variables  # noqa: F401 (autouse)
from torch_resnet50 import make_random_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (128, 128)
STRIDES = (8, 16, 32, 64, 128)
SHAPES = [(HW[0] // s, HW[1] // s) for s in STRIDES]
RANGES = [(-1, 32), (32, 96), (96, 192), (192, 384), (384, 9999999)]



# ---------------------------------------------------------------------------
# device preprocess, host augment, synthetic batches
# ---------------------------------------------------------------------------
def jax_jitter_draws(rng, b, prob, strength=0.1):
    """The draws JAX ``color_jitter`` makes from ``rng`` (its key split and calls)."""
    keys = jax.random.split(rng, 5)
    factor = [jax.random.uniform(k, (b, 1, 1, 1), minval=1.0 - strength, maxval=1.0 + strength) for k in keys[1:4]]
    return {"apply": jax.random.uniform(keys[0], (b, 1, 1, 1)) < prob,
            "brightness": factor[0], "contrast": factor[1], "saturation": factor[2],
            "hue": jax.random.uniform(keys[4], (b, 1, 1), minval=-strength, maxval=strength)}


@pytest.mark.parametrize("prob", [0.5, 1.0])
def test_color_jitter_and_hflip_match_jax_draws(prob):
    rng = np.random.default_rng(2)
    images = rng.uniform(0.0, 1.0, (6, 20, 24, 3)).astype(np.float32)
    images[0, :4] = 0.5  # gray pixels: no hue (delta 0)
    images[1, :, :, 1] = images[1, :, :, 0]  # ties between channels in the hue's sector choice
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_pipeline.color_jitter(key, jnp.asarray(images), prob))
    draws = {k: torch.from_numpy(np.asarray(v)) for k, v in jax_jitter_draws(key, 6, prob).items()}
    assert 0 < int(draws["apply"].sum()) or prob == 1.0
    got = pipeline.color_jitter_apply(torch.from_numpy(images), draws).numpy()
    # the same f32 operations in the same order; XLA's fused divisions and
    # floor-mods may round a value at a hue sector's edge differently
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)

    boxes = np.full((6, 4, 4), -1.0, np.float32)
    boxes[:, :2] = rng.uniform(0, 10, (6, 2, 4)).astype(np.float32) + [0, 0, 10, 10]
    content_w = np.array([24, 20, 17, 24, 1, 9], np.int32)
    fkey = jax.random.PRNGKey(9)
    want_i, want_b = jax_pipeline.hflip(fkey, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(content_w), prob)
    flip = torch.from_numpy(np.asarray(jax.random.uniform(fkey, (6,)) < prob))
    got_i, got_b = pipeline.hflip_apply(torch.from_numpy(images), torch.from_numpy(boxes),
                                        torch.from_numpy(content_w), flip)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def test_device_preprocess_matches_jax_and_draws_in_order():
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (2, 16, 16, 3), np.uint8)
    boxes = np.array([[[1, 2, 9, 12], [-1, -1, -1, -1]]] * 2, np.float32)
    cw = np.array([16, 12], np.int32)
    want_x, want_b = jax_pipeline.make_device_preprocess(train=False)(jax.random.PRNGKey(0), jnp.asarray(u8),
                                                                      jnp.asarray(boxes), jnp.asarray(cw))
    fn = pipeline.make_device_preprocess(train=False)
    got_x, got_b = fn(None, torch.from_numpy(u8), torch.from_numpy(boxes), torch.from_numpy(cw))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    # the train preprocess: the flip's draws, then the jitter's, from one generator
    train = pipeline.make_device_preprocess(train=True, jitter_prob=1.0)
    x, b = train(torch.Generator().manual_seed(5), torch.from_numpy(u8), torch.from_numpy(boxes), torch.from_numpy(cw))
    g = torch.Generator().manual_seed(5)
    flip = pipeline.hflip_draws(g, 2)
    draws = pipeline.color_jitter_draws(g, 2, 1.0)
    fx, fb = pipeline.hflip_apply(torch.from_numpy(u8).float() / 255.0, torch.from_numpy(boxes),
                                  torch.from_numpy(cw), flip)
    mean, std = torch.tensor(pipeline.IMAGENET_MEAN), torch.tensor(pipeline.IMAGENET_STD)
    assert torch.equal(x, (pipeline.color_jitter_apply(fx, draws) - mean) / std) and torch.equal(b, fb)


def test_host_augment_matches_jax_byte_for_byte():
    rng = np.random.default_rng(4)
    port, ref = augment.HostAugment(seed=3), jax_augment.HostAugment(seed=3)
    for i in range(16):
        h, w = rng.integers(60, 140, 2)
        image = rng.integers(0, 256, (h, w, 3), np.uint8)
        n = int(rng.integers(0, 4))
        xy = rng.uniform(0, [w - 20, h - 20], (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 19, (n, 2))], 1).astype(np.float32)
        gi, gb = port(image.copy(), boxes.copy())
        wi, wb = ref(image.copy(), boxes.copy())
        assert gi.shape == wi.shape and gi.tobytes() == wi.tobytes(), i
        np.testing.assert_array_equal(gb, wb)
    assert port.rng.getstate() == ref.rng.getstate()


def test_synthetic_batch_layout():
    want = jax_synthetic_batch(jax.random.PRNGKey(0), 4, (64, 96), 5, max_boxes=8, mean_boxes=3)
    got = synthetic_batch(torch.Generator().manual_seed(0), 4, (64, 96), 5, max_boxes=8, mean_boxes=3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype), (g.shape, w.shape, g.dtype, w.dtype)
    images, boxes, labels = got
    assert 0 <= float(images.min()) and float(images.max()) < 1
    valid = labels > 0
    n = valid.sum(1)
    assert bool(((n >= 1) & (n <= 6)).all()) and bool((valid == (boxes[..., 0] > -1)).all())
    assert bool((valid[:, :-1] >= valid[:, 1:]).all())  # the valid boxes come first
    assert bool((labels[valid] <= 5).all()) and bool((labels[~valid] == -1).all())
    v = boxes[valid]
    assert bool((v[:, 2] > v[:, 0]).all() and (v[:, 3] > v[:, 1]).all() and (v[:, 2] <= 95).all()
                and (v[:, 3] <= 63).all() and (v[:, :2] >= 0).all())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def small_state(frozen_stages: int = 1, seed: int = 0):
    model = build_model("HISFCOS", 5, 64, frozen_stages=frozen_stages, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return trainer.create_train_state(model, {"lr": 1e-2, "warmup_steps": 3}, True, frozen_stages)


def batch(seed: int):
    g = torch.Generator().manual_seed(seed)
    images, boxes, labels = synthetic_batch(g, 2, HW, 5, max_boxes=6)
    return (images - 0.5) / 0.25, boxes, labels


def steps(state, seeds):
    step = trainer.make_train_step(state.model, SHAPES, STRIDES, RANGES, "giou", torch.float32)
    return [step(state, *batch(s)) for s in seeds]


def test_checkpoint_save_restore_and_resume_continuity(tmp_path):
    straight = small_state()
    want = steps(straight, range(4))
    state = small_state()
    steps(state, range(2))
    path = checkpoints.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "step_00000002.pt" and sorted(os.listdir(tmp_path)) == ["step_00000002.pt"]
    template = small_state(seed=1)  # other weights: all of them come from the file
    checkpoints.restore_checkpoint(str(tmp_path), template)
    assert template.step == 2
    for (k, v), w in zip(template.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(v, w), k
    bufs = [template.optimizer.state[p]["momentum_buffer"] for p in template.model.parameters() if p.requires_grad]
    assert len(bufs) == len(template.trainable_names())
    assert all(torch.equal(a, state.optimizer.state[p]["momentum_buffer"])
               for a, p in zip(bufs, [p for p in state.model.parameters() if p.requires_grad]))
    got = steps(template, range(2, 4))
    for g, w in zip(got, want[2:]):
        assert all(torch.equal(g[k], w[k]) for k in w)
    for (k, v), w in zip(template.model.state_dict().items(), straight.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_checkpoint_keep_and_other_freeze_masks(tmp_path):
    state = small_state()
    steps(state, [0])
    for s in range(1, 5):
        checkpoints.save_checkpoint(str(tmp_path), state, step=s, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003.pt", "step_00000004.pt"]
    other = small_state(frozen_stages=0, seed=1)  # layer1 trainable: another optimizer layout
    checkpoints.restore_checkpoint(str(tmp_path / "step_00000003.pt"), other)
    assert other.step == 1 and not other.optimizer.state  # the state's step; the template's fresh optimizer
    for (k, v), w in zip(other.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(v, w), k
    with pytest.raises(FileNotFoundError):
        checkpoints.restore_checkpoint(str(tmp_path / "empty_dir_does_not_exist"), other)
    # the eval CLIs' --checkpoint: the newest training checkpoint's weights, or a plain state dict
    plain = tmp_path / "plain"
    plain.mkdir()
    torch.save(state.model.state_dict(), plain / "weights.pt")
    for source in (str(tmp_path), str(plain / "weights.pt")):
        model = build_model("HISFCOS", 5, 64, device="cpu", generator=torch.Generator().manual_seed(2))
        checkpoints.load_model_checkpoint(model, source)
        assert all(torch.equal(v, w) for v, w in zip(model.state_dict().values(), state.model.state_dict().values()))


@pytest.mark.parametrize("prefix", ["", "module."])
def test_load_pretrained_backbone_matches_jax_converter(tmp_path, prefix):
    sd = make_random_state_dict(0)
    path = str(tmp_path / "resnet50.pth")
    torch.save({prefix + k: torch.from_numpy(v) for k, v in sd.items()}, path)
    model = build_model("HISFCOS", 20, 64, device="cpu")
    checkpoints.load_pretrained_backbone(model, path)
    params, stats = perturbed_variables(0)
    params["backbone"], stats["backbone"] = torchvision_resnet50_to_pytree(sd)
    want = checkpoints.load_flax_variables(build_model("HISFCOS", 20, 64, device="cpu"), params, stats)
    got_sd, want_sd = model.state_dict(), want.state_dict()
    keys = [k for k in want_sd if k.startswith("backbone.")]
    assert len(keys) == 265  # 53 convs, 53 BNs' four tensors
    for k in keys:
        assert torch.equal(got_sd[k], want_sd[k]), k


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
TINY_DATA = """dataset_setting:
  class_num : 20
  train_07 : '{voc}'
  test_07 : '{voc}'
  type : 'test'
  input : [128, 128]
  num_workers : 2
  max_boxes : 16
{model}:
  channel: 64
  Epoch: 1
  batch_size: 2
  optimizer: {{name : SGD, lr : {lr}}}
  schedule: {{warmup_steps : 10}}
  criterion : giou
  stride : [8, 16, 32, 64, 128]
  range : [[-1, 32], [32, 96], [96, 192], [192, 384], [384, 9999999]]
"""


def tiny_config(tmp_path, name="tiny", lr=1e-2, model="HISFCOS"):
    voc = os.path.join(REPO, "tests", "fixtures", "port_eval", "voc")
    (tmp_path / f"{name}_data.yaml").write_text(TINY_DATA.format(voc=voc, lr=lr, model=model))
    (tmp_path / f"{name}.yaml").write_text(f"dataset : VOC\nmodel : {model}\nVOC : {name}_data.yaml\n"
                                           f"savename : {name}\n")
    return str(tmp_path / f"{name}.yaml")


def cli(tmp_path, *args, **popen):
    cmd = [sys.executable, "-m", "pytorch_object_detection_tpu_torch.cli.train", *args]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # one intra-op thread, as in-process
    if popen:
        return subprocess.Popen(cmd, cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
    return subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_cli_synthetic_matches_the_jax_generator_and_resumes(tmp_path):
    # the JAX CLI's --synthetic generator (cli/train.py), as written there
    rng_np = np.random.default_rng(0)
    imgs = rng_np.integers(0, 255, (2, 128, 128, 3), np.uint8)
    gen = synthetic_batches(2, (128, 128), 20)
    for _ in range(3):
        n = rng_np.integers(1, 8)
        boxes = np.full((2, 32, 4), -1.0, np.float32)
        labels = np.full((2, 32), -1, np.int32)
        cxy = rng_np.uniform(0.1, 0.9, (2, n, 2)) * np.array((128, 128))
        wh = rng_np.uniform(0.05, 0.4, (2, n, 2)) * np.array((128, 128))
        boxes[:, :n, :2] = np.maximum(cxy - wh / 2, 0)
        boxes[:, :n, 2:] = np.minimum(cxy + wh / 2, np.array((128, 128)) - 1)
        labels[:, :n] = rng_np.integers(1, 21, (2, n))
        got = next(gen)
        assert got[0].tobytes() == imgs.tobytes() and got[1].tobytes() == boxes.tobytes()
        assert got[2].tobytes() == labels.tobytes()

    cfg = tiny_config(tmp_path)
    run = cli(tmp_path, "--config", cfg, "--device", "cpu", "--synthetic", "--steps", "2", "--log-every", "1000")
    assert run.returncode == 0, run.stdout + run.stderr
    assert "training done: step 2" in run.stdout
    assert os.listdir(tmp_path / "checkpoint" / "tiny") == ["step_00000002.pt"]
    run = cli(tmp_path, "--config", cfg, "--device", "cpu", "--synthetic", "--steps", "3", "--log-every", "100",
              "--resume", str(tmp_path / "checkpoint" / "tiny"))
    assert run.returncode == 0, run.stdout + run.stderr
    assert "at step 2" in run.stdout and "training done: step 3" in run.stdout
    assert sorted(os.listdir(tmp_path / "checkpoint" / "tiny")) == ["step_00000002.pt", "step_00000003.pt"]


def test_cli_checkpoints_and_exits_on_sigterm(tmp_path):
    proc = cli(tmp_path, "--config", tiny_config(tmp_path), "--device", "cpu", "--synthetic", "--steps", "100000",
               "--log-every", "100000", popen=True)
    try:
        lines = []
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            if line.startswith("training HISFCOS") or not line:
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines) + out
    assert proc.returncode == 0, out
    assert "signal 15: checkpointing" in out
    saved = os.listdir(tmp_path / "checkpoint" / "tiny")
    assert len(saved) == 1 and saved[0].startswith("step_"), saved
    model = build_model("HISFCOS", 20, 64, frozen_stages=1, device="cpu")
    state = trainer.create_train_state(model, {}, True, 1)
    checkpoints.restore_checkpoint(str(tmp_path / "checkpoint" / "tiny"), state)
    assert state.step == int(saved[0][5:13]) >= 1


def test_cli_halts_on_a_non_finite_loss(tmp_path):
    run = cli(tmp_path, "--config", tiny_config(tmp_path, lr=1e30), "--device", "cpu", "--synthetic", "--steps",
              "8", "--log-every", "100")
    assert run.returncode == 1, run.stdout + run.stderr
    assert "NON-FINITE loss at step" in run.stdout
    assert not os.path.exists(tmp_path / "checkpoint" / "tiny")  # the diverged weights are not saved


def test_cli_dataset_and_ring_loader_paths(tmp_path):
    """One step through DetectionLoader + HostAugment + the device
    preprocess, and one through RingTileLoader + the device resize, on the
    committed eight-image VOC tree; the fixture's training config loads."""
    cfg = tiny_config(tmp_path)
    for extra, name in (((), "loader"), (("--ring-loader",), "ring")):
        run = cli(tmp_path, "--config", cfg, "--device", "cpu", "--steps", "1", "--log-every", "1000",
                  "--checkpoint-dir", name, *extra)
        assert run.returncode == 0, run.stdout + run.stderr
        assert "training done: step 1" in run.stdout
        assert os.listdir(tmp_path / name / "tiny") == ["step_00000001.pt"]
    fixture = port_config.load_config(os.path.join(REPO, "tests", "fixtures", "port_eval", "voc_train.yaml"))
    block = port_config.model_block(fixture)
    assert fixture["model"]["name"] == "HISFCOS" and block["batch_size"] == 8 and block["Epoch"] >= 2
    assert fixture["dataset_setting"]["type"] == "test" and port_config.canvas_hw(fixture) == (512, 512)


def test_cli_refusals(tmp_path):
    run = cli(tmp_path, "--config", tiny_config(tmp_path), "--synthetic", "--steps", "1")
    assert run.returncode == 1 and "no CUDA device" in run.stderr  # the card by default; none here
    # RETINANET, refused until the anchor families were ported, now trains a synthetic step on the CPU
    run = cli(tmp_path, "--config", tiny_config(tmp_path, "anchor", model="RETINANET"), "--device", "cpu",
              "--synthetic", "--steps", "1", "--log-every", "1000")
    assert run.returncode == 0 and "training RETINANET on cpu" in run.stdout, run.stdout + run.stderr
    assert "training done: step 1" in run.stdout


def test_metric_writer_opens_at_first_write(tmp_path):
    from pytorch_object_detection_tpu_torch.utils.metrics import MetricWriter

    w = MetricWriter(str(tmp_path / "runs"))
    assert not os.path.exists(tmp_path / "runs")
    w.close()
