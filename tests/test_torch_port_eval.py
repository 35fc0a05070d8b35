"""VOC evaluation from the dataset: the port against the JAX package (CPU).

The host modules the port keeps its own copies of (``core/config.py``,
``native/``, ``eval/voc_map.py``, ``data/decode.py``, ``data/voc.py``), the
loaders and the device resize (``data/pipeline.py``), ``evaluate_voc`` and
the ``eval_voc`` CLI, on the VOC fixture of ``tests/test_data.py`` (five
JPEGs of 320x240 to 400x280, one ``dog`` and one difficult ``cat`` each)
at a 128x128 canvas:

  * config: every YAML under ``config/`` loads to the JAX dict;
  * native: matching, NMS, decode and decode into a tile equal the JAX
    library's;
  * VOC AP: the native and numpy matchers give the JAX function's APs;
  * data: both loaders yield the JAX loaders' batches byte for byte
    (shuffled, padded, sharded);
  * device resize: within one uint8 step of the JAX function on at most
    ``RESIZE_SHARE`` of the values, scales and content sizes exact;
  * evaluate_voc: the same per-class AP from a pipeline that returns the
    ground truth (exactly) and from the float pipeline at f32 on the same
    weights (to 1e-6);
  * nms_impl and the CLI.

The JAX package's native library is built by whichever test first needs it
and written straight to its path (ROADMAP "tests/test_native.py may skip
itself"): ``torch_port_fixtures.jax_native`` loads it again where a
concurrent build left it half written.
"""
from __future__ import annotations

import glob
import hashlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_object_detection_tpu.core import config as jax_config
from pytorch_object_detection_tpu.data import pipeline as jax_pipeline
from pytorch_object_detection_tpu.data.voc import VOCDataset as JaxVOCDataset
from pytorch_object_detection_tpu.eval import evaluator as jax_evaluator
from pytorch_object_detection_tpu.eval import voc_map as jax_voc_map
from pytorch_object_detection_tpu.ops.postprocess import Detections as JaxDetections
from pytorch_object_detection_tpu_torch.core import config as port_config
from pytorch_object_detection_tpu_torch.data import decode, pipeline
from pytorch_object_detection_tpu_torch.data.voc import VOCDataset, parse_voc_xml
from pytorch_object_detection_tpu_torch.eval import evaluator, voc_map
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.native import lib as native
from pytorch_object_detection_tpu_torch.nn.resnet_int8 import calibrate_resnet50
from pytorch_object_detection_tpu_torch.ops.postprocess import Detections, resolve_nms_impl
from pytorch_object_detection_tpu_torch.train.checkpoints import load_flax_variables
from test_data import _write_voc_fixture
from torch_port_fixtures import FEATURES, NUM_CLASSES, STRIDES, jax_model, jax_native, perturbed_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (128, 128)
TILE = (512, 512)  # the raw tiles bound the fixture's images, as 512 bounds VOC's
N_IMAGES = 5
# the device resize sums its f32 products in another order than XLA's, so a
# value at .5 may round the other way: one step on a few in 10^4 values
# (5.5e-4 of them at 512x512 on seeded tiles, 1.1e-4 at 256x384); at most
# one step, on at most this share
RESIZE_SHARE = 2e-3


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc") / "VOC2007")
    _write_voc_fixture(root, n=N_IMAGES)
    return root


# ---------------------------------------------------------------------------
# core/config.py
# ---------------------------------------------------------------------------
def _config_cases():
    """(main yaml, dataset yaml or None) for every file under config/: a main
    file as it is; a dataset file behind a main file for each model block."""
    import yaml

    cases = []
    for path in sorted(glob.glob(os.path.join(REPO, "config", "*.yaml"))):
        with open(path) as f:
            doc = yaml.safe_load(f)
        if "dataset" in doc:
            cases.append((os.path.basename(path), None))
        else:
            cases += [(os.path.basename(path), name) for name, block in doc.items()
                      if isinstance(block, dict) and "channel" in block]
    return cases


@pytest.mark.parametrize("name,model", _config_cases())
def test_config_matches_jax(name, model, tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    path = os.path.join("config", name)
    if model is not None:  # a dataset file: a main file that selects it and the model block
        path = str(tmp_path / "main.yaml")
        with open(path, "w") as f:
            f.write(f"dataset : VOC\nmodel : {model}\nVOC : {os.path.join(REPO, 'config', name)}\n")
    want, got = jax_config.load_config(path), port_config.load_config(path)
    assert got == want
    if "stride" in port_config.model_block(got):
        for fn in ("model_block", "strides", "input_hw", "num_classes", "level_shapes", "canvas_hw"):
            assert getattr(port_config, fn)(got) == getattr(jax_config, fn)(want), fn
    if "range" in port_config.model_block(got):
        assert port_config.limit_ranges(got) == jax_config.limit_ranges(want)


# ---------------------------------------------------------------------------
# native/: the port's two libraries against the JAX one
# ---------------------------------------------------------------------------
def _boxes(rng, n, lo=0.0, hi=300.0):
    xy = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + rng.uniform(5, 80, (n, 2)).astype(np.float32)], 1)


@pytest.mark.parametrize("seed", range(4))
def test_native_ops_match_jax(seed):
    jn = jax_native()
    rng = np.random.default_rng(seed)
    gt, pred = _boxes(rng, 6), _boxes(rng, 40)
    pred[:6] = gt + rng.normal(0, 4, gt.shape).astype(np.float32)  # some hits, some near the threshold
    for thr in (0.3, 0.5, 0.7):
        np.testing.assert_array_equal(native.voc_match_native(gt, pred, thr), jn.voc_match_native(gt, pred, thr))
    valid = rng.uniform(size=40) > 0.2
    np.testing.assert_array_equal(native.nms_cpu_native(pred, valid, 0.5), jn.nms_cpu_native(pred, valid, 0.5))
    ignore, out = rng.uniform(size=6) > 0.7, rng.uniform(size=40) > 0.8
    thr = np.linspace(0.5, 0.95, 10).astype(np.float32)
    crowd = rng.uniform(size=6) > 0.8
    for got, want in zip(native.coco_match_native(gt, ignore, pred, out, thr, crowd),
                         jn.coco_match_native(gt, ignore, pred, out, thr, crowd)):
        np.testing.assert_array_equal(got, want)


def test_native_jpeg_matches_jax(voc_root):
    jn = jax_native()
    paths = sorted(glob.glob(os.path.join(voc_root, "JPEGImages", "*.jpg")))
    for path in paths:
        np.testing.assert_array_equal(native.jpeg_decode_native(path), jn.jpeg_decode_native(path))
        np.testing.assert_array_equal(decode.decode_image(path), jn.jpeg_decode_native(path))
        for tile_hw in ((512, 512), (200, 256)):  # the second crops: content larger than the tile
            got, want = native.jpeg_decode_tile_native(path, tile_hw), jn.jpeg_decode_tile_native(path, tile_hw)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
            tile, hw = decode.decode_image_to_tile(path, tile_hw)
            np.testing.assert_array_equal(tile, want[0])
    blobs = [open(p, "rb").read() for p in paths]
    got, want = native.jpeg_decode_batch_native(blobs, TILE, 2), jn.jpeg_decode_batch_native(blobs, TILE, 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # a stream the decoder declines raises, naming it (no PIL fallback)
    assert native.jpeg_decode_native(b"not a jpeg") is None
    with pytest.raises(ValueError, match="declines"):
        decode.decode_image(b"not a jpeg")
    with pytest.raises(ValueError, match="declines"):
        decode.decode_image_to_tile(b"\x89PNG\r\n", TILE)
    _, _, ok = native.jpeg_decode_batch_native([blobs[0], b"junk"], TILE, 2)
    assert ok.tolist() == [True, False]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A library that does not build raises with the compiler's output."""
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.build_library("broken.cpp")


# ---------------------------------------------------------------------------
# eval/voc_map.py
# ---------------------------------------------------------------------------
def _predictions(seed, n_images=12):
    """Seeded GT and predictions over 20 classes: jittered copies of the GT
    (hits and misses near the threshold), duplicates and random boxes."""
    rng = np.random.default_rng(seed)
    gts, glabs, boxes, labs, scores = [], [], [], [], []
    for _ in range(n_images):
        g = _boxes(rng, int(rng.integers(0, 6)))
        gl = rng.integers(1, 21, len(g)).astype(np.int32)
        p = np.concatenate([g + rng.normal(0, 6, g.shape).astype(np.float32), g[:2], _boxes(rng, 10)])
        pl = np.concatenate([gl, gl[:2], rng.integers(1, 21, 10)]).astype(np.int32)
        gts.append(g)
        glabs.append(gl)
        boxes.append(p)
        labs.append(pl)
        scores.append(rng.uniform(0.05, 1.0, len(p)).astype(np.float32))
    return gts, glabs, boxes, labs, scores


@pytest.mark.parametrize("seed", range(3))
def test_voc_ap_matches_jax_with_both_matchers(seed):
    jax_native()  # the JAX function's own matcher is the native one where it is built
    args = _predictions(seed)
    want = jax_voc_map.eval_voc_ap(*args)
    for native_matcher in (True, False):
        got = voc_map.eval_voc_ap(*args, native=native_matcher)
        assert got == want
        assert voc_map.mean_ap(got) == jax_voc_map.mean_ap(want)
    assert 0.0 < voc_map.mean_ap(want) < 1.0
    # the two matchers give the same flags, class by class
    gts, _, boxes, _, _ = args
    for g, p in zip(gts, boxes):
        for thr in (0.3, 0.5):
            np.testing.assert_array_equal(voc_map._greedy_match(g, p, thr, True), voc_map._greedy_match(g, p, thr, False))


# ---------------------------------------------------------------------------
# data/voc.py and the loaders
# ---------------------------------------------------------------------------
def _datasets(root, raw):
    kw = dict(raw_tiles=True, tile_hw=TILE) if raw else {}
    return JaxVOCDataset(root, "trainval", CANVAS, **kw), VOCDataset(root, "trainval", CANVAS, **kw)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert g.image_ids == w.image_ids and g.n_valid == w.n_valid
        for field in ("images", "boxes", "labels", "scales", "content_w", "content_h"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("raw", [False, True], ids=["canvas", "raw_tiles"])
def test_voc_dataset_matches_jax(voc_root, raw):
    jds, ds = _datasets(voc_root, raw)
    assert len(ds) == len(jds) == N_IMAGES and ds.class_names == jds.class_names
    for i in range(N_IMAGES):
        got, want = ds[i], jds[i]
        np.testing.assert_array_equal(got.image, want.image)
        np.testing.assert_array_equal(got.boxes, want.boxes)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert (got.scale, got.image_id, tuple(got.content_hw)) == (want.scale, want.image_id, tuple(want.content_hw))
    xml = os.path.join(voc_root, "Annotations", "img000.xml")
    for difficult in (False, True):
        for a, b in zip(parse_voc_xml(xml, difficult), __import__(
                "pytorch_object_detection_tpu.data.voc", fromlist=["parse_voc_xml"]).parse_voc_xml(xml, difficult)):
            np.testing.assert_array_equal(a, b)


LOADER_CASES = {
    "plain": dict(batch_size=2, shuffle=False, drop_last=False),
    "padded": dict(batch_size=2, shuffle=False, drop_last=False, pad_last=True),
    "shuffled": dict(batch_size=2, shuffle=True, seed=3, drop_last=True),
    "shard0": dict(batch_size=2, shuffle=True, seed=1, drop_last=False, pad_last=True, process_count=2,
                   process_index=0),
    "shard1": dict(batch_size=2, shuffle=False, drop_last=False, pad_last=True, process_count=2, process_index=1),
}


@pytest.mark.parametrize("raw", [False, True], ids=["canvas", "raw_tiles"])
@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_detection_loader_matches_jax(voc_root, raw, case):
    jds, ds = _datasets(voc_root, raw)
    kw = dict(LOADER_CASES[case], max_boxes=8, num_workers=2)
    want = list(jax_pipeline.DetectionLoader(jds, **kw))
    loader = pipeline.DetectionLoader(ds, **kw)
    got = list(loader)
    _assert_batches_equal(got, want)
    assert len(loader) == len(got)
    if kw.get("pad_last"):
        assert all(b.images.shape[0] == 2 for b in got) and got[-1].n_valid in (1, 2)


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_ring_loader_matches_jax(voc_root, case):
    jax_native()
    jds, ds = _datasets(voc_root, raw=True)
    kw = dict(LOADER_CASES[case], max_boxes=8, decode_threads=2, depth=2)
    # copies: a ring slot is reused depth - 1 batches later
    copy = lambda b: b._replace(images=b.images.copy())
    want = [copy(b) for b in jax_pipeline.RingTileLoader(jds, **kw)]
    got = [copy(b) for b in pipeline.RingTileLoader(ds, **kw)]
    _assert_batches_equal(got, want)
    # the ring loader's batches are the DetectionLoader's over the raw-tile dataset
    det = list(pipeline.DetectionLoader(ds, **{k: v for k, v in kw.items() if k not in ("decode_threads", "depth")},
                                        num_workers=2))
    _assert_batches_equal(got, det)


def test_loaders_raise_on_a_declined_image(voc_root, tmp_path):
    """An image the native decoder declines raises ValueError naming it, from
    the loader's producer thread through the consumer (no PIL fallback, no
    hang)."""
    import shutil

    root = str(tmp_path / "VOC2007")
    shutil.copytree(voc_root, root)
    with open(os.path.join(root, "JPEGImages", "img003.jpg"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n not a jpeg")
    _, ds = _datasets(root, raw=True)
    with pytest.raises(ValueError, match="img003"):
        list(pipeline.RingTileLoader(ds, 2, shuffle=False, drop_last=False, decode_threads=2))
    with pytest.raises(ValueError, match="img003"):
        list(pipeline.DetectionLoader(ds, 2, shuffle=False, drop_last=False, num_workers=2))


def test_loader_shard_follows_torch_distributed(voc_root, monkeypatch):
    """Without explicit process_count/index the shard is torch.distributed's
    world size and rank where a process group is initialised, else one."""
    import torch.distributed as dist

    _, ds = _datasets(voc_root, raw=False)
    assert pipeline.process_shard(None, None) == (1, 0)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert pipeline.process_shard(None, None) == (2, 1)
    assert pipeline.process_shard(3, None) == (3, 1)
    ids = [i for b in pipeline.DetectionLoader(ds, 1, shuffle=False, drop_last=False) for i in b.image_ids]
    assert ids == [f"img{i:03d}" for i in range(1, N_IMAGES, 2)]


def test_decode_to_tile_matches_jax():
    rng = np.random.default_rng(0)
    for h, w in ((30, 40), (64, 64), (70, 20), (1, 1), (100, 90)):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        got, want = pipeline.decode_to_tile(img, (64, 64)), jax_pipeline.decode_to_tile(img, (64, 64))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


# ---------------------------------------------------------------------------
# make_device_resize
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("canvas", [(512, 512), (128, 128), (256, 384)])
def test_device_resize_matches_jax(canvas):
    rng = np.random.default_rng(sum(canvas))
    tiles, hw = [], []
    for h, w in ((300, 500), (500, 333), (128, 128), (37, 91), (512, 512), (375, 500)):  # down- and upsampled
        tile, size = jax_pipeline.decode_to_tile(rng.integers(0, 256, (h, w, 3), np.uint8), TILE)
        tiles.append(tile)
        hw.append(size)
    tiles, hw = np.stack(tiles), np.asarray(hw, np.int32)
    want = [np.asarray(v) for v in jax_pipeline.make_device_resize(canvas)(jnp.asarray(tiles), jnp.asarray(hw))]
    got = [v.numpy() for v in pipeline.make_device_resize(canvas)(torch.from_numpy(tiles), torch.from_numpy(hw))]
    np.testing.assert_array_equal(got[1], want[1])  # the scales, f32
    np.testing.assert_array_equal(got[2], want[2])  # the content sizes
    assert got[0].dtype == np.uint8 and got[0].shape == want[0].shape
    d = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32))
    share = float((d > 0).mean())
    print(f"device resize {canvas}: {share:.3g} of the values one step from the JAX function's")
    assert d.max() <= 1 and share <= RESIZE_SHARE
    # outside the content the canvas is zero
    for i, (nh, nw) in enumerate(got[2]):
        assert not got[0][i, nh:].any() and not got[0][i, :, nw:].any()


# ---------------------------------------------------------------------------
# evaluate_voc
# ---------------------------------------------------------------------------
def _key(images):
    return [hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest() for im in images]


def _gt_table(root, raw):
    """Image bytes (canvas or raw tile) -> (original boxes, labels, scale)."""
    jds, _ = _datasets(root, raw)
    table = {}
    for i in range(len(jds)):
        s = jds[i]
        table[_key([s.image])[0]] = (s.boxes / s.scale, s.labels, s.scale)
    return table


def _gt_detections(table, images, scales):
    """Fixed-size detections that are each image's ground truth at ``scales``."""
    k = 4
    boxes, classes, scores = np.zeros((len(images), k, 4), np.float32), np.ones((len(images), k), np.int32), \
        np.zeros((len(images), k), np.float32)
    valid = np.zeros((len(images), k), bool)
    for i, key in enumerate(_key(images)):
        b, lab, _ = table[key]
        n = len(b)
        boxes[i, :n], classes[i, :n], scores[i, :n], valid[i, :n] = b * scales[i], lab, 0.9, True
    return boxes, classes, scores, valid


@pytest.mark.parametrize("raw", [False, True], ids=["canvas", "device_resize"])
def test_evaluate_voc_gt_pipeline_matches_jax(voc_root, raw):
    """A pipeline that returns the ground truth gives AP 1 on every class
    with GT, and the same per-class AP in both evaluators; with the device
    resize the port's pipeline scales the GT by the resize's own scales, so
    ``_collect``'s unscale by the loader's scales must undo it."""
    table = _gt_table(voc_root, raw)
    jds, ds = _datasets(voc_root, raw)

    def jax_gt(params, stats, images, *extra):
        scales = [table[k][2] for k in _key(np.asarray(images))]
        b, c, s, v = _gt_detections(table, np.asarray(images), scales)
        return JaxDetections(s, c, b, v)

    resize = pipeline.make_device_resize(CANVAS)

    def port_gt(images, src_hw=None):
        scales = resize(images, src_hw)[1].numpy() if raw else [table[k][2] for k in _key(images.numpy())]
        b, c, s, v = _gt_detections(table, images.numpy(), scales)
        return Detections(*(torch.from_numpy(a) for a in (s, c, b, v)))

    want = jax_evaluator.evaluate_voc(None, None, None, jds, batch_size=2, pipeline=jax_gt, verbose=False)
    got = evaluator.evaluate_voc(None, ds, batch_size=2, pipeline=port_gt, verbose=False)
    assert got["per_class_ap"] == want["per_class_ap"]
    assert got["per_class_ap"][12] == 1.0  # dog; the difficult cat is filtered out of the GT
    assert got["num_images"] == want["num_images"] == N_IMAGES
    # the ring loader yields the same batches
    if raw:
        ring = evaluator.evaluate_voc(None, ds, batch_size=2, pipeline=port_gt, verbose=False, use_ring_loader=True)
        assert ring["per_class_ap"] == got["per_class_ap"]


def _write_annotations(root, src_root, preds):
    """A VOC tree at ``root`` with ``src_root``'s images, annotated with
    ``preds``: per image id, (boxes, labels) in original 0-based coords."""
    from pytorch_object_detection_tpu_torch.data.voc import VOC_CLASSES

    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub))
    for img_id, (boxes, labels) in preds.items():
        os.symlink(os.path.join(src_root, "JPEGImages", f"{img_id}.jpg"),
                   os.path.join(root, "JPEGImages", f"{img_id}.jpg"))
        objs = "".join(
            f"<object><name>{VOC_CLASSES[lab - 1]}</name><difficult>0</difficult><bndbox>"
            + "".join(f"<{k}>{float(v) + 1.0!r}</{k}>" for k, v in zip(("xmin", "ymin", "xmax", "ymax"), b))
            + "</bndbox></object>" for b, lab in zip(boxes, labels))
        with open(os.path.join(root, "Annotations", f"{img_id}.xml"), "w") as f:
            f.write(f"<annotation>{objs}</annotation>")
    with open(os.path.join(root, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(sorted(preds)))


def test_evaluate_voc_float_pipeline_matches_jax(voc_root, tmp_path, capsys):
    """The float pipeline at f32 on the same weights: the same per-class AP
    to 1e-6, and the JAX function's printed lines.  Random weights find no
    fixture dog, so the APs are also taken against a second annotation of
    the same images: the JAX pipeline's own three best detections each
    (at these weights one class, whose AP is 0.9076 in both)."""
    params, stats = perturbed_variables(seed=21)
    jpipe = jax_evaluator.make_eval_pipeline(jax_model(), STRIDES, CANVAS, compute_dtype=jnp.float32)
    model = build_model("HISFCOS", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    pipe = evaluator.make_eval_pipeline(model, STRIDES, CANVAS, compute_dtype=torch.float32)
    jds, _ = _datasets(voc_root, raw=False)
    col = jax_evaluator.collect_voc_predictions(jpipe, params, stats, jds, batch_size=N_IMAGES)
    pseudo = {img_id: (b[:3], c[:3]) for b, c, img_id in zip(col[2], col[3], col[5])}
    _write_annotations(str(tmp_path / "VOC2007"), voc_root, pseudo)
    for root, verbose in ((voc_root, True), (str(tmp_path / "VOC2007"), False)):
        jds, ds = _datasets(root, raw=False)
        want = jax_evaluator.evaluate_voc(jax_model(), params, stats, jds, batch_size=N_IMAGES, pipeline=jpipe,
                                          verbose=verbose)
        jax_lines = capsys.readouterr().out.splitlines()
        got = evaluator.evaluate_voc(model, ds, batch_size=N_IMAGES, pipeline=pipe, verbose=verbose)
        lines = capsys.readouterr().out.splitlines()
        assert sorted(got["per_class_ap"]) == sorted(want["per_class_ap"])
        for cls, ap in want["per_class_ap"].items():
            assert abs(got["per_class_ap"][cls] - ap) <= 1e-6, cls
        assert abs(got["mAP"] - want["mAP"]) <= 1e-6
        if verbose:
            assert lines[:-1] == jax_lines[:-1] and len(lines) == 21  # "ap for <class> is ..."
            assert lines[-1].split("(")[0] == jax_lines[-1].split("(")[0] and lines[-1].endswith("img/s)")
    print(f"float pipeline against its own detections: AP {got['per_class_ap']!r}, JAX {want['per_class_ap']!r}")
    assert 0.3 < max(want["per_class_ap"].values()) <= 1.0


def test_calibration_on_device_resized_canvases(voc_root):
    """--int8 --device-resize calibrates on the device-resized canvases of the
    first batch, where the JAX CLI calibrates on cv2's (the card has no
    cv2).  The backbone's activation scales from the two, on the same
    model (the port's calibration equals the JAX one on the same input,
    tests/test_torch_port_int8.py): the device resize moves a value by at
    most one step, and the abs-max taps by under 1 %."""
    params, stats = perturbed_variables(seed=22)
    model = build_model("HISFCOS", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    jds, ds = _datasets(voc_root, raw=True)
    canvas_ds, _ = _datasets(voc_root, raw=False)
    raw = next(iter(pipeline.DetectionLoader(ds, 4, shuffle=False, drop_last=False, num_workers=2)))
    host = next(iter(pipeline.DetectionLoader(canvas_ds, 4, shuffle=False, drop_last=False, num_workers=2)))
    src_hw = torch.from_numpy(np.stack([raw.content_h, raw.content_w], 1).astype(np.int32))
    dev_canvas = pipeline.make_device_resize(CANVAS)(torch.from_numpy(raw.images), src_hw)[0]
    d = (dev_canvas.int() - torch.from_numpy(host.images).int()).abs()
    print(f"device resize vs cv2 canvases: max {int(d.max())} steps, {float((d > 0).float().mean()):.3g} differ")
    assert int(d.max()) <= 1
    from pytorch_object_detection_tpu_torch.cli.eval_voc import calib_images

    taps_dev = calibrate_resnet50(model.backbone, calib_images(dev_canvas), torch.float32)
    taps_cv2 = calibrate_resnet50(model.backbone, calib_images(torch.from_numpy(host.images)), torch.float32)
    rel = max(abs(float(taps_dev[k]) / float(taps_cv2[k]) - 1.0) for k in taps_cv2)
    print(f"activation scales, device resize vs cv2: max relative difference {rel:.4g} over {len(taps_cv2)} taps")
    assert sorted(taps_dev) == sorted(taps_cv2) and rel < 0.01


# ---------------------------------------------------------------------------
# nms_impl, mesh and the CLI
# ---------------------------------------------------------------------------
def test_nms_impl_mapping_and_errors():
    assert resolve_nms_impl("auto", torch.device("cpu")) == "fixpoint"
    assert resolve_nms_impl("auto", torch.device("cuda")) == "pallas"
    assert resolve_nms_impl("fixpoint", torch.device("cuda")) == "fixpoint"
    assert resolve_nms_impl("pallas", torch.device("cuda")) == "pallas"
    with pytest.raises(ValueError, match="kernel A"):
        resolve_nms_impl("pallas", torch.device("cpu"))
    with pytest.raises(ValueError, match="nms_impl"):
        resolve_nms_impl("xla", torch.device("cpu"))
    model = build_model("HISFCOS", NUM_CLASSES, FEATURES, device="cpu")
    calib = torch.zeros(1, *CANVAS, 3)
    with pytest.raises(ValueError, match="kernel A"):
        evaluator.make_eval_pipeline_int8(model, calib, STRIDES, CANVAS, nms_impl="pallas")
    with pytest.raises(ValueError, match="nms_impl"):
        evaluator.make_eval_pipeline_int8(model, calib, STRIDES, CANVAS, nms_impl="fast")
    with pytest.raises(NotImplementedError, match="item 11"):
        evaluator.make_eval_pipeline_int8(model, calib, STRIDES, CANVAS, mesh=object())
    with pytest.raises(NotImplementedError, match="item 11"):
        evaluator.evaluate_voc(model, None, pipeline=lambda x: x, mesh=object())


def _cli_config(tmp_path, root):
    data = tmp_path / "voc.yaml"
    data.write_text(f"dataset_setting:\n  class_num : 20\n  test_07 : '{root}'\n  input : [128, 128]\n"
                    f"HISFCOS :\n  channel : {FEATURES}\n  stride : [8, 16, 32, 64, 128]\n")
    main = tmp_path / "main.yaml"
    main.write_text(f"dataset : VOC\nmodel : HISFCOS\nVOC : {data}\n")
    return str(main)


@pytest.mark.parametrize("flags", [[], ["--int8", "--device-resize"]], ids=["float", "int8_device_resize"])
def test_eval_voc_cli_on_cpu(voc_root, tmp_path, flags):
    cmd = [sys.executable, "-m", "pytorch_object_detection_tpu_torch.cli.eval_voc", "--config",
           _cli_config(tmp_path, voc_root), "--split", "trainval", "--batch-size", "2", "--device", "cpu", *flags]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))  # one torch thread, as in-process
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[-1].startswith("mAP=====>") and "img/s" in lines[-1], proc.stdout[-2000:]
    assert sum(line.startswith("ap for ") for line in lines) == 20


def test_eval_voc_cli_refuses_what_waits():
    cmd = [sys.executable, "-m", "pytorch_object_detection_tpu_torch.cli.eval_voc", "--torch-checkpoint", "x.pth"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "--torch-checkpoint is not supported" in proc.stderr
