"""COCO evaluation from JPEGs: the port against the JAX package (CPU).

The port's copies of ``eval/coco_map.py`` and ``data/coco.py``, the native
decode of grayscale, CMYK and YCCK JPEGs, ``evaluate_coco`` and the
``eval_coco`` CLI, on the committed fixture tree ``tests/fixtures/port_eval``
(``scripts/make_port_fixtures.py``: four synthetic COCO frames of 511x646
to 752x1047, a grayscale and a CMYK frame, one crowd annotation, COCO 2017
category ids; eight VOC images; a YCCK file):

  * COCOEvaluator, the native and the Python matcher: the JAX evaluator's
    12 numbers exactly, on the hand-derived cases of
    ``tests/test_coco_spec_goldens.py`` and on seeded hostile fixtures in
    the form of ``tests/test_eval_metrics.py``'s, with
    ``tests/cocoeval_oracle.py`` as a third opinion; ``native=True`` raises
    where the library does not build (no fallback);
  * COCODataset: the canvas path byte for byte; the raw-tile path against
    ``decode_to_tile`` of the JAX decode, with equal scale, boxes, crowds
    and category maps; ``tile_hw`` from the JSON; an oversized image raises;
  * the native decode equals PIL's (the JAX path) on RGB, grayscale, CMYK
    and YCCK files written here, and the committed manifest;
  * evaluate_coco: the JAX function's stats exactly from a pipeline that
    returns the ground truth (canvas and device resize, a detection on the
    crowd region absorbed), to 1e-6 from the float pipeline at f32 on the
    same weights with the same results-JSON ids, and the int8 pipeline
    (``nms_impl="fixpoint"``) through both evaluators;
  * the CLI by subprocess on the committed tree, float and ``--int8
    --device-resize``; RetinaNet and SSD300 refused; no card, exit 1.
"""
from __future__ import annotations

import copy
import functools
import hashlib
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cocoeval_oracle import OracleEval
from pytorch_object_detection_tpu.data import pipeline as jax_pipeline
from pytorch_object_detection_tpu.data.coco import COCODataset as JaxCOCODataset
from pytorch_object_detection_tpu.data.decode import decode_image as jax_decode_image
from pytorch_object_detection_tpu.eval import coco_map as jax_coco_map
from pytorch_object_detection_tpu.eval import evaluator as jax_evaluator
from pytorch_object_detection_tpu.ops.postprocess import Detections as JaxDetections
from pytorch_object_detection_tpu_torch.data import decode, pipeline
from pytorch_object_detection_tpu_torch.data.coco import COCODataset
from pytorch_object_detection_tpu_torch.eval import coco_map, evaluator
from pytorch_object_detection_tpu_torch.models.registry import build_model
from pytorch_object_detection_tpu_torch.native import lib as native
from pytorch_object_detection_tpu_torch.ops.postprocess import Detections
from pytorch_object_detection_tpu_torch.train.checkpoints import load_flax_variables
from torch_port_fixtures import FEATURES, NUM_CLASSES, STRIDES, jax_model, jax_native, perturbed_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "port_eval")
IMAGE_DIR = os.path.join(FIXTURE, "coco", "val")
ANNOTATIONS = os.path.join(FIXTURE, "coco", "instances_val.json")
COCO_CANVAS = (896, 1408)
CANVAS = (128, 256)  # the small canvas of the pipeline runs (the COCO canvas's shape, cut)
N_IMAGES = 6
TILE_HW = (752, 1047)  # the largest height and width in the fixture's JSON


# ---------------------------------------------------------------------------
# eval/coco_map.py
# ---------------------------------------------------------------------------
L1 = np.array([1])


def _golden_cases():
    """The inputs of tests/test_coco_spec_goldens.py's hand-derived cases:
    per case, (num_classes, [add_image arguments])."""
    sq = np.array([[0.0, 0, 100, 100]])
    two = np.array([[0.0, 0, 100, 100], [200.0, 0, 300, 100]])
    return {
        "interpolation": (1, [(1, two, np.array([1, 1]), np.array([[0.0, 0, 100, 100], [400.0, 0, 500, 100]]),
                               np.array([1, 1]), np.array([0.9, 0.8]), None)]),
        "fp_after_recall": (1, [(1, sq, L1, np.concatenate([sq, sq]), np.array([1, 1]), np.array([0.9, 0.8]),
                                 None)]),
        "iou_ladder": (1, [(1, sq, L1, np.array([[0.0, 0, 100, 62.0]]), L1, np.array([0.9]), None)]),
        "greedy_max_iou": (1, [(1, np.array([[0.0, 0, 100, 75], [0.0, 80, 100, 180]]), np.array([1, 1]), sq, L1,
                                np.array([0.9]), None)]),
        "crowd_iod": (1, [(1, sq, L1, sq, L1, np.array([0.8]), None),
                          (2, np.array([[0.0, 0, 500, 500]]), L1, np.array([[200.0, 200, 300, 300]]), L1,
                           np.array([0.9]), np.array([True]))]),
        "absent_class": (3, [(1, np.array([[0.0, 0, 50, 50]]), L1, np.array([[0.0, 0, 50, 50]]), L1,
                              np.array([0.9]), None)]),
        "maxdets": (1, [(1, two, np.array([1, 1]), two, np.array([1, 1]), np.array([0.9, 0.8]), None)]),
        "score_order": (1, [(1, sq, L1, np.concatenate([sq, sq]), np.array([1, 1]), np.array([0.3, 0.9]), None)]),
        "area_ranges": (1, [(1, np.array([[0.0, 0, 10, 10]]), L1, np.array([[0.0, 0, 10, 10]]), L1,
                             np.array([0.9]), None)]),
    }


def _hostile_case(seed: int):
    """tests/test_eval_metrics.py's hostile fixture at ``seed``: crowds,
    tiny to huge boxes, exact score ties, 130 detections in one
    image-class, empty images, a class never in the GT."""
    rng = np.random.RandomState(seed)
    n_classes = 5

    def rand_boxes(n, sizes):
        wh = rng.choice(sizes, (n, 2)) * rng.uniform(0.6, 1.5, (n, 2))
        xy = rng.uniform(0, 500, (n, 2))
        return np.concatenate([xy, xy + wh], axis=1).astype(np.float64)

    images = []
    for img in range(40):
        n_gt = rng.randint(0, 8)
        gt = rand_boxes(n_gt, [8, 24, 64, 200])
        gl = rng.randint(1, n_classes, n_gt)
        crowd = rng.rand(n_gt) < 0.2
        n_det = 130 if img == 0 else rng.randint(0, 20)
        if n_gt and n_det:
            base = gt[rng.randint(0, n_gt, n_det)]
            det = np.where(rng.rand(n_det, 1) < 0.5, base + rng.uniform(-10, 10, (n_det, 4)),
                           rand_boxes(n_det, [8, 64, 200]))
        else:
            det = rand_boxes(n_det, [8, 64, 200])
        dl = rng.randint(1, n_classes + 1, n_det)
        if img == 0:
            dl[:] = 1
        images.append((img, gt, gl, det, dl, np.round(rng.rand(n_det), 2), crowd))
    return n_classes, images


def _summaries(n_classes, images, native_matcher):
    want_ev = jax_coco_map.COCOEvaluator(n_classes)
    got_ev = coco_map.COCOEvaluator(n_classes, native=native_matcher)
    for img, gt, gl, det, dl, sc, crowd in images:
        want_ev.add_image(img, gt, gl, det, dl, sc, gt_crowd=crowd)
        got_ev.add_image(img, gt, gl, det, dl, sc, gt_crowd=crowd)
    return got_ev.summarize(), want_ev.summarize()


@pytest.mark.parametrize("native_matcher", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case", sorted(_golden_cases()))
def test_coco_evaluator_matches_jax_on_goldens(case, native_matcher):
    jax_native()  # the JAX evaluator's own matcher is the native one where it is built
    got, want = _summaries(*_golden_cases()[case], native_matcher)
    assert got == want and len(got) == 12


@pytest.mark.parametrize("native_matcher", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("seed", [7, 11])
def test_coco_evaluator_matches_jax_and_oracle_on_hostile_fixtures(seed, native_matcher):
    jax_native()
    n_classes, images = _hostile_case(seed)
    got, want = _summaries(n_classes, images, native_matcher)
    assert got == want
    oracle = OracleEval(n_classes)
    for _img, gt, gl, det, dl, sc, crowd in images:
        oracle.add_image(gt_boxes=gt.tolist(), gt_labels=gl.tolist(), gt_crowd=crowd.tolist(),
                         det_boxes=det.tolist(), det_labels=dl.tolist(), det_scores=sc.tolist())
    for k, v in oracle.summarize().items():
        assert abs(got[k] - v) < 1e-9, (k, got[k], v)
    assert 0.0 < got["AP"] < 1.0


def test_coco_evaluator_native_raises_when_the_build_fails(tmp_path, monkeypatch):
    """native=True matches in the native library or raises: no quiet fall
    back to the Python loop (the JAX evaluator swallows the exception)."""
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "detection_ops.cpp").write_text("int f( {\n")
    native.ops_lib.cache_clear()
    try:
        ev = coco_map.COCOEvaluator(1)
        ev.add_image(1, np.array([[0.0, 0, 10, 10]]), L1, np.array([[0.0, 0, 10, 10]]), L1, np.array([0.9]))
        with pytest.raises(RuntimeError, match="detection_ops.cpp"):
            ev.summarize()
        python = coco_map.COCOEvaluator(1, native=False)
        python.add_image(1, np.array([[0.0, 0, 10, 10]]), L1, np.array([[0.0, 0, 10, 10]]), L1, np.array([0.9]))
        assert python.summarize()["AP"] == 1.0
    finally:
        native.ops_lib.cache_clear()


# ---------------------------------------------------------------------------
# the native decode against PIL
# ---------------------------------------------------------------------------
def _pil_rgb(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _ycck(cmyk_jpeg: bytes) -> bytes:
    """The CMYK stream marked YCCK: the Adobe APP14 transform byte set to 2
    (PIL writes no YCCK), so both decoders take libjpeg's YCCK -> CMYK path."""
    at = cmyk_jpeg.index(b"Adobe") + 11  # "Adobe", version, flags0, flags1, then the transform
    assert cmyk_jpeg[at] == 0
    return cmyk_jpeg[:at] + b"\x02" + cmyk_jpeg[at + 1:]


def _written(mode: str, seed: int) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(17, 300)), int(rng.integers(17, 300))
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), np.uint8)  # blocky content, then noise
    arr = np.clip(np.kron(base, np.ones((8, 8, 1)))[:h, :w] + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    pil_mode = "CMYK" if mode == "YCCK" else mode
    kw = {"subsampling": int(rng.integers(0, 3))} if pil_mode == "RGB" else {}
    Image.fromarray(arr).convert(pil_mode).save(buf, "JPEG", quality=int(rng.integers(60, 98)), **kw)
    return _ycck(buf.getvalue()) if mode == "YCCK" else buf.getvalue()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", ["RGB", "L", "CMYK", "YCCK"])
def test_native_decode_matches_pil(mode, seed):
    """Full, tile and batch decode equal PIL's convert("RGB") (the JAX
    package's path for CMYK and YCCK, its PIL fallback) bit for bit."""
    from PIL import Image

    data = _written(mode, seed)
    im = Image.open(io.BytesIO(data))
    assert im.mode == ("L" if mode == "L" else "CMYK" if mode in ("CMYK", "YCCK") else "RGB")
    if mode == "YCCK":
        assert im.info.get("adobe_transform") == 2
    want = _pil_rgb(data)
    got = decode.decode_image(data)
    off = got.astype(np.int32) - want
    print(f"{mode} {want.shape}: {float((off != 0).mean()):.3g} of the values off, largest {int(np.abs(off).max())}")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax_decode_image(data), want)  # the JAX package reads it through PIL
    for tile_hw in ((320, 320), (want.shape[0] + 1, want.shape[1])):
        tile, hw = decode.decode_image_to_tile(data, tile_hw)
        ref_tile, ref_hw = jax_pipeline.decode_to_tile(want, tile_hw)
        np.testing.assert_array_equal(tile, ref_tile)
        assert hw == ref_hw
    tiles, hws, ok = native.jpeg_decode_batch_native([data, data], (320, 320), 2)
    assert ok.all()
    np.testing.assert_array_equal(tiles[1], jax_pipeline.decode_to_tile(want, (320, 320))[0])


def test_fixture_tree_matches_its_manifest():
    """Every committed JPEG decodes natively (full, tile, batch) and through
    PIL to the manifest's SHA-256; the tree holds RGB, gray, CMYK and YCCK
    files."""
    with open(os.path.join(FIXTURE, "manifest.json")) as f:
        files = json.load(f)["files"]
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    blobs, shapes = [], []
    for rel, info in sorted(files.items()):
        with open(os.path.join(FIXTURE, rel), "rb") as f:
            data = f.read()
        assert sha(_pil_rgb(data)) == info["sha256"], rel
        full = decode.decode_image(data)
        assert list(full.shape) == info["shape"] and sha(full) == info["sha256"], rel
        tile, (h, w) = decode.decode_image_to_tile(data, (800, 1280))
        assert sha(tile[:h, :w]) == info["sha256"], rel
        blobs.append(data)
        shapes.append(full.shape[:2])
    tiles, hws, ok = native.jpeg_decode_batch_native(blobs, (800, 1280), 3)
    assert ok.all() and [tuple(v) for v in hws] == shapes
    for (rel, info), t, (h, w) in zip(sorted(files.items()), tiles, hws):
        assert sha(t[:h, :w]) == info["sha256"], rel
    assert sorted({info["mode"] for info in files.values()}) == ["CMYK", "L", "RGB"]
    assert sorted(info["adobe_transform"] for info in files.values() if "adobe_transform" in info) == [0, 2]
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _s, ns in os.walk(FIXTURE) for n in ns)
    print(f"fixture tree: {len(files)} JPEGs, {size} bytes")
    assert size < 2.5e6


@pytest.mark.parametrize("system", [True, False], ids=["system_libjpeg", "wheel_libjpeg"])
def test_jpeg_library_links_either_libjpeg(system, monkeypatch):
    """The system's libjpeg, and the ABI-62 libjpeg-turbo of the installed
    Pillow wheel against the committed headers (what a machine with no
    libjpeg headers builds): both decode the fixture tree to its manifest,
    CMYK and gray included."""
    link, what = native.jpeg_link(system)
    assert ("-ljpeg" in link) == system, what
    built = native.jpeg_lib(system)
    monkeypatch.setattr(native, "jpeg_lib", lambda: built)
    with open(os.path.join(FIXTURE, "manifest.json")) as f:
        files = json.load(f)["files"]
    for rel, info in sorted(files.items()):
        got = native.jpeg_decode_native(os.path.join(FIXTURE, rel))
        assert hashlib.sha256(got.tobytes()).hexdigest() == info["sha256"], (what, rel)


def test_jpeg_library_without_libjpeg_raises(monkeypatch):
    monkeypatch.setattr(native, "_wheel_libjpeg", lambda: None)
    native.jpeg_link.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no libjpeg"):
            native.jpeg_link(False)
    finally:
        native.jpeg_link.cache_clear()


# ---------------------------------------------------------------------------
# data/coco.py
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def annotations(tmp_path_factory):
    """The fixture's annotations plus a degenerate box (min_size) and an
    image with no annotation (filter_empty), pointing at existing files."""
    with open(ANNOTATIONS) as f:
        coco = json.load(f)
    first = coco["images"][0]
    coco["images"].append(dict(first, id=999999))
    coco["annotations"].append({"id": 999999, "image_id": first["id"], "category_id": 3,
                                "bbox": [10.0, 10.0, 0.5, 40.0], "iscrowd": 0, "area": 20.0})
    path = tmp_path_factory.mktemp("coco") / "instances.json"
    path.write_text(json.dumps(coco))
    return str(path)


def _assert_samples_equal(got, want):
    np.testing.assert_array_equal(got.image, want.image)
    np.testing.assert_array_equal(got.boxes, want.boxes)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.boxes.dtype == want.boxes.dtype and got.labels.dtype == want.labels.dtype
    assert (got.scale, got.image_id, tuple(got.content_hw)) == (want.scale, want.image_id, tuple(want.content_hw))


@pytest.mark.parametrize("filter_empty", [True, False])
def test_coco_dataset_canvas_path_matches_jax(annotations, filter_empty):
    jds = JaxCOCODataset(IMAGE_DIR, annotations, COCO_CANVAS, filter_empty=filter_empty)
    ds = COCODataset(IMAGE_DIR, annotations, COCO_CANVAS, filter_empty=filter_empty)
    assert len(ds) == len(jds) == N_IMAGES + (0 if filter_empty else 1)
    assert ds.class_names == jds.class_names and len(ds.class_names) == 80
    assert ds.cat_to_contig == jds.cat_to_contig and ds.contig_to_cat == jds.contig_to_cat
    assert ds.images == jds.images
    for i in range(len(ds)):
        _assert_samples_equal(ds[i], jds[i])
    n_crowds = 0
    for info in ds.images:
        for a, b in zip(ds.eval_crowds(info["id"]), jds.eval_crowds(info["id"])):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        n_crowds += len(ds.eval_crowds(info["id"])[1])
    assert n_crowds == 1


def test_coco_dataset_raw_tiles_match_decode_to_tile(annotations):
    """The tile is decode_to_tile of the JAX decode (PIL for the CMYK
    frame); scale, boxes and content size as the canvas path computes them;
    tile_hw defaults to the JSON's largest height and width."""
    jds = JaxCOCODataset(IMAGE_DIR, annotations, COCO_CANVAS)
    ds = COCODataset(IMAGE_DIR, annotations, COCO_CANVAS, raw_tiles=True)
    assert ds.tile_hw == TILE_HW and ds.raw_tiles
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        info = ds.images[i]
        img = jax_decode_image(os.path.join(IMAGE_DIR, info["file_name"]))
        tile, hw = jax_pipeline.decode_to_tile(img, TILE_HW)
        np.testing.assert_array_equal(got.image, tile)
        assert tuple(got.content_hw) == hw == img.shape[:2] == (info["height"], info["width"])
        assert got.scale == want.scale and got.image_id == want.image_id
        np.testing.assert_array_equal(got.boxes, want.boxes)
        np.testing.assert_array_equal(got.labels, want.labels)
    explicit = COCODataset(IMAGE_DIR, annotations, COCO_CANVAS, raw_tiles=True, tile_hw=(800, 1280))
    s = explicit[0]
    assert s.image.shape == (800, 1280, 3) and tuple(s.content_hw) == (752, 1047)


def test_coco_dataset_raises_on_an_image_larger_than_its_tile(annotations):
    ds = COCODataset(IMAGE_DIR, annotations, COCO_CANVAS, raw_tiles=True, tile_hw=(600, 800))
    big = next(i for i, info in enumerate(ds.images) if info["height"] > 600)
    with pytest.raises(ValueError, match=ds.images[big]["file_name"]):
        ds[big]
    with pytest.raises(ValueError, match=ds.images[big]["file_name"]):
        list(pipeline.DetectionLoader(ds, 2, shuffle=False, drop_last=False, num_workers=2))
    with pytest.raises(ValueError, match="augment"):
        COCODataset(IMAGE_DIR, annotations, COCO_CANVAS, raw_tiles=True, augment=lambda img, boxes: (img, boxes))


# ---------------------------------------------------------------------------
# evaluate_coco
# ---------------------------------------------------------------------------
def _key(image):
    return hashlib.sha256(np.ascontiguousarray(image).tobytes()).hexdigest()


@functools.lru_cache(maxsize=None)
def _gt_table(raw: bool, canvas):
    """Image bytes (canvas or raw tile) -> (original boxes, labels, scale,
    crowd boxes, crowd labels)."""
    ds = COCODataset(IMAGE_DIR, ANNOTATIONS, canvas, raw_tiles=raw)
    table = {}
    for i in range(len(ds)):
        s = ds[i]
        table[_key(s.image)] = (s.boxes / s.scale, s.labels, s.scale, *ds.eval_crowds(s.image_id))
    return table


def _gt_detections(table, images, scales):
    """Fixed-size detections: each image's ground truth at ``scales``
    (score 0.5), and a detection on each crowd region scored above them
    (0.9), which the crowd must absorb."""
    k = 12
    n = len(images)
    boxes, classes = np.zeros((n, k, 4), np.float32), np.ones((n, k), np.int32)
    scores, valid = np.zeros((n, k), np.float32), np.zeros((n, k), bool)
    for i, image in enumerate(images):
        b, lab, _, cb, cl = table[_key(image)]
        b, lab = np.concatenate([b, cb]), np.concatenate([lab, cl])
        m = len(b)
        boxes[i, :m], classes[i, :m], valid[i, :m] = b * scales[i], lab, True
        scores[i, :m] = np.where(np.arange(m) < m - len(cl), 0.5, 0.9)
    return boxes, classes, scores, valid


@pytest.mark.parametrize("raw", [False, True], ids=["canvas", "device_resize"])
def test_evaluate_coco_gt_pipeline_matches_jax(raw, tmp_path):
    """A pipeline that returns the ground truth, plus a top-scored detection
    on the crowd region: AP, AP50 and AP75 are 1 and the 12 numbers equal
    the JAX function's (canvas path) exactly; with the device resize the
    pipeline scales by the resize's own scales, which ``_collect`` undoes."""
    canvas = (256, 384)
    table = _gt_table(raw, canvas)
    jds = JaxCOCODataset(IMAGE_DIR, ANNOTATIONS, canvas)
    ds = COCODataset(IMAGE_DIR, ANNOTATIONS, canvas, raw_tiles=raw)
    jax_table = _gt_table(False, canvas)

    def jax_gt(params, stats, images, *extra):
        images = np.asarray(images)
        b, c, s, v = _gt_detections(jax_table, images, [jax_table[_key(im)][2] for im in images])
        return JaxDetections(s, c, b, v)

    resize = pipeline.make_device_resize(canvas)

    def port_gt(images, src_hw=None):
        images = images.numpy()
        scales = resize(torch.from_numpy(images), src_hw)[1].numpy() if raw else \
            [table[_key(im)][2] for im in images]
        b, c, s, v = _gt_detections(table, images, scales)
        return Detections(*(torch.from_numpy(a) for a in (s, c, b, v)))

    want = jax_evaluator.evaluate_coco(None, None, None, jds, batch_size=4, pipeline=jax_gt, verbose=False,
                                       results_json=str(tmp_path / "jax.json"))
    got = evaluator.evaluate_coco(None, ds, batch_size=4, pipeline=port_gt, verbose=False,
                                  results_json=str(tmp_path / "port.json"))
    for k in ("images_per_sec", "num_images"):
        assert got.pop(k) > 0 and want.pop(k) > 0
    assert got == want
    assert got["AP"] == got["AP50"] == got["AP75"] == 1.0
    records = [json.load(open(tmp_path / f"{n}.json")) for n in ("port", "jax")]
    assert [(r["image_id"], r["category_id"], r["score"]) for r in records[0]] == \
        [(r["image_id"], r["category_id"], r["score"]) for r in records[1]]
    assert len(records[0]) == sum(len(v[1]) + len(v[4]) for v in table.values())
    # without the crowd rows the crowd detection is a top-scored FP
    no_crowd = copy.copy(ds)
    no_crowd.eval_crowds = lambda image_id: (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32))
    assert evaluator.evaluate_coco(None, no_crowd, batch_size=4, pipeline=port_gt, verbose=False)["AP"] < 1.0


@functools.lru_cache(maxsize=None)
def _models(seed: int):
    params, stats = perturbed_variables(seed=seed)
    model = build_model("HISFCOS", NUM_CLASSES, FEATURES, device="cpu")
    load_flax_variables(model, params, stats)
    return params, stats, model.eval()


def _pseudo_annotations(path, jax_records, k=3):
    """The fixture's images annotated with the JAX pipeline's ``k`` best
    detections each (random weights find no fixture object), and the
    fixture's crowd row."""
    with open(ANNOTATIONS) as f:
        coco = json.load(f)
    anns = [a for a in coco["annotations"] if a.get("iscrowd")]
    for info in coco["images"]:
        mine = sorted((r for r in jax_records if r["image_id"] == info["id"]), key=lambda r: -r["score"])[:k]
        anns += [{"id": 10 * info["id"] + j, "image_id": info["id"], "category_id": r["category_id"],
                  "bbox": r["bbox"], "iscrowd": 0, "area": r["bbox"][2] * r["bbox"][3]} for j, r in enumerate(mine)]
    coco["annotations"] = anns
    with open(path, "w") as f:
        json.dump(coco, f)


def test_evaluate_coco_float_pipeline_matches_jax(tmp_path, capsys):
    """The float pipeline at f32 on the same weights, canvas path: the 12
    numbers to 1e-6 (evaluate_voc's float test's tolerance) against the
    fixture and against the JAX pipeline's own best detections as GT, the
    JAX function's printed keys, and results JSONs with the same image ids
    and category ids, detection for detection once sorted by score within
    (image, category)."""
    params, stats, model = _models(31)
    jpipe = jax_evaluator.make_eval_pipeline(jax_model(), STRIDES, CANVAS, compute_dtype=jnp.float32)
    pipe = evaluator.make_eval_pipeline(model, STRIDES, CANVAS, compute_dtype=torch.float32)
    pseudo = str(tmp_path / "pseudo.json")
    for ann, verbose in ((ANNOTATIONS, True), (pseudo, False)):
        jds = JaxCOCODataset(IMAGE_DIR, ann, CANVAS, filter_empty=False)
        ds = COCODataset(IMAGE_DIR, ann, CANVAS, filter_empty=False)
        jpath, ppath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
        want = jax_evaluator.evaluate_coco(jax_model(), params, stats, jds, STRIDES, batch_size=N_IMAGES,
                                           pipeline=jpipe, results_json=jpath, verbose=verbose)
        jax_lines = capsys.readouterr().out.splitlines()
        got = evaluator.evaluate_coco(model, ds, STRIDES, batch_size=N_IMAGES, pipeline=pipe, results_json=ppath,
                                      verbose=verbose)
        lines = capsys.readouterr().out.splitlines()
        for k, v in want.items():
            if k != "images_per_sec":
                assert abs(got[k] - v) <= 1e-6, (k, got[k], v)
        if verbose:
            assert [ln.split(":")[0] for ln in lines] == [ln.split(":")[0] for ln in jax_lines]
            assert len(lines) == 14
        jrec, prec = json.load(open(jpath)), json.load(open(ppath))
        assert len(prec) == len(jrec) > 0
        assert all(isinstance(r["image_id"], int) for r in prec)
        # scores within 1e-6 of each other may come out of NMS in either order
        key = lambda r: (r["image_id"], r["category_id"], r["score"])
        jrec, prec = sorted(jrec, key=key), sorted(prec, key=key)
        assert [(r["image_id"], r["category_id"]) for r in prec] == [(r["image_id"], r["category_id"]) for r in jrec]
        assert max(abs(a["score"] - b["score"]) for a, b in zip(prec, jrec)) <= 1e-5
        if ann == ANNOTATIONS:
            _pseudo_annotations(pseudo, jrec)
    print(f"float pipeline against the JAX pipeline's own detections: AP {got['AP']!r} (JAX {want['AP']!r})")
    assert 0.3 < want["AP"] <= 1.0


def test_evaluate_coco_int8_pipeline(tmp_path):
    """The int8 pipeline (make_eval_pipeline_int8's defaults, the plain
    versions on the CPU, nms_impl="fixpoint") through evaluate_coco: the
    same 12 numbers and records as the JAX evaluate_coco scoring the same
    pipeline; with the device resize on raw tiles, finite stats and the
    category ids of the fixture."""
    from pytorch_object_detection_tpu_torch.cli.eval_voc import first_batch_calib

    _, _, model = _models(32)
    ds = COCODataset(IMAGE_DIR, ANNOTATIONS, CANVAS, filter_empty=False)
    jds = JaxCOCODataset(IMAGE_DIR, ANNOTATIONS, CANVAS, filter_empty=False)
    calib = first_batch_calib(ds, 4, CANVAS, torch.device("cpu"))
    pipe = evaluator.make_eval_pipeline_int8(model, calib, STRIDES, CANVAS, nms_impl="fixpoint",
                                             compute_dtype=torch.float32)

    def as_jax(params, stats, images, *extra):
        return JaxDetections(*(t.numpy() for t in pipe(torch.from_numpy(np.array(images)))))

    want = jax_evaluator.evaluate_coco(None, None, None, jds, batch_size=3, pipeline=as_jax, verbose=False,
                                       results_json=str(tmp_path / "jax.json"))
    got = evaluator.evaluate_coco(model, ds, batch_size=3, pipeline=pipe, verbose=False,
                                  results_json=str(tmp_path / "port.json"))
    for k in ("images_per_sec", "num_images"):
        got.pop(k), want.pop(k)
    assert got == want
    assert json.load(open(tmp_path / "port.json")) == json.load(open(tmp_path / "jax.json"))
    raw = COCODataset(IMAGE_DIR, ANNOTATIONS, CANVAS, filter_empty=False, raw_tiles=True)
    calib = first_batch_calib(raw, 4, CANVAS, torch.device("cpu"))
    rpipe = evaluator.make_eval_pipeline_int8(model, calib, STRIDES, CANVAS, nms_impl="fixpoint", device_resize=True,
                                              compute_dtype=torch.float32)
    stats = evaluator.evaluate_coco(model, raw, batch_size=4, pipeline=rpipe, verbose=False,
                                    results_json=str(tmp_path / "raw.json"))
    assert stats["num_images"] == N_IMAGES and all(np.isfinite(v) for v in stats.values())
    cats = {r["category_id"] for r in json.load(open(tmp_path / "raw.json"))}
    assert cats and cats <= set(raw.contig_to_cat.values())


def test_evaluate_coco_mesh_raises():
    """A mesh serves the ranks of a process group (parallel/mesh.py): one
    process without a group refuses it."""
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        evaluator.evaluate_coco(None, None, pipeline=lambda x: x, mesh=object())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _cli_config(tmp_path, model="HISFCOS"):
    data = tmp_path / "coco_data.yaml"
    data.write_text(f"dataset_setting:\n  class_num : 80\n  ValData : '{IMAGE_DIR}'\n"
                    f"  ValAnnotation : '{ANNOTATIONS}'\n  input : [{CANVAS[0]}, {CANVAS[1]}]\n"
                    f"{model} :\n  channel : {FEATURES}\n  stride : [8, 16, 32, 64, 128]\n")
    main = tmp_path / "coco.yaml"
    main.write_text(f"dataset : COCO\nmodel : {model}\nCOCO : {data}\n")
    return str(main)


@pytest.mark.parametrize("flags", [[], ["--int8", "--device-resize"]], ids=["float", "int8_device_resize"])
def test_eval_coco_cli_on_cpu(tmp_path, flags):
    out = tmp_path / "results.json"
    cmd = [sys.executable, "-m", "pytorch_object_detection_tpu_torch.cli.eval_coco", "--config",
           _cli_config(tmp_path), "--batch-size", "4", "--device", "cpu", "--results-json", str(out), *flags]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))  # one torch thread, as in-process
    assert proc.returncode == 0, proc.stderr[-3000:]
    keys = [line.split(":")[0] for line in proc.stdout.splitlines()]
    assert keys[:4] == ["AP", "AP50", "AP75", "AR@100"] and keys[-2:] == ["images_per_sec", "num_images"]
    assert proc.stdout.splitlines()[-1] == f"num_images: {N_IMAGES}"
    assert "pycocotools" not in proc.stdout  # not installed here
    records = json.load(open(out))
    with open(ANNOTATIONS) as f:
        coco = json.load(f)
    assert {r["image_id"] for r in records} <= {im["id"] for im in coco["images"]}
    assert {r["category_id"] for r in records} <= {c["id"] for c in coco["categories"]}


@pytest.mark.parametrize("model", ["RETINANET", "SSD300"])
def test_eval_coco_cli_refuses_what_waits(tmp_path, model, capsys):
    """The anchor families with ``--int8``: RetinaNet evaluates through its
    int8 anchor pipeline; SSD300 is refused with exit 2, as the JAX CLI
    asserts (its int8 path covers the ResNet-50 families)."""
    from pytorch_object_detection_tpu_torch.cli import eval_coco

    args = ["--config", _cli_config(tmp_path, model), "--device", "cpu", "--int8", "--batch-size", "4",
            "--results-json", str(tmp_path / "r.json")]
    if model == "SSD300":
        assert eval_coco.main(args) == 2
        assert "SSD300" in capsys.readouterr().err
        return
    assert eval_coco.main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("AP: ") and lines[-1] == f"num_images: {N_IMAGES}"


def test_eval_coco_cli_needs_the_card(tmp_path, capsys):
    from pytorch_object_detection_tpu_torch.cli import eval_coco

    assert eval_coco.main(["--config", _cli_config(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_port_console_entry_points_resolve():
    """pyproject's podt-torch-* scripts name the port's CLI mains."""
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["podt-torch-eval-coco"] == "pytorch_object_detection_tpu_torch.cli.eval_coco:main"
    for name, target in scripts.items():
        if name.startswith("podt-torch-"):
            mod, fn = target.split(":")
            assert callable(getattr(importlib.import_module(mod), fn)), name
