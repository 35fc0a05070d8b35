#!/usr/bin/env python
"""Write the committed JPEG fixture tree of the port's evaluation tests and
of ``chip_smoke.py``: the same JPEGs, with their PIL decodes recorded, are
decoded by the CPU tests and on the card.

    python scripts/make_port_fixtures.py [OUT]      (default tests/fixtures/port_eval)

It calls the repo's generators unchanged, then adds what COCO's own image
sets hold and the generators do not write:

  * ``OUT/voc``: ``make_synthetic_voc.py --train 0 --val 8`` (the ``test``
    split, 8 images of 320-500 px a side, 20 classes);
  * ``OUT/coco``: ``make_synthetic_coco.py --train 0 --val 4`` (4 frames of
    480-800 x 640-1280: the device resize scales them down onto the CPU
    tests' small canvases and up, by 1.19-1.75, onto 896x1408), plus one
    grayscale and one CMYK JPEG written with PIL (frames of the VOC
    renderer, their classes as the first 20 categories) with their
    annotations, and one ``iscrowd: 1`` annotation on the first frame; the
    category ids renumbered to COCO 2017's 80 ids (1-90 with gaps), so the
    contiguous remap is not the identity;
  * ``OUT/decode/ycck.jpg``: a small CMYK JPEG written with PIL and marked
    YCCK (its Adobe transform byte set to 2: PIL writes no YCCK), so that
    libjpeg's YCCK path runs; decode checks only, in no dataset;
  * ``OUT/manifest.json``: each JPEG's path under OUT, PIL mode, Adobe
    transform (0 CMYK, 2 YCCK, absent elsewhere), shape and
    the SHA-256 of its PIL RGB decode (``Image.open(p).convert("RGB")``),
    the reference the native decode is held to on the CPU and on the card;
  * ``OUT/{voc,coco}.yaml`` (main configs) and ``OUT/{voc,coco}_data.yaml``
    (dataset blocks) for ``podt-torch-eval-voc`` / ``podt-torch-eval-coco``
    run from the repo root: HISFCOS(20, 256) at 512x512 and HISFCOS(80, 256)
    at 896x1408.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(SCRIPTS)
DEFAULT_OUT = os.path.join("tests", "fixtures", "port_eval")
QUALITY = 92  # the generators' JPEG quality
# COCO 2017's 80 category ids, in order
COCO_IDS = (list(range(1, 12)) + list(range(13, 26)) + [27, 28] + list(range(31, 45)) + list(range(46, 66))
            + [67, 70] + list(range(72, 83)) + list(range(84, 91)))

MAIN_YAML = "dataset : {ds}\nmodel : HISFCOS\n{ds} : {data}\namp : True\nddp_enabled : False\nsavename : port_eval\n"
HISFCOS_BLOCK = """HISFCOS:
  CannelofBackbone: [512, 1024, 2048]
  channel: 256
  stride : [8, 16, 32, 64, 128]
  range :
    - [-1, 64]
    - [64, 128]
    - [128, 256]
    - [256, 512]
    - [512, 999999]
"""


def run_generator(script: str, out: str, val: int) -> None:
    subprocess.run([sys.executable, os.path.join(SCRIPTS, script), out, "--train", "0", "--val", str(val)],
                   check=True, cwd=REPO)


def add_coco_extras(coco_root: str) -> None:
    """The grayscale and CMYK frames and the crowd annotation."""
    from PIL import Image

    sys.path.insert(0, SCRIPTS)
    from make_synthetic_voc import make_image

    ann_path = os.path.join(coco_root, "instances_val.json")
    with open(ann_path) as f:
        coco = json.load(f)
    rng = np.random.default_rng(16)
    next_img = max(im["id"] for im in coco["images"]) + 1
    next_ann = max(a["id"] for a in coco["annotations"]) + 1
    for mode in ("L", "CMYK"):
        arr, boxes, labels = make_image(rng)
        fname = f"{next_img:012d}.jpg"
        Image.fromarray(arr).convert(mode).save(os.path.join(coco_root, "val", fname), quality=QUALITY)
        coco["images"].append({"id": next_img, "file_name": fname, "width": arr.shape[1], "height": arr.shape[0]})
        for b, c in zip(boxes, labels):
            coco["annotations"].append({
                "id": next_ann, "image_id": next_img, "category_id": int(c) + 1,
                "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]), float(b[3] - b[1])],
                "iscrowd": 0, "area": float((b[2] - b[0]) * (b[3] - b[1])),
            })
            next_ann += 1
        next_img += 1
    first = coco["images"][0]
    cat = next(a["category_id"] for a in coco["annotations"] if a["image_id"] == first["id"])
    w, h = first["width"] / 3.0, first["height"] / 3.0
    coco["annotations"].append({"id": next_ann, "image_id": first["id"], "category_id": cat,
                                "bbox": [0.0, 0.0, w, h], "iscrowd": 1, "area": w * h})
    for item in coco["categories"] + coco["annotations"]:
        key = "id" if "name" in item else "category_id"
        item[key] = COCO_IDS[item[key] - 1]
    with open(ann_path, "w") as f:
        json.dump(coco, f)


def write_ycck(out: str) -> None:
    import io

    from PIL import Image

    sys.path.insert(0, SCRIPTS)
    from make_synthetic_voc import make_image

    arr, _, _ = make_image(np.random.default_rng(17))
    buf = io.BytesIO()
    Image.fromarray(arr[:160, :240]).convert("CMYK").save(buf, "JPEG", quality=QUALITY)
    data = buf.getvalue()
    at = data.index(b"Adobe") + 11  # "Adobe", version, flags0, flags1, then the transform byte
    os.makedirs(os.path.join(out, "decode"))
    with open(os.path.join(out, "decode", "ycck.jpg"), "wb") as f:
        f.write(data[:at] + b"\x02" + data[at + 1:])


def write_manifest(out: str) -> dict:
    from PIL import Image

    files = {}
    for dirpath, _dirs, names in sorted(os.walk(out)):
        for name in sorted(names):
            if not name.endswith(".jpg"):
                continue
            path = os.path.join(dirpath, name)
            im = Image.open(path)
            rgb = np.asarray(im.convert("RGB"))
            files[os.path.relpath(path, out)] = {
                "mode": im.mode, "shape": list(rgb.shape), **({"adobe_transform": im.info["adobe_transform"]}
                                                              if "adobe_transform" in im.info else {}),
                "sha256": hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()}
    manifest = {"decode": "PIL Image.open(path).convert('RGB'), uint8 [H, W, 3] C order", "files": files}
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def write_configs(out: str) -> None:
    rel = os.path.relpath(os.path.abspath(out), REPO)
    voc_data = (f"dataset_setting:\n  class_num : 20\n  train_07 : '{rel}/voc'\n  test_07 : '{rel}/voc'\n"
                f"  input : [512, 512]\n  max_boxes : 16\n" + HISFCOS_BLOCK)
    coco_data = (f"dataset_setting:\n  class_num : 80\n  ValData : '{rel}/coco/val'\n"
                 f"  ValAnnotation : '{rel}/coco/instances_val.json'\n  input : [800, 1333]\n  max_boxes : 16\n"
                 + HISFCOS_BLOCK)
    for ds, data in (("VOC", voc_data), ("COCO", coco_data)):
        name = ds.lower()
        with open(os.path.join(out, f"{name}_data.yaml"), "w") as f:
            f.write(data)
        with open(os.path.join(out, f"{name}.yaml"), "w") as f:
            f.write(MAIN_YAML.format(ds=ds, data=f"{rel}/{name}_data.yaml"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    if os.path.exists(out):
        shutil.rmtree(out)
    os.makedirs(out)
    run_generator("make_synthetic_voc.py", os.path.join(out, "voc"), 8)
    os.remove(os.path.join(out, "voc", "ImageSets", "Main", "trainval.txt"))  # the empty train split
    run_generator("make_synthetic_coco.py", os.path.join(out, "coco"), 4)
    os.rmdir(os.path.join(out, "coco", "train"))
    os.remove(os.path.join(out, "coco", "instances_train.json"))
    add_coco_extras(os.path.join(out, "coco"))
    write_ycck(out)
    manifest = write_manifest(out)
    write_configs(out)
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _s, ns in os.walk(out) for n in ns)
    print(f"wrote {len(manifest['files'])} JPEGs under {out}: {size} bytes in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
