"""ctypes bindings for the port's native host runtime.

The port's copy of ``pytorch_object_detection_tpu/native/lib.py`` and
``build.py``, over copies of their C++ sources, built as two libraries so
that VOC AP never needs libjpeg:

  * the ops library (``detection_ops.cpp``): VOC and COCO matching and the
    exact greedy NMS, no dependency;
  * the JPEG library (``jpeg_loader.cpp``, ``-ljpeg``): decode straight into
    a fixed uint8 tile, and a threaded batch decode; grayscale, RGB, CMYK
    and YCCK streams, the last two converted to RGB as PIL converts them.

The JPEG library links the system's libjpeg where its ``jpeglib.h`` is
installed (``-ljpeg``).  On a machine with none, it links the ABI-62
libjpeg-turbo shared object an installed Pillow wheel bundles
(``pillow.libs/libjpeg-*.so.62*``, found by path: PIL is not imported),
compiled against the ABI-62 headers in ``native/jpeg62``
(:func:`jpeg_link`); the loaded library checks that header and shared
object agree.

Each is built with ``g++`` at first use into ``build/`` inside this package
(git-ignored), under a name that hashes the source and the flags, written
to a temporary file and moved into place with ``os.replace`` (a process
loading it sees all of it or none).  A library that fails to build or to
load raises ``RuntimeError`` with the compiler's output: no caller falls
back quietly, where the JAX ``_load`` returns ``None``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "build"
BASE_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
ABI_VERSION = 3  # native_abi_version() of detection_ops.cpp

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_build_lock = threading.Lock()


def build_library(source: str, libs=()) -> Path:
    """Compile ``native/<source>`` into ``build/`` (once per content and
    flags) and return the library's path; raises ``RuntimeError`` with
    g++'s output where the build fails."""
    src = NATIVE_DIR / source
    cmd_flags = [*BASE_FLAGS, *libs]
    digest = hashlib.sha256(src.read_bytes() + "\0".join(cmd_flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    with _build_lock:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = ["g++", *BASE_FLAGS, str(src), "-o", str(tmp), *libs]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as err:
                raise RuntimeError(f"native build of {source} failed: {' '.join(cmd)}: {err}") from err
            if proc.returncode != 0:
                raise RuntimeError(f"native build of {source} failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent process sees all of it or none
    return out


@functools.lru_cache(maxsize=None)
def ops_lib() -> ctypes.CDLL:
    """The matching and NMS library (built at first use)."""
    lib = ctypes.CDLL(str(build_library("detection_ops.cpp")))
    lib.voc_match.argtypes = [_f32p, ctypes.c_int, _f32p, ctypes.c_int, ctypes.c_float, _u8p]
    lib.voc_match.restype = None
    lib.coco_match.argtypes = [_f32p, _u8p, _u8p, ctypes.c_int, _f32p, _u8p, ctypes.c_int, _f32p, ctypes.c_int,
                               _u8p, _u8p]
    lib.coco_match.restype = None
    lib.nms_cpu.argtypes = [_f32p, _u8p, ctypes.c_int, ctypes.c_float, _u8p]
    lib.nms_cpu.restype = None
    lib.native_abi_version.argtypes = []
    lib.native_abi_version.restype = ctypes.c_int
    if lib.native_abi_version() != ABI_VERSION:
        raise RuntimeError(f"native ops library ABI {lib.native_abi_version()}, expected {ABI_VERSION}")
    return lib


def _system_jpeg_headers() -> bool:
    """Whether g++ finds the system's ``jpeglib.h``."""
    try:
        proc = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                              input="#include <cstdio>\n#include <jpeglib.h>\n", capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"native build of jpeg_loader.cpp: g++ did not run: {err}") from err
    return proc.returncode == 0


def _wheel_libjpeg() -> Optional[Path]:
    """The ABI-62 libjpeg shared object an installed Pillow wheel bundles, or
    None (found by path: PIL is not imported)."""
    import importlib.util

    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    site = Path(list(spec.submodule_search_locations)[0]).parent
    found = sorted(site.glob("pillow.libs/libjpeg*.so.62*")) + sorted(site.glob("Pillow.libs/libjpeg*.so.62*"))
    return found[0] if found else None


@functools.lru_cache(maxsize=None)
def jpeg_link(system: Optional[bool] = None):
    """``(flags, what)``: how the JPEG library links libjpeg.  The system's
    (``-ljpeg``) where g++ finds its ``jpeglib.h``; else the ABI-62
    libjpeg-turbo of an installed Pillow wheel against the headers in
    ``native/jpeg62``.  ``system`` forces one of the two (tests).  Raises
    ``RuntimeError`` where there is no libjpeg to link."""
    if system is None:
        system = _system_jpeg_headers()
    if system:
        return ("-ljpeg", "-lpthread"), "the system libjpeg (-ljpeg)"
    so = _wheel_libjpeg()
    if so is None:
        raise RuntimeError("native build of jpeg_loader.cpp: no libjpeg: the system has no jpeglib.h and no "
                           "installed Pillow wheel bundles an ABI-62 libjpeg (pillow.libs/libjpeg-*.so.62*)")
    return (f"-I{NATIVE_DIR / 'jpeg62'}", str(so), f"-Wl,-rpath,{so.parent}", "-lpthread"), \
        f"{so.name} (ABI 62, from the installed Pillow wheel) against native/jpeg62"


@functools.lru_cache(maxsize=None)
def jpeg_lib(system: Optional[bool] = None) -> ctypes.CDLL:
    """The JPEG decode library (built at first use; links libjpeg as
    :func:`jpeg_link` says; ``system`` forces the system's or the wheel's)."""
    lib = ctypes.CDLL(str(build_library("jpeg_loader.cpp", jpeg_link(system)[0])))
    lib.jpeg_selftest.argtypes = [_i32p]
    lib.jpeg_selftest.restype = ctypes.c_int
    version = np.zeros(1, np.int32)
    if lib.jpeg_selftest(version.ctypes.data_as(_i32p)) != 0:
        raise RuntimeError(f"the JPEG library was compiled for libjpeg ABI {int(version[0])}, which the linked "
                           f"libjpeg ({jpeg_link(system)[1]}) does not take")
    lib.jpeg_peek.argtypes = [_u8p, ctypes.c_size_t, _i32p]
    lib.jpeg_peek.restype = ctypes.c_int
    lib.jpeg_decode_tile.argtypes = [_u8p, ctypes.c_size_t, _u8p, ctypes.c_int, ctypes.c_int, _i32p]
    lib.jpeg_decode_tile.restype = ctypes.c_int
    lib.jpeg_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
                                      ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_int, _i32p, ctypes.c_int, _i32p]
    lib.jpeg_decode_batch.restype = None
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def voc_match_native(gt_boxes: np.ndarray, pred_boxes: np.ndarray, iou_threshold: float) -> np.ndarray:
    """TP flags for score-sorted predictions of one (image, class)."""
    gt = np.ascontiguousarray(gt_boxes, np.float32)
    pred = np.ascontiguousarray(pred_boxes, np.float32)
    tp = np.zeros(len(pred), np.uint8)
    ops_lib().voc_match(_fptr(gt), len(gt), _fptr(pred), len(pred), ctypes.c_float(iou_threshold), _u8ptr(tp))
    return tp.astype(bool)


def coco_match_native(gt_boxes: np.ndarray, gt_ignore: np.ndarray, det_boxes: np.ndarray, det_out: np.ndarray,
                      thresholds: np.ndarray, gt_crowd: Optional[np.ndarray] = None):
    """(matched, ignored) ``[T, D]`` bool: COCO-protocol matching of score-sorted detections."""
    gt = np.ascontiguousarray(gt_boxes, np.float32)
    gi = np.ascontiguousarray(gt_ignore, np.uint8)
    gc = np.ascontiguousarray(np.zeros(len(gt), np.uint8) if gt_crowd is None else gt_crowd, np.uint8)
    det = np.ascontiguousarray(det_boxes, np.float32)
    do = np.ascontiguousarray(det_out, np.uint8)
    thr = np.ascontiguousarray(thresholds, np.float32)
    t, d = len(thr), len(det)
    matched = np.zeros((t, d), np.uint8)
    ignored = np.zeros((t, d), np.uint8)
    ops_lib().coco_match(_fptr(gt), _u8ptr(gi), _u8ptr(gc), len(gt), _fptr(det), _u8ptr(do), d, _fptr(thr), t,
                         _u8ptr(matched), _u8ptr(ignored))
    return matched.astype(bool), ignored.astype(bool)


def nms_cpu_native(boxes: np.ndarray, valid: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Keep flags of the exact greedy NMS over score-sorted boxes."""
    b = np.ascontiguousarray(boxes, np.float32)
    v = np.ascontiguousarray(valid, np.uint8)
    keep = np.zeros(len(b), np.uint8)
    ops_lib().nms_cpu(_fptr(b), _u8ptr(v), len(b), ctypes.c_float(iou_threshold), _u8ptr(keep))
    return keep.astype(bool)


def _as_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray)):
        return bytes(data)
    with open(data, "rb") as f:  # path-like
        return f.read()


def jpeg_size_native(data) -> Optional[tuple]:
    """``(h, w)`` of one JPEG (bytes or path) from its header alone; ``None``
    where libjpeg cannot read the header."""
    buf = np.frombuffer(_as_bytes(data), np.uint8)
    hw = np.zeros(2, np.int32)
    if jpeg_lib().jpeg_peek(_u8ptr(buf), buf.size, hw.ctypes.data_as(_i32p)) != 0:
        return None
    return int(hw[0]), int(hw[1])


def jpeg_decode_native(data) -> Optional[np.ndarray]:
    """Full-size RGB decode of one JPEG (bytes or path: RGB, grayscale, CMYK
    or YCCK, the last two converted as PIL converts them); ``None`` where
    libjpeg cannot read the stream (not a JPEG, corrupt)."""
    data = _as_bytes(data)
    size = jpeg_size_native(data)
    if size is None:
        return None
    h, w = size
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    hw = np.zeros(2, np.int32)
    rc = jpeg_lib().jpeg_decode_tile(_u8ptr(buf), buf.size, _u8ptr(out), h, w, hw.ctypes.data_as(_i32p))
    return out if rc == 0 else None


def jpeg_decode_tile_native(data, tile_hw) -> Optional[tuple]:
    """Decode one JPEG straight into a fixed uint8 tile (``data.pipeline.
    decode_to_tile`` semantics: content top-left, one replicated edge row
    and column, oversize content cropped to the tile).  Returns ``(tile
    [th, tw, 3] u8, (h, w))``, or ``None`` where the decoder declines."""
    th, tw = tile_hw
    buf = np.frombuffer(_as_bytes(data), np.uint8)
    tile = np.empty((th, tw, 3), np.uint8)
    hw = np.zeros(2, np.int32)
    if jpeg_lib().jpeg_decode_tile(_u8ptr(buf), buf.size, _u8ptr(tile), th, tw, hw.ctypes.data_as(_i32p)) != 0:
        return None
    return tile, (int(hw[0]), int(hw[1]))


def jpeg_decode_batch_native(datas, tile_hw, n_threads: int = 0, out_tiles: Optional[np.ndarray] = None,
                             out_hw: Optional[np.ndarray] = None):
    """Threaded batch decode into one contiguous ``[N, th, tw, 3]`` u8 array
    (one ctypes call; the C++ thread pool runs without the GIL).  Returns
    ``(tiles, hw [N, 2] i32, ok [N] bool)``; a declined image has
    ``ok=False`` and an undefined tile.  ``out_tiles``/``out_hw``:
    preallocated C-contiguous destinations of exactly those shapes and
    dtypes (a loader's ring slots)."""
    th, tw = tile_hw
    bufs = [np.frombuffer(_as_bytes(d), np.uint8) for d in datas]
    n = len(bufs)
    tiles = np.empty((n, th, tw, 3), np.uint8) if out_tiles is None else out_tiles
    hw = np.zeros((n, 2), np.int32) if out_hw is None else out_hw
    if tiles.shape != (n, th, tw, 3) or tiles.dtype != np.uint8 or not tiles.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out_tiles must be C-contiguous uint8 {(n, th, tw, 3)}; got {tiles.dtype} {tiles.shape}")
    if hw.shape != (n, 2) or hw.dtype != np.int32 or not hw.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out_hw must be C-contiguous int32 {(n, 2)}; got {hw.dtype} {hw.shape}")
    status = np.zeros(n, np.int32)
    ptrs = (ctypes.c_void_p * n)(*[b.ctypes.data for b in bufs])
    lens = (ctypes.c_size_t * n)(*[b.size for b in bufs])
    jpeg_lib().jpeg_decode_batch(ptrs, lens, n, _u8ptr(tiles), th, tw, hw.ctypes.data_as(_i32p),
                                 n_threads if n_threads > 0 else (os.cpu_count() or 1),
                                 status.ctypes.data_as(_i32p))
    return tiles, hw, status == 0
