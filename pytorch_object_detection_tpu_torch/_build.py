"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
library lands in ``build/`` inside this package, under a name that hashes
the sources, the headers and the flags, so a changed source never loads a
stale build.  Nothing is built when a module is imported: the first wrapper
call that launches a kernel builds it.

Usage::

    from pytorch_object_detection_tpu_torch._build import load_library
    lib = load_library("nms.cu", ["-fmad=false"])
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# sm_90a: Hopper with its architecture-specific instructions (wgmma,
# setmaxnreg); the kernels here need only sm_90 but later ones will not
BASE_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# one lock per library (a source and its -D flags): different libraries
# build in parallel threads, each builds once
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
# library name (the source and its -D flags) -> (seconds spent in nvcc,
# nvcc's stderr incl. ptxas -v); empty seconds when the library was found
# already built
build_log: Dict[str, Tuple[float, str]] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under PyTorch's CUDA home (which reads
    ``$CUDA_HOME``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _digest(source: Path, flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for path in [source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def load_library(source: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` with ``extra_flags`` (once per content and
    flags) and return the loaded library.  ``build_log`` keys it by the
    source, followed by any ``-D`` flags."""
    src = CSRC_DIR / source
    flags = [*BASE_FLAGS, *extra_flags]
    out = BUILD_DIR / f"{src.stem}-{_digest(src, flags)}.so"
    name = " ".join([source, *(f for f in extra_flags if f.startswith("-D"))])
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if out.exists():
            build_log[name] = (0.0, "")
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent process sees all of it or none
            build_log[name] = (time.perf_counter() - t0, proc.stderr)
        return ctypes.CDLL(str(out))
