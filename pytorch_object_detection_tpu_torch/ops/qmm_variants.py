"""K4': K4's int8 GEMM tile with three epilogues, a timing harness, and their plain versions.

K4' (``csrc/qmm_variants.cu``) replaces ``scripts/dev_qmm_variants.py``'s
three Pallas kernels: on the stage-1 conv3 GEMM of a B=64 ResNet-50 at
512x512, ``x [1048576, 64]`` times ``w [64, 256]`` (here ``[256, 64]``, the
port's ``[N, K]``) int8, it times

* ``full``:  ``clip8(relu(acc * a + b + res * 0.5))``,
* ``nores``: ``clip8(relu(acc * a + b))``,
* ``shift``: ``(acc >> 8)`` cast to int8 with two's-complement wrap,

each on K4's 64x64 ``__dp4a`` tile (``csrc/qmm_tile.cuh``, shared with K4),
so the three times show how much of K4 is its epilogue.  ``clip8`` rounds
half to even and clips to +-127.  Run it on the card::

    python3 -m pytorch_object_detection_tpu_torch.ops.qmm_variants

On a CPU tensor :func:`qmm_variant` runs the plain version; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from pytorch_object_detection_tpu_torch.ops.quant import clip8, int_mm

SOURCE = "qmm_variants.cu"
NVCC_FLAGS = ("-fmad=false",)
VARIANTS = ("full", "nores", "shift")
# the JAX script's shape (dev_qmm_variants.py:17): M = 64 * 128 * 128, K = 64, N = 256
SHAPE = (64 * 128 * 128, 64, 256)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load K4'; its C signature is declared here."""
    from pytorch_object_detection_tpu_torch._build import load_library

    lib = load_library(SOURCE, NVCC_FLAGS)
    lib.qmm_variant_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.qmm_variant_launch.restype = ctypes.c_int
    return lib


def qmm_variant_plain(variant: str, x, w, a, b, res=None) -> torch.Tensor:
    """The GEMM and one of the three epilogues in plain PyTorch ops (the reference for K4')."""
    acc = int_mm(x, w)
    if variant == "shift":
        return (acc >> 8).to(torch.int8)  # int32 -> int8 keeps the low byte: the wrap of astype(int8)
    y = acc.float() * a + b
    if variant == "full":
        y = y + res.float() * 0.5
    return clip8(torch.clamp(y, min=0.0))


def qmm_variant(variant: str, x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                res: Optional[torch.Tensor] = None, plain: bool = False) -> torch.Tensor:
    """int8 ``x [M, K]`` x ``w [N, K]^T`` -> int8 ``[M, N]`` with epilogue
    ``variant`` (module docstring); ``res [M, N]`` int8 for ``full`` only.
    ``plain=True`` runs the plain version on any device, for the comparison
    only.  ``qmm_variant.launches`` counts kernel launches."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got {variant!r}")
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x and w must be int8 [M, K] and [N, K]; got {x.dtype} {tuple(x.shape)}, "
                         f"{w.dtype} {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[0]
    for name, v in (("a", a), ("b", b)):
        if v.dtype != torch.float32 or tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be float32 [{n}]; got {v.dtype} {tuple(v.shape)}")
    if (res is not None) != (variant == "full") or (res is not None and (res.dtype != torch.int8
                                                                         or tuple(res.shape) != (m, n))):
        raise ValueError(f"res: int8 [{m}, {n}] for 'full' only; got "
                         f"{None if res is None else (res.dtype, tuple(res.shape))} for {variant!r}")
    if plain or x.device.type == "cpu":
        return qmm_variant_plain(variant, x, w, a, b, res)
    if x.device.type != "cuda":
        raise ValueError(f"K4' runs on CUDA tensors; got {x.device}")
    operands = [x, w, a, b] + ([res] if res is not None else [])
    if any(t.device != x.device for t in operands):
        raise ValueError(f"K4': every operand must be on {x.device}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("K4' takes contiguous operands")
    if k % 16 or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"K4' reads x and w in 16-byte words: K must be a multiple of 16 (got {k}) "
                         "and both must start 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _lib().qmm_variant_launch(VARIANTS.index(variant), x.data_ptr(), w.data_ptr(), a.data_ptr(),
                                        b.data_ptr(), None if res is None else res.data_ptr(), out.data_ptr(), m, n,
                                        k, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K4' launch failed: cudaError {err}")
    qmm_variant.launches += 1
    return out


qmm_variant.launches = 0


def make_inputs(shape: Tuple[int, int, int] = SHAPE, device="cuda", seed: int = 0) -> Dict[str, torch.Tensor]:
    """The script's operands, drawn from ``seed``: x and res uniform in
    [-127, 127), w in [-16, 16), a = |N(0, 1)| * 1e-3, b = N(0, 1)."""
    m, k, n = shape
    g = torch.Generator(device=device).manual_seed(seed)
    i8 = lambda lo, hi, size: torch.randint(lo, hi, size, generator=g, device=device, dtype=torch.int8)
    return dict(x=i8(-127, 127, (m, k)), w=i8(-16, 16, (n, k)),
                a=torch.randn(n, generator=g, device=device).abs() * 1e-3,
                b=torch.randn(n, generator=g, device=device), res=i8(-127, 127, (m, n)))


def run_variants(inp: Dict[str, torch.Tensor], plain: bool = False) -> Dict[str, torch.Tensor]:
    """The three epilogues on one set of operands, one launch each."""
    return {v: qmm_variant(v, inp["x"], inp["w"], inp["a"], inp["b"], inp["res"] if v == "full" else None,
                           plain=plain) for v in VARIANTS}


def main() -> int:
    """Build, check each variant against its plain version, and print the
    three times (ms per launch between CUDA events, median of 5 runs of 20)."""
    import statistics

    if not torch.cuda.is_available():
        print("qmm_variants: no CUDA device", flush=True)
        return 1
    inp = make_inputs()
    got, want = run_variants(inp), run_variants(inp, plain=True)
    for v in VARIANTS:
        n_diff = int((got[v] != want[v]).sum())
        print(f"{v}: {n_diff} of {want[v].numel()} int8 elements differ from the plain version")
        if n_diff:
            return 1
    times = {}
    for v in VARIANTS:
        run = lambda: qmm_variant(v, inp["x"], inp["w"], inp["a"], inp["b"], inp["res"] if v == "full" else None)
        for _ in range(3):
            run()
        per = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                run()
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end) / 20)
        times[v] = statistics.median(per)
        print(f"{v}: {times[v]:.4f} ms on {torch.cuda.get_device_name(0)}")
    print(f"epilogue share of full: {(times['full'] - times['shift']) / times['full']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
