"""Profiling hooks (``torch.profiler``) and device memory stats.

Counterpart of ``pytorch_object_detection_tpu/utils/profile.py``: a trace
context writing a Chrome/Perfetto trace of host and card activity, named
regions inside it, the card's memory in the JAX function's keys, and a
throughput meter.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Profile the block's CPU and CUDA activity (CUDA where the card is
    there) and write it as a Chrome/Perfetto trace, ``logdir/trace.json``
    (open in Perfetto or ``chrome://tracing``).  Yields ``logdir``.  The
    card's first events after the session starts can be missing from the
    trace: run a warm-up step inside the block before the steps to read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the card's work inside the block ends inside the trace
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region inside a trace (use around steps)."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The card's memory in bytes, in the JAX function's keys: in use and its
    peak (PyTorch's allocator), and the limit (the card's total memory).
    ``None`` for a device without stats (the CPU), as JAX returns for a
    backend without them.  The default device is the card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", -1)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", -1)),
        "bytes_limit": int(total),
    }


class StepTimer:
    """Throughput meter over pipelined steps (images/sec, EMA-smoothed)."""

    def __init__(self, smoothing: float = 0.9):
        self._time = time.perf_counter
        self._last = self._time()
        self._ema = None
        self._smoothing = smoothing

    def tick(self, images: int) -> float:
        now = self._time()
        rate = images / max(now - self._last, 1e-9)
        self._last = now
        self._ema = rate if self._ema is None else (
            self._smoothing * self._ema + (1 - self._smoothing) * rate
        )
        return self._ema
