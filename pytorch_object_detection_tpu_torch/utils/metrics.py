"""Metric writer: TensorBoard scalars (the port's copy of the JAX package's ``utils/metrics.py``).

Writes through ``torch.utils.tensorboard`` or ``tensorboardX``, whichever
imports, opened at the first write; where neither imports, it says so in
one line and writes nothing.
Callers print their own progress lines.
"""
from __future__ import annotations

import sys
from typing import Dict, Optional


class MetricWriter:
    """Scalars to TensorBoard under ``logdir`` (none where ``logdir`` is
    None).  The writer is opened at the first :meth:`write`, so a run that
    logs nothing imports no TensorBoard."""

    def __init__(self, logdir: Optional[str] = None):
        self.logdir = logdir
        self._tb = None

    def _open(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            try:
                from tensorboardX import SummaryWriter  # type: ignore
            except ImportError:
                print(f"MetricWriter: no TensorBoard writer (torch.utils.tensorboard, tensorboardX); "
                      f"nothing is written to {self.logdir}", file=sys.stderr)
                self.logdir = None
                return
        self._tb = SummaryWriter(self.logdir)

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        if self._tb is None and self.logdir is not None:
            self._open()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
