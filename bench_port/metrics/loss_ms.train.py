"""Device milliseconds of the targets and the loss (record("forward") to record("loss")), between CUDA
events: the median over the window's steps."""
from bench_port.harness import median


def read(run):
    return median(run.spans.get("loss_ms", []))
