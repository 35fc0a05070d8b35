"""Device milliseconds of the SGD update and the metrics (record("backward") to record("optimizer")),
between CUDA events: the median over the window's steps."""
from bench_port.harness import median


def read(run):
    return median(run.spans.get("optimizer_ms", []))
