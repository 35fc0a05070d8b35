"""Device milliseconds of the forward under autocast (from the step's call to its record("forward")),
between CUDA events: the median over the window's steps."""
from bench_port.harness import median


def read(run):
    return median(run.spans.get("forward_ms", []))
