"""Device milliseconds of the backward and, in a group, the gradients' mean (record("loss") to
record("backward")), between CUDA events: the median over the window's steps."""
from bench_port.harness import median


def read(run):
    return median(run.spans.get("backward_ms", []))
