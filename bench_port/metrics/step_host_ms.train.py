"""Host milliseconds of one train-step call until it returns: the median over the window's steps."""
from bench_port.harness import median


def read(run):
    return median(run.spans.get("step_host_ms", []))
