"""Device milliseconds of ``forward_levels`` (stem, backbone, pyramid, head) a batch, between CUDA events
around the public call: the median over the window's batches."""
from bench_port.harness import median


def read(run):
    return median(run.spans.get("forward_ms", []))
