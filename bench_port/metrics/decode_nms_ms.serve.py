"""Device milliseconds of ``decode`` (scores, top-k, boxes, class-aware NMS) a batch, between CUDA events
around the public call: the median over the window's batches."""
from bench_port.harness import median


def read(run):
    return median(run.spans.get("decode_ms", []))
