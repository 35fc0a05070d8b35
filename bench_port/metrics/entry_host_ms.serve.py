"""Host milliseconds of one pipeline call (the device copy-in aside), until it returns: the median over
the window's batches.  A call that waits for the card inside shows here as more than its enqueue."""
from bench_port.harness import median


def read(run):
    return median(run.spans.get("entry_host_ms", []))
