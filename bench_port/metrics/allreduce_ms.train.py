"""Device milliseconds a step in NCCL kernels (the gradients' and the losses' all-reduce) in the profiled
segment; nothing where the step ran none."""


def read(run):
    match = lambda name: "nccl" in name.lower()  # noqa: E731
    if run.launches(match) == 0:
        return None
    return run.device_us(match) / 1e3 / run.counts["trace_calls"]
