"""Kernel C's share of its roofline in the profiled segment: the operations of ResNet-50's 16 bottlenecks
at the cell's batch and canvas, counted from shapes (``work.bottleneck_ops``), for every batch whose 16
launches the trace holds, over the device time of those launches, against the int8 peak."""
from bench_port import work

KERNEL = "qblock_kernel"
LAUNCHES_PER_BATCH = 16  # 13 stride-1 and 3 stride-2 bottlenecks


def read(run):
    match = lambda name: KERNEL in name  # noqa: E731
    launches = run.launches(match)
    if launches == 0:
        return None
    h, w = run.config["canvas"]
    ops = work.bottleneck_ops(h, w) * run.cell["batch"] * launches / LAUNCHES_PER_BATCH
    return work.roofline_pct(ops, run.device_us(match) / 1e6, "int8")
