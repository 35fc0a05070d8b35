"""The whole call's share of the int8 peak: the forward pass's operations an image, counted from the
configuration's shapes (``work.forward_ops``, whatever implements them), times the window's images a
second."""
from bench_port import work


def read(run):
    c = run.config
    ops = work.forward_ops(c["family"], c["num_classes"], c["features"], *c["canvas"])
    return 100.0 * ops * run.counts["images"] / run.counts["seconds"] / (work.PEAK_OPS["int8"] * run.chips)
