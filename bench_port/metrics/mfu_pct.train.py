"""The whole step's share of the bf16 peak of the cards: three forward passes' operations an image
(forward, and the backward's two products), counted from the configuration's shapes, times the
window's images a second."""
from bench_port import work


def read(run):
    c = run.config
    ops = 3 * work.forward_ops(c["family"], c["num_classes"], c["features"], *c["canvas"])
    return 100.0 * ops * run.counts["images"] / run.counts["seconds"] / (work.PEAK_OPS["bf16"] * run.chips)
