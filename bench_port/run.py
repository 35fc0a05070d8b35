"""The port's benchmark: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is ``bench_port/workloads/<cell>.json``;
the metrics it prints are those ``BENCHMARK.json`` lists for it.  The last
line on standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``compared``: each number the check compared beside its limit, also
the last lines on standard error).  Exits with 2, printing no result, where
the cell's cards are not there; with 3 where JAX, Flax or the JAX package
were loaded, in this process or in a rank's; and with 1 where the program
is not in this checkout.
"""
import time

T_START = time.time()  # set-up runs from here to the first timed batch or step

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="cell name: bench_port/workloads/<name>.json")
    p.add_argument("--seed", type=int, required=True, help="draws the weights, frames, boxes and the check's sample")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: the per-layer metrics, from spans and a profiled segment after the window")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(CHECKOUT))
    # every build and kernel cache of the run at a fixed place inside the checkout
    cache = CHECKOUT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    import torch

    from bench_port import harness

    cell, cfg = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {args.workload} needs {cell['chips']} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    try:
        import pytorch_object_detection_tpu_torch as port
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 1
    if CHECKOUT not in Path(port.__file__).resolve().parents:
        print(f"the program was imported from {port.__file__}, outside this checkout", file=sys.stderr)
        return 1
    spec = harness.benchmark_spec()
    if cell["kind"] == "serve":
        from bench_port import serve
        result, compared = serve.run(cell, cfg, args, T_START, torch.device("cuda"), spec)
        loaded = []
    else:
        from bench_port import train
        result, compared, loaded = train.launch(cell, cfg, args, T_START, spec)
    return finish(result, compared, loaded, spec)


def finish(result: dict, compared: dict, loaded, spec: dict) -> int:
    """Print the result, or, where this process or a rank process (``loaded``)
    holds modules of JAX, Flax or the JAX package, name them on standard
    error, print no result and return 3."""
    from bench_port import harness

    bad = sorted(set(harness.forbidden_modules()) | set(loaded))
    if bad:
        print(f"modules of JAX, Flax or the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    harness.emit(result, compared, spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
