"""The readings a cell's limits are set from, at the cell's own sizes, in one process.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 [--faults]

For each of ``--seeds``, the program's numbers: set-up as a run makes it,
the sampled batches served (or the first steps and one later step taken)
through the timed path's own call, and the check's comparison with the
reference.  For each
of ``--control-seeds``, the control's: the reference computed one
precision below the configuration's (serving: int4 for int8; training:
float8 e4m3 for bfloat16) put in the program's place.  With ``--faults``
(training), the program with part of each batch left out (the mean over
the rest), as a rank whose gradients were never exchanged would compute.
One JSON line a reading; the benchmark's own runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_port import check, harness, inputs, serve, train, weights  # noqa: E402
from bench_port.reference import quant  # noqa: E402
from bench_port.reference import train as ref_train  # noqa: E402


def serve_program(cell, cfg, seed, device):
    pipeline = serve.build_pipeline(cell, cfg, seed, device)
    g = weights.generator(device, seed, 1)
    frames, kept = {}, {}
    for i in range(cell["check"]["sample_batches"]):
        u8, _, _ = inputs.frames(g, cell["batch"], tuple(cfg["canvas"]), cell["frames"], cfg["num_classes"], device)
        frames[i] = u8
        det = pipeline(u8)
        kept[i] = tuple(t.cpu() for t in det)
    del pipeline
    torch.cuda.empty_cache()
    return serve.compare(cell, cfg, seed, kept, frames, device)


def serve_control(cell, cfg, seed, device, name):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = weights.draw(cfg, seed, device)
    g = weights.generator(device, seed, 1)
    served, want = [], []
    for _ in range(cell["check"]["sample_batches"]):
        u8, _, _ = inputs.frames(g, cell["batch"], tuple(cfg["canvas"]), cell["frames"], cfg["num_classes"], device)
        want += serve.reference_detections(cell, cfg, w, u8)
        served += serve.reference_detections(cell, cfg, w, u8, quant.CONTROLS[name])
    return check.detection_gaps(served, want, cell["check"])


def _gaps(got, want, cell):
    """The comparison, with every leaf's gap of the directions and changes (to look into a seed)."""
    out = check.train_gaps(got, want, cell["check"]["limits"])
    for part, g, w in (("", got, want), ("window_", got["window"], want["window"])):
        for key in ("dir", "change"):
            out[f"{part}{key}_leaves"] = check.leaf_gaps(g[key], w[key], sorted(w[key]))
            out[f"{part}{key}_norms"] = dict(w[key])
    return out


LATER = 4  # steps between the first steps and the step read as a window's


def program_steps(cell, cfg, seed, device, rows=None, autocast=None):
    """The program's first steps on one card and, ``LATER`` steps on, one
    step read as a run reads its window's.  ``rows``: only the first rows
    of each global batch; ``autocast``: the program's step in that type
    instead of the configuration's."""
    one = dict(cell, chips=1, batch=cell["batch"] * cell["chips"])
    run_cfg = dict(cfg, train=dict(cfg["train"], autocast=autocast)) if autocast else cfg
    trainer = train.Trainer(one, run_cfg, seed, device, None, 0, False)
    if rows is not None:
        trainer.pool = [tuple(t[:rows] for t in b) for b in trainer.pool]
    got = train.first_steps(trainer, cell["check"]["steps"])
    trainer.run(LATER)
    trainer.arm(trainer.steps)
    trainer.run(1)
    got["window"] = trainer.window_step(cfg["train"]["momentum"])
    names = sorted(trainer.state.trainable_names())
    del trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return one, got, names


def train_program(cell, cfg, seed, device, rows=None, autocast=None):
    one, got, names = program_steps(cell, cfg, seed, device, rows, autocast)
    return train.compare(one, cfg, seed, got, names, device, gaps=lambda g, w: _gaps(g, w, cell))


def train_control(cell, cfg, seed, device, name):
    """The reference in ``name`` in the program's place: from the seed's
    weights for the first steps, from the program's state for the later step."""
    one, got, _ = program_steps(cell, cfg, seed, device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    low = train.reference_readings(one, cfg, seed, got["window"], device, quant.CONTROLS[name])
    want = train.reference_readings(one, cfg, seed, got["window"], device)
    return _gaps(low, want, cell)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--autocast", choices=("bfloat16", "float32"),
                   help="training: the program's step in this type (a look into its rounding)")
    args = p.parse_args()
    cell, cfg = harness.load_cell(args.workload)
    device = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    kind = cell["kind"]
    if kind == "serve":
        serve.prebuild(cell.get("kernels", []))
    name = "int4" if kind == "serve" else "fp8"
    jobs = [("program", s) for s in seeds] + [(name, s) for s in controls]
    if args.faults and kind == "train":
        b = cell["batch"] * cell["chips"]
        jobs += [(f"rows{b // 2}", s) for s in controls]
        if cell["chips"] > 1:
            jobs += [(f"rows{cell['batch']}", s) for s in controls]
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    for what, seed in jobs:
        # each reading starts from the settings a run starts from (a comparison turns TF32 off)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        t0 = time.perf_counter()
        if kind == "serve":
            out = serve_program(cell, cfg, seed, device) if what == "program" else serve_control(cell, cfg, seed,
                                                                                                  device, what)
        elif what == "program":
            out = train_program(cell, cfg, seed, device, autocast=args.autocast)
        elif what.startswith("rows"):
            out = train_program(cell, cfg, seed, device, rows=int(what[4:]))
        else:
            out = train_control(cell, cfg, seed, device, what)
        print(json.dumps({"cell": args.workload, "reading": what, "seed": seed,
                          "values": {k: v["value"] if "value" in v else v for k, v in out.items()},
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    print(f"card: {torch.cuda.get_device_name(0)}", file=sys.stderr)


if __name__ == "__main__":
    main()
