"""The training loop: the program's train step over seeded batches, on one card or by data parallelism.

Set-up draws the configuration's weights and a pool of ``pool_batches``
global batches (frames, boxes, labels) from the seed, builds the train
state and step the configuration's recipe names, and drives that state
through its first ``check.steps`` steps on distinct batches through the
same call the window makes, reading what the check compares (each step's
loss, the first update direction from the optimizer's momentum, each
trained leaf's change after those steps).  After two more steps the
window runs a fixed number of steps, sized by rank 0 from the warm steps'
pace to fill ``--seconds``, with ``in_flight`` steps enqueued at a time.
One step of the window, drawn from the seed, is bracketed by copies of the
trained leaves and their momentum into pinned host memory (set up before
the window), and the reference replays that step from the copies.
The rate is every image of every step over the time from the first step's
call to the last step's end.

With ``chips`` above 1 the launching process spawns one process a card,
joined in an NCCL data group (``parallel/mesh``); each rank takes its
rows of every global batch, and the launching process prints the line.
After the window every rank's weights are held to rank 0's, rank 0
runs the reference's steps on the whole global batches, and each rank
reports the modules of JAX it has loaded by then.
"""
from __future__ import annotations

import gc
import os
import socket
import tempfile
import sys
import time
import traceback

import torch

from bench_port import check, harness, inputs, weights
from bench_port.reference import train as ref_train

PHASES = ("forward", "loss", "backward", "optimizer")


def global_batches(cfg: dict, cell: dict, seed: int, device, count: int):
    """The first ``count`` global batches of the pool: normalized frames, boxes, labels."""
    g = weights.generator(device, seed, 1)
    n = cell["batch"] * cell["chips"]
    out = []
    for _ in range(count):
        u8, boxes, labels = inputs.frames(g, n, tuple(cfg["canvas"]), cell["frames"], cfg["num_classes"], device)
        out.append((inputs.normalize(u8), boxes, labels))
    return out


def level_shapes(cfg: dict):
    h, w = cfg["canvas"]
    return [(h // s, w // s) for s in cfg["strides"]]


class Trainer:
    """The program's state and step over this rank's pool, in a closed loop."""

    def __init__(self, cell, cfg, seed, device, mesh, rank, spans):
        from pytorch_object_detection_tpu_torch.models.registry import build_model
        from pytorch_object_detection_tpu_torch.parallel.mesh import replicate_state
        from pytorch_object_detection_tpu_torch.train.trainer import create_train_state, make_train_step

        recipe = cfg["train"]
        model = build_model(cfg["family"], cfg["num_classes"], cfg["features"], frozen_stages=recipe["frozen_stages"],
                            device=device, generator=torch.Generator().manual_seed(0))
        model.load_state_dict(weights.draw(cfg, seed, device))
        opt = {"name": recipe["optimizer"], "lr": recipe["lr"], "momentum": recipe["momentum"],
               "weight_decay": recipe["weight_decay"], "warmup_steps": recipe["warmup_steps"],
               "warmup_factor": recipe["warmup_factor"]}
        self.state = create_train_state(model, opt, freeze_bn=recipe["freeze_bn"],
                                        frozen_stages=recipe["frozen_stages"])
        if mesh is not None:
            replicate_state(mesh, self.state)
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[recipe["autocast"]]
        self.step_fn = make_train_step(model, level_shapes(cfg), cfg["strides"], [tuple(r) for r in cfg["ranges"]],
                                       recipe["criterion"], dtype, mesh=mesh)
        b = cell["batch"]
        rows = slice(rank * b, (rank + 1) * b)
        self.pool = [tuple(t[rows].contiguous() for t in batch)
                     for batch in global_batches(cfg, cell, seed, device, cell["pool_batches"])]
        self.in_flight, self.spans, self.device = cell["in_flight"], spans, device
        self.steps = 0
        self.snap_step, self.snap = None, {}
        self.losses = []
        self.host_ms = []
        self.phase_ms = {p: [] for p in PHASES}

    def _issue(self):
        batch = self.pool[self.steps % len(self.pool)]
        snap = self.steps == self.snap_step
        if snap:
            self._copy("before")
            self.snap.update(step=self.state.step, batch=self.steps % len(self.pool))
        events = None
        record = None
        if self.spans:
            events = {"start": harness.event(self.device, timing=True)}

            def record(phase):
                events[phase] = harness.event(self.device, timing=True)
                events[phase].record()

            events["start"].record()
        hand = time.perf_counter()
        metrics = self.step_fn(self.state, *batch, record=record)
        if self.spans:
            self.host_ms.append((time.perf_counter() - hand) * 1e3)
        if snap:
            self._copy("after")
            self.snap["loss"] = metrics["total"]
        done = harness.event(self.device)
        done.record()
        self.steps += 1
        return metrics["total"], done, events

    def trained(self):
        return {n: p for n, p in self.state.model.named_parameters() if p.requires_grad}

    def arm(self, step: int):
        """Copy the trained leaves and their momentum to host buffers (one
        float32 block each, pinned on the card's host) before and after
        global step ``step``."""
        named = self.trained()
        total = sum(p.numel() for p in named.values())
        self.snap_step, self.snap = step, {}
        for key in ("params_before", "momentum_before", "params_after", "momentum_after"):
            flat = torch.empty(total, dtype=torch.float32, pin_memory=self.device.type == "cuda")
            self.snap[key], at = {}, 0
            for n, p in named.items():
                self.snap[key][n] = flat[at:at + p.numel()].view(p.shape)
                at += p.numel()

    def _copy(self, when: str):
        opt = self.state.optimizer.state
        for n, p in self.trained().items():
            self.snap[f"params_{when}"][n].copy_(p.detach(), non_blocking=True)
            mom = opt.get(p, {}).get("momentum_buffer")
            if mom is None:  # a state with no momentum (none taken yet, or dropped): zero
                self.snap[f"momentum_{when}"][n].zero_()
            else:
                self.snap[f"momentum_{when}"][n].copy_(mom, non_blocking=True)

    def window_step(self, momentum: float) -> dict:
        """The armed step as the program took it: its loss, update direction
        (the momentum after it less ``momentum`` times the momentum before)
        and change, as leaf norms in float64; and the state before it."""
        harness.sync(self.device)
        s, direction, change = self.snap, {}, {}
        for n in s["params_before"]:
            mom = [s[f"momentum_{w}"][n].to(self.device, torch.float64) for w in ("before", "after")]
            direction[n] = float((mom[1] - momentum * mom[0]).norm())
            par = [s[f"params_{w}"][n].to(self.device, torch.float64) for w in ("before", "after")]
            change[n] = float((par[1] - par[0]).norm())
        return {"losses": [float(s["loss"])], "dir": direction, "change": change, "step": s["step"],
                "batch": s["batch"], "params": s["params_before"], "momentum": s["momentum_before"]}

    def _finish(self, item):
        loss, done, events = item
        done.synchronize()
        self.losses.append(loss)
        if events is not None:
            prev = "start"
            for p in PHASES:
                self.phase_ms[p].append(events[prev].elapsed_time(events[p]))
                prev = p
        return time.perf_counter()

    def run(self, n: int):
        """``n`` steps; (first call, last end)."""
        pending = []
        start = last = time.perf_counter()
        for _ in range(n):
            pending.append(self._issue())
            if len(pending) >= self.in_flight:
                last = self._finish(pending.pop(0))
        for item in pending:
            last = self._finish(item)
        return start, last


def first_steps(trainer: Trainer, steps: int) -> dict:
    """Drive the state through its first ``steps`` steps and read what the check compares."""
    if len(trainer.pool) < steps:
        raise ValueError(f"the check's {steps} steps need as many distinct batches; the pool holds {len(trainer.pool)}")
    state = trainer.state
    named = trainer.trained()
    start = {n: p.detach().clone() for n, p in named.items()}
    losses, direction = [], None
    for i in range(steps):
        loss = trainer.step_fn(state, *trainer.pool[i % len(trainer.pool)])["total"]
        trainer.steps += 1
        losses.append(float(loss))
        if i == 0:
            momenta = {n: state.optimizer.state[p].get("momentum_buffer") for n, p in named.items()}
            direction = check.leaf_norms({n: torch.zeros((), device=named[n].device) if m is None else m
                                          for n, m in momenta.items()})
    change = check.leaf_norms({n: named[n].detach() - start[n] for n in named})
    return {"losses": losses, "dir": direction, "change": change, "names": sorted(named)}


def rank_gap(model, group) -> float:
    """The largest difference of a trained weight from rank 0's, over its leaf's largest magnitude."""
    import torch.distributed as dist

    worst = torch.zeros((), device=next(model.parameters()).device)
    for p in model.parameters():
        if not p.requires_grad:
            continue
        theirs = p.detach().clone()
        dist.broadcast(theirs, src=0, group=group)
        worst = torch.maximum(worst, (p.detach() - theirs).abs().max() / theirs.abs().max().clamp(min=1e-30))
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group)
    return float(worst)


def rank_main(rank: int, world: int, port: int, cell, cfg, args, t_start, spec, queue, device_type="cuda"):
    """One rank of a run.  Puts ``("done", rank, out, loaded)`` on ``queue``:
    ``out`` rank 0's ``(result, compared)`` and the others' ``None``,
    ``loaded`` the modules of JAX, Flax or the JAX package the rank holds
    once its work is done; or ``("error", rank, traceback)``."""
    try:
        out = _rank(rank, world, port, cell, cfg, args, t_start, spec, device_type)
    except BaseException:
        queue.put(("error", rank, traceback.format_exc()))
        raise
    queue.put(("done", rank, out, harness.forbidden_modules()))


def _rank(rank, world, port, cell, cfg, args, t_start, spec, device_type):
    import torch.distributed as dist

    mesh, group = None, None
    if world > 1:
        from pytorch_object_detection_tpu_torch.parallel.mesh import create_mesh, data_group, initialize_distributed

        initialize_distributed(f"127.0.0.1:{port}", world, rank, device=device_type)
        mesh = create_mesh()
        group = data_group(mesh)
    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device("cpu")
    out = run_rank(cell, cfg, args, t_start, spec, device, mesh, group, rank, world)
    if world > 1:
        dist.destroy_process_group()
    return out


def run_rank(cell, cfg, args, t_start, spec, device, mesh, group, rank, world):
    import torch.distributed as dist

    trainer = Trainer(cell, cfg, args.seed, device, mesh, rank, bool(args.trace))
    got = first_steps(trainer, cell["check"]["steps"])
    trainer.run(2)  # warm steps, also the pace of the window
    harness.sync(device)
    t0 = time.perf_counter()
    trainer.run(2)
    pace = (time.perf_counter() - t0) / 2
    n = torch.tensor([max(2, round(args.seconds / pace))], device=device)
    if group is not None:
        dist.broadcast(n, src=0, group=group)
    n = int(n)
    pick = torch.Generator().manual_seed((args.seed << 4) | 5)
    trainer.arm(trainer.steps + int(torch.randint(n, (1,), generator=pick)))
    trainer.losses.clear(), trainer.host_ms.clear()
    for v in trainer.phase_ms.values():
        v.clear()
    # a host-paced step: one host thread for the program's CPU work, and set-up's objects frozen out of the
    # collector's full passes, so that runs differ less in how the host keeps up
    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()
    setup_peak = harness.peak_bytes(device, reset=True)
    setup_s = time.time() - t_start
    start, last = trainer.run(n)
    harness.sync(device)
    window_s = last - start
    window_peak = harness.peak_bytes(device)
    peak = max(window_peak, setup_peak)
    failed = sum(1 for t in trainer.losses if not torch.isfinite(t))
    images = n * cell["batch"] * world
    mine = {"peak": peak, "window_peak": window_peak}
    if rank == 0:
        got["window"] = trainer.window_step(cfg["train"]["momentum"])
    if args.trace:
        mine.update(trace(trainer, cell, cfg, spec, args, images, n, window_s, world, device))
    if group is not None:
        got["rank_gap"] = rank_gap(trainer.state.model, group)
        names = sorted(trainer.state.trainable_names())
        everyone = [None] * world
        dist.all_gather_object(everyone, mine, group=group)
    else:
        names = sorted(trainer.state.trainable_names())
        everyone = [mine]
    del trainer
    if rank != 0:
        return None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    metrics = {"train_img_per_s": images / window_s, "peak_mem_gib": max(e["window_peak"] for e in everyone) / 2 ** 30,
               "setup_s": setup_s}
    result = {"attempted": n, "failed": failed}
    extra = {}
    if args.trace:
        metrics = {}
        for name in harness.per_layer_names(spec, args.workload, ["train_img_per_s"]):
            values = [e["per_layer"][name] for e in everyone if e["per_layer"].get(name) is not None]
            if values:
                metrics[name] = sum(values) / len(values)
        extra = {k: sum(e[k] for e in everyone) / world for k in ("busy_s", "window_s")}
        result["breakdown"] = everyone[0]["breakdown"]
    else:
        metrics = {k: metrics[k] for k in harness.end_to_end_names(spec, args.workload, list(metrics))}
    numbers = compare(cell, cfg, args.seed, got, names, device)
    for name, c in numbers.items():
        if "limit" not in c:
            print(f"reported {name} {c['value']!r} (no limit: not compared)", file=sys.stderr, flush=True)
    compared = check.compared_only(numbers)
    peak_bytes = max(e["peak"] for e in everyone)
    result.update(correct=check.passes(compared) and failed == 0, metrics=metrics,
                  device=harness.device_info(device, world, peak_bytes, extra))
    return result, compared


def trace(trainer, cell, cfg, spec, args, images, n, window_s, world, device) -> dict:
    """This rank's per-layer numbers: the window's spans, then a profiled segment of ``trace_steps`` steps."""
    k = cell["trace_steps"]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        # the card's operations alone: tracing host ops doubles a step the host paces
        harness.profile_segment(device, lambda: trainer.run(1), lambda: trainer.run(k), path, host_ops=False)
        kernels, window, runtime, host = harness.read_trace(path, "bench.window")
    finally:
        os.remove(path)
    spans = {"step_host_ms": trainer.host_ms, **{f"{p}_ms": v for p, v in trainer.phase_ms.items()}}
    counts = {"images": images, "calls": n, "seconds": window_s, "trace_calls": k,
              "trace_images": k * cell["batch"] * world}
    run = harness.Run(cell, cfg, spans, counts, [(x[0], x[1], x[2]) for x in kernels], window, world)
    per_layer = {}
    for name in harness.per_layer_names(spec, args.workload, ["train_img_per_s"]):
        per_layer[name] = harness.reader(name)(run)
    return {"per_layer": per_layer, "busy_s": run.busy_us() / 1e6, "window_s": window[1] / 1e6,
            "breakdown": harness.breakdown(kernels, window, runtime, host)}


def reference_readings(cell, cfg, seed, window, device, quant=None) -> dict:
    """What the reference reads where the program read: the first steps on
    the whole global batches from the seed's weights, and the window step
    replayed from the program's state before it (``window``, as
    :meth:`Trainer.window_step` gives it).  ``quant``: the reference one
    precision lower (the control)."""
    steps, chunk, recipe = cell["check"]["steps"], cell["check"]["chunk"], cfg["train"]
    w0 = weights.draw(cfg, seed, device)
    batches = global_batches(cfg, cell, seed, device, max(steps, window["batch"] + 1))
    common = (level_shapes(cfg), cfg["strides"], cfg["ranges"], recipe)
    first = ref_train.sgd_steps(cfg["family"], w0, batches, *common, steps, chunk, quant=quant)
    out = {"names": first["names"], "losses": first["losses"], "dir": check.leaf_norms(first["first_dir"]),
           "change": check.leaf_norms(first["change"]), "grad": check.leaf_norms(first["first_grad"])}
    del first
    on = lambda tensors: {n: t.to(device) for n, t in tensors.items()}  # noqa: E731
    one = ref_train.sgd_step_from(cfg["family"], w0, on(window["params"]), on(window["momentum"]),
                                  batches[window["batch"]], window["step"], *common, chunk, quant=quant)
    out["window"] = {"losses": [one["loss"]], "dir": check.leaf_norms(one["dir"]),
                     "change": check.leaf_norms(one["change"]), "grad": check.leaf_norms(one["grad"])}
    return out


def compare(cell, cfg, seed, got, names, device, gaps=None) -> dict:
    """The reference's readings (:func:`reference_readings`) against the
    program's (``gaps(got, want)``: the comparison, ``check.train_gaps``)."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    want = reference_readings(cell, cfg, seed, got["window"], device)
    if sorted(want["names"]) != names:
        raise RuntimeError(f"the program trains {len(names)} leaves, the recipe {len(want['names'])}: "
                           f"{sorted(set(names) ^ set(want['names']))[:8]}")
    for part, g, w in (("first", got, want), ("window", got["window"], want["window"])):
        for key in ("dir", "change"):  # where to look when a seed reads far from the others
            leaf = check.leaf_gaps(g[key], w[key], sorted(w[key]))
            worst = sorted(leaf, key=leaf.get)[-3:]
            print(f"reported worst {part} {key} leaves: " + ", ".join(f"{n} {leaf[n]:.4g}" for n in worst),
                  file=sys.stderr)
    if gaps is not None:
        return gaps(got, want)
    return check.train_gaps(got, want, cell["check"]["limits"])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cell, cfg, args, t_start, spec, device_type="cuda", target=None):
    """Run the cell: in this process on one card, else one spawned process a
    card, each running ``target`` (:func:`rank_main`).  Returns ``(result,
    compared, loaded)``: ``loaded`` the modules of JAX, Flax or the JAX
    package that the rank processes held (this process is the caller's to
    look at)."""
    world = cell["chips"]
    if world == 1:
        device = torch.device("cuda") if device_type == "cuda" else torch.device("cpu")
        return (*run_rank(cell, cfg, args, t_start, spec, device, None, None, 0, 1), [])
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target or rank_main,
                         args=(r, world, port, cell, cfg, args, t_start, spec, queue, device_type))
             for r in range(world)]
    for p in procs:
        p.start()
    outs = []
    try:
        for _ in range(world):
            outs.append(queue.get(timeout=cell["rank_timeout_s"]))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    errors = [o for o in outs if o[0] == "error"]
    if errors:
        raise RuntimeError("".join(f"rank {r}:\n{tb}" for _, r, tb in errors))
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"rank processes exited with {bad}")
    loaded = sorted({f"{name} (rank {r})" for _, r, _, names in outs for name in names})
    result, compared = next(o[2] for o in outs if o[2] is not None)
    return result, compared, loaded
