"""The serving loop: batches of host frames through a pipeline, a closed loop with batches in flight.

Set-up draws the configuration's weights and a pool of frames from the
seed, builds the pipeline the cell names (calibrating int8 on frames of
its own), copies the pool into pinned host memory and serves every pool
batch once.  The window then serves batches until ``--seconds`` have
passed: each batch's frames go to the card by a non-blocking copy, the
pipeline runs, its detections come back by non-blocking copies into
pinned buffers behind an event, and the next batch is enqueued before that
event is waited on (``in_flight`` batches at a time).  A batch's latency
runs from the moment its frames were handed over to the moment its
detections were in host memory.  The rate is every image whose detections
arrived, over the time from the first hand-over to the last arrival.

After the window the reference (``reference/``) recomputes the
detections of a sample of served batches, drawn from the seed, and
``check.py`` compares them.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from bench_port import check, harness, inputs, weights
from bench_port.reference import models, postprocess


def prebuild(names):
    """Load (building where needed) the kernel libraries ``module:attr``
    the cell's path runs, all at once: one nvcc each."""
    import importlib

    def load(spec):
        module, attr = spec.split(":")
        return getattr(importlib.import_module(f"pytorch_object_detection_tpu_torch.{module}"), attr)()

    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        for fut in [pool.submit(load, n) for n in names]:
            fut.result()


def build_pipeline(cell: dict, cfg: dict, seed: int, device: torch.device):
    from pytorch_object_detection_tpu_torch.eval import evaluator
    from pytorch_object_detection_tpu_torch.models.registry import build_model

    model = build_model(cfg["family"], cfg["num_classes"], cfg["features"], device=device,
                        generator=torch.Generator().manual_seed(0))
    model.load_state_dict(weights.draw(cfg, seed, device))
    serve = cfg["serve"]
    calib, _, _ = inputs.frames(weights.generator(device, seed, 2), serve["calib_frames"], tuple(cfg["canvas"]),
                                cell["frames"], cfg["num_classes"], device)
    maker = getattr(evaluator, cell["pipeline"]["maker"])
    return maker(model, inputs.normalize(calib), cfg["strides"], tuple(cfg["canvas"]),
                 score_threshold=serve["score_threshold"], nms_iou=serve["nms_iou"],
                 max_detections=serve["max_detections"], **cell["pipeline"].get("kwargs", {}))


class Server:
    """The closed loop over one pipeline: ``serve(n)`` or ``serve(seconds=s)``."""

    def __init__(self, pipeline, pool, in_flight: int, device: torch.device, spans: bool = False):
        self.pipeline, self.pool, self.in_flight, self.device = pipeline, pool, in_flight, device
        self.slots = None  # the pinned host buffers a batch's detections are copied into, one set a batch in flight
        self.spans = spans
        self.batches = 0  # batches issued so far
        self.keep = set()  # batch indices whose detections are kept
        self.kept = {}
        self.host_ms, self.forward_ms, self.decode_ms = [], [], []

    def _issue(self, i: int):
        from torch.profiler import record_function as span

        if not self.spans:  # the untraced run marks nothing
            span = lambda name: contextlib.nullcontext()  # noqa: E731
        hand = time.perf_counter()
        with span("bench.h2d"):
            frames = self.pool[i % len(self.pool)].to(self.device, non_blocking=True)
        events = None
        if self.spans:
            events = [harness.event(self.device, timing=True) for _ in range(3)]
            events[0].record()
            with span("bench.forward"):
                levels = self.pipeline.forward_levels(self.pipeline.canvas(frames))
            events[1].record()
            with span("bench.decode"):
                det = self.pipeline.decode(levels)
            events[2].record()
            self.host_ms.append((time.perf_counter() - hand) * 1e3)
        else:
            det = self.pipeline(frames)
        if self.slots is None:
            pin = self.device.type == "cuda"
            self.slots = [tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for t in det)
                          for _ in range(self.in_flight)]
        slot = self.slots[i % self.in_flight]
        with span("bench.d2h"):
            for host, dev in zip(slot, det):
                host.copy_(dev, non_blocking=True)
            done = harness.event(self.device)
            done.record()
        return i, hand, done, events

    def _finish(self, item, latencies):
        i, hand, done, events = item
        done.synchronize()
        latencies.append((time.perf_counter() - hand) * 1e3)
        if events is not None:
            self.forward_ms.append(events[0].elapsed_time(events[1]))
            self.decode_ms.append(events[1].elapsed_time(events[2]))
        if i in self.keep:
            self.kept[i] = tuple(t.clone() for t in self.slots[i % self.in_flight])
        return time.perf_counter()

    def serve(self, n: int = 0, seconds: float = 0.0):
        """Serve ``n`` batches, or batches until ``seconds`` have passed
        since the first hand-over; ``(latencies ms, first hand-over, last
        arrival, batches)``."""
        latencies, pending, count = [], [], 0
        start = time.perf_counter()
        last = start
        while (count < n) if n else (time.perf_counter() - start < seconds):
            pending.append(self._issue(self.batches))
            self.batches += 1
            count += 1
            if len(pending) >= self.in_flight:
                last = self._finish(pending.pop(0), latencies)
        for item in pending:
            last = self._finish(item, latencies)
        return latencies, start, last, count


def run(cell: dict, cfg: dict, args, t_start: float, device: torch.device, spec: dict) -> dict:
    if device.type == "cuda":
        prebuild(cell.get("kernels", []))
    b, canvas = cell["batch"], tuple(cfg["canvas"])
    pipeline = build_pipeline(cell, cfg, args.seed, device)
    g = weights.generator(device, args.seed, 1)
    pool = []
    for _ in range(cell["pool_batches"]):
        u8, _, _ = inputs.frames(g, b, canvas, cell["frames"], cfg["num_classes"], device)
        pool.append(torch.empty(u8.shape, dtype=torch.uint8, pin_memory=device.type == "cuda").copy_(u8))
    del u8
    server = Server(pipeline, pool, cell["in_flight"], device, spans=bool(args.trace))
    server.serve(n=max(len(pool), 2 * cell["in_flight"]))  # every pool batch once: every shape, every kernel
    harness.sync(device)
    # the sample the check compares: batch positions in the window drawn from the seed, scaled by the
    # warm-up's pace so that they fall inside it
    per_batch = time.perf_counter()
    server.serve(n=cell["in_flight"])
    per_batch = (time.perf_counter() - per_batch) / cell["in_flight"]
    expected = max(int(0.6 * args.seconds / max(per_batch, 1e-4)), cell["check"]["sample_batches"])
    sg = torch.Generator().manual_seed((args.seed << 4) | 3)
    sample = [server.batches + int(i) for i in torch.randperm(expected, generator=sg)[:cell["check"]["sample_batches"]]]
    server.keep = set(sample)
    server.host_ms.clear(), server.forward_ms.clear(), server.decode_ms.clear()
    setup_peak = harness.peak_bytes(device, reset=True)
    setup_s = time.time() - t_start
    first_timed = server.batches
    latencies, start, last, count = server.serve(seconds=args.seconds)
    harness.sync(device)
    window_peak = harness.peak_bytes(device)
    window_s = last - start
    images = count * b
    metrics = {"serve_img_per_s": images / window_s, "serve_batch_p95_ms": harness.p95(latencies),
               "peak_mem_gib": window_peak / 2 ** 30, "setup_s": setup_s}
    extra = {}
    result = {"attempted": count, "failed": count - len(latencies)}
    if args.trace:
        run_obj, extra, result["breakdown"] = trace(server, cell, cfg, images, count, window_s)
        metrics = {}
        for name in harness.per_layer_names(spec, args.workload, ["serve_img_per_s", "serve_batch_p95_ms"]):
            value = harness.reader(name)(run_obj)
            if value is not None:
                metrics[name] = value
    else:
        metrics = {k: metrics[k] for k in harness.end_to_end_names(spec, args.workload, list(metrics))}
    kept = {i: server.kept[i] for i in sample if i in server.kept and i >= first_timed}
    missing = [i for i in sample if i not in kept]
    if missing:  # drawn within 0.6 of the pace the warm-up showed: a window this short is a fault of its own
        raise RuntimeError(f"sampled batches {missing} were not served in the window ({count} batches)")
    frames = {i: pool[i % len(pool)] for i in kept}
    del server, pipeline
    harness.sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared = compare(cell, cfg, args.seed, kept, frames, device)
    result.update(correct=check.passes(compared) and result["failed"] == 0, metrics=metrics,
                  device=harness.device_info(device, 1, max(setup_peak, window_peak), extra))
    return result, compared


def trace(server, cell, cfg, images, count, window_s):
    """The per-layer view of the traced run: the window's spans, then a
    profiled segment of ``trace_batches`` batches."""
    n = cell["trace_batches"]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        harness.profile_segment(server.device, lambda: server.serve(n=cell["in_flight"]), lambda: server.serve(n=n),
                                path)
        kernels, window, runtime, host = harness.read_trace(path, "bench.window")
    finally:
        os.remove(path)
    spans = {"entry_host_ms": server.host_ms, "forward_ms": server.forward_ms, "decode_ms": server.decode_ms}
    counts = {"images": images, "calls": count, "seconds": window_s, "trace_calls": n,
              "trace_images": n * cell["batch"]}
    run_obj = harness.Run(cell, cfg, spans, counts, [(k[0], k[1], k[2]) for k in kernels], window, 1)
    extra = {"busy_s": run_obj.busy_us() / 1e6, "window_s": window[1] / 1e6}
    return run_obj, extra, harness.breakdown(kernels, window, runtime, host)


def reference_detections(cell: dict, cfg: dict, w: dict, u8: torch.Tensor, quant=None):
    """The reference's kept detections of each frame of ``u8`` (on its device), in chunks."""
    serve, out = cfg["serve"], []
    for s in range(0, u8.shape[0], cell["check"]["chunk"]):
        with torch.no_grad():
            maps = models.forward(cfg["family"], w, inputs.normalize(u8[s:s + cell["check"]["chunk"]]), quant)
        out += postprocess.detections(maps, cfg["strides"], serve["score_threshold"], serve["nms_iou"],
                                      serve["max_detections"], tuple(cfg["canvas"]))
    return out


def compare(cell: dict, cfg: dict, seed: int, kept: dict, frames: dict, device: torch.device) -> dict:
    """The reference's detections of the sampled batches against the served ones."""
    torch.backends.cudnn.allow_tf32 = False  # the reference in float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    w = weights.draw(cfg, seed, device)
    served, want = [], []
    for i, host in kept.items():
        want += reference_detections(cell, cfg, w, frames[i].to(device))
        served += check.served_detections(host)
    return check.detection_gaps(served, want, cell["check"])
