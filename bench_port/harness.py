"""What every cell shares: its files, its metrics, the trace reader and the result line.

A cell is ``bench_port/workloads/<cell>.json`` (its traffic and check),
naming a configuration ``bench_port/configs/<config>.json``.  Which
metrics a run prints comes from ``BENCHMARK.json`` in the working
directory: the end-to-end metrics with ``--trace 0`` and the per-layer
ones with ``--trace 1``, each where its ``workloads`` list names the cell
(or, without the key, where the cell reports the end-to-end metric it
moves).  A per-layer metric is read by ``bench_port/metrics/<name>.py``,
whose ``read(run)`` returns a number or ``None`` (nothing to read: the
metric is left out of the line).
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_object_detection_tpu")  # top-level module names, compared whole


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str):
    """``(cell, config)`` of the workload file ``name``."""
    path = ROOT / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no workload file {path.relative_to(ROOT.parent)} for cell {name!r}")
    cell = load_json(path)
    return cell, load_json(ROOT / "configs" / f"{cell['config']}.json")


def benchmark_spec() -> dict:
    return load_json(Path("BENCHMARK.json"))


def end_to_end_names(spec: dict, cell: str, available: Sequence[str]) -> List[str]:
    """The end-to-end metrics this cell reports: those it can measure that
    ``BENCHMARK.json`` lists for it."""
    return [m["name"] for m in spec["end_to_end"]
            if m["name"] in available and cell in m.get("workloads", [cell])]


def per_layer_names(spec: dict, cell: str, reported: Sequence[str]) -> List[str]:
    """The per-layer metrics this cell reports with ``--trace 1``."""
    return [m["name"] for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def units(spec: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of all values (inclusive interpolation)."""
    return statistics.quantiles(values, n=100, method="inclusive")[94] if len(values) > 1 else values[0]


def median(values: Sequence[float]) -> Optional[float]:
    return statistics.median(values) if values else None


class Run:
    """What a per-layer reader sees of one traced run.

    ``cell``, ``config``; ``spans``: per-call lists of milliseconds by name
    (host clock or CUDA events around the program's calls); ``counts``:
    ``images``, ``calls`` and ``seconds`` of the timed window and of the
    profiled segment (``trace_calls``, ``trace_images``); ``kernels``:
    ``(name, start_us, dur_us)`` of every device operation in the profiled
    segment; ``window_us``: that segment's ``(start, length)``; ``chips``."""

    def __init__(self, cell: dict, config: dict, spans: Dict[str, List[float]], counts: Dict[str, float],
                 kernels: List[tuple], window_us: tuple, chips: int):
        self.cell, self.config, self.spans, self.counts = cell, config, spans, counts
        self.kernels, self.window_us, self.chips = kernels, window_us, chips

    def busy_us(self) -> float:
        """Microseconds of the segment in which some device operation ran."""
        start, length = self.window_us
        end = start + length
        busy, cur_s, cur_e = 0.0, None, None
        for _, s, d in sorted((k for k in self.kernels), key=lambda k: k[1]):
            s, e = max(s, start), min(s + d, end)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def device_us(self, match) -> float:
        """Device microseconds of the operations whose name ``match`` accepts."""
        return sum(d for n, _, d in self.kernels if match(n))

    def launches(self, match) -> int:
        return sum(1 for n, _, _ in self.kernels if match(n))


def read_trace(path: str, window_span: str):
    """``(kernels, window_us, launchers)`` from a ``torch.profiler`` Chrome
    trace: every kernel, copy and memset on the device, the segment the
    user annotation ``window_span`` covers, and for each kernel's
    correlation id the innermost host op that launched it."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels, window, runtime, host = [], None, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            kernels.append((e["name"], float(e["ts"]), float(e["dur"]), e.get("args", {}).get("correlation")))
        elif cat == "user_annotation" and e["name"] == window_span:
            window = (float(e["ts"]), float(e["dur"]))
        elif cat == "cuda_runtime":
            runtime[e.get("args", {}).get("correlation")] = (float(e["ts"]), e.get("tid"))
        elif cat in ("cpu_op", "user_annotation"):
            host.append((float(e["ts"]), float(e["dur"]), e["name"], e.get("tid")))
    if window is None:  # a trace of the card alone: the segment is what the profiler kept
        if not kernels:
            raise RuntimeError(f"the trace holds no span {window_span!r} and no device operation")
        start = min(k[1] for k in kernels)
        window = (start, max(k[1] + k[2] for k in kernels) - start)
    host.sort(key=lambda h: (h[0], -h[1]))
    return kernels, window, runtime, host


def launcher_name(ts: float, tid, host) -> str:
    """The harness span and the innermost host op around time ``ts`` on thread ``tid``."""
    inner, span = None, None
    for s, d, name, t in host:
        if s > ts:
            break
        if t == tid and s <= ts <= s + d:
            if name.startswith("bench."):
                span = name
            else:
                inner = name
    return "/".join(x for x in (span, inner) if x) or "unknown"


def breakdown(kernels, window, runtime, host, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the segment named by what the host was launching when each ended."""
    start, length = window
    by_name: Dict[str, float] = {}
    inside = sorted((k for k in kernels if start <= k[1] <= start + length), key=lambda k: k[1])
    for name, _, dur, _ in inside:
        name = name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], start
    for name, s, d, corr in inside:
        if s > end:
            gaps.append((s - end, corr))
        end = max(end, s + d)
    if start + length > end:
        gaps.append((start + length - end, None))
    gaps.sort(key=lambda g: -g[0])
    named = []
    after = {k[3]: k[0] for k in inside}
    for gap, corr in gaps[:top]:
        ts, tid = runtime.get(corr, (None, None))
        if corr is None:
            name = "window end"
        elif host and ts is not None:
            name = launcher_name(ts, tid, host)
        else:  # no host ops traced: the gap named by the operation that ended it
            name = f"before {after.get(corr, 'unknown')[:NAME_CHARS]}"
        named.append([name, gap / 1e6])
    return {"device_ops": [[n, us / 1e6] for n, us in ops], "idle_gaps": named}


class HostEvent:
    """``torch.cuda.Event``'s interface on the host clock, for runs on the CPU (the tests)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, later) -> float:
        return (later.t - self.t) * 1e3


def event(device: torch.device, timing: bool = False):
    return torch.cuda.Event(enable_timing=timing) if device.type == "cuda" else HostEvent()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device, reset: bool = False) -> int:
    """The allocator's peak on ``device`` since the last reset (0 off the card); ``reset`` starts anew."""
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


NAME_CHARS = 120  # an operation's name in the breakdown, cut to this length


def profile_segment(device: torch.device, warm, segment, path: str, span: str = "bench.window",
                    host_ops: bool = True) -> None:
    """Trace ``segment()`` under ``torch.profiler`` and write the Chrome
    trace to ``path``: a schedule runs ``warm()`` as the profiler's warm-up
    step (a session can lose the card's first events) and keeps only the
    active step, ``segment()`` inside the user annotation ``span`` ending
    in a synchronize.  ``host_ops=False`` records the card's operations
    alone, which costs the host far less a launch; the trace then holds no
    span, and the segment runs from its first device operation to its last."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    activities = ([ProfilerActivity.CPU] if host_ops or device.type != "cuda" else []) + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda prof: prof.export_chrome_trace(path)) as prof:
        warm()
        sync(device)
        prof.step()
        with record_function(span):
            segment()
            sync(device)
        prof.step()


def device_info(device: torch.device, count: int, peak: int, extra: Optional[dict] = None) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    info.update(extra or {})
    return info


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def emit(result: dict, compared: Dict[str, dict], spec: dict) -> None:
    """Print each compared number beside its limit as the last lines on
    standard error, then the result as the last line on standard output:
    each metric with its unit from ``spec``, ``compared`` as the last key."""
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    line = dict(result)
    unit = units(spec)
    line["metrics"] = {k: {"value": v, "unit": unit[k]} for k, v in result["metrics"].items()}
    line["compared"] = compared
    print(json.dumps(line), flush=True)
