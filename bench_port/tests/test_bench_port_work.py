"""Work counts against the records, and the window's arithmetic: every rate over all the window's work and
time, every tail over all its batches."""
import statistics
import types

import numpy as np
import pytest
import torch

from bench_port import harness, serve, work

# PERF.md's bound of kernel C at B=8, 512x512 (13 stride-1 + 3 stride-2 bottlenecks), at 1,979 TOP/s
K2_K3_BOUND_MS_B8 = 0.12045 + 0.04720


def test_kernel_c_work_matches_the_recorded_bound():
    ops = work.bottleneck_ops(512, 512)
    assert ops / 1e9 == pytest.approx(41.47, abs=0.01)  # about 41.5 GOP an image
    assert 8 * ops / work.PEAK_OPS["int8"] * 1e3 == pytest.approx(K2_K3_BOUND_MS_B8, rel=1e-3)


def test_forward_work_counts_every_conv():
    his = work.forward_ops("HISFCOS", 20, 256, 512, 512)
    fcos = work.forward_ops("FCOS", 20, 256, 512, 512)
    stem = 2 * 256 * 256 * 64 * 3 * 49
    assert his > work.bottleneck_ops(512, 512) + stem
    # FCOS's four 3x3 towers of 256 a branch on P3..P7 (5456 positions at 512x512)
    towers = 2 * 8 * 5456 * 256 * 256 * 9
    assert fcos > work.bottleneck_ops(512, 512) + stem + towers
    assert work.forward_ops("HISFCOS", 20, 256, 256, 256) == pytest.approx(his / 4, rel=0.01)


def test_p95_is_the_tail_of_all_values():
    values = list(np.random.default_rng(0).exponential(10.0, 1000))
    assert harness.p95(values) == pytest.approx(float(np.percentile(values, 95)), rel=1e-9)


class FakePipeline:
    """A pipeline whose call takes a fixed time on the host and returns fixed-shape detections."""

    max_detections = 4

    def __init__(self, seconds):
        self.seconds, self.calls = seconds, 0

    def __call__(self, frames):
        import time

        self.calls += 1
        time.sleep(self.seconds)
        b = frames.shape[0]
        return (torch.ones(b, 4), torch.ones(b, 4, dtype=torch.int32), torch.zeros(b, 4, 4),
                torch.ones(b, 4, dtype=torch.bool))


@pytest.mark.parametrize("in_flight", [1, 2])
def test_serving_window_counts_all_work_over_all_time(in_flight):
    pipeline = FakePipeline(0.01)
    pool = [torch.zeros(3, 8, 8, 3, dtype=torch.uint8) for _ in range(2)]
    server = serve.Server(pipeline, pool, in_flight, torch.device("cpu"))
    latencies, start, last, count = server.serve(seconds=0.25)
    assert count == pipeline.calls == len(latencies)  # every batch issued is counted and waited for
    rate = count * 3 / (last - start)
    assert rate == pytest.approx(3 / 0.01, rel=0.25)
    assert harness.p95(latencies) >= statistics.median(latencies)


def test_training_rate_is_images_of_all_steps_over_the_window():
    from bench_port import train

    trainer = types.SimpleNamespace()
    calls = []

    def step(state, *batch, record=None):
        import time

        time.sleep(0.01)
        calls.append(1)
        return {"total": torch.tensor(1.0)}

    t = train.Trainer.__new__(train.Trainer)
    t.pool, t.in_flight, t.spans, t.device, t.steps = [(torch.zeros(1),)], 1, False, torch.device("cpu"), 0
    t.snap_step = None
    t.losses, t.host_ms, t.phase_ms, t.step_fn, t.state = [], [], {p: [] for p in train.PHASES}, step, trainer
    start, last = t.run(20)
    assert len(calls) == len(t.losses) == 20
    assert 20 / (last - start) == pytest.approx(100, rel=0.3)
