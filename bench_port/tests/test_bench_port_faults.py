"""A run driven on the CPU past the harness's look for a card, with the timed path broken underneath:
``correct`` comes out false for each fault a cell can have, and true for the path as it is."""
import time

import pytest

from bench_port import check, harness, run, serve, train
from bench_port.tests import faults
from bench_port.tests.small import CPU, args, small

SERVE = "hisfcos20-int8-serve-b64"
TRAIN = "hisfcos20-train-b64"
DDP = "hisfcos20-ddp4-train-b16x4"


def serve_run(monkeypatch, fault=None, cell_name=SERVE):
    cell, cfg = small(cell_name)
    if fault:
        make = serve.build_pipeline
        monkeypatch.setattr(serve, "build_pipeline", lambda *a: faults.BrokenPipeline(make(*a), fault))
    result, compared = serve.run(cell, cfg, args(cell_name), time.time(), CPU, harness.benchmark_spec())
    return result, compared


@pytest.mark.parametrize("cell_name", [SERVE, "fcos20-int8-serve-b64"])
def test_serving_sound_run_is_correct(monkeypatch, cell_name):
    result, compared = serve_run(monkeypatch, cell_name=cell_name)
    assert result["correct"], compared
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_serving_fault_is_not_correct(monkeypatch, fault):
    result, compared = serve_run(monkeypatch, fault)
    assert not result["correct"], compared


def train_run(monkeypatch, fault=None, cell_name=TRAIN, target=None):
    cell, cfg = small(cell_name)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each spawned rank on one thread
    if fault:
        from pytorch_object_detection_tpu_torch.train import trainer

        make = trainer.make_train_step
        monkeypatch.setattr(trainer, "make_train_step", lambda *a, **k: faults.broken_step(make(*a, **k), fault))
    return train.launch(cell, cfg, args(cell_name), time.time(), harness.benchmark_spec(), device_type="cpu",
                        target=target)


def test_training_sound_run_is_correct(monkeypatch):
    result, compared, loaded = train_run(monkeypatch)
    assert result["correct"], compared
    assert loaded == []
    assert "window_change_p95_gap" in compared


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_training_fault_is_not_correct(monkeypatch, fault):
    result, compared, _ = train_run(monkeypatch, fault)
    assert not result["correct"], compared
    if fault == "unchanged":  # the window's step alone shows an update left out
        window = {k: v for k, v in compared.items() if k.startswith("window_")}
        assert not check.passes(window), window


def test_data_parallel_sound_run_is_correct(monkeypatch):
    result, compared, loaded = train_run(monkeypatch, cell_name=DDP)
    assert loaded == []
    assert result["correct"], compared
    assert compared["rank_gap"]["value"] == 0.0


def test_data_parallel_without_the_exchange_is_not_correct(monkeypatch):
    result, compared, _ = train_run(monkeypatch, cell_name=DDP, target=faults.no_exchange_rank)
    assert not result["correct"], compared
    assert compared["rank_gap"]["value"] > 0.0


def test_data_parallel_rank_that_loads_jax_gives_no_result(monkeypatch, capsys):
    result, compared, loaded = train_run(monkeypatch, cell_name=DDP, target=faults.jax_rank)
    assert loaded == ["jax.numpy (rank 1)"]
    capsys.readouterr()
    assert run.finish(result, compared, loaded, harness.benchmark_spec()) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax.numpy (rank 1)" in out.err
