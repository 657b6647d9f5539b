"""The GNN's cell end to end at a tiny size on the CPU, through the
port's plain kernels: a sound run is correct; the control (the reference
in the next lower precision, in the program's place) fails on ``ab_gap``,
and a token fault and a state fault planted underneath the timed path
fail too."""
import pytest

import tasq_bench_tiny
from tasq_bench.drivers import cluster_passes
from tasq_bench_tiny import sample_all, tiny_run          # noqa: F401

CELL = "gnn-cluster-novel"
TINY = {"n_unique": 32, "n_events": 200, "warm_events": 40}


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(tasq_bench_tiny.SIZES, CELL, TINY)


def test_sound_run_is_correct(tiny, sample_all):
    correct, res = tiny_run(CELL)
    assert correct, res.checks
    assert res.attempted > 0
    assert all(v > 0 for v in res.metrics.values()), res.metrics


def test_control_is_not_correct(tiny, sample_all):
    correct, res = tiny_run(CELL, control=True)
    assert not correct
    assert {c.name for c in res.checks if not c.ok} >= {"ab_gap"}


@pytest.mark.parametrize("fault", ["token", "state"])
def test_fault_is_not_correct(fault, tiny, sample_all, monkeypatch):
    monkeypatch.setattr(cluster_passes, "GRACE_S", 2.0)
    correct, res = tiny_run(CELL, fault=fault)
    assert not correct, res.checks
