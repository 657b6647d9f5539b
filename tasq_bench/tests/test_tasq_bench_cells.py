"""Each cell end to end at a tiny size on the CPU, through the port's
plain kernels: a sound run is correct; the control (the reference in the
next lower precision, in the program's place) and each fault the cell
can have, planted underneath the timed path, are not."""
import pytest

from tasq_bench.drivers import cluster_passes
from tasq_bench_tiny import sample_all, tiny_run          # noqa: F401

CELLS = ["nn-submit-steady", "nn-cluster-recurring"]
FAULTS = [("nn-submit-steady", "token"), ("nn-submit-steady", "half"),
          ("nn-cluster-recurring", "token"),
          ("nn-cluster-recurring", "state"),
          ("nn-cluster-recurring", "queue"),
          ("nn-cluster-recurring", "order")]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, sample_all):
    correct, res = tiny_run(name)
    assert correct, res.checks
    assert res.attempted > 0
    assert all(v > 0 for v in res.metrics.values()), res.metrics


@pytest.mark.parametrize("name", ["nn-submit-steady",
                                  "nn-cluster-recurring"])
def test_control_is_not_correct(name, sample_all):
    correct, res = tiny_run(name, control=True)
    assert not correct
    assert {c.name for c in res.checks if not c.ok} >= {"ab_gap"}


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault, sample_all, monkeypatch):
    monkeypatch.setattr(cluster_passes, "GRACE_S", 2.0)
    correct, res = tiny_run(name, fault=fault)
    assert not correct, res.checks
    if fault in ("queue", "order"):     # the host loop's, not a kernel's
        assert "pass_misses" in {c.name for c in res.checks if not c.ok}
