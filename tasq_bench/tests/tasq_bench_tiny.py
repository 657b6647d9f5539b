"""Tiny CPU runs of the benchmark's cells for the tests: the cell's own
window kind and checks at sizes a test run can hold."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from tasq_bench import harness                              # noqa: E402

SIZES = {
    "nn-submit-steady": {"rate_qps": 150.0, "n_unique": 16},
    "nn-cluster-recurring": {"n_unique": 24, "n_events": 160,
                             "warm_events": 40},
}
SEED = 2 ** 31 + 12345          # past 32 signed bits, as a driver's seeds


def tiny_run(name, seed=SEED, seconds=0.6, **kw):
    """(correct, result) of one CPU run of cell ``name`` (its file under
    ``tasq_bench/cells/``, in ``BENCHMARK.json`` or not yet) at its tiny
    size, with every call sampled for the check."""
    bench = ROOT / "tasq_bench"
    cell = harness.load_json(bench / "cells" / f"{name}.json")
    config = harness.load_json(bench / "configs" / f"{cell['config']}.json")
    cell["limits"]["min_rows"] = 1
    ctx = harness.Context(cell=cell, config=config, seed=seed,
                          seconds=seconds, trace=False,
                          t0=time.perf_counter(), device="cpu",
                          size=SIZES[name], **kw)
    res = harness.run_cell(ctx)
    correct = all(c.ok for c in res.checks) and res.failed == 0
    return correct, res


import pytest                                               # noqa: E402


@pytest.fixture
def sample_all(monkeypatch):
    """Every recorded call kept for the check."""
    from tasq_bench.drivers import cluster_passes, submit_open_loop
    monkeypatch.setattr(submit_open_loop, "SAMPLE_P", 1.0)
    monkeypatch.setattr(cluster_passes, "SAMPLE_P",
                        {k: 1.0 for k in cluster_passes.SAMPLE_P})


@pytest.fixture
def card():
    """Skips the test where there is no NVIDIA card (decided here, not
    at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
