"""The model-path readers of cluster control on a made-up trace: each
reads what its docstring says, and returns None where the run gave it
nothing, as on a program that records no ``cluster.featurize`` span and
no adjacency counter."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

import tasq_bench_tiny                                      # noqa: F401

BENCH = Path(__file__).resolve().parents[1]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "tasq_bench_test_metric", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, t0, t1, depth=0, **attrs):
    return SimpleNamespace(name=name, t0=t0, t1=t1, depth=depth, attrs=attrs)


# two passes' set-ups featurizing for 30 and 10 ms over 4 epochs; model
# decides timed at 0.5 and 0.3 ms, a history decide at 0.25 ms and an
# untimed model decide
TRACED = {
    "spans": [_span("cluster.setup", 1.0, 1.05),
              _span("cluster.featurize", 1.01, 1.04, 1, family="gnn",
                    jobs=8192, n_max=50),
              _span("cluster.epoch", 1.05, 1.06),
              _span("fabric.decide", 1.051, 1.053, 2, path="model",
                    device_ms=0.5),
              _span("fabric.decide", 1.054, 1.055, 2, path="history",
                    device_ms=0.25),
              _span("cluster.setup", 2.0, 2.02),
              _span("cluster.featurize", 2.005, 2.015, 1, family="gnn",
                    jobs=8192, n_max=50),
              _span("fabric.decide", 2.03, 2.031, 2, path="model",
                    device_ms=0.3),
              _span("fabric.decide", 2.04, 2.041, 2, path="model")],
    "counters": {"epochs": 4, "cache_hit": 9, "cache_miss": 11,
                 "model_rows": 11, "model_nodes": 121,
                 "model_adj_entries": 1331, "model_adj_slots": 80000},
    "run_window_s": 2.0, "window_s": 2.0, "busy_s": 0.5,
}
WANT = {"model_decide_ms.cluster": 0.2, "adj_fill_share.cluster": 1.66375,
        "featurize_ms.cluster": 10.0}
# what a program without the featurize span and the adjacency counters
# records (its decide spans carry their path and device time)
UNCOUNTED = {"spans": [_span("cluster.epoch", 1.05, 1.06),
                       _span("fabric.decide", 1.051, 1.053, 2,
                             path="history", device_ms=0.5)],
             "counters": {"epochs": 2, "cache_hit": 9, "cache_miss": 1},
             "run_window_s": 2.0, "window_s": 2.0, "busy_s": 0.5}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    read = _reader(name)
    assert read(SimpleNamespace(traced=TRACED)) == pytest.approx(WANT[name])
    assert read(SimpleNamespace(traced={})) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_on_an_uncounted_program(name):
    assert _reader(name)(SimpleNamespace(traced=UNCOUNTED)) is None
