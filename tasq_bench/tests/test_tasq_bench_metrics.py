"""The per-layer readers on a made-up trace: each reads what its
docstring says, and returns None where the run gave it nothing."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

import tasq_bench_tiny                                      # noqa: F401
from tasq_bench.bounds import kernels as bounds

BENCH = Path(__file__).resolve().parents[1]
# every reader under metrics/
PER_LAYER = sorted(p.name[:-3] for p in (BENCH / "metrics").glob("*.py")
                   if p.name != "__init__.py")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "tasq_bench_test_metric", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, t0, t1, depth=0, **attrs):
    return SimpleNamespace(name=name, t0=t0, t1=t1, depth=depth, attrs=attrs)


TRACED = {
    "spans": [_span("cluster_epoch_step", 1.0, 1.004),
              _span("scheduler.expire", 1.0005, 1.001, 1)],
    "counters": {"epochs": 2, "cache_hit": 9, "cache_miss": 1},
    "run_window_s": 2.0, "window_s": 2.0, "busy_s": 0.5,
    "kernel_s": {"void arepas_runtimes_kernel(...)": 0.004,
                 "epoch_step_kernel": 0.001, "resize_step_kernel": 0.002},
    "bound_s": {"K1": 1e-6, "K2": 2e-6, "K3": 1e-6,
                "all": 4e-6},
}
WANT = {"idle_share.cluster": 75.0,
        "epoch_ms.cluster": 1000.0, "admit_ms.cluster": 1.75,
        "cache_hit_share.cluster": 90.0, "k1_roofline.cluster": 0.025,
        "k2_roofline.cluster": 0.2, "k3_roofline.cluster": 0.05,
        "epoch_mfu.cluster": 2e-4}


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader(name):
    read = _reader(name)
    assert read(SimpleNamespace(traced=TRACED)) == pytest.approx(WANT[name])
    assert read(SimpleNamespace(traced={})) is None


def test_bounds_grow_with_the_work():
    assert bounds.k1_seconds(2000, 4, 1) > bounds.k1_seconds(1000, 4, 1)
    assert bounds.k2_seconds(4, 8192, 64) > bounds.k2_seconds(4, 4096, 64)
    assert bounds.gnn_row_flops(20, 49, (64, 64, 32), (16,)) > \
        bounds.gnn_row_flops(10, 49, (64, 64, 32), (16,))
    assert bounds.nn_row_flops(51, (32, 16)) == 2 * 51 + 2 * (
        51 * 32 + 32 * 16 + 16 * 2)
